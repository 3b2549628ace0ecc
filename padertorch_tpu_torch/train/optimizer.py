"""Optimizer wrappers over ``torch.optim``.

Counterpart of ``padertorch_tpu/train/optimizer.py`` (reference
``padertorch/train/optimizer.py``): a configurable object that gets the
model's parameters with :meth:`Optimizer.set_parameters`, clips the
gradients by their global norm (mandatory, like the reference) and steps.

Held against the JAX package:

- the clip scales by ``min(1, clip / (norm + 1e-6))`` and returns the norm
  from before the clip, as a tensor on the parameters' device (no host
  sync in the step);
- ``Adam`` has ``torch.optim.Adam``'s coupled weight decay and amsgrad,
  ``AdamW`` the decoupled decay, ``SGD`` momentum and nesterov;
- only parameters that require a gradient are optimized;
- ``state_dict`` is keyed by parameter name, not by position.

``Adadelta``, ``Adafactor``, ``Lion`` and ``Muon`` are the JAX package's
optax chains (``optax.adadelta``, ``optax.adafactor``, ``optax.lion``,
``optax.contrib.muon``) written out as ``torch.optim.Optimizer`` subclasses,
operation by operation in optax's order and in float32 (the bias
corrections and Adafactor's decay schedule too), so that they follow the
JAX package's trajectories within float32 rounding.  No step reads a
value back from the card: every norm and clip factor stays a tensor.
"""
import numpy as np
import torch

from padertorch_tpu_torch.configurable import Configurable

__all__ = ['Optimizer', 'Adam', 'AdamW', 'SGD', 'Adadelta', 'Adafactor',
           'Lion', 'Muon']


def _restore(value, device):
    """A checkpoint's array -> tensor: moments on the parameter's device,
    0-d ``step`` counters on the host, where torch keeps them."""
    if not hasattr(value, 'shape'):
        return value
    value = torch.as_tensor(value).clone()
    return value.to(device) if value.dim() else value


class Optimizer(Configurable):
    """Base wrapper: a ``torch.optim`` optimizer plus gradient clipping."""

    optimizer_cls = None

    def __init__(self, gradient_clipping, **kwargs):
        self.gradient_clipping = gradient_clipping
        self.optimizer_kwargs = kwargs
        self.optimizer = None
        self.names = None

    def set_parameters(self, named_parameters, module=None):
        """``named_parameters``: ``module.named_parameters()`` (or any
        iterable of (name, parameter)); those that do not require a
        gradient are left out.  ``module``, where given, is the module
        that owns them (:class:`Muon` reads its layers' layouts)."""
        named = [(n, p) for n, p in named_parameters if p.requires_grad]
        self.names = [n for n, _ in named]
        self.optimizer = self.optimizer_cls(
            [p for _, p in named], **self.optimizer_kwargs)
        return self

    def check_if_set(self):
        assert self.optimizer is not None, (
            'The optimizer is not initialized; call set_parameters before '
            'using any of the optimizer functions.'
        )

    @property
    def parameters(self):
        self.check_if_set()
        return self.optimizer.param_groups[0]['params']

    def zero_grad(self):
        self.check_if_set()
        self.optimizer.zero_grad(set_to_none=True)

    def clip_grad(self):
        """Clip the gradients in place by their global norm; returns the
        norm from before the clip (a 0-d float32 tensor)."""
        self.check_if_set()
        grads = [p.grad for p in self.parameters if p.grad is not None]
        if not grads:
            return torch.zeros(())
        norm = torch.sqrt(sum(
            torch.sum(torch.square(g.to(torch.float32))) for g in grads))
        scale = torch.clamp(self.gradient_clipping / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale)
        return norm

    def step(self):
        """Clip, then update the parameters; returns the pre-clip norm."""
        grad_norm = self.clip_grad()
        self.optimizer.step()
        return grad_norm

    @property
    def lr(self):
        """The learning rate; ``None`` for ``Adafactor(lr=None)``."""
        self.check_if_set()
        lr = self.optimizer.param_groups[0]['lr']
        return None if lr is None else float(lr)

    @lr.setter
    def lr(self, value):
        self.check_if_set()
        if self.optimizer.param_groups[0]['lr'] is None:
            raise ValueError(
                f'{type(self).__name__}(lr=None) has no learning rate to '
                'set')
        for group in self.optimizer.param_groups:
            group['lr'] = float(value)

    def state_dict(self):
        """``{'state': {parameter name: {...}}, 'hyperparams': {...}}``,
        tensors as they are (a checkpoint stores them as arrays)."""
        self.check_if_set()
        group = self.optimizer.param_groups[0]
        state = {}
        for name, p in zip(self.names, self.parameters):
            if p in self.optimizer.state:
                state[name] = dict(self.optimizer.state[p])
        hyper = {k: (list(group[k]) if isinstance(group[k], tuple)
                     else group[k]) for k in self.optimizer_kwargs}
        return {'state': state, 'hyperparams': hyper}

    def load_state_dict(self, state_dict):
        self.check_if_set()
        unknown = set(state_dict['state']) - set(self.names)
        assert not unknown, f'optimizer state for unknown parameters {unknown}'
        self.optimizer.state.clear()
        for name, p in zip(self.names, self.parameters):
            if name not in state_dict['state']:
                continue
            self.optimizer.state[p] = {
                k: _restore(v, p.device)
                for k, v in state_dict['state'][name].items()}
        for group in self.optimizer.param_groups:
            for key, value in state_dict['hyperparams'].items():
                old = group[key]
                group[key] = tuple(value) if isinstance(old, tuple) else value

    def to(self, device):
        """Move the optimizer state (the parameters move with the model;
        ``step`` counters stay on the host, where torch keeps them)."""
        if self.optimizer is None:
            return self
        for state in self.optimizer.state.values():
            for key, value in state.items():
                if torch.is_tensor(value) and value.dim():
                    state[key] = value.to(device)
        return self


class Adam(Optimizer):
    optimizer_cls = torch.optim.Adam

    def __init__(
            self,
            gradient_clipping=1e10,
            lr=1e-3,
            betas=(0.9, 0.999),
            eps=1e-8,
            weight_decay=0,
            amsgrad=False,
    ):
        super().__init__(
            gradient_clipping, lr=lr, betas=tuple(betas), eps=eps,
            weight_decay=weight_decay, amsgrad=amsgrad)


class AdamW(Optimizer):
    optimizer_cls = torch.optim.AdamW

    def __init__(
            self,
            gradient_clipping=1e10,
            lr=1e-3,
            betas=(0.9, 0.999),
            eps=1e-8,
            weight_decay=1e-2,
            amsgrad=False,
    ):
        super().__init__(
            gradient_clipping, lr=lr, betas=tuple(betas), eps=eps,
            weight_decay=weight_decay, amsgrad=amsgrad)


class SGD(Optimizer):
    optimizer_cls = torch.optim.SGD

    def __init__(
            self,
            gradient_clipping=1e10,
            lr=1e-3,
            momentum=0,
            dampening=0,
            weight_decay=0,
            nesterov=False,
    ):
        assert dampening == 0, 'dampening is not supported'
        super().__init__(
            gradient_clipping, lr=lr, momentum=momentum,
            weight_decay=weight_decay, nesterov=nesterov)


# --------------------------------------------------------------------- #
# optax's chains, written out                                            #
# --------------------------------------------------------------------- #
def _f32(x):
    """A host number rounded to float32, as optax's hyperparameters are
    (a float32 value that torch takes as a scalar without rounding it
    again)."""
    return float(np.float32(x))


def _bias_correction(decay, count):
    """optax's ``1 - decay ** count``, in float32."""
    return _f32(np.float32(1) - np.float32(decay) ** np.float32(count))


def _ema_(moments, values, decay):
    """optax's ``update_moment``: ``(1 - decay) * value + decay * moment``
    in place, for lists of tensors."""
    scaled = torch._foreach_mul(values, 1 - decay)
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, scaled)


def _add_decay(updates, params, weight_decay):
    """optax's ``add_decayed_weights``: ``update + weight_decay * p``."""
    if weight_decay:
        torch._foreach_add_(updates, torch._foreach_mul(params, weight_decay))
    return updates


def _descend_(params, updates, lr):
    """optax's ``scale_by_learning_rate`` and ``apply_updates``:
    ``p + (-lr) * update``, the learning rate in float32."""
    torch._foreach_mul_(updates, -_f32(lr))
    torch._foreach_add_(params, updates)


def _with_grads(group, state, init):
    """The group's parameters that have a gradient, with their state
    (``init(p)`` fills an empty one)."""
    params = [p for p in group['params'] if p.grad is not None]
    for p in params:
        if not state[p]:
            state[p].update(init(p))
    return params, [p.grad for p in params]


class _Adadelta(torch.optim.Optimizer):
    """``optax.adadelta``: the decay added to the gradient first (coupled),
    then ``scale_by_adadelta``, then the learning rate."""

    def __init__(self, params, lr=1.0, rho=0.9, eps=1e-6, weight_decay=0):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params, grads = _with_grads(group, self.state, lambda p: dict(
                e_g=torch.zeros_like(p), e_x=torch.zeros_like(p)))
            if not params:
                continue
            rho, eps = group['rho'], group['eps']
            grads = _add_decay(list(grads), params, group['weight_decay'])
            e_g = [self.state[p]['e_g'] for p in params]
            e_x = [self.state[p]['e_x'] for p in params]
            _ema_(e_g, torch._foreach_mul(grads, grads), rho)
            updates = torch._foreach_div(
                torch._foreach_sqrt(torch._foreach_add(e_x, eps)),
                torch._foreach_sqrt(torch._foreach_add(e_g, eps)))
            torch._foreach_mul_(updates, grads)
            _ema_(e_x, torch._foreach_mul(updates, updates), rho)
            _descend_(params, updates, group['lr'])


class _Lion(torch.optim.Optimizer):
    """``optax.lion``: the sign of the interpolated momentum, then the
    decoupled decay, then the learning rate."""

    def __init__(self, params, lr=1e-4, betas=(0.9, 0.99), weight_decay=0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params, grads = _with_grads(group, self.state, lambda p: dict(
                mu=torch.zeros_like(p)))
            if not params:
                continue
            b1, b2 = group['betas']
            mu = [self.state[p]['mu'] for p in params]
            mixed = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mixed, torch._foreach_mul(mu, b1))
            updates = torch._foreach_sign(mixed)
            _ema_(mu, grads, b2)
            _add_decay(updates, params, group['weight_decay'])
            _descend_(params, updates, group['lr'])


def _factored_dims(shape, factored, min_dim_size_to_factor):
    """optax's rule: the second largest and the largest axis, or None."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _safe_rms(x, min_rms):
    """optax's ``safe_root_mean_squares`` (a tensor, no host read)."""
    rms = x.square().mean().sqrt()
    return torch.where(rms <= _f32(min_rms), _f32(min_rms), rms)


class _Adafactor(torch.optim.Optimizer):
    """``optax.adafactor``: ``scale_by_factored_rms`` (factored second
    moments over the two largest axes, decay ``1 - (t + 1) ** -decay_rate``
    from ``decay_offset``), the update clipped by its RMS, the learning
    rate (none for ``lr=None``), the parameter's RMS, the momentum, the
    decay, and the step down the gradient.  Not ``torch.optim.Adafactor``,
    which is another algorithm."""

    def __init__(self, params, lr=1e-3, min_dim_size_to_factor=128,
                 decay_rate=0.8, decay_offset=0,
                 multiply_by_parameter_scale=True, clipping_threshold=1.0,
                 momentum=None, weight_decay=0, eps=1e-30, factored=True):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            weight_decay=weight_decay, eps=eps, factored=factored))

    def _init(self, group, p):
        state = {'step': 0}
        dims = _factored_dims(tuple(p.shape), group['factored'],
                              group['min_dim_size_to_factor'])
        if dims is None:
            state['v'] = torch.zeros_like(p)
        else:
            d1, d0 = dims
            shape = list(p.shape)
            state['v_row'] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
            state['v_col'] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        if group['momentum'] is not None:
            state['ema'] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init(group, p))
                p.sub_(self._update(group, state, p, p.grad))

    def _update(self, group, state, p, g):
        step = int(state['step'])
        state['step'] = step + 1
        t = np.float32(step - group['decay_offset'] + 1)
        decay = np.float32(1) - t ** np.float32(-group['decay_rate'])
        keep, new = _f32(decay), _f32(np.float32(1) - decay)
        grad_sqr = g * g + _f32(group['eps'])
        if 'v' in state:
            v = state['v']
            v.copy_(keep * v + new * grad_sqr)
            update = g * v.pow(-0.5)
        else:
            d1, d0 = _factored_dims(tuple(p.shape), group['factored'],
                                    group['min_dim_size_to_factor'])
            v_row, v_col = state['v_row'], state['v_col']
            v_row.copy_(keep * v_row + new * grad_sqr.mean(dim=d0))
            v_col.copy_(keep * v_col + new * grad_sqr.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)
                          ).pow(-0.5)
            update = (g * row_factor.unsqueeze(d0)
                      * v_col.pow(-0.5).unsqueeze(d1))
        if group['clipping_threshold'] is not None:
            rms = update.square().mean().sqrt()
            update = update / torch.clamp(
                rms / _f32(group['clipping_threshold']), min=1.0)
        if group['lr'] is not None:
            update = _f32(group['lr']) * update
        if group['multiply_by_parameter_scale']:
            update = update * _safe_rms(p, 1e-3)
        if group['momentum'] is not None:
            ema = state['ema']
            m = group['momentum']
            ema.copy_((1 - m) * update + m * ema)
            update = ema
        if group['weight_decay']:
            update = update + group['weight_decay'] * p
        return update


_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def _newton_schulz(x, steps, eps):
    """optax's ``orthogonalize_via_newton_schulz`` of a matrix in the
    JAX layout (reduction axis first): transposed while it has more rows
    than columns, scaled to Frobenius norm 1, then quintic iterations."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.norm(x) + _f32(eps))
    c0, c1, c2 = _NS_COEFFS
    for _ in range(steps):
        a = x @ x.T
        b = c1 * a + (c2 * a) @ a
        x = c0 * x + b @ x
    return x.T if transposed else x


class _Muon(torch.optim.Optimizer):
    """``optax.contrib.muon``: every 2-D parameter on Muon (Nesterov
    momentum, Newton-Schulz, the shape factor, the decay, the learning
    rate), every other one on AdamW with Muon's ``eps`` and Nesterov
    flag.  ``reduction_axis`` maps a 2-D parameter to the axis its layer
    sums over (1 where it has none: torch's (out, in) layout)."""

    def __init__(self, params, lr=2e-2, beta=0.95, ns_steps=5,
                 nesterov=True, weight_decay=0, eps=1e-8,
                 adam_betas=(0.9, 0.999), adam_weight_decay=0):
        super().__init__(params, dict(
            lr=lr, beta=beta, ns_steps=ns_steps, nesterov=nesterov,
            weight_decay=weight_decay, eps=eps, adam_betas=tuple(adam_betas),
            adam_weight_decay=adam_weight_decay))
        self.reduction_axis = {}

    @staticmethod
    def _momentum(m, g, decay, step, nesterov):
        """optax's bias-corrected momentum, Nesterov's blend where asked."""
        if not nesterov:
            return m / _bias_correction(decay, step)
        return (decay * (m / _bias_correction(decay, step + 1))
                + (1 - decay) * (g / _bias_correction(decay, step)))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params, grads = _with_grads(group, self.state, lambda p: dict(
                step=0, mu=torch.zeros_like(p),
                **({} if p.dim() == 2 else {'nu': torch.zeros_like(p)})))
            if not params:
                continue
            step = int(self.state[params[0]]['step']) + 1
            for p in params:
                self.state[p]['step'] = step
            mu = [self.state[p]['mu'] for p in params]
            matrices = [i for i, p in enumerate(params) if p.dim() == 2]
            others = [i for i, p in enumerate(params) if p.dim() != 2]
            if matrices:
                self._muon(group, step, [params[i] for i in matrices],
                           [grads[i] for i in matrices],
                           [mu[i] for i in matrices])
            if others:
                self._adamw(group, step, [params[i] for i in others],
                            [grads[i] for i in others],
                            [mu[i] for i in others])

    def _muon(self, group, step, params, grads, mu):
        beta = group['beta']
        _ema_(mu, grads, beta)
        updates = []
        for p, g, m in zip(params, grads, mu):
            m_hat = self._momentum(m, g, beta, step, group['nesterov'])
            if self.reduction_axis.get(p, 1) == 1:
                orth = _newton_schulz(m_hat.T, group['ns_steps'],
                                      group['eps']).T
                factor = p.shape[0] / p.shape[1]   # n_out / n_in
            else:
                orth = _newton_schulz(m_hat, group['ns_steps'],
                                      group['eps'])
                factor = p.shape[1] / p.shape[0]
            updates.append(orth * _f32(np.sqrt(np.float32(max(1, factor)))))
        _add_decay(updates, params, group['weight_decay'])
        _descend_(params, updates, group['lr'])

    def _adamw(self, group, step, params, grads, mu):
        b1, b2 = group['adam_betas']
        nu = [self.state[p]['nu'] for p in params]
        _ema_(mu, grads, b1)
        _ema_(nu, torch._foreach_mul(grads, grads), b2)
        updates = []
        for g, m, v in zip(grads, mu, nu):
            m_hat = self._momentum(m, g, b1, step, group['nesterov'])
            v_hat = v / _bias_correction(b2, step)
            updates.append(m_hat / (v_hat.sqrt() + _f32(group['eps'])))
        _add_decay(updates, params, group['adam_weight_decay'])
        _descend_(params, updates, group['lr'])


class Adadelta(Optimizer):
    """``optax.adadelta`` with the JAX wrapper's defaults."""
    optimizer_cls = _Adadelta

    def __init__(
            self,
            gradient_clipping=1e10,
            lr=1.0,
            rho=0.9,
            eps=1e-6,
            weight_decay=0,
    ):
        super().__init__(gradient_clipping, lr=lr, rho=rho, eps=eps,
                         weight_decay=weight_decay)


class Adafactor(Optimizer):
    """Adafactor (Shazeer & Stern 2018) as ``optax.adafactor``: the second
    moment of a weight whose two largest axes have at least
    ``min_dim_size_to_factor`` entries is kept as a row and a column
    vector.  ``lr=None`` takes no learning rate: the step is the clipped,
    factored update times the parameter's RMS (``lr`` reads ``None``)."""
    optimizer_cls = _Adafactor

    def __init__(
            self,
            gradient_clipping=1e10,
            lr=1e-3,
            min_dim_size_to_factor=128,
            decay_rate=0.8,
            decay_offset=0,
            multiply_by_parameter_scale=True,
            clipping_threshold=1.0,
            momentum=None,
            weight_decay=0,
            eps=1e-30,
            factored=True,
    ):
        super().__init__(
            gradient_clipping, lr=lr,
            min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            weight_decay=weight_decay, eps=eps, factored=factored)


class Lion(Optimizer):
    """Sign momentum (Chen et al. 2023) as ``optax.lion``: one momentum
    buffer, decoupled decay added after the sign."""
    optimizer_cls = _Lion

    def __init__(
            self,
            gradient_clipping=1e10,
            lr=1e-4,
            betas=(0.9, 0.99),
            weight_decay=0,
    ):
        super().__init__(gradient_clipping, lr=lr, betas=tuple(betas),
                         weight_decay=weight_decay)


class Muon(Optimizer):
    """Momentum orthogonalized by Newton-Schulz (Jordan 2024) as
    ``optax.contrib.muon``: 2-D weights on Muon, the rest on AdamW.

    optax reads a 2-D weight as (reduction, output), the JAX package's
    ``Linear`` and recurrent layouts; the port's ``Linear`` and recurrent
    weights are their transposes, (output, reduction), so their shape
    factor ``sqrt(max(1, n_out / n_in))`` is taken with the axes swapped
    and the Newton-Schulz iteration sees the JAX layout's matrix.  An
    ``Embedding``'s (num, dim) table is the same in both, so where
    :meth:`set_parameters` is given the module, its tables keep axis 0 as
    the reduction.  The products are float32 (the package turns TF32 off).
    """
    optimizer_cls = _Muon

    def __init__(
            self,
            gradient_clipping=1e10,
            lr=2e-2,
            beta=0.95,
            ns_steps=5,
            nesterov=True,
            weight_decay=0,
            eps=1e-8,
            adam_betas=(0.9, 0.999),
            adam_weight_decay=0,
    ):
        super().__init__(
            gradient_clipping, lr=lr, beta=beta, ns_steps=ns_steps,
            nesterov=nesterov, weight_decay=weight_decay, eps=eps,
            adam_betas=tuple(adam_betas),
            adam_weight_decay=adam_weight_decay)

    def set_parameters(self, named_parameters, module=None):
        super().set_parameters(named_parameters)
        if module is not None:
            tables = {id(m.weight) for m in module.modules()
                      if isinstance(m, torch.nn.Embedding)}
            self.optimizer.reduction_axis = {
                p: 0 for p in self.parameters if id(p) in tables}
        return self
