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

Adafactor, Muon, Lion and Adadelta of the JAX package are not ported yet.
"""
import torch

from padertorch_tpu_torch.configurable import Configurable

__all__ = ['Optimizer', 'Adam', 'AdamW', 'SGD']


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

    def set_parameters(self, named_parameters):
        """``named_parameters``: ``module.named_parameters()`` (or any
        iterable of (name, parameter)); those that do not require a
        gradient are left out."""
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
        self.check_if_set()
        return float(self.optimizer.param_groups[0]['lr'])

    @lr.setter
    def lr(self, value):
        self.check_if_set()
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
