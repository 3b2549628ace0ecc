"""Carry the weights of a JAX model over to its port, and back.

The JAX package's ``state_dict()`` names arrays by their pytree path and
keeps its own layouts; the port keeps torch's.  Per layer type (JAX ->
port):

- ``LSTM``: ``w_ih.{i}`` (in, 4H) -> ``weight_ih_l{k}[_reverse]`` (4H, in)
  and ``w_hh.{i}`` (H, 4H) -> ``weight_hh_l{k}[_reverse]`` (4H, H),
  transposed, with i = num_directions * k + direction; the fused bias
  ``b.{i}`` goes to ``bias_ih`` and ``bias_hh`` is zero (the cell only
  uses their sum); the other way, ``b.{i} = bias_ih + bias_hh``;
- ``Linear``: ``weight`` (in, out) -> (out, in), transposed; ``bias``
  copied.

:func:`to_jax_state_dict` is the inverse of :func:`from_jax_state_dict`:
the port's trainer writes its checkpoints' ``model`` entry with it, so
one storage dir loads in both packages.  (``padertorch_tpu.migrate
.import_torch_state_dict`` also maps the port's ``state_dict()`` onto the
JAX model.)
"""
import numpy as np
import torch

from padertorch_tpu_torch.modules.recurrent import LSTM

__all__ = ['from_jax_state_dict', 'to_jax_state_dict']


def _jax_to_port(model):
    """{jax name: (port parameter, converter)} for every parameter."""
    pairs = {}
    for name, mod in model.named_modules():
        dot = f'{name}.' if name else ''
        if isinstance(mod, LSTM):
            for layer in range(mod.num_layers):
                for d, suffix in enumerate(mod._suffixes()):
                    i = layer * mod.num_directions + d
                    p = {n: getattr(mod, f'{n}_l{layer}{suffix}') for n in
                         ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}
                    pairs[f'{dot}w_ih.{i}'] = [(p['weight_ih'], np.transpose)]
                    pairs[f'{dot}w_hh.{i}'] = [(p['weight_hh'], np.transpose)]
                    pairs[f'{dot}b.{i}'] = [(p['bias_ih'], np.asarray),
                                            (p['bias_hh'], np.zeros_like)]
        elif isinstance(mod, torch.nn.Linear):
            pairs[f'{dot}weight'] = [(mod.weight, np.transpose)]
            if mod.bias is not None:
                pairs[f'{dot}bias'] = [(mod.bias, np.asarray)]
    covered = {id(p) for targets in pairs.values() for p, _ in targets}
    missed = [n for n, p in model.named_parameters() if id(p) not in covered]
    if missed:
        raise NotImplementedError(
            f'no JAX layout known for the parameters {missed}: only LSTM '
            'and Linear layers move between the packages yet')
    return pairs


def from_jax_state_dict(model, sd):
    """Fill ``model``'s parameters from a JAX model's ``state_dict()``
    (``{dotted name: numpy array}``); returns ``model``.

    Raises ``KeyError`` if a JAX array has no target or a parameter of
    ``model`` gets no value, and ``ValueError`` on a shape mismatch.
    """
    pairs = _jax_to_port(model)
    unexpected = sorted(set(sd) - set(pairs))
    missing = sorted(set(pairs) - set(sd))
    if unexpected or missing:
        raise KeyError(f'from_jax_state_dict: JAX arrays without a target '
                       f'{unexpected}, parameters without a value {missing}')
    with torch.no_grad():
        for name, targets in pairs.items():
            for param, convert in targets:
                value = np.asarray(convert(np.asarray(sd[name])))
                if tuple(value.shape) != tuple(param.shape):
                    raise ValueError(
                        f'{name}: {tuple(value.shape)} does not fit '
                        f'{tuple(param.shape)}')
                param.copy_(torch.tensor(value, dtype=torch.float32))
    return model


def to_jax_state_dict(model):
    """``model``'s parameters in the JAX model's ``state_dict()`` layout
    (``{dotted name: numpy array}``): the inverse of
    :func:`from_jax_state_dict`.  Where several parameters share one JAX
    array (the LSTM's two biases), their sum is written."""
    sd = {}
    for name, targets in _jax_to_port(model).items():
        params = [param.detach().cpu().numpy() for param, _ in targets]
        convert = targets[0][1]  # transposes are their own inverse
        sd[name] = np.ascontiguousarray(convert(sum(params[1:], params[0])))
    return sd
