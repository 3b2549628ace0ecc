"""Carry the weights of a JAX model over to its port.

The JAX package's ``state_dict()`` names arrays by their pytree path and
keeps its own layouts; the port keeps torch's.  Per layer type (JAX ->
port):

- ``LSTM``: ``w_ih.{i}`` (in, 4H) -> ``weight_ih_l{k}[_reverse]`` (4H, in)
  and ``w_hh.{i}`` (H, 4H) -> ``weight_hh_l{k}[_reverse]`` (4H, H),
  transposed, with i = num_directions * k + direction; the fused bias
  ``b.{i}`` goes to ``bias_ih`` and ``bias_hh`` is zero (the cell only
  uses their sum);
- ``Linear``: ``weight`` (in, out) -> (out, in), transposed; ``bias``
  copied.

The other way, ``padertorch_tpu.migrate.import_torch_state_dict`` maps the
port's ``state_dict`` onto the JAX model unchanged.
"""
import numpy as np
import torch

from padertorch_tpu_torch.modules.recurrent import LSTM

__all__ = ['from_jax_state_dict']


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
