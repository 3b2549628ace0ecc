"""Primitive layers: ``torch.nn``'s own.

Counterpart of ``padertorch_tpu/nn.py``.  The port uses torch's layers
and their parameter layouts, e.g. ``Linear.weight`` is (out, in) where the
JAX package stores (in, out); ``migrate.from_jax_state_dict`` moves
weights between the two.
"""
from torch.nn import (  # noqa: F401
    Dropout, ELU, GELU, GLU, Identity, LeakyReLU, Linear, Module, PReLU,
    ReLU, Sigmoid, SiLU, Softmax, Tanh,
)

__all__ = ['Linear', 'Dropout', 'ReLU', 'LeakyReLU', 'ELU', 'GELU',
           'Sigmoid', 'Tanh', 'Softmax', 'PReLU', 'GLU', 'SiLU', 'Identity']
