"""Primitive layers: ``torch.nn``'s own.

Counterpart of ``padertorch_tpu/nn.py``.  The port uses torch's layers
and their parameter layouts, e.g. ``Linear.weight`` is (out, in) where the
JAX package stores (in, out), and ``ConvTranspose1d.weight`` is
(in, out, k) where the JAX package stores (out, in, k);
``migrate.from_jax_state_dict`` moves weights between the two.
"""
from torch.nn import (  # noqa: F401
    Conv1d, ConvTranspose1d, Dropout, ELU, GELU, GLU, Identity, LayerNorm,
    LeakyReLU, Linear, Module, PReLU, ReLU, Sigmoid, SiLU, Softmax, Tanh,
)

__all__ = ['Linear', 'Conv1d', 'ConvTranspose1d', 'LayerNorm', 'Dropout',
           'ReLU', 'LeakyReLU', 'ELU', 'GELU', 'Sigmoid', 'Tanh', 'Softmax',
           'PReLU', 'GLU', 'SiLU', 'Identity']
