"""Primitive layers: ``torch.nn``'s own.

Counterpart of ``padertorch_tpu/nn.py``.  The port uses torch's layers
and their parameter layouts, e.g. ``Linear.weight`` is (out, in) where the
JAX package stores (in, out), and ``ConvTranspose1d.weight`` is
(in, out, k) where the JAX package stores (out, in, k);
``migrate.from_jax_state_dict`` moves weights between the two.
"""
import torch
from torch.nn import (  # noqa: F401
    Conv1d, Conv2d, ConvTranspose1d, Dropout, ELU, Embedding, GELU, GLU,
    Identity, LayerNorm, LeakyReLU, Linear, Module, PReLU, ReLU, Sequential,
    Sigmoid, SiLU, Softmax, Tanh,
)

__all__ = ['Linear', 'Embedding', 'Sequential', 'Conv1d', 'Conv2d',
           'ConvTranspose1d', 'LayerNorm', 'RMSNorm', 'Dropout', 'ReLU',
           'LeakyReLU', 'ELU', 'GELU', 'Sigmoid', 'Tanh', 'Softmax', 'PReLU',
           'GLU', 'SiLU', 'Identity']


class RMSNorm(Module):
    """Root-mean-square norm (Zhang & Sennrich 2019): no mean subtraction,
    learnable scale, no bias.  Counterpart of ``padertorch_tpu/nn.py``
    ``RMSNorm``, whose ``eps`` is 1e-6 (``torch.nn.RMSNorm`` defaults to the
    type's machine epsilon), so this is a class of the port's own.

    >>> y = RMSNorm(4)(torch.tensor([[1.0, -1.0, 1.0, -1.0]]))
    >>> [round(float(x), 4) for x in y[0]]
    [1.0, -1.0, 1.0, -1.0]
    """

    def __init__(self, normalized_shape, eps=1e-6, elementwise_affine=True):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        if elementwise_affine:
            self.weight = torch.nn.Parameter(
                torch.ones(self.normalized_shape))
        else:
            self.register_parameter('weight', None)

    def forward(self, x):
        dims = tuple(range(x.dim() - len(self.normalized_shape), x.dim()))
        ms = torch.mean(torch.square(x), dim=dims, keepdim=True)
        y = x * torch.rsqrt(ms + self.eps)
        if self.weight is not None:
            y = y * self.weight
        return y

    def extra_repr(self):
        return f'{self.normalized_shape}, eps={self.eps}'
