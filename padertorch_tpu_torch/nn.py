"""Primitive layers: ``torch.nn``'s own, and where the JAX package rounds
otherwise, subclasses of them.

Counterpart of ``padertorch_tpu/nn.py``.  The port uses torch's layers
and their parameter layouts, e.g. ``Linear.weight`` is (out, in) where the
JAX package stores (in, out), and ``ConvTranspose1d.weight`` is
(in, out, k) where the JAX package stores (out, in, k);
``migrate.from_jax_state_dict`` moves weights between the two.

Rounding in bf16 (or any type but float32).  The JAX layers compute in the
input's type one operation at a time: ``Linear`` and the convolutions
round the product, then add the bias and round again; ``LayerNorm`` rounds
the mean, the variance, the centred input, the normalized value, the
scaled one and the shifted one.  torch's fused layers round once.  So
:class:`Linear`, :class:`Conv1d`, :class:`Conv2d`, :class:`ConvTranspose1d`
and :class:`LayerNorm` keep torch's parameters and its fused call for a
float32 input, bit for bit, and otherwise take the JAX package's steps.
"""
import torch
import torch.nn.functional as F
from torch.nn import (  # noqa: F401
    Dropout, ELU, Embedding, GELU, GLU, Identity, LeakyReLU, Module, ReLU,
    Sequential, Sigmoid, SiLU, Softmax, Tanh,
)

__all__ = ['Linear', 'Embedding', 'Sequential', 'Conv1d', 'Conv2d',
           'ConvTranspose1d', 'LayerNorm', 'RMSNorm', 'Dropout', 'ReLU',
           'LeakyReLU', 'ELU', 'GELU', 'Sigmoid', 'Tanh', 'Softmax', 'PReLU',
           'GLU', 'SiLU', 'Identity', 'Float32Buffers']


def _fused(x, bias):
    """Whether torch's fused call computes what the JAX layer does: no
    bias to add after the product, or a float32 input."""
    return bias is None or x.dtype == torch.float32


def _add_bias(y, bias):
    """``y`` (B, C, ...) plus a bias per channel, in ``y``'s type."""
    return y + bias.reshape((-1,) + (1,) * (y.dim() - 2))


class Linear(torch.nn.Linear):
    """``torch.nn.Linear``; outside float32 the product is rounded before
    the bias is added, as ``padertorch_tpu/nn.py`` ``Linear`` does.

    >>> layer = Linear(3, 2).to(torch.bfloat16)
    >>> x = torch.randn(4, 3).bfloat16()
    >>> torch.equal(layer(x), x @ layer.weight.t() + layer.bias)
    True
    """

    def forward(self, x):
        if _fused(x, self.bias):
            return super().forward(x)
        return F.linear(x, self.weight) + self.bias


class Conv1d(torch.nn.Conv1d):
    """``torch.nn.Conv1d``; outside float32 the bias is added after the
    rounded convolution (``padertorch_tpu/nn.py`` ``_Conv``)."""

    def forward(self, x):
        if _fused(x, self.bias):
            return super().forward(x)
        return _add_bias(self._conv_forward(x, self.weight, None), self.bias)


class Conv2d(torch.nn.Conv2d):
    """``torch.nn.Conv2d``; outside float32 the bias is added after the
    rounded convolution (``padertorch_tpu/nn.py`` ``_Conv``)."""

    def forward(self, x):
        if _fused(x, self.bias):
            return super().forward(x)
        return _add_bias(self._conv_forward(x, self.weight, None), self.bias)


class ConvTranspose1d(torch.nn.ConvTranspose1d):
    """``torch.nn.ConvTranspose1d``; outside float32 the bias is added
    after the rounded transposed convolution (``padertorch_tpu/nn.py``
    ``_ConvTranspose``)."""

    def forward(self, x, output_size=None):
        if _fused(x, self.bias):
            return super().forward(x, output_size)
        output_padding = self._output_padding(
            x, output_size, self.stride, self.padding, self.kernel_size, 1,
            self.dilation)
        y = F.conv_transpose1d(x, self.weight, None, self.stride,
                               self.padding, output_padding, self.groups,
                               self.dilation)
        return _add_bias(y, self.bias)


class PReLU(torch.nn.PReLU):
    """``torch.nn.PReLU``'s parameter with the function of
    ``padertorch_tpu/nn.py`` ``PReLU``: ``where(x >= 0, x, a * x)``, whose
    derivative at x = 0 is 1 where torch's is ``a``; a weight of more than
    one value scales axis 1.

    >>> x = torch.zeros(3, requires_grad=True)
    >>> PReLU()(x).sum().backward()
    >>> x.grad.tolist()
    [1.0, 1.0, 1.0]
    """

    def forward(self, x):
        a = self.weight
        if a.shape[0] != 1 and x.dim() >= 2:
            a = a.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, a * x)


class LayerNorm(torch.nn.LayerNorm):
    """``torch.nn.LayerNorm``; outside float32 the steps of
    ``padertorch_tpu/nn.py`` ``LayerNorm`` in the input's type: the mean
    and the variance summed in float32 and rounded (``jnp.mean``,
    ``jnp.var``), then ``(x - mean) * rsqrt(var + eps)``, the scale and the
    shift, each rounded."""

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        dims = tuple(range(x.dim() - len(self.normalized_shape), x.dim()))
        wide = x.float()
        mean = wide.mean(dim=dims, keepdim=True)
        var = (wide - mean).square().mean(dim=dims, keepdim=True)
        # torch's bf16 rsqrt on the CPU can be a unit off the rounded
        # float32 one, which XLA computes
        inv = torch.rsqrt((var.to(x.dtype) + self.eps).float()).to(x.dtype)
        y = (x - mean.to(x.dtype)) * inv
        if self.weight is not None:
            y = y * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y


class Float32Buffers(Module):
    """A module whose buffers named in ``float32_buffers`` stay float32
    when the module is cast: ``module.to(torch.bfloat16)`` casts every
    floating parameter and buffer, these only move between devices.  The
    JAX package casts a model's trainable arrays and leaves its buffers
    (RoPE frequencies, int8 scales) as they are.

    >>> class Scaled(Float32Buffers):
    ...     float32_buffers = ('scale',)
    ...     def __init__(self):
    ...         super().__init__()
    ...         self.register_buffer('scale', torch.ones(2))
    >>> Scaled().to(torch.bfloat16).scale.dtype
    torch.float32
    """

    float32_buffers = ()

    def _apply(self, fn, recurse=True):
        kept = {name: self._buffers[name] for name in self.float32_buffers
                if self._buffers.get(name) is not None}
        super()._apply(fn, recurse)
        for name, buf in kept.items():
            self._buffers[name] = buf.to(self._buffers[name].device)
        return self


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
