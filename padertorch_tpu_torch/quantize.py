"""Weight-only int8 quantization for serving.

Counterpart of ``padertorch_tpu/quantize.py``.  Decoding re-reads every
weight at every step, so storing the weights as int8 with one float32
scale per output column (symmetric, no zero point) cuts the bytes a step
reads fourfold against float32 and twofold against bf16.  Eval and export
only: int8 weights carry no gradient; quantize a trained model right before
serving it.

A :class:`QuantizedLinear` runs one of two routes: the composed route
dequantizes the weight in the activations' type and multiplies
(``x @ (w_q * scale)``, as the JAX package's XLA path), the kernel route
(``ops/kernels/int8_matmul.py``) reads the int8 weight itself and scales the
float32 sum.  The two round differently in bf16 by design.

Not ported: the JAX package pads ``weight_q`` to 128-lane tiles at
quantization time for the TPU kernel; the port keeps the logical
(in_features, out_features) layout, and ``migrate.from_jax_state_dict``
cuts a padded JAX weight back to it.

>>> _ = torch.manual_seed(0)
>>> head = torch.nn.Sequential(torch.nn.Linear(64, 32)).eval()
>>> x = torch.randn(4, 64)
>>> want = head(x)
>>> quantize_module(head)
1
>>> got = head(x)
>>> bool((got - want).abs().max() < want.abs().max() * 0.02)
True
"""
import torch

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.module import swap_submodules
from padertorch_tpu_torch.ops.kernels.int8_matmul import (
    INT8_KERNEL_MAX_ROWS, composed, int8_matmul, int8_matmul_plain,
    matmul_rows)

__all__ = ['QuantizedLinear', 'quantize_module', 'quantization_error',
           'kernel_route']


def kernel_route(device, rows):
    """Whether ``QuantizedLinear(use_kernel=None)`` takes the int8 kernel
    for ``rows`` rows of x on ``device``: on a CUDA card up to
    ``INT8_KERNEL_MAX_ROWS`` rows (where the kernel's device time is at
    most the composed route's), the composed route above and on the CPU
    (as the JAX package's ``None``).  ``QuantizedLinear`` applies the
    rows' part inside the ``ptt::int8_matmul`` operator, where the rows are
    concrete (an exported graph keeps them symbolic); above the limit the
    operator casts the composed route's result to x's type.

    >>> [kernel_route(torch.device('cpu'), 1),
    ...  kernel_route(torch.device('cuda'), 1)]
    [False, True]
    """
    return device.type == 'cuda' and rows <= INT8_KERNEL_MAX_ROWS


class QuantizedLinear(nn.Float32Buffers):
    """Drop-in serving replacement for :class:`torch.nn.Linear`.

    Buffers: ``weight_q`` (in_features, out_features) int8, ``scale``
    (out_features,) float32 (``w ~ w_q * scale``; it stays float32 when the
    module is cast to bf16) and ``bias`` (out_features,) or None.

    ``use_kernel`` (a class attribute, set per instance to override):
    ``True`` takes the kernel route (the hand-written kernel on a CUDA
    tensor, its plain version on a CPU tensor), ``False`` the composed
    route, ``None`` (the default) what :func:`kernel_route` picks from the
    device and the rows of x (the kernel on a CUDA tensor of at most
    ``INT8_KERNEL_MAX_ROWS`` rows, the composed route otherwise), and
    ``'interpret'`` the kernel's plain version (the JAX package's interpret
    mode).
    """

    use_kernel = None
    float32_buffers = ('scale',)

    def __init__(self, weight_q, scale, bias=None):
        super().__init__()
        if weight_q.dtype != torch.int8 or weight_q.dim() != 2:
            raise ValueError(f'weight_q must be a 2-d int8 tensor, got '
                             f'{weight_q.dtype} {tuple(weight_q.shape)}')
        self.register_buffer('weight_q', weight_q)
        self.register_buffer('scale', scale.to(torch.float32))
        self.register_buffer('bias', bias)

    @property
    def in_features(self):
        return self.weight_q.shape[0]

    @property
    def out_features(self):
        return self.weight_q.shape[1]

    @classmethod
    def from_linear(cls, linear):
        """Quantize a ``torch.nn.Linear`` in its weight's own type (a bf16
        layer gets bf16 amax and scale before the float32 cast), as the
        JAX package's ``from_linear`` does: equal ``weight_q`` and ``scale``
        bits for equal weights."""
        with torch.no_grad():
            w = linear.weight.detach().t()            # (in, out)
            amax = w.abs().amax(dim=0)                # per output column
            scale = amax.clamp(min=1e-12) / 127.0
            w_q = torch.clamp(torch.round(w / scale), -127, 127).to(
                torch.int8).contiguous()
            bias = (None if linear.bias is None
                    else linear.bias.detach().clone())
        return cls(w_q, scale.to(torch.float32), bias)

    def _route(self, x):
        mode = self.use_kernel
        if mode is None:
            return kernel_route(x.device, x.numel() // max(x.shape[-1], 1))
        return mode

    def forward(self, x):
        if self.use_kernel is None and x.device.type == 'cuda':
            # the rows decide inside the operator, where they are
            # concrete (an export keeps them symbolic)
            return matmul_rows(x, self.weight_q, self.scale, self.bias,
                               max_kernel_rows=INT8_KERNEL_MAX_ROWS)
        route = self._route(x)
        if route == 'interpret':
            return int8_matmul_plain(x, self.weight_q, self.scale, self.bias)
        if route:
            return int8_matmul(x, self.weight_q, self.scale, self.bias)
        return composed(x, self.weight_q, self.scale, self.bias)

    def extra_repr(self):
        return (f'in_features={self.in_features}, '
                f'out_features={self.out_features}, int8')


def quantize_module(module, min_params=256):
    """Swap every ``torch.nn.Linear`` under ``module`` (in place) for a
    :class:`QuantizedLinear`; returns how many were swapped.  Layers with
    fewer than ``min_params`` weights are kept (their scales and bias
    outweigh the saving, and small heads are sensitive to rounding)."""
    return swap_submodules(
        module,
        lambda item, name: (type(item) in (nn.Linear, torch.nn.Linear)
                            and item.weight.numel() >= min_params),
        QuantizedLinear.from_linear)


def _first_tensor(out):
    """The first array leaf in the JAX package's tree order (dict keys
    sorted)."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        return _first_tensor(out[sorted(out)[0]])
    return _first_tensor(out[0])


def quantization_error(module, quantized, example):
    """Largest output difference of ``quantized`` from ``module`` on an
    example input, relative to the largest output: a number to check
    before export."""
    with torch.no_grad():
        a = _first_tensor(module(example)).float()
        b = _first_tensor(quantized(example)).float()
    return float((a - b).abs().max() / (a.abs().max() + 1e-12))
