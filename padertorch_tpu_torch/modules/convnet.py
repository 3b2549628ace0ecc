"""Conv-TasNet temporal convolutional network (TCN).

Counterpart of ``padertorch_tpu/modules/convnet.py`` (reference
``padertorch/modules/convnet.py``: dilated depthwise 1-D conv blocks with
residual connections, gLN/cLN norms, PReLU).  TasNet:
https://arxiv.org/abs/1809.07454.

The convolutions are ``torch.nn.functional.conv1d`` (cuDNN on the card;
the JAX package's are ``lax.conv_general_dilated``, outside any Pallas
kernel).  The reference's quirks are kept, so that its weights compute the
same here:

- each ``Conv1d`` wrapper runs its norm *before* its convolution;
- ``ConvNet.forward`` drops ``sequence_lengths``, so gLN's statistics
  include the padding of a batch;
- the padding is ``total // 2`` in front and ``ceil(total / 2)`` at the
  end, an explicit ``F.pad`` (torch's ``padding='same'`` does not promise
  that split);
- the norms use the population variance and ``rsqrt(var + 1e-8)``, and
  ``PReLU`` is ``where(x >= 0, x, a * x)`` (``padertorch_tpu_torch.nn``).

Outside float32 the norms take the JAX steps (``nn.py``, "Rounding in
bf16"): the mean and the variance summed in float32 and rounded, then
``gamma * (x - mean) * rsqrt(var + eps) + beta`` one rounded operation at
a time.
"""
import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP

__all__ = ['ConvNet', 'GlobalLayerNorm', 'ChannelwiseLayerNorm',
           'build_norm', 'Conv1d']


def _normalize(x, dims, gamma, beta, eps):
    """``gamma * (x - mean) * rsqrt(var + eps) + beta`` over ``dims``, in
    the JAX package's order and roundings."""
    if x.dtype == torch.float32:
        mean = torch.mean(x, dim=dims, keepdim=True)
        var = torch.var(x, dim=dims, unbiased=False, keepdim=True)
        return gamma * (x - mean) * torch.rsqrt(var + eps) + beta
    wide = x.float()
    mean = wide.mean(dim=dims, keepdim=True)
    var = (wide - mean).square().mean(dim=dims, keepdim=True).to(x.dtype)
    # torch's bf16 rsqrt on the CPU can be a unit off the rounded float32
    # one, which XLA computes
    inv = torch.rsqrt((var + eps).float()).to(x.dtype)
    return gamma * (x - mean.to(x.dtype)) * inv + beta


class GlobalLayerNorm(nn.Module):
    """gLN: normalize over (C, T) per sample; per-channel affine."""

    def __init__(self, num_channels, eps=1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = torch.nn.Parameter(torch.ones(1, num_channels, 1))
        self.beta = torch.nn.Parameter(torch.zeros(1, num_channels, 1))

    def forward(self, x):  # (B, C, T)
        return _normalize(x, (1, 2), self.gamma, self.beta, self.eps)


class ChannelwiseLayerNorm(nn.Module):
    """cLN: normalize over C per (sample, frame); per-channel affine."""

    def __init__(self, num_channels, eps=1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = torch.nn.Parameter(torch.ones(1, num_channels, 1))
        self.beta = torch.nn.Parameter(torch.zeros(1, num_channels, 1))

    def forward(self, x):  # (B, C, T)
        return _normalize(x, (1,), self.gamma, self.beta, self.eps)


def build_norm(norm, num_channels):
    """'gLN' | 'cLN' | None -> norm module (reference: jensheit/norm.py)."""
    if norm is None:
        return None
    if norm == 'gLN':
        return GlobalLayerNorm(num_channels)
    if norm == 'cLN':
        return ChannelwiseLayerNorm(num_channels)
    raise ValueError(f'Unknown norm: {norm!r}')


def compute_pad_size(kernel_size, dilation, stride, pad_type):
    """Front/end padding sizes (reference: contrib/je/modules/conv.py).

    >>> compute_pad_size(3, 2, 1, 'both'), compute_pad_size(4, 1, 1, 'both')
    ((2, 2), (1, 2))
    """
    if pad_type is None:
        return 0, 0
    total = dilation * (kernel_size - 1)
    if pad_type == 'both':
        return total // 2, -(-total // 2)
    if pad_type == 'front':
        return total, 0
    if pad_type == 'end':
        return 0, total
    raise ValueError(f'Unknown pad_type: {pad_type!r}')


class Conv1d(nn.Module):
    """Conv1d with dropout/norm/pad/activation (reference convnet.py:17):
    dropout, then the norm, then the padding, the convolution and the
    activation."""

    def __init__(self, in_channels, out_channels, kernel_size, dropout=0.0,
                 pad_type='both', groups=1, dilation=1, stride=1, bias=True,
                 norm=None, activation_fn='relu'):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.pad_type = pad_type
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.stride = stride
        self.activation_fn = ACTIVATION_FN_MAP[activation_fn]()
        if norm is not None:
            assert callable(norm), norm
        self.norm = norm
        self.conv = nn.Conv1d(
            in_channels, out_channels, kernel_size=kernel_size,
            dilation=dilation, stride=stride, bias=bias, groups=groups)

    def forward(self, x):  # (B, C, T)
        if self.dropout is not None:
            x = self.dropout(x)
        if self.norm is not None:
            x = self.norm(x)
        front, end = compute_pad_size(
            self.kernel_size, self.dilation, self.stride, self.pad_type)
        if front or end:
            x = F.pad(x, (front, end))
        return self.activation_fn(self.conv(x))


class _Conv1DBlock(nn.Module):
    """TCN block with a residual connection (reference convnet.py:114):
    Norm(in) - Conv1D - PReLU - depthwise Conv1D - PReLU - Norm - Conv1D,
    the reference's implemented order (its docstring describes the
    canonical Conv-PReLU-Norm order; its ``Conv1d`` wrapper norms
    first)."""

    def __init__(self, in_channels=256, hidden_channels=512, kernel_size=3,
                 dilation=1, norm='cLN'):
        super().__init__()
        self.input_conv = Conv1d(
            in_channels, hidden_channels, 1, pad_type=None,
            norm=build_norm(norm, in_channels), activation_fn='prelu')
        self.conv = Conv1d(
            hidden_channels, hidden_channels, kernel_size,
            groups=hidden_channels, activation_fn='prelu',
            pad_type='both', dilation=dilation)
        self.output_conv = Conv1d(
            hidden_channels, in_channels, 1,
            norm=build_norm(norm, hidden_channels),
            activation_fn='identity')

    def forward(self, x):
        y = self.input_conv(x)
        y = self.conv(y)
        y = self.output_conv(y)
        return x + y


class ConvNet(nn.Module):
    """TasNet convolutional separator (reference convnet.py:164).

    >>> module = ConvNet(input_size=64, num_blocks=2, num_repeats=2,
    ...                  hidden_channels=32)
    >>> module(torch.ones((4, 23, 64)), None).shape
    torch.Size([4, 23, 64])
    """

    def __init__(self, input_size=256, num_blocks=8, num_repeats=4,
                 hidden_channels=512, kernel_size=3, norm='gLN'):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = input_size
        self.conv_blocks = nn.Sequential(*[
            nn.Sequential(*[
                _Conv1DBlock(
                    in_channels=input_size,
                    hidden_channels=hidden_channels,
                    kernel_size=kernel_size,
                    norm=norm,
                    dilation=2 ** b,
                )
                for b in range(num_blocks)
            ])
            for _ in range(num_repeats)
        ])

    def forward(self, sequence, sequence_lengths=None):
        """(B, L, N) -> (B, L, N); ``sequence_lengths`` is dropped, as the
        reference drops it (gLN over the padding)."""
        del sequence_lengths
        y = self.conv_blocks(sequence.transpose(1, 2))  # b l n -> b n l
        return y.transpose(1, 2)
