"""Conformer encoder (Gulati et al., Interspeech 2020).

Counterpart of ``padertorch_tpu/modules/conformer.py``: the macaron
feed-forward sandwich, multi-head self-attention with rotary positions and
a gated depthwise convolution module, built from the port's primitives:

- attention is :class:`padertorch_tpu_torch.contrib.mk.modules.transformer
  .MultiheadAttention` (RoPE; on the card at float32 heads up to 128 it
  runs the hand-written flash attention kernels, with key padding, causal
  and sliding-window masks);
- the convolution module's norm is the sequence-masked
  :class:`padertorch_tpu_torch.modules.normalization.Normalization`
  (masked batch norm: statistics of the valid frames only, running
  statistics updated in training) or a LayerNorm;
- padded frames are zeroed before the depthwise conv, so padding never
  leaks into valid frames and the outputs are padding-invariant.

Layout is (B, T, C) throughout.  The carried-state streaming methods
(``init_stream_state`` and ``stream_step``) hold the attention's KV cache
and the depthwise conv's left context; a causal encoder fed chunk by chunk
equals its one-shot forward.
"""
import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    MultiheadAttention)
from padertorch_tpu_torch.modules.normalization import Normalization
from padertorch_tpu_torch.ops.sequence.mask import compute_mask

__all__ = ['ConformerBlock', 'ConformerConvModule', 'ConformerEncoder']


class _HalfStepFFN(nn.Module):
    """Macaron feed-forward: pre-LN -> expand -> SiLU -> project, added
    with weight 1/2 by the block (Gulati et al. eq. 1/4)."""

    def __init__(self, d_model, d_ff, dropout=0.0):
        super().__init__()
        self.norm = nn.LayerNorm((d_model,))
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        h = F.silu(self.linear1(self.norm(x)))
        if self.dropout is not None:
            h = self.dropout(h)
        h = self.linear2(h)
        if self.dropout is not None:
            h = self.dropout(h)
        return h


class ConformerConvModule(nn.Module):
    """Pre-LN -> pointwise (2x, GLU) -> depthwise -> norm -> SiLU ->
    pointwise -> dropout (Gulati et al. Fig. 2).

    ``norm='batch_norm'`` is the sequence-masked batch normalization
    (statistics over batch and time of the valid frames only);
    ``'layer_norm'`` the mask-free alternative.  ``causal=True`` left-pads
    the depthwise conv (streaming encoders).
    """

    def __init__(self, d_model, kernel_size=31, norm='batch_norm',
                 dropout=0.0, causal=False):
        super().__init__()
        assert kernel_size % 2 == 1 or causal, kernel_size
        self.d_model = d_model
        self.norm_in = nn.LayerNorm((d_model,))
        self.pointwise1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise = nn.Conv1d(
            d_model, d_model, kernel_size, groups=d_model, padding=0)
        self.kernel_size = kernel_size
        self.causal = causal
        if norm == 'batch_norm':
            self.norm_conv = Normalization(
                data_format='bct', shape=(None, d_model, None),
                statistics_axis='bt', independent_axis='c')
        elif norm == 'layer_norm':
            # channel LayerNorm applied in (B, T, C)
            self.norm_conv = nn.LayerNorm((d_model,))
        else:
            raise ValueError(f'Unknown conv norm: {norm!r}')
        self.norm_kind = norm
        self.pointwise2 = nn.Conv1d(d_model, d_model, 1)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def _glu(self, x):
        h = self.pointwise1(self.norm_in(x).transpose(1, 2))  # (B, 2C, T)
        a, b = h.chunk(2, dim=1)
        return a * torch.sigmoid(b)

    def _after_depthwise(self, h, seq_len):
        if self.norm_kind == 'batch_norm':
            h = self.norm_conv(h, sequence_lengths=seq_len)
        else:
            h = self.norm_conv(h.transpose(1, 2)).transpose(1, 2)
        h = self.pointwise2(F.silu(h)).transpose(1, 2)      # (B, T, C)
        if self.dropout is not None:
            h = self.dropout(h)
        return h

    def forward(self, x, seq_len=None):
        """(B, T, C) -> (B, T, C)."""
        h = self._glu(x)
        if seq_len is not None:
            # padded frames must not leak into valid ones through the
            # depthwise conv's receptive field; the pointwise bias makes
            # them nonzero, so mask right before the depthwise conv
            h = h * compute_mask(h, seq_len, 0, 2)
        if self.causal:
            h = F.pad(h, (self.kernel_size - 1, 0))
        else:
            half = (self.kernel_size - 1) // 2
            h = F.pad(h, (half, half))
        return self._after_depthwise(self.depthwise(h), seq_len)

    # ---- carried-state streaming (serving) ----------------------------
    def init_stream_state(self, batch_size, dtype=torch.float32,
                          device=None):
        """Carried left context of the depthwise conv: the last
        ``kernel_size - 1`` frames of the GLU output.  Zeros reproduce the
        causal left padding exactly."""
        assert self.causal, 'streaming requires the causal conv module'
        device = self.depthwise.weight.device if device is None else device
        return torch.zeros((batch_size, self.d_model, self.kernel_size - 1),
                           dtype=dtype, device=device)

    def stream_step(self, x, state):
        """One chunk with carried conv state; in eval mode the batch norm
        applies its running statistics (per frame), so the chunked output
        equals the causal one-shot forward."""
        h_cat = torch.cat([state, self._glu(x)], dim=-1)
        new_state = h_cat[..., h_cat.shape[-1] - (self.kernel_size - 1):]
        return self._after_depthwise(self.depthwise(h_cat), None), new_state


class ConformerBlock(nn.Module):
    """FFN/2 -> MHSA -> conv module -> FFN/2 -> LN (Gulati et al. eq. 1-5).

    ``attn_window``: optional ``(left, right)`` sliding-window attention
    (the flash kernels skip out-of-band key tiles).
    """

    def __init__(self, d_model, num_heads, d_ff=None, kernel_size=31,
                 dropout=0.0, conv_norm='batch_norm', causal=False,
                 attn_window=None, use_rope=True):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.ffn1 = _HalfStepFFN(d_model, d_ff, dropout)
        self.attn_norm = nn.LayerNorm((d_model,))
        self.self_attn = MultiheadAttention(
            d_model, num_heads, dropout=dropout, use_rope=use_rope)
        self.conv = ConformerConvModule(
            d_model, kernel_size=kernel_size, norm=conv_norm,
            dropout=dropout, causal=causal)
        self.ffn2 = _HalfStepFFN(d_model, d_ff, dropout)
        self.final_norm = nn.LayerNorm((d_model,))
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.causal = causal
        self.attn_window = attn_window

    def forward(self, x, seq_len=None):
        x = x + 0.5 * self.ffn1(x)
        h = self.self_attn(
            self.attn_norm(x), key_padding_lens=seq_len, causal=self.causal,
            attn_window=self.attn_window)
        if self.dropout is not None:
            h = self.dropout(h)
        x = x + h
        x = x + self.conv(x, seq_len=seq_len)
        x = x + 0.5 * self.ffn2(x)
        return self.final_norm(x)

    # ---- carried-state streaming (serving) ----------------------------
    def init_stream_state(self, batch_size, max_len, dtype=torch.float32,
                          device=None):
        """Per-block streaming state: the self-attention K/V cache
        (preallocated to ``max_len``) and the conv module's carried left
        context."""
        assert self.causal, 'streaming requires a causal block'
        assert self.attn_window is None, (
            'chunked streaming with sliding-window attention is not '
            'wired up; use the full causal cache')
        return {
            'attn': self.self_attn.init_cache(batch_size, max_len, dtype,
                                              device=device),
            'conv': self.conv.init_stream_state(batch_size, dtype,
                                                device=device),
        }

    def stream_step(self, x, state, index):
        """One chunk at absolute positions ``[index, index + Tc)``: O(chunk)
        work per call (the attention reads the cache, written in place; the
        conv reads ``kernel_size - 1`` carried frames).  Equal to the causal
        one-shot :meth:`forward` on the concatenated chunks."""
        x = x + 0.5 * self.ffn1(x)
        h, attn_state = self.self_attn.decode_step(
            self.attn_norm(x), state['attn'], index)
        x = x + h
        h, conv_state = self.conv.stream_step(x, state['conv'])
        x = x + h
        x = x + 0.5 * self.ffn2(x)
        return self.final_norm(x), {'attn': attn_state, 'conv': conv_state}


class ConformerEncoder(nn.Module):
    """Stack of conformer blocks with an optional input projection.

    >>> _ = torch.manual_seed(0)
    >>> enc = ConformerEncoder(d_model=32, num_layers=2, num_heads=4,
    ...                        input_size=16, kernel_size=7).eval()
    >>> tuple(enc(torch.ones((2, 20, 16)), seq_len=[20, 15]).shape)
    (2, 20, 32)
    """

    def __init__(self, d_model, num_layers, num_heads, d_ff=None,
                 kernel_size=31, dropout=0.0, conv_norm='batch_norm',
                 causal=False, attn_window=None, use_rope=True,
                 input_size=None):
        super().__init__()
        self.input_proj = (nn.Linear(input_size, d_model)
                           if input_size and input_size != d_model
                           else None)
        self.layers = torch.nn.ModuleList([
            ConformerBlock(
                d_model, num_heads, d_ff=d_ff, kernel_size=kernel_size,
                dropout=dropout, conv_norm=conv_norm, causal=causal,
                attn_window=attn_window, use_rope=use_rope)
            for _ in range(num_layers)
        ])
        self.d_model = self.hidden_size = d_model

    def forward(self, x, seq_len=None):
        """(B, T, F) -> (B, T, d_model)."""
        if self.input_proj is not None:
            x = self.input_proj(x)
        for layer in self.layers:
            x = layer(x, seq_len=seq_len)
        if seq_len is not None:
            x = x * compute_mask(x, seq_len, 0, 1)
        return x

    # ---- carried-state streaming (serving) ----------------------------
    def init_stream_state(self, batch_size, max_len, dtype=torch.float32,
                          device=None):
        """State for :meth:`stream_step` (at most ``max_len`` frames over
        all chunks)."""
        return [layer.init_stream_state(batch_size, max_len, dtype,
                                        device=device)
                for layer in self.layers]

    def stream_step(self, x, state, index):
        """Encode one chunk at absolute positions ``[index, index + Tc)``;
        returns ``(frames, state)``.  Chunked equals the one-shot causal
        forward."""
        if self.input_proj is not None:
            x = self.input_proj(x)
        new_state = []
        for layer, s in zip(self.layers, state):
            x, s = layer.stream_step(x, s, index)
            new_state.append(s)
        return x, new_state
