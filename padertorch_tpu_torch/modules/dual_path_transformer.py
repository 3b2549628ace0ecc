"""Dual-path transformer separator (SepFormer-style).

Counterpart of ``padertorch_tpu/modules/dual_path_transformer.py``,
following Subakan et al., "Attention is All You Need in Speech Separation"
(SepFormer, ICASSP 2021): the chunking scheme of the dual-path RNN
(:func:`padertorch_tpu_torch.modules.dual_path_rnn.segment` /
:func:`~padertorch_tpu_torch.modules.dual_path_rnn.overlap_add`), with the
intra- and inter-chunk RNNs replaced by transformer encoder stacks.

The chunked layout turns one long sequence (B, L, N) into large batched
attention problems, intra-chunk on (B*S, K, N) and inter-chunk on
(B*K, S, N), which both run in the fused attention kernels
(``ops/kernels/attention.py``) after
:func:`padertorch_tpu_torch.contrib.mk.modules.transformer
.set_attention_backend`.

Drop-in separator for :class:`padertorch_tpu_torch.models.tasnet.TasNet`
(exposes ``input_size``/``hidden_size`` and the
``forward(sequence, sequence_lengths)`` contract of
:class:`~padertorch_tpu_torch.modules.dual_path_rnn.DPRNN`).  The chunk
counts cross to the device once per forward; every block builds its masks
and key lengths there, and nothing is read back.
"""
import math

import torch

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    TransformerEncoderLayer, _make_norm)
from padertorch_tpu_torch.modules.dual_path_rnn import (
    _host_lengths, overlap_add, segment)

__all__ = ['DualPathTransformer', 'DualPathTransformerBlock']


def _device_lengths(sequence_lengths, device):
    """Lengths as a 1-D integer tensor on ``device`` (a tensor already
    there is taken as it is)."""
    if isinstance(sequence_lengths, torch.Tensor):
        return sequence_lengths.to(device)
    return torch.from_numpy(_host_lengths(sequence_lengths)).to(device)


class _ChunkTransformer(nn.Module):
    """Transformer encoder stack along the intra- (k) or inter- (s) chunk
    axis; the residual around the whole stack (SepFormer Fig. 2:
    ``x + Transformer(x)``) is the block's.

    ``chunk_axis='k'`` batches the segment axis S into the batch;
    ``chunk_axis='s'`` batches the within-chunk axis K (the same folding
    as ``dual_path_rnn._ChunkRNN``).  Positions come from RoPE inside the
    attention, so no positional encoding is added.
    """

    def __init__(self, feat_size, num_layers, num_heads, d_ff=None,
                 chunk_axis='k', dropout=0.0, use_rope=True):
        super().__init__()
        assert chunk_axis in ('k', 's'), chunk_axis
        self.chunk_axis = chunk_axis
        self.layers = torch.nn.ModuleList([
            TransformerEncoderLayer(
                feat_size, num_heads, d_ff=d_ff, dropout=dropout,
                use_rope=use_rope, pre_norm=True)
            for _ in range(num_layers)
        ])
        self.final_norm = _make_norm('layer_norm', feat_size)
        self.feat_size = feat_size

    def _run(self, x, lens):
        h = x
        for layer in self.layers:
            h = layer(h, seq_len=lens)
        return self.final_norm(h)

    def forward(self, sequence, sequence_lengths=None):
        """sequence: (B, N, K, S); lengths count valid chunks along S."""
        b, n, k, s = sequence.shape
        if sequence_lengths is not None:
            sequence_lengths = _device_lengths(
                sequence_lengths, sequence.device)
        if self.chunk_axis == 'k':
            # intra-chunk: attend over k, batch (b, s)
            x = sequence.permute(0, 3, 2, 1).reshape(b * s, k, n)
            y = self._run(x, None)
            out = y.reshape(b, s, k, self.feat_size).permute(0, 3, 2, 1)
        else:
            # inter-chunk: attend over s, batch (b, k)
            x = sequence.permute(0, 2, 3, 1).reshape(b * k, s, n)
            lens = None
            if sequence_lengths is not None:
                lens = sequence_lengths.repeat_interleave(k)
            y = self._run(x, lens)
            out = y.reshape(b, k, s, self.feat_size).permute(0, 3, 1, 2)
        if sequence_lengths is not None:
            mask = (torch.arange(s, device=out.device)[None, :]
                    < sequence_lengths[:, None])
            out = out * mask[:, None, None, :].to(out.dtype)
        return out


class DualPathTransformerBlock(nn.Module):
    """One SepFormer block: intra-chunk transformer + residual, then
    inter-chunk transformer + residual (the transformer analog of
    ``dual_path_rnn.DPRNNBlock``)."""

    def __init__(self, feat_size, num_layers_intra=2, num_layers_inter=2,
                 num_heads=4, d_ff=None, dropout=0.0, use_rope=True):
        super().__init__()
        self.intra_chunk = _ChunkTransformer(
            feat_size, num_layers_intra, num_heads, d_ff=d_ff,
            chunk_axis='k', dropout=dropout, use_rope=use_rope)
        self.inter_chunk = _ChunkTransformer(
            feat_size, num_layers_inter, num_heads, d_ff=d_ff,
            chunk_axis='s', dropout=dropout, use_rope=use_rope)

    def forward(self, sequence, sequence_lengths=None):
        sequence = sequence + self.intra_chunk(sequence, sequence_lengths)
        sequence = sequence + self.inter_chunk(sequence, sequence_lengths)
        return sequence


class DualPathTransformer(nn.Module):
    """Dual-path transformer ("SepFormer") sequence processor.

    Same contract as :class:`~padertorch_tpu_torch.modules.dual_path_rnn
    .DPRNN`: (B, L, N) in, (B, L, N) out, so it plugs straight into
    :class:`~padertorch_tpu_torch.models.tasnet.TasNet` as the separator.

    >>> _ = torch.manual_seed(0)
    >>> dpt = DualPathTransformer(16, window_length=10, hop_size=5,
    ...                           num_blocks=2, num_heads=4).eval()
    >>> dpt(torch.ones((2, 30, 16))).shape
    torch.Size([2, 30, 16])
    """

    def __init__(self, input_size, window_length, hop_size, num_blocks,
                 num_layers_intra=2, num_layers_inter=2, num_heads=4,
                 d_ff=None, dropout=0.0, use_rope=True):
        super().__init__()
        self.window_size = window_length
        self.hop_size = hop_size
        self.input_size = self.hidden_size = input_size
        self.dpt_blocks = torch.nn.ModuleList([
            DualPathTransformerBlock(
                feat_size=input_size,
                num_layers_intra=num_layers_intra,
                num_layers_inter=num_layers_inter,
                num_heads=num_heads,
                d_ff=d_ff,
                dropout=dropout,
                use_rope=use_rope,
            ) for _ in range(num_blocks)
        ])

    def calculate_window_and_hop_size(self, sequence,
                                      sequence_lengths=None):
        """'auto': K ~ sqrt(2L) as in DPRNN (paper Sec 2.2)."""
        if self.window_size == 'auto' or self.hop_size == 'auto':
            assert self.window_size == self.hop_size == 'auto'
            window_size = int(math.sqrt(2 * sequence.shape[-2]))
            hop_size = window_size // 2
            return window_size, hop_size
        return self.window_size, self.hop_size

    def forward(self, sequence, sequence_lengths=None):
        """(B, L, N) -> (B, L, N)."""
        window_size, hop_size = self.calculate_window_and_hop_size(
            sequence, sequence_lengths)
        segmented, chunk_lengths = segment(
            sequence, hop_size=hop_size, window_size=window_size,
            sequence_lengths=sequence_lengths)
        if chunk_lengths is not None:
            # one copy to the device for all blocks
            chunk_lengths = _device_lengths(chunk_lengths, sequence.device)
        h = segmented
        for block in self.dpt_blocks:
            h = block(h, chunk_lengths)
        out = overlap_add(h, hop_size=hop_size, unpad=True)
        return out[:, :sequence.shape[1]]
