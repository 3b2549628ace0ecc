"""Dual-Path RNN: chunked two-scale sequence modeling.

Counterpart of ``padertorch_tpu/modules/dual_path_rnn.py`` (reference
``padertorch/modules/dual_path_rnn.py``): ``segment`` (zero-pad + fold to
B x N x K x S), ``overlap_add``, ``_ChunkRNN`` (RNN + FC + LayerNorm along
the intra- or inter-chunk axis), ``DPRNNBlock``, ``DPRNN``.  Luo et al.,
"Dual-path RNN: efficient long sequence modeling for time-domain
single-channel speech separation".

The chunk RNNs batch all chunks into the batch axis, so each is one call of
the recurrence kernel over (B * S) or (B * K) rows.  Segmentation is a
strided view (``unfold``) and overlap-add a ``fold``, which sums each
output sample's addends in a fixed order: the same input gives the same
output on every run.  Sequence lengths are host integers (lists or numpy
arrays): all length arithmetic is the host's, masks are built on the
device from a copy of the lengths, and no step waits for the device to
read a length.  A length tensor is accepted and read back once.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.modules.recurrent import LSTM, GRU

__all__ = ['segment', 'overlap_add', 'DPRNN', 'DPRNNBlock',
           'apply_examplewise', 'pack', 'unpack']


def _host_lengths(sequence_lengths):
    """Lengths as a 1-D numpy int array on the host."""
    if isinstance(sequence_lengths, torch.Tensor):
        sequence_lengths = sequence_lengths.cpu().numpy()
    return np.asarray(sequence_lengths).reshape(-1).astype(np.int64)


def _length_mask(lengths, size, device, dtype):
    """(B, size) mask of the valid positions.  Only the lengths cross to
    the device (a few bytes); the mask is built there."""
    lengths = torch.from_numpy(_host_lengths(lengths)).to(device)
    return (torch.arange(size, device=device)[None, :]
            < lengths[:, None]).to(dtype)


def pack(x, sequence_lengths):
    """Concatenate the valid prefixes of each example, dropping padding
    (reference ``modules/dual_path_rnn.py:214``).  Inverse: :func:`unpack`.

    >>> a = torch.ones((2, 4, 3))
    >>> pack(a, [2, 4]).shape
    torch.Size([6, 3])
    """
    assert len(sequence_lengths) == len(x), (len(sequence_lengths), len(x))
    return torch.cat([x_[:int(l)] for x_, l in zip(x, sequence_lengths)])


def unpack(x, sequence_lengths):
    """Inverse of :func:`pack`: re-pad to ``(B, T_max, ...)`` with zeros.

    >>> a = torch.arange(6.).reshape(6, 1)
    >>> unpack(pack(unpack(a[:3], [3]), [3]), [3]).shape
    torch.Size([1, 3, 1])
    >>> r = unpack(torch.ones((5, 2)), [2, 3])
    >>> r.shape, float(r[0, 2].sum())
    (torch.Size([2, 3, 2]), 0.0)
    """
    sequence_lengths = [int(l) for l in sequence_lengths]
    out = x.new_zeros((len(sequence_lengths), max(sequence_lengths),
                       *x.shape[1:]))
    start = 0
    for b, l in enumerate(sequence_lengths):
        out[b, :l] = x[start:start + l]
        start += l
    return out


def apply_examplewise(fn, x, sequence_lengths, time_axis=1):
    """Apply ``fn`` per example, restricted to the valid time range.

    Reference parity: ``modules/dual_path_rnn.py:258``: for fns whose
    output depends on the input's statistics (e.g. norms), masking is
    not enough: each example is sliced to its true length, processed
    with a singleton batch axis, and written back; padding stays zero.

    >>> x = torch.ones((2, 3, 4))
    >>> y = apply_examplewise(lambda a: a / a.sum(-1, keepdim=True), x,
    ...                       [4, 2], time_axis=2)
    >>> y[:, 0].tolist()
    [[0.25, 0.25, 0.25, 0.25], [0.5, 0.5, 0.0, 0.0]]
    """
    if sequence_lengths is None:
        return fn(x)
    assert time_axis != 0, 'The first axis must be the batch axis!'
    assert len(sequence_lengths) == x.shape[0], (
        len(sequence_lengths), x.shape)
    time_axis = time_axis % x.dim()
    selector = (slice(None),) * (time_axis - 1)
    pieces = []
    for b, l in enumerate(sequence_lengths):
        s = (b, *selector, slice(int(l)))
        piece = fn(x[s][None, ...])[0]
        pad = [0, 0] * (x.dim() - 1 - time_axis) \
            + [0, x.shape[time_axis] - int(l)]
        pieces.append(F.pad(piece, pad))
    return torch.stack(pieces)


def segment(signal, hop_size, window_size, sequence_lengths=None):
    """Zero-pad and fold (B, L, N) into (B, N, K, S) chunks.

    Padding: ``hop_size`` zeros at the front, and at the back enough zeros
    that the last window is complete (>= hop_size).  With
    ``sequence_lengths`` the second result holds the chunks per example, a
    numpy array on the host.

    >>> segmented, _ = segment(torch.ones((1, 50, 3)), 10, 20)
    >>> segmented.shape  # B x N x K x S
    torch.Size([1, 3, 20, 6])
    >>> float(segmented[..., :10, 0].abs().sum())  # front zero-padded
    0.0
    >>> seg, lens = segment(torch.ones((1, 50, 3)), 10, 20,
    ...                     sequence_lengths=[30])
    >>> lens.tolist()
    [4]
    """
    b, l, n = signal.shape
    if sequence_lengths is not None:
        sequence_lengths = _host_lengths(sequence_lengths)
        # zero out the padded part so chunks beyond the length stay zero
        signal = signal * _length_mask(
            sequence_lengths, l, signal.device, signal.dtype)[..., None]
    front = hop_size
    # pad back so that (front + L + back - window) % hop == 0 and the last
    # window is fully inside, with at least hop_size zeros at the end
    total = front + l + hop_size
    remainder = (total - window_size) % hop_size
    back = hop_size + (hop_size - remainder if remainder else 0)
    x = F.pad(signal, (0, 0, front, back))
    chunks = x.unfold(1, window_size, hop_size)  # (B, S, N, K)
    out = chunks.permute(0, 2, 3, 1)  # (B, N, K, S)
    if sequence_lengths is not None:
        chunk_lengths = (sequence_lengths + hop_size - 1) // hop_size + 1
        return out, chunk_lengths
    return out, None


def overlap_add(signal, hop_size, unpad=True):
    """Inverse of :func:`segment`: (B, N, K, S) -> (B, L, N).

    >>> a = torch.arange(50.)[None, :, None]
    >>> segmented, _ = segment(a, 10, 20)
    >>> added = overlap_add(segmented, 10, unpad=True)
    >>> added.shape
    torch.Size([1, 50, 1])
    >>> added[0, :3, 0].tolist()  # 2x overlap doubles the values
    [0.0, 2.0, 4.0]
    """
    b, n, k, s = signal.shape
    length = (s - 1) * hop_size + k
    out = F.fold(signal.reshape(b, n * k, s), output_size=(1, length),
                 kernel_size=(1, k), stride=(1, hop_size))  # (B, N, 1, L)
    out = out[:, :, 0, :].transpose(1, 2)
    if unpad:
        out = out[:, hop_size:length - hop_size]
    return out


class _ChunkRNN(nn.Module):
    """RNN + FC + LayerNorm along the intra- or inter-chunk axis.

    ``chunk_axis='k'`` (intra) batches the segment axis S into the batch;
    ``chunk_axis='s'`` (inter) batches the within-chunk axis K.
    Reference parity: ``dual_path_rnn.py:284`` (there via einops strings
    '(b s) k n' / '(b k) s n').
    """

    def __init__(self, feat_size, rnn_size, chunk_axis, rnn_type='blstm'):
        super().__init__()
        assert chunk_axis in ('k', 's'), chunk_axis
        self.chunk_axis = chunk_axis
        self.rnn_type = rnn_type
        if rnn_type in ('lstm', 'blstm'):
            self.rnn = LSTM(feat_size, rnn_size,
                            bidirectional=rnn_type == 'blstm')
        elif rnn_type in ('gru', 'bgru'):
            self.rnn = GRU(feat_size, rnn_size,
                           bidirectional=rnn_type == 'bgru')
        elif rnn_type == 'cnn':
            self.rnn = nn.Conv1d(feat_size, rnn_size, 3, padding=1)
        else:
            raise ValueError(f'Unknown rnn_type for chunk RNN: {rnn_type}')
        out_size = 2 * rnn_size if rnn_type in ('blstm', 'bgru') \
            else rnn_size
        self.fc = nn.Linear(out_size, feat_size)
        self.norm = nn.LayerNorm((feat_size,))
        self.feat_size = feat_size

    def forward(self, sequence, sequence_lengths=None):
        """sequence: (B, N, K, S); lengths along S (host integers)."""
        b, n, k, s = sequence.shape
        if self.chunk_axis == 'k':
            # intra-chunk: iterate over k, batch (b, s)
            x = sequence.permute(0, 3, 2, 1).reshape(b * s, k, n)
            y = self._run(x, None)
            out = y.reshape(b, s, k, self.feat_size).permute(0, 3, 2, 1)
        else:
            # inter-chunk: iterate over s, batch (b, k)
            x = sequence.permute(0, 2, 3, 1).reshape(b * k, s, n)
            lens = None
            if sequence_lengths is not None:
                lens = np.repeat(_host_lengths(sequence_lengths), k)
            y = self._run(x, lens)
            out = y.reshape(b, k, s, self.feat_size).permute(0, 3, 1, 2)
        if sequence_lengths is not None:
            mask = _length_mask(sequence_lengths, s, out.device, out.dtype)
            out = out * mask[:, None, None, :]
        return out

    def _run(self, x, lens):
        if self.rnn_type == 'cnn':
            h = self.rnn(x.transpose(1, 2)).transpose(1, 2)
        else:
            h, _ = self.rnn(x, seq_lens=lens)
        return self.norm(self.fc(h))


class DPRNNBlock(nn.Module):
    """Intra-chunk RNN + residual, then inter-chunk RNN + residual.

    Reference parity: ``dual_path_rnn.py:510``.
    """

    def __init__(self, feat_size, rnn_size, inter_chunk_type='blstm',
                 intra_chunk_type='blstm'):
        super().__init__()
        self.intra_chunk_rnn = _ChunkRNN(
            feat_size, rnn_size, chunk_axis='k',
            rnn_type=intra_chunk_type)
        self.inter_chunk_rnn = _ChunkRNN(
            feat_size, rnn_size, chunk_axis='s',
            rnn_type=inter_chunk_type)

    def forward(self, sequence, sequence_lengths=None):
        sequence = sequence + self.intra_chunk_rnn(
            sequence, sequence_lengths)
        sequence = sequence + self.inter_chunk_rnn(
            sequence, sequence_lengths)
        return sequence


class DPRNN(nn.Module):
    """The Dual-Path RNN (not the separator). Reference: ``dual_path_rnn.py:550``.

    >>> _ = torch.manual_seed(0)
    >>> dprnn = DPRNN(16, 8, window_length=10, hop_size=5, num_blocks=2)
    >>> dprnn(torch.ones((2, 30, 16))).shape
    torch.Size([2, 30, 16])
    """

    def __init__(self, input_size, rnn_size, window_length, hop_size,
                 num_blocks, inter_chunk_type='blstm',
                 intra_chunk_type='blstm'):
        super().__init__()
        self.window_size = window_length
        self.hop_size = hop_size
        self.input_size = self.hidden_size = input_size
        self.dprnn_blocks = torch.nn.ModuleList([
            DPRNNBlock(
                feat_size=input_size,
                rnn_size=rnn_size,
                inter_chunk_type=inter_chunk_type,
                intra_chunk_type=intra_chunk_type,
            ) for _ in range(num_blocks)
        ])

    def calculate_window_and_hop_size(self, sequence,
                                      sequence_lengths=None):
        """'auto': K ~ sqrt(2L) heuristic from the DPRNN paper, Sec 2.2."""
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
        h = segmented
        for block in self.dprnn_blocks:
            h = block(h, chunk_lengths)
        out = overlap_add(h, hop_size=hop_size, unpad=True)
        return out[:, :sequence.shape[1]]
