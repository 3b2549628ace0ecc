"""Conv layers and CNN stacks with padding and length bookkeeping.

Counterpart of ``padertorch_tpu/contrib/je/modules/conv.py`` (reference
``padertorch/contrib/je/modules/conv.py``), the forward stack:
``Conv1d``/``Conv2d`` with pad-type handling, norm, gated activations and
pre-activation; ``Pool1d``/``Pool2d`` (VALID windows after an explicit pad,
the max-pool index helpers); ``CNN1d``/``CNN2d`` stacks that track
sequence lengths through strides and pooling and project residual
connections; ``Pad``, ``Trim`` and the size and length helpers.  The
convolutions are the port's ``nn.Conv1d``/``nn.Conv2d`` (torch's layers;
cuDNN on the card: the JAX package computes them outside any Pallas
kernel too) with zero padding added before them as the JAX layer adds it;
a batch norm is the port's ``Normalization``, masked by the sequence
lengths.  Submodules carry the JAX module's attribute names (``convs``,
``pools``, ``residual_skip_convs``, ``conv``, ``norm``), so
``migrate.from_jax_state_dict`` moves the weights and running statistics
as they are.  The transposed stack, unpooling and ``resnet50`` are not
ported yet.
"""
import numpy as np
import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.data.segment import to_list
from padertorch_tpu_torch.modules.normalization import Normalization
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP

__all__ = ['Conv1d', 'Conv2d', 'CNN1d', 'CNN2d', 'Pool1d', 'Pool2d', 'Pad',
           'Trim', 'compute_pad_size', 'compute_conv_out_size',
           'compute_transpose_out_size', 'compute_conv_output_shape',
           'compute_conv_output_sequence_lengths', 'to_pair',
           'map_activation_fn']

_PAD_MODE_MAP = {  # jnp.pad mode names of the JAX package -> torch's
    'constant': 'constant',
    'replicate': 'replicate',
    'reflect': 'reflect',
    'circular': 'circular',
}


def _torch_pad(pad):
    """[(front, end) per axis, first axis first] -> ``F.pad``'s flat
    list, last axis first."""
    return [int(v) for pair in reversed(pad) for v in pair]


def _maximum(seq_len, minimum):
    if isinstance(seq_len, torch.Tensor):
        return torch.clamp(seq_len, min=minimum)
    return np.maximum(seq_len, minimum)


class Pad(torch.nn.Module):
    """Pad the last (two) axes by ``size`` at front/end/both
    (reference ``je/modules/conv_utils.py:11``; 'both' with an odd size
    pads the end one more than the front).

    >>> Pad(side='both')(torch.ones((1, 1, 4)), 3).shape
    torch.Size([1, 1, 7])
    """

    def __init__(self, side='both', mode='constant'):
        super().__init__()
        self.side = side
        self.mode = mode

    def forward(self, x, size):
        assert x.dim() in (3, 4), x.shape
        n = x.dim() - 2
        sides = to_list(self.side, n)
        sizes = to_list(size, n)
        if not any(np.asarray(sizes)):
            return x
        pad = []
        for side, sz in zip(sides, sizes):
            if side is None or sz < 1:
                assert sz == 0, sizes
                pad.append((0, 0))
            elif side == 'front':
                pad.append((sz, 0))
            elif side == 'both':
                pad.append((sz // 2, -(-sz // 2)))
            elif side == 'end':
                pad.append((0, sz))
            else:
                raise ValueError(f'pad side {side} unknown')
        return F.pad(x, _torch_pad(pad), mode=_PAD_MODE_MAP[self.mode])


class Trim(torch.nn.Module):
    """Counterpart to :class:`Pad`: remove ``size`` values from the last
    (two) axes (reference ``je/modules/conv_utils.py:57``; 'both' with an
    odd size trims the end one more than the front).

    >>> Trim(side='front')(torch.ones((1, 1, 7)), 3).shape
    torch.Size([1, 1, 4])
    """

    def __init__(self, side='both'):
        super().__init__()
        self.side = side

    def forward(self, x, size):
        assert x.dim() in (3, 4), x.shape
        n = x.dim() - 2
        sides = to_list(self.side, n)
        sizes = to_list(size, n)
        slc = [slice(None)] * x.dim()
        for i, (side, sz) in enumerate(zip(sides, sizes)):
            axis = 2 + i
            if side is None or sz < 1:
                assert sz == 0, sizes
            elif side == 'front':
                slc[axis] = slice(sz, x.shape[axis])
            elif side == 'both':
                slc[axis] = slice(sz // 2, -(-(-sz // 2)) or None)
            elif side == 'end':
                slc[axis] = slice(0, -sz)
            else:
                raise ValueError(f'trim side {side} unknown')
        return x[tuple(slc)]


def compute_pad_size(kernel_size, dilation, stride, pad_type):
    """(front, end) zero padding of one axis.

    >>> compute_pad_size(4, 1, 1, 'both'), compute_pad_size(3, 2, 1, 'front')
    ((1, 2), (4, 0))
    """
    if pad_type is None:
        return (0, 0)
    total = dilation * (kernel_size - 1)
    if pad_type == 'both':
        return (total // 2, -(-total // 2))
    if pad_type == 'front':
        return (total, 0)
    if pad_type == 'end':
        return (0, total)
    raise ValueError(f'Unknown pad_type {pad_type!r}')


def compute_conv_out_size(in_size, kernel_size, dilation, stride,
                          pad_type):
    """Length of one axis after a conv.

    >>> compute_conv_out_size(10, 3, 1, 2, None)
    4
    """
    front, end = compute_pad_size(kernel_size, dilation, stride, pad_type)
    return (in_size + front + end - dilation * (kernel_size - 1) - 1) \
        // stride + 1


def compute_transpose_out_size(in_size, kernel_size, dilation, stride,
                               pad_type):
    """Length after a transpose op (unpool/transpose conv).

    Reference parity: ``je/modules/conv_utils.py:322`` —
    ``_compute_transpose_out_size``: upsample to ``(in-1)*stride + 1``
    plus the kernel extent, minus the padding that the forward op
    would have introduced (end pad reduced by ``stride - 1`` because
    the final window only has to start, not fit, within the signal).

    >>> int(compute_transpose_out_size(4, 3, 1, 2, 'both'))
    8
    """
    out = 1 + (np.asarray(in_size) - 1) * stride \
        + dilation * (kernel_size - 1)
    front, end = compute_pad_size(kernel_size, dilation, stride, pad_type)
    end = max(end - stride + 1, 0)
    return out - front - end


def to_pair(x):
    """Broadcast a scalar to a 2-tuple (reference
    ``je/modules/conv_utils.py:257``).

    >>> to_pair(3)
    (3, 3)
    """
    return tuple(to_list(x, 2))


def map_activation_fn(activation_fn):
    """String/None/callable -> activation callable (reference
    ``conv_utils.py:290``)."""
    if activation_fn in ('linear', None):
        activation_fn = 'identity'
    if isinstance(activation_fn, str):
        return ACTIVATION_FN_MAP[activation_fn]()
    if not callable(activation_fn):
        raise ValueError(
            f'Type {type(activation_fn)} not supported for activation_fn')
    return activation_fn


def compute_conv_output_shape(input_shape, out_channels, kernel_size,
                              dilation, stride, pad_type,
                              transpose=False):
    """(B, C, *spatial) shape after a (transpose) conv (reference
    ``conv_utils.py:330``); per-axis parameters broadcast.

    >>> compute_conv_output_shape((2, 1, 16, 100), 4, 3, 1, 2, 'both').tolist()
    [2, 4, 8, 50]
    """
    input_shape = np.asarray(input_shape)
    n_spatial = len(input_shape) - 2
    output_shape = np.zeros_like(input_shape)
    output_shape[0] = input_shape[0]
    output_shape[1] = out_channels
    kernel_size = to_list(kernel_size, n_spatial)
    dilation = to_list(dilation, n_spatial)
    stride = to_list(stride, n_spatial)
    pad_type = to_list(pad_type, n_spatial)
    fn = compute_transpose_out_size if transpose else compute_conv_out_size
    for d in range(n_spatial):
        output_shape[2 + d] = fn(
            input_shape[2 + d], kernel_size[d], dilation[d], stride[d],
            pad_type[d])
    assert np.all(output_shape > 0), output_shape
    return output_shape.astype(np.int64)


def compute_conv_output_sequence_lengths(input_sequence_lengths,
                                         kernel_size, dilation, pad_type,
                                         stride, transpose=False):
    """Valid-length bookkeeping through a (transpose) conv's LAST
    (time) axis (reference ``conv_utils.py:354``; note the reference's
    argument order — ``pad_type`` before ``stride``).

    >>> compute_conv_output_sequence_lengths([9, 10], 3, 1, None, 2).tolist()
    [4, 4]
    """
    kernel_size = to_list(kernel_size)
    dilation = to_list(dilation)
    stride = to_list(stride)
    pad_type = to_list(pad_type)
    fn = compute_transpose_out_size if transpose else compute_conv_out_size
    seq_len_out = fn(
        np.asarray(input_sequence_lengths), kernel_size[-1],
        dilation[-1], stride[-1], pad_type[-1])
    assert np.all(seq_len_out > 0), seq_len_out
    return np.asarray(seq_len_out).astype(np.int64)


def _max_pool_indices_1d(x, k, s):
    """Max pool (B, C, T) returning values + flat argmax time indices
    (the first maximum of a window, as ``jnp.argmax``)."""
    t = x.shape[-1]
    w = (t - k) // s + 1
    starts = torch.arange(w, device=x.device) * s
    win_idx = starts[:, None] + torch.arange(k, device=x.device)[None, :]
    windows = x[..., win_idx]                             # (B, C, W, k)
    y = windows.amax(dim=-1)
    offsets = windows.argmax(dim=-1)                      # (B, C, W)
    return y, starts[None, None, :] + offsets


def _max_pool_indices_2d(x, k, s):
    """Max pool (B, C, F, T) returning values + flat indices into F*T
    (torch ``MaxPool2d(return_indices=True)`` convention)."""
    kf, kt = k
    sf, st = s
    f, t = x.shape[-2:]
    wf = (f - kf) // sf + 1
    wt = (t - kt) // st + 1
    dev = x.device
    f_idx = (torch.arange(wf, device=dev)[:, None] * sf
             + torch.arange(kf, device=dev)[None, :])
    t_idx = (torch.arange(wt, device=dev)[:, None] * st
             + torch.arange(kt, device=dev)[None, :])
    windows = x[..., f_idx, :][..., t_idx]       # (B, C, Wf, kf, Wt, kt)
    windows = windows.movedim(-3, -2)            # (B, C, Wf, Wt, kf, kt)
    flat = windows.reshape(*windows.shape[:-2], kf * kt)
    y = flat.amax(dim=-1)
    off = flat.argmax(dim=-1)                    # (B, C, Wf, Wt)
    of, ot = off // kt, off % kt
    f_abs = f_idx[None, None, :, None, :].expand(*of.shape, kf).gather(
        -1, of[..., None])[..., 0]
    t_abs = t_idx[None, None, None, :, :].expand(*ot.shape, kt).gather(
        -1, ot[..., None])[..., 0]
    return y, f_abs * t + t_abs


class _ConvBase(torch.nn.Module):
    n: int = 1

    def __init__(self, in_channels, out_channels, kernel_size, *,
                 dropout=0.0, pad_type='both', dilation=1, stride=1,
                 bias=True, groups=1, norm=None, activation_fn='relu',
                 gated=False, pre_activation=False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = to_list(kernel_size, self.n)
        self.dilation = to_list(dilation, self.n)
        self.stride = to_list(stride, self.n)
        self.pad_type = to_list(pad_type, self.n)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.activation_fn = ACTIVATION_FN_MAP[activation_fn]()
        self.gated = gated
        self.pre_activation = pre_activation
        fmt = 'bct' if self.n == 1 else 'bcft'
        shape = [None, in_channels if pre_activation else out_channels]
        shape += [None] * self.n
        if norm is None:
            self.norm = None
        elif norm == 'batch':
            self.norm = Normalization(
                data_format=fmt, shape=shape,
                statistics_axis='bt' if self.n == 1 else 'bft',
                independent_axis='c')
        elif norm == 'sequence':
            self.norm = Normalization(
                data_format=fmt, shape=shape, statistics_axis='t',
                independent_axis='c', batch_axis='b', sequence_axis='t')
        elif callable(norm):
            self.norm = norm
        else:
            raise ValueError(f'Unknown norm {norm!r}')
        conv_cls = nn.Conv1d if self.n == 1 else nn.Conv2d
        self.conv = conv_cls(
            in_channels, out_channels * (2 if gated else 1),
            kernel_size=kernel_size, dilation=dilation, stride=stride,
            bias=bias, groups=groups)

    def _pad(self, x):
        pads = [
            compute_pad_size(k, d, s, p)
            for k, d, s, p in zip(self.kernel_size, self.dilation,
                                  self.stride, self.pad_type)
        ]
        if any(sum(p) for p in pads):
            x = F.pad(x, _torch_pad(pads))
        return x

    def _normalize(self, x, seq_len):
        if isinstance(self.norm, Normalization):
            return self.norm(x, sequence_lengths=seq_len)
        return self.norm(x)

    def forward(self, x, seq_len=None):
        """x: (B, C, [F,] T); returns (y, out_seq_len)."""
        if self.dropout is not None:
            x = self.dropout(x)
        if self.pre_activation:
            if self.norm is not None:
                x = self._normalize(x, seq_len)
            x = self.activation_fn(x)
        y = self.conv(self._pad(x))
        if self.gated:
            y, gate = torch.chunk(y, 2, dim=1)
            y = y * torch.sigmoid(gate)
        out_seq_len = self.get_out_lengths(seq_len)
        if not self.pre_activation:
            if self.norm is not None:
                y = self._normalize(y, out_seq_len)
            y = self.activation_fn(y)
        return y, out_seq_len

    def get_out_lengths(self, seq_len):
        """Sequence lengths after this conv (time = last axis).

        >>> Conv1d(1, 1, 3, stride=2, pad_type=None).get_out_lengths(
        ...     np.array([9, 10])).tolist()
        [4, 4]
        """
        if seq_len is None:
            return None
        if not isinstance(seq_len, (np.ndarray, torch.Tensor)):
            seq_len = np.asarray(seq_len)
        k, d, s = self.kernel_size[-1], self.dilation[-1], self.stride[-1]
        front, end = compute_pad_size(k, d, s, self.pad_type[-1])
        return (seq_len + front + end - d * (k - 1) - 1) // s + 1


class Conv1d(_ConvBase):
    n = 1


class Conv2d(_ConvBase):
    n = 2


class _Pool(torch.nn.Module):
    n = 1

    def __init__(self, pool_type='max', pool_size=2, pool_stride=None,
                 pad_type=None):
        super().__init__()
        self.pool_type = pool_type
        self.pool_size = pool_size
        self.pool_stride = pool_size if pool_stride is None \
            else pool_stride
        self.pad_type = pad_type

    def forward(self, x, seq_len=None, return_indices=False):
        if self.pool_type is None or self.pool_size in (1, None):
            return (x, seq_len, None) if return_indices else (x, seq_len)
        k = to_list(self.pool_size, self.n)
        s = to_list(self.pool_stride, self.n)
        pad_types = to_list(self.pad_type, self.n)
        pads = [compute_pad_size(ki, 1, si, pi)
                for ki, si, pi in zip(k, s, pad_types)]
        if any(sum(p) for p in pads):
            fill = -float('inf') if self.pool_type == 'max' else 0.0
            x = F.pad(x, _torch_pad(pads), value=fill)
        indices = None
        if return_indices and self.pool_type == 'max':
            if self.n == 1:
                y, indices = _max_pool_indices_1d(x, k[0], s[0])
            else:
                y, indices = _max_pool_indices_2d(x, k, s)
        elif self.pool_type == 'max':
            pool = F.max_pool1d if self.n == 1 else F.max_pool2d
            y = pool(x, kernel_size=k, stride=s)
        elif self.pool_type == 'avg':
            # the window's sum over its size, padded values included
            pool = F.avg_pool1d if self.n == 1 else F.avg_pool2d
            y = pool(x, kernel_size=k, stride=s)
        else:
            raise ValueError(self.pool_type)
        if seq_len is not None:
            if not isinstance(seq_len, (np.ndarray, torch.Tensor)):
                seq_len = np.asarray(seq_len)
            front, end = pads[-1]
            seq_len = _maximum((seq_len + front + end - k[-1]) // s[-1] + 1,
                               1)
        return (y, seq_len, indices) if return_indices else (y, seq_len)


class Pool1d(_Pool):
    n = 1


class Pool2d(_Pool):
    n = 2


class _CNN(torch.nn.Module):
    """Stack of convs (+ optional pooling), with length bookkeeping and
    projected residual connections.

    Reference parity: ``je/modules/conv.py:421-743`` — ``residual_
    connections[src]`` names the *destination layer index* whose input
    receives the saved input of layer ``src``; when channels or
    cumulative stride differ, a 1x1 skip conv (with matching stride)
    projects the residual, exactly like the reference's
    ``residual_skip_convs``.
    """

    conv_cls = None
    pool_cls = None

    def __init__(self, in_channels, out_channels, kernel_size, *,
                 dropout=0.0, pad_type='both', dilation=1, stride=1,
                 norm=None, activation_fn='relu', gated=False,
                 pool_type='max', pool_size=1, pool_stride=None,
                 output_activation_fn=None, residual_connections=None,
                 pre_activation=False, return_pool_indices=False):
        super().__init__()
        self.return_pool_indices = return_pool_indices
        out_channels = list(out_channels)
        num_layers = len(out_channels)
        kernel_sizes = to_list(kernel_size, num_layers)
        dilations = to_list(dilation, num_layers)
        strides = to_list(stride, num_layers)
        pool_sizes = to_list(pool_size, num_layers)
        pool_strides = to_list(
            pool_size if pool_stride is None else pool_stride,
            num_layers)
        pool_types = to_list(pool_type, num_layers)
        dropouts = to_list(dropout, num_layers)
        norms = to_list(norm, num_layers)
        activations = to_list(activation_fn, num_layers)
        if output_activation_fn is not None:
            activations[-1] = output_activation_fn
        # normalize to list-of-lists of destination indices
        rc = to_list(
            residual_connections
            if residual_connections is not None else [None] * num_layers,
            num_layers)
        self.residual_connections = [
            [] if dst is None else [int(d) for d in to_list(dst)]
            for dst in rc
        ]
        channels = [in_channels] + out_channels
        self.convs = torch.nn.ModuleList([
            self.conv_cls(
                channels[i], channels[i + 1], kernel_sizes[i],
                dropout=dropouts[i], pad_type=pad_type,
                dilation=dilations[i], stride=strides[i], norm=norms[i],
                activation_fn=activations[i], gated=gated,
                pre_activation=pre_activation)
            for i in range(num_layers)
        ])
        self.pools = torch.nn.ModuleList([
            self.pool_cls(pool_type=pool_types[i],
                          pool_size=pool_sizes[i],
                          pool_stride=pool_strides[i])
            for i in range(num_layers)
        ])
        self.kernel_sizes = kernel_sizes
        self.dilations = dilations
        self.strides = strides
        self.pool_sizes = pool_sizes
        self.pool_strides = pool_strides
        self.num_layers = num_layers
        # skip projections where channels or cumulative stride mismatch
        skip_convs = {}
        for src, dsts in enumerate(self.residual_connections):
            for dst in dsts:
                assert src < dst <= num_layers, (src, dst)
                # per-axis cumulative stride (strides may be tuples,
                # e.g. (2, 1) for freq-only downsampling)
                cum = np.ones(self.n, dtype=int)
                for j in range(src, dst):
                    cum = cum * np.asarray(to_list(strides[j], self.n))
                    cum = cum * np.asarray(
                        to_list(pool_strides[j], self.n))
                if channels[src] != channels[dst] or (cum != 1).any():
                    stride = (int(cum[0]) if self.n == 1
                              else tuple(int(c) for c in cum))
                    skip_convs[f'{src}->{dst}'] = self.conv_cls(
                        channels[src], channels[dst], 1,
                        stride=stride, activation_fn='identity')
        self.residual_skip_convs = torch.nn.ModuleDict(skip_convs)
        self.out_channels = out_channels[-1]

    def _add_residuals(self, x, saved, layer):
        for src, res in saved.pop(layer, []):
            key = f'{src}->{layer}'
            if key in self.residual_skip_convs:
                res, _ = self.residual_skip_convs[key](res)
            if res.shape == x.shape:
                x = x + res
        return x

    def forward(self, x, seq_len=None):
        saved = {}
        pool_indices = []
        for i, (conv, pool) in enumerate(zip(self.convs, self.pools)):
            x = self._add_residuals(x, saved, i)
            for dst in self.residual_connections[i]:
                saved.setdefault(dst, []).append((i, x))
            x, seq_len = conv(x, seq_len)
            if self.return_pool_indices:
                x, seq_len, idx = pool(x, seq_len, return_indices=True)
                pool_indices.append(idx)
            else:
                x, seq_len = pool(x, seq_len)
        # destinations == num_layers attach to the output
        x = self._add_residuals(x, saved, self.num_layers)
        if self.return_pool_indices:
            return x, seq_len, pool_indices
        return x, seq_len

    def get_shapes(self, in_shape):
        """Per-layer full output shapes ``[in_shape, out_0, ...]``
        (reference ``je/modules/conv.py`` ``CNN.get_shapes``).

        >>> cnn = CNN2d(in_channels=1, out_channels=[4, 8],
        ...             kernel_size=3, pool_size=2)
        >>> cnn.get_shapes((2, 1, 16, 100))
        [(2, 1, 16, 100), (2, 4, 8, 50), (2, 8, 4, 25)]
        """
        shapes = [tuple(in_shape)]
        cur = np.asarray(in_shape[2:])
        batch = in_shape[0]
        for conv, pool in zip(self.convs, self.pools):
            cur = np.asarray([
                compute_conv_out_size(int(c), k, d, s, p)
                for c, k, d, s, p in zip(
                    cur, conv.kernel_size, conv.dilation, conv.stride,
                    conv.pad_type)
            ])
            if pool.pool_type is not None and \
                    pool.pool_size not in (1, None):
                pk = to_list(pool.pool_size, self.n)
                ps = to_list(pool.pool_stride, self.n)
                pp = to_list(pool.pad_type, self.n)
                out = []
                for c, ki, si, pi in zip(cur, pk, ps, pp):
                    f, e = compute_pad_size(ki, 1, si, pi)
                    out.append((int(c) + f + e - ki) // si + 1)
                cur = np.asarray(out)
            shapes.append(
                (batch, conv.out_channels) + tuple(int(c) for c in cur))
        return shapes

    def get_seq_lens(self, in_lengths):
        """Per-layer sequence lengths ``[in_lengths, out_0, ...]``
        (reference ``CNN.get_seq_lens``; time = last axis)."""
        seq = np.asarray(in_lengths)
        lens = [seq]
        for conv, pool in zip(self.convs, self.pools):
            seq = conv.get_out_lengths(seq)
            if pool.pool_type is not None and \
                    pool.pool_size not in (1, None):
                k = to_list(pool.pool_size, self.n)[-1]
                s = to_list(pool.pool_stride, self.n)[-1]
                p = to_list(pool.pad_type, self.n)[-1]
                f, e = compute_pad_size(k, 1, s, p)
                seq = np.maximum((seq + f + e - k) // s + 1, 1)
            lens.append(seq)
        return lens

    def get_receptive_field(self):
        """Receptive field (reference je/modules/conv.py:944).

        >>> CNN1d(1, [4, 4], kernel_size=3, pool_size=[2, 1]) \\
        ...     .get_receptive_field().tolist()
        [8]
        """
        is_2d = self.n == 2
        receptive_field = np.ones(1 + is_2d, dtype=int)
        for i in reversed(range(self.num_layers)):
            receptive_field *= np.array(
                to_list(self.pool_strides[i], self.n))
            receptive_field += (
                np.array(to_list(self.pool_sizes[i], self.n))
                - np.array(to_list(self.pool_strides[i], self.n)))
            receptive_field *= np.array(to_list(self.strides[i], self.n))
            receptive_field += (
                1 + (np.array(to_list(self.kernel_sizes[i], self.n)) - 1)
                * np.array(to_list(self.dilations[i], self.n))
                - np.array(to_list(self.strides[i], self.n)))
        return receptive_field


class CNN1d(_CNN):
    n = 1
    conv_cls = Conv1d
    pool_cls = Pool1d


class CNN2d(_CNN):
    n = 2
    conv_cls = Conv2d
    pool_cls = Pool2d
