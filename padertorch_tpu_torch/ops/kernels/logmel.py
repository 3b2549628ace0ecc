"""Fused STFT -> power -> mel -> log front end.

Counterpart of ``padertorch_tpu/ops/pallas/logmel.py`` (``LogMelFrontend``,
``fused_logmel``).  On CUDA tensors :class:`LogMelFrontend` launches the
hand-written kernel of ``csrc/fused_logmel.cu``, one launch per call:
framing (with the fading pad folded into the kernel's loads), both
windowed-DFT products (3xTF32 ``wgmma`` on the tensor cores), the power and
the mel product stay on chip and only the (B, frames, n_mels) log-mel
features are written.  :func:`logmel_plan` divides the work before the
launch: tiles of 64 frames of one signal, and clusters of CTAs that split a
tile's bins, so that the recipes' small inputs still fill the card; a tile
keeps its 64 frames' span of the signal in shared memory, or, for a hop so
long that the span does not fit (``sliced``: 1600/800, 1024/1024 on an
H100), each stage's slice of it.  On CPU
tensors it runs the plain version (pad -> frames -> two products -> power
-> mel -> log).

The TPU kernel frames with rolls and so needs ``shift | window_length``;
the CUDA kernel reads each frame at its own offset and takes any shift.
It is inference-shaped as in the JAX package (audio needs no gradient and
the filterbank is a buffer): there is no backward kernel, and an input
that requires a gradient is refused.
"""
from typing import NamedTuple

import numpy as np
import torch

from padertorch_tpu_torch.ops._stft import (
    _get_window, get_stft_kernel, tables_on)
from padertorch_tpu_torch.ops.kernels import _build, _ops
from padertorch_tpu_torch.ops.kernels.gru import device_limits

__all__ = ['fused_logmel', 'fused_logmel_plain', 'LogMelFrontend',
           'LogMelPlan', 'logmel_plan', 'logmel_smem', 'mel_bands',
           'kernel_basis', 'tf32_split', 'pad_widths', 'fused_logmel_op']

EPS = 1e-12

# the kernel's constants (csrc/fused_logmel.cu): frames of a CTA, bins of
# a chunk (64 basis columns), window positions of a stage, CTAs of a
# cluster at most
FRAMES = 64
BINS = 32
STAGE_ROWS = 32
MAX_CLUSTER = 16


class LogMelPlan(NamedTuple):
    """How the kernel divides a call: tiles of 64 frames of one signal,
    ``CS`` CTAs a cluster (they split a tile's ``chunks`` of 32 bins, rank
    c taking chunks c, c + CS, ...), ``blocks`` CTAs in all, ``smem``
    bytes of shared memory a CTA, and whether the signal comes a stage's
    slice at a time (``sliced``) or as the tile's whole span."""
    CS: int
    chunks: int
    blocks: int
    smem: int
    sliced: bool = False


def _round_up(x, to):
    return -(-x // to) * to


def logmel_smem(window_length, shift, n_partials, sliced=False):
    """Bytes of shared memory a CTA needs: two basis stages (32 positions
    of 64 columns) of a hi and a lo plane each, its 64 frames' span of the
    signal in segments of ``shift`` samples padded to 4 mod 8 floats (or,
    ``sliced``, two tiles of a stage's 32 positions of the 64 frames, rows
    of 36 floats), the power of a chunk (64, 33), the mel partial sums (64,
    ``n_partials``, one for each band and chunk of 32 bins the band meets)
    and, but ``sliced``, one int per window position (rounded up to 32)."""
    lk = _round_up(window_length, STAGE_ROWS)
    ss = shift + (12 - shift % 8) % 8
    n_seg = FRAMES + (lk - 1) // shift
    signal = (2 * FRAMES * (STAGE_ROWS + 4) if sliced
              else _round_up(n_seg * ss, 4) + lk)
    floats = (4 * STAGE_ROWS * 2 * BINS + signal
              + FRAMES * (BINS + 1) + FRAMES * n_partials)
    return 4 * floats


def tf32_split(x):
    """(hi, lo) of float32 ``x``: hi is x rounded to the nearest TF32 value
    (ties away from zero), lo the rest rounded the same way: the kernel's
    ``cvt.rna.tf32.f32`` split."""
    def rna(v):
        u = np.ascontiguousarray(v, np.float32).view(np.uint32).astype(
            np.uint64) + 0x1000
        return (u & 0xffffe000).astype(np.uint32).view(np.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def kernel_basis(interleaved, length):
    """The kernel's basis from the (L, 2 F') one, F' a multiple of 32
    ([re, im] of bin b at columns 2b, 2b + 1), L padded with zeros to a
    multiple of 32: per chunk of 64 columns and stage of 32 window
    positions, the hi plane and then the lo plane (:func:`tf32_split`),
    each four k-steps of 8 positions of 512 floats in the order (column
    group of 8, position group of 4, column, position), the K-major core
    matrices ``wgmma`` reads B from.  Shape (chunks, stages, 2, 2048)."""
    lk = _round_up(length, STAGE_ROWS)
    chunks = interleaved.shape[1] // (2 * BINS)
    padded = np.zeros((lk, interleaved.shape[1]), np.float32)
    padded[:length] = interleaved
    core = padded.reshape(lk // 8, 2, 4, chunks, 8, 8).transpose(
        3, 0, 4, 1, 5, 2).reshape(chunks, lk // STAGE_ROWS, 2048)
    return np.ascontiguousarray(np.stack(tf32_split(core), axis=2))


def mel_bands(fbanks):
    """The kernel's table of an (F, M) filterbank, int32: for each band
    its bins [lo, hi), which hold every nonzero of its column (lo = hi = 0
    for none), and the index of its first partial sum, one for each chunk
    of 32 bins from lo // 32 through (hi - 1) // 32; then for each chunk
    the first and the last band that meet it (0, -1 for none).  Returns
    (the table, the count of partial sums).

    >>> fb = np.zeros((70, 2), np.float32)
    >>> fb[3:5, 0] = fb[30:40, 1] = 1
    >>> table, count = mel_bands(fb)
    >>> table[:6].reshape(2, 3).tolist(), table[6:].reshape(3, 2).tolist()
    ([[3, 5, 0], [30, 40, 1]], [[0, 1], [1, 1], [0, -1]])
    >>> count
    3
    """
    n_bins, n_mels = fbanks.shape
    chunks = -(-n_bins // BINS)
    per_band = np.zeros((n_mels, 3), np.int32)
    per_chunk = np.tile(np.array([[0, -1]], np.int32), (chunks, 1))
    count = 0
    for m in range(n_mels):
        nonzero = np.flatnonzero(fbanks[:, m])
        per_band[m, 2] = count
        if not len(nonzero):
            continue
        lo, hi = int(nonzero[0]), int(nonzero[-1]) + 1
        per_band[m, :2] = lo, hi
        count += (hi - 1) // BINS - lo // BINS + 1
        for c in range(lo // BINS, (hi - 1) // BINS + 1):
            if per_chunk[c, 1] < 0:
                per_chunk[c, 0] = m
            per_chunk[c, 1] = m
    return np.concatenate([per_band.ravel(), per_chunk.ravel()]), count


def logmel_plan(batch, n_frames, window_length, shift, n_bins, n_partials,
                n_sm, max_smem):
    """The kernel's plan for ``batch`` signals of ``n_frames`` frames on a
    card of ``n_sm`` SMs whose blocks may opt in to ``max_smem`` bytes, or
    None where nothing is to compute.  The whole span of a tile's 64
    frames is staged where it fits; otherwise (a long hop) the signal comes
    a stage's slice at a time (``sliced``; the same operands, the same
    bits).

    Of the cluster sizes (1 ... 16, at most one CTA per chunk), the one
    with the fewest chunks a CTA takes times the waves of CTAs the card
    runs (as many as the shared memory lets each SM hold at once, of an
    SM's 1 KB more than a block may opt in to, less 1 KB a block); of
    equal ones the smaller cluster.  The plan depends on the batch, the
    results do not: every output is the same sum in the same order on
    every plan.

    >>> logmel_plan(8, 66, 512, 128, 257, 78, 132, 232448)[:3]
    (9, 9, 144)
    >>> logmel_plan(16, 503, 512, 128, 257, 78, 132, 232448)[:3]
    (2, 9, 256)
    """
    smem = logmel_smem(window_length, shift, n_partials)
    sliced = smem > max_smem
    if sliced:
        smem = logmel_smem(window_length, shift, n_partials, sliced=True)
    if n_frames < 1 or batch < 1 or smem > max_smem:
        return None
    chunks = -(-n_bins // BINS)
    tiles = batch * -(-n_frames // FRAMES)
    slots = n_sm * ((max_smem + 1024) // (smem + 1024))
    best, best_cost = None, None
    for cs in range(1, min(chunks, MAX_CLUSTER) + 1):
        blocks = tiles * cs
        cost = -(-chunks // cs) * -(-blocks // slots)
        if best_cost is None or cost < best_cost:
            best = LogMelPlan(cs, chunks, blocks, smem, sliced)
            best_cost = cost
    return best



class LogMelFrontend:
    """Callable fused front end: (B, T) audio -> (B, frames, n_mels) log-mel.

    Matches ``STFT(...)(x)`` -> power -> ``MelTransform`` numerics
    (``pad=True``) to float32 accuracy.

    >>> frontend = LogMelFrontend(size=512, shift=128, n_mels=40)
    >>> tuple(frontend(torch.ones(2, 4000)).shape)
    (2, 35, 40)
    """

    def __init__(self, sample_rate=16000, size=512, shift=128,
                 window_length=None, n_mels=64, window='blackman',
                 lowest_frequency=50.0, highest_frequency=None,
                 fading='full'):
        from padertorch_tpu_torch.contrib.je.modules.features import (
            get_fbanks)
        window_length = window_length or size
        if fading not in (None, False, 'full', 'half'):
            raise ValueError(f'unknown fading {fading!r}')
        self.size = size
        self.shift = shift
        self.window_length = window_length
        self.n_mels = n_mels
        self.fading = fading
        w = _get_window(window, False, window_length)
        kernel = get_stft_kernel(size, w)  # (2F, L)
        f = size // 2 + 1
        fb = get_fbanks(
            sample_rate, size, n_mels,
            lowest_frequency=lowest_frequency,
            highest_frequency=highest_frequency).astype(np.float32)
        fb = fb / (fb.sum(-1, keepdims=True) + 1e-6)
        # (L, F) real and imaginary bases and the (F, M) filterbank; for
        # the kernel one (L, 2 * F') basis, F' = F rounded up to the
        # kernel's chunks of 32 bins: [re, im] of bin b at columns 2b and
        # 2b + 1, zeros beyond F, in the kernel's layout (kernel_basis)
        interleaved = np.zeros((window_length, _round_up(f, BINS), 2),
                               np.float32)
        interleaved[:, :f, 0] = kernel[:f].T
        interleaved[:, :f, 1] = kernel[f:].T
        self._bases_np = tuple(
            np.ascontiguousarray(a, dtype=np.float32)
            for a in (kernel[:f].T, kernel[f:].T, fb.T, kernel_basis(
                interleaved.reshape(window_length, -1), window_length)))
        # the mel bands' bin ranges, for the kernel's sparse mel product
        self._bands_np, self.n_partials = mel_bands(fb.T)
        self._bases_on_device = {}
        self._bands_on_device = {}

    def bases_on(self, device):
        """(wr (L, F), wi (L, F), fbanks (F, M), the kernel's basis (see
        :func:`kernel_basis`)) float32 tensors on ``device``, cached per
        device."""
        return tables_on(self._bases_on_device, device,
                         lambda: self._bases_np)

    def bands_on(self, device):
        """The int32 table of :func:`mel_bands` on ``device``, cached per
        device."""
        return tables_on(self._bands_on_device, device,
                         lambda: (self._bands_np,))[0]

    def _pad_widths(self, t):
        """(zeros before, zeros after) the fading pad puts around a signal
        of ``t`` samples (:func:`pad_widths`)."""
        return pad_widths(t, self.window_length, self.shift, self.fading)

    def _as_batch(self, signal):
        if signal.ndim == 1:
            signal = signal[None]
        if signal.ndim != 2:
            raise ValueError(f'audio must be (B, T) or (T,), got '
                             f'{tuple(signal.shape)}')
        return signal.to(torch.float32)

    def _prepare(self, signal):
        """The (B, T) float32 signal with the fading pad."""
        signal = self._as_batch(signal)
        return torch.nn.functional.pad(
            signal, self._pad_widths(signal.shape[-1]))

    def _operands(self, signal):
        """The operator's arguments for a (B, T) float32 ``signal``."""
        wr, wi, fbanks, basis = self.bases_on(signal.device)
        return (signal, wr, wi, fbanks, basis, self.bands_on(signal.device),
                self.window_length, self.shift, self.n_mels,
                self.n_partials, FADINGS.index(self.fading or None))

    def plain(self, signal):
        """The plain PyTorch version of :meth:`__call__`."""
        return _op_plain(*self._operands(self._as_batch(signal)))

    def __call__(self, signal):
        if torch.is_grad_enabled() and signal.requires_grad:
            raise ValueError(
                'fused_logmel is an inference-shaped front end without a '
                'backward: audio that requires a gradient is not taken '
                '(detach it, or use the composed path)')
        return _ops.call(fused_logmel_op,
                         *self._operands(self._as_batch(signal)))

    def _launch(self, signal, out, lo, n_frames, plan, device, stream):
        """One launch on ``plan`` (:func:`logmel_plan`; a test may force
        the other route with ``plan._replace``)."""
        _, _, fbanks, basis = self.bases_on(signal.device)
        return _launch(signal, basis, fbanks, self.bands_on(signal.device),
                       out, lo, n_frames, self.window_length, self.shift,
                       self.n_mels, self.n_partials, plan, device, stream)


def pad_widths(t, window_length, shift, fading):
    """(zeros before, zeros after) the fading pad puts around a signal of
    ``t`` samples: whole frames of ``shift`` and at least one window."""
    lo, hi = _fading_pads(window_length, shift, fading)
    total = t + lo + hi
    if total < window_length:
        hi += window_length - total
    else:
        remainder = (total - window_length) % shift
        if remainder:
            hi += shift - remainder
    return lo, hi


def _fading_pads(window_length, shift, fading):
    """The zeros of the fading alone, before and after."""
    pad = window_length - shift
    if fading == 'full':
        return pad, pad
    if fading == 'half':
        return pad // 2, -(-pad // 2)
    return 0, 0


def _launch(signal, basis, fbanks, bands, out, lo, n_frames, window_length,
            shift, n_mels, n_partials, plan, device, stream):
    b, t = signal.shape
    if plan is None:
        raise ValueError(
            f'fused_logmel has no plan for {n_frames} frames of '
            f'{b} signals: shift={shift}, window_length={window_length}')
    lib = _build.load_library()
    err = lib.fused_logmel_fwd(
        signal.data_ptr(), basis.data_ptr(), fbanks.data_ptr(),
        bands.data_ptr(), out.data_ptr(), b, t, lo, n_frames, window_length,
        fbanks.shape[0], n_mels, n_partials, shift, plan.CS,
        int(plan.sliced), plan.smem, EPS, device, stream)
    _build.check(lib, err, 'fused_logmel kernel')
    fused_logmel.launches += 1
    fused_logmel.routes['sliced' if plan.sliced else 'span'] += 1
    return out


# the ``fading`` values, as the operator's int takes them
FADINGS = (None, 'full', 'half')


def _op_plain(signal: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
              fbanks: torch.Tensor, basis: torch.Tensor, bands: torch.Tensor,
              window_length: int, shift: int, n_mels: int, n_partials: int,
              fading: int) -> torch.Tensor:
    """pad -> frames -> two products -> power -> mel -> log."""
    signal = torch.nn.functional.pad(signal, pad_widths(
        signal.shape[-1], window_length, shift, FADINGS[fading]))
    frames = signal.unfold(-1, window_length, shift)
    real, imag = frames @ wr, frames @ wi
    return torch.log((real * real + imag * imag) @ fbanks + EPS)


def _op_launch(signal, wr, wi, fbanks, basis, bands, window_length, shift,
               n_mels, n_partials, fading):
    signal = signal.contiguous()
    b, t = signal.shape
    lo, hi = pad_widths(t, window_length, shift, FADINGS[fading])
    n_frames = (t + lo + hi - window_length) // shift + 1
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=signal.device)
    stream, device = _build.stream_and_device(signal)
    plan = logmel_plan(b, n_frames, window_length, shift, fbanks.shape[0],
                       n_partials, *device_limits(device))
    return _launch(signal, basis, fbanks, bands, out, lo, n_frames,
                   window_length, shift, n_mels, n_partials, plan, device,
                   stream)


def _op_fake(signal, wr, wi, fbanks, basis, bands, window_length, shift,
             n_mels, n_partials, fading):
    b, t = signal.shape
    lo, hi = _fading_pads(window_length, shift, FADINGS[fading])
    # frames of the padded signal, without a test on a symbolic t:
    # ceil((t + lo + hi - window_length) / shift) + 1, at least 1 (the
    # floor matters only where the fading pads alone are shorter than a
    # window).  One floor division: torch.export can take it as a factor
    # (a (B, frames) to (B * frames) reshape then holds for B = 1 too)
    n_frames = (t + lo + hi - window_length + 2 * shift - 1) // shift
    if lo + hi < window_length:
        n_frames = torch.sym_max(n_frames, 1)
    return signal.new_empty((b, n_frames, n_mels), dtype=torch.float32)


# the front end as ``torch.ops.ptt.fused_logmel(signal (B, T) float32, wr,
# wi, fbanks, basis, bands, window_length, shift, n_mels, n_partials,
# fading)`` (the tables of ``LogMelFrontend.bases_on`` and ``bands_on``;
# ``fading`` an index of FADINGS) -> (B, frames, n_mels)
fused_logmel_op = _ops.define('fused_logmel', _op_plain, _op_launch,
                              _op_fake)


def fused_logmel(signal, **kwargs):
    """One-shot helper: ``LogMelFrontend(**kwargs)(signal)``.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (or raise).
    ``fused_logmel.launches`` counts the launches (of this helper and of
    every :class:`LogMelFrontend`), ``fused_logmel.routes`` them by route
    (``span``, ``sliced``)."""
    return LogMelFrontend(**kwargs)(signal)


def fused_logmel_plain(signal, **kwargs):
    """Plain PyTorch version of :func:`fused_logmel` (same contract)."""
    return LogMelFrontend(**kwargs).plain(signal)


fused_logmel.launches = 0
fused_logmel.routes = {'span': 0, 'sliced': 0}
