"""Fused mask multiply + inverse STFT.

Counterpart of ``padertorch_tpu/ops/pallas/masked_istft.py``
``masked_istft``.  On CUDA tensors :func:`masked_istft` launches the
hand-written kernel of ``csrc/masked_istft.cu`` on one of two routes,
chosen from the geometry before the launch (:func:`route`):

- ``fft`` (a power-of-two size from 16 to 8192, ``window_length <=
  size``): each frame's segment as a shared-memory inverse real FFT, the
  window and the overlap-add fused, on the plan of :func:`fft_plan`;
- ``dft`` (every other size): the direct synthesis product against the
  folded onesided matrices, bins staged in chunks (:func:`dft_plan`).

``masked_istft.routes`` counts launches by route.  On CPU tensors it runs
:func:`masked_istft_plain`: mask times spectrogram, the full-spectrum
mirror, a matmul with the iSTFT kernels and an overlap-add.
"""
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from padertorch_tpu_torch.ops._stft import synthesis_rows, tables_on
from padertorch_tpu_torch.ops.kernels import _build, _ops
from padertorch_tpu_torch.ops.kernels.gru import device_limits

__all__ = ['masked_istft', 'masked_istft_plain', 'route', 'fft_plan',
           'dft_plan', 'FftPlan', 'DftPlan', 'masked_istft_op']

# the fft route's sizes, and its kernel's limits (csrc/masked_istft.cu):
# threads a block, output rows a block owns at most
FFT_MIN_SIZE, FFT_MAX_SIZE = 16, 8192
FFT_MAX_THREADS = 256
FFT_MAX_ROWS = 32
# the dft route's output rows a block (``DFT_ROWS`` in the kernel) and
# threads a block at most
DFT_ROWS = 16
DFT_MAX_THREADS = 256


class FftPlan(NamedTuple):
    """How the fft route divides a launch: ``rows`` output rows a block
    owns, ``frames`` frames a block transforms at once, ``per_thread``
    complex values a thread holds in a pass (4, 8 or 16), ``threads``
    (``frames * size / 2 / per_thread``), ``blocks`` and ``smem`` bytes."""
    rows: int
    frames: int
    per_thread: int
    threads: int
    blocks: int
    smem: int


class DftPlan(NamedTuple):
    """How the dft route divides a launch: ``chunk`` bins staged in shared
    memory at a time, ``threads``, ``blocks`` (tiles of ``DFT_ROWS``
    output rows) and ``smem`` bytes."""
    chunk: int
    threads: int
    blocks: int
    smem: int


def _round_up(x, to):
    return -(-x // to) * to


def route(size, window_length):
    """``'fft'`` for a power-of-two ``size`` from 16 to 8192 whose window
    fits in it, else ``'dft'``."""
    power = size & (size - 1) == 0
    if (power and FFT_MIN_SIZE <= size <= FFT_MAX_SIZE
            and window_length <= size):
        return 'fft'
    return 'dft'


def fft_smem(size, shift, rows, frames):
    """Bytes of shared memory the fft route needs: the owned rows' sums
    (``rows * shift`` floats, rounded up to 4) and one buffer of size / 2
    complex values a frame, one pad value every 16."""
    m = size // 2
    return 4 * _round_up(rows * shift, 4) + 8 * frames * (m + m // 16)


@functools.lru_cache(maxsize=1024)
def fft_plan(n_signals, n_frames, size, shift, ratio, n_sm, max_smem):
    """The fft route's plan for ``n_signals`` signal rows of ``n_frames``
    frames on a card of ``n_sm`` SMs whose blocks may opt in to
    ``max_smem`` bytes, or None where no plan fits.

    A thread holds 4 values of the size / 2-point transform up to 1024
    points (8 at 2048, 16 at 4096), so a frame takes at most 256 threads;
    a block transforms as many frames at once as 256 threads hold, evened
    out over the groups a tile needs.  The rows a block owns are the most
    (32, 16, ..., 1) that still give the grid a block for every SM; where
    even one row a block does not, one row.  A block transforms ``rows +
    ratio - 1`` frames, so fewer rows repeat more of the transforms at the
    tiles' edges: the price of filling the card at a few signals, as the
    uPIT request's two.
    """
    m = size // 2
    per_thread = 4 if m <= 1024 else m // FFT_MAX_THREADS
    per_frame = m // per_thread
    at_once = max(1, FFT_MAX_THREADS // per_frame)
    n_rows = n_frames + ratio - 1
    fallback = None
    rows = FFT_MAX_ROWS
    while rows >= 1:
        need = max(1, min(rows + ratio - 1, n_frames))
        frames = -(-need // -(-need // at_once))   # even groups
        smem = fft_smem(size, shift, rows, frames)
        if smem <= max_smem:
            plan = FftPlan(rows, frames, per_thread, frames * per_frame,
                           n_signals * -(-n_rows // rows), smem)
            if plan.blocks >= n_sm:
                return plan
            fallback = plan
        rows //= 2
    return fallback


@functools.lru_cache(maxsize=1024)
def dft_plan(n_signals, n_frames, n_bins, shift, ratio, max_smem):
    """The dft route's plan: tiles of ``DFT_ROWS`` output rows, their
    ``DFT_ROWS + ratio - 1`` frames' masked bins staged in shared memory
    in chunks of as many bins as ``max_smem`` bytes hold (all of them
    where they fit), one thread per sample position up to 256; or None
    where not one bin fits."""
    frames = DFT_ROWS + ratio - 1
    chunk = min(n_bins, max_smem // (8 * frames))
    if chunk < 1:
        return None
    n_rows = n_frames + ratio - 1
    return DftPlan(chunk, min(DFT_MAX_THREADS, _round_up(shift, 32)),
                   n_signals * -(-n_rows // DFT_ROWS), 8 * frames * chunk)


def _fold_onesided(k_real, k_imag, size):
    """Fold the full-spectrum iSTFT kernels to onesided synthesis
    matrices: bins 1..size/2-1 also appear (conjugated) at channel
    size-f, so their rows fold in with the imag part negated."""
    f = size // 2 + 1
    sr = np.asarray(k_real, np.float64)[:f].copy()
    si = np.asarray(k_imag, np.float64)[:f].copy()
    sr[1:size // 2] += np.asarray(k_real)[size - 1:size // 2:-1]
    si[1:size // 2] -= np.asarray(k_imag)[size - 1:size // 2:-1]
    return sr.astype(np.float32), si.astype(np.float32)


def fft_tables(stft):
    """The fft route's tables as float32 numpy arrays, from float64 and
    rounded once: the twiddles ``e^{2 pi i q / size}``, q < size, as
    (size, 2) (cos, sin), and the synthesis window (window_length,): the
    biorthogonal window over size, the stft's synthesis kernel at bin 0."""
    q = np.arange(stft.size)
    angle = 2 * np.pi * q / stft.size
    twiddles = np.stack([np.cos(angle), np.sin(angle)], -1)
    window = np.asarray(stft._istft_kernel_np[0], np.float64)[0]
    return twiddles.astype(np.float32), window.astype(np.float32)


# the card's limits, asked once per device (the plans are cached too): at
# a small shape an eager call's time is the host's work
_device_limits = functools.lru_cache(maxsize=None)(device_limits)


def _check_geometry(stft):
    if stft.window_length % stft.shift:
        raise ValueError(
            'the fused kernel requires shift | window_length; got '
            f'{stft.window_length} % {stft.shift} — use stft.inverse')
    if stft.window_length == stft.shift:
        raise ValueError(
            'no frame overlap (window_length == shift) — the kernel '
            'needs overlapping frames; use stft.inverse')


def _split(stft_signal, mask, stft):
    """-> re, im as (N_spec, frames, F) and mask as (N, frames, F), float32
    contiguous, and the lead shape of the result.  Signal row n reads
    spectrogram row n % N_spec: where the mask only adds leading axes
    (per-source masks on one mixture) the spectrogram is kept once, not
    broadcast; otherwise all three are broadcast to the full shape."""
    rep = stft.complex_representation
    if rep == 'stacked':
        re, im = stft_signal[..., 0], stft_signal[..., 1]
    elif rep == 'concat':
        re, im = torch.chunk(stft_signal, 2, dim=-1)
    else:
        re, im = stft_signal.real, stft_signal.imag
    lead = re.shape[:-2]
    if mask is not None:
        full = torch.broadcast_shapes(re.shape, mask.shape)
        lead = full[:-2]
        spec_lead = list(re.shape[:-2])
        while spec_lead and spec_lead[0] == 1:
            spec_lead.pop(0)
        leading_only = (
            re.shape[-2:] == full[-2:]
            and tuple(full[len(full) - 2 - len(spec_lead):-2])
            == tuple(spec_lead))
        if not leading_only:
            re, im = re.broadcast_to(full), im.broadcast_to(full)
        mask = mask.broadcast_to(full)
    tf, f = re.shape[-2:]

    def rows(x):
        return x.to(torch.float32).reshape(-1, tf, f).contiguous()

    return rows(re), rows(im), None if mask is None else rows(mask), lead


def _on_device(stft, name, make, device):
    """``make()``'s numpy arrays as tensors on ``device``, cached on the
    stft object under ``name``."""
    return tables_on(stft.__dict__.setdefault(name, {}), device, make)


def _geometry(size, shift, window_length, n_out, tf):
    return (f'size {size}, shift {shift}, window_length {window_length}, '
            f'{n_out} signal rows of {tf} frames')


def _tables(stft, which, device):
    """The ``which`` route's tables on ``device``: the twiddles and the
    synthesis window (``fft``), or the folded synthesis matrices as one
    (F, L, 2) tensor (``dft``); cached on the stft object."""
    if which == 'fft':
        return _on_device(stft, '_fft_tables_on_device',
                          lambda: fft_tables(stft), device)
    return _on_device(
        stft, '_synthesis_on_device',
        lambda: [np.stack(_fold_onesided(*stft._istft_kernel_np, stft.size),
                          axis=-1)],
        device)


def _launch(re, im, mask, stft, plan=None, fast_twiddles=False):
    """Launch the kernel on the route of ``plan`` (by default
    :func:`route` and its planner's plan).  ``fast_twiddles`` takes the
    fft route's twiddles from ``__sincosf`` (a measurement control)."""
    which = ('dft' if isinstance(plan, DftPlan)
             else route(stft.size, stft.window_length))
    return _launch_rows(re, im, mask, _tables(stft, which, re.device),
                        stft.size, stft.shift, stft.window_length, which,
                        plan, fast_twiddles)


def _launch_rows(re, im, mask, tables, size, shift, window_length, which,
                 plan=None, fast_twiddles=False):
    n_spec, tf, f = re.shape
    ratio = window_length // shift
    if f != size // 2 + 1:
        raise ValueError(f'{f} frequency bins, the stft has '
                         f'{size // 2 + 1}')
    n_out = n_spec if mask is None else mask.shape[0]
    geometry = _geometry(size, shift, window_length, n_out, tf)
    out = torch.empty((n_out, (tf + ratio - 1) * shift),
                      dtype=torch.float32, device=re.device)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(re)
    n_sm, max_smem = _device_limits(device)
    if which == 'fft':
        plan = plan or fft_plan(n_out, tf, size, shift, ratio, n_sm,
                                max_smem)
    elif isinstance(plan, FftPlan):
        raise ValueError(f'the fft route does not take {geometry}')
    else:
        plan = plan or dft_plan(n_out, tf, f, shift, ratio, max_smem)
    if plan is None:
        raise ValueError(f'masked_istft: no {which} plan for {geometry} in '
                         f'{max_smem} bytes of shared memory a block')
    mask_ptr = None if mask is None else mask.data_ptr()
    if which == 'fft':
        twiddles, window = tables
        err = lib.masked_istft_fft(
            re.data_ptr(), im.data_ptr(), mask_ptr, twiddles.data_ptr(),
            window.data_ptr(), out.data_ptr(), n_out, n_spec, tf,
            size // 2, shift, ratio, plan.rows, plan.frames,
            plan.per_thread, plan.smem, int(fast_twiddles), device, stream)
    else:
        s_ri, = tables
        err = lib.masked_istft_dft(
            re.data_ptr(), im.data_ptr(), mask_ptr, s_ri.data_ptr(),
            out.data_ptr(), n_out, n_spec, tf, f, shift, ratio, plan.chunk,
            plan.threads, plan.smem, device, stream)
    _build.check(lib, err, f'masked_istft kernel ({which} route, '
                 f'{geometry})')
    masked_istft.launches += 1
    masked_istft.routes[which] += 1
    return out


def _rows_plain(re, im, mask, k_real, k_imag, shift):
    if mask is not None:
        reps = mask.shape[0] // re.shape[0]
        re = re.repeat(reps, 1, 1) * mask
        im = im.repeat(reps, 1, 1) * mask
    return synthesis_rows(re, im, k_real, k_imag, shift)


def _operands(re, im, mask, stft):
    """The operator's arguments (see :data:`masked_istft_op`)."""
    k_real, k_imag = stft.kernels_on(re.device)[1:]
    tables = _tables(stft, route(stft.size, stft.window_length), re.device)
    return (re, im, mask, k_real, k_imag, list(tables), stft.size,
            stft.shift, stft.window_length)


def masked_istft(stft_signal, mask=None, *, stft):
    """``stft.inverse(stft_signal * mask)`` as one fused kernel.

    Args:
        stft_signal: STFT frames, layout per
            ``stft.complex_representation``: ``(..., frames, F, 2)``
            stacked, ``(..., frames, 2 F)`` concat or ``(..., frames, F)``
            complex.
        mask: optional real mask, broadcastable to ``(..., frames, F)``
            (e.g. per-source masks with an extra leading axis).
        stft: the :class:`padertorch_tpu_torch.ops.STFT` whose
            ``inverse`` this fuses (window, shift, fading).

    Returns:
        Time signal, float32, of the shape ``stft.inverse`` gives.  CPU
        tensors run :func:`masked_istft_plain`; CUDA tensors launch the
        kernel (or raise).  The synthesis is the custom operator
        ``torch.ops.ptt.masked_istft`` (``ops/kernels/_ops.py``), which
        ``torch.export`` records.
    """
    _check_geometry(stft)
    re, im, mask, lead = _split(stft_signal, mask, stft)
    if mask is not None and mask.device != re.device:
        raise ValueError(f'mask on {mask.device}, spectrogram on '
                         f'{re.device}')
    rows = _ops.call(masked_istft_op, *_operands(re, im, mask, stft))
    return stft.crop_fading(rows.reshape(*lead, rows.shape[-1]))


def masked_istft_plain(stft_signal, mask=None, *, stft):
    """Plain PyTorch version of :func:`masked_istft` (same contract)."""
    _check_geometry(stft)
    re, im, mask, lead = _split(stft_signal, mask, stft)
    rows = _op_plain(*_operands(re, im, mask, stft))
    return stft.crop_fading(rows.reshape(*lead, rows.shape[-1]))


def _op_plain(re: torch.Tensor, im: torch.Tensor,
              mask: Optional[torch.Tensor], k_real: torch.Tensor,
              k_imag: torch.Tensor, tables: list[torch.Tensor], size: int,
              shift: int, window_length: int) -> torch.Tensor:
    return _rows_plain(re, im, mask, k_real, k_imag, shift)


def _op_launch(re, im, mask, k_real, k_imag, tables, size, shift,
               window_length):
    # an exported graph drops a ``.contiguous()`` that was a no-op at the
    # traced shapes, so the operator takes any strides
    re, im = re.contiguous(), im.contiguous()
    mask = None if mask is None else mask.contiguous()
    return _launch_rows(re, im, mask, tables, size, shift, window_length,
                        route(size, window_length))


def _op_fake(re, im, mask, k_real, k_imag, tables, size, shift,
             window_length):
    n_out = re.shape[0] if mask is None else mask.shape[0]
    samples = (re.shape[1] + window_length // shift - 1) * shift
    return re.new_empty((n_out, samples), dtype=torch.float32)


# the synthesis as ``torch.ops.ptt.masked_istft(re, im, mask (or None),
# k_real, k_imag, tables, size, shift, window_length)`` on the rows of
# ``_split`` (signal row n reads spectrogram row n % N_spec) -> (rows,
# samples) before the fading crop; ``k_real``, ``k_imag``: the stft's
# synthesis kernels (the CPU implementation's), ``tables``: the kernel's
# route's (:func:`_tables`)
masked_istft_op = _ops.define('masked_istft', _op_plain, _op_launch,
                              _op_fake)


masked_istft.launches = 0
masked_istft.routes = {'fft': 0, 'dft': 0}
