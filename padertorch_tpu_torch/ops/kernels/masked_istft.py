"""Fused mask multiply + inverse STFT.

Counterpart of ``padertorch_tpu/ops/pallas/masked_istft.py``
``masked_istft``.  On CUDA tensors :func:`masked_istft` launches the
hand-written kernel of ``csrc/masked_istft.cu``; on CPU tensors it runs
:func:`masked_istft_plain`: mask times spectrogram, the full-spectrum
mirror, a matmul with the iSTFT kernels and an overlap-add.
"""
import numpy as np
import torch

from padertorch_tpu_torch.ops.kernels import _build

__all__ = ['masked_istft', 'masked_istft_plain']


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


def _synthesis(stft, device):
    """Interleaved (F, L, 2) onesided synthesis matrices on ``device``,
    cached on the stft object."""
    cache = stft.__dict__.setdefault('_synthesis_on_device', {})
    if device not in cache:
        sr, si = _fold_onesided(*stft._istft_kernel_np, stft.size)
        cache[device] = torch.from_numpy(
            np.stack([sr, si], axis=-1)).to(device)
    return cache[device]


def _launch(re, im, mask, stft):
    n, tf, f = re.shape
    shift = stft.shift
    ratio = stft.window_length // shift
    s_ri = _synthesis(stft, re.device)
    if s_ri.shape[0] != f:
        raise ValueError(f'{f} frequency bins, the stft has '
                         f'{s_ri.shape[0]}')
    n_out = n if mask is None else mask.shape[0]
    out = torch.empty((n_out, (tf + ratio - 1) * shift),
                      dtype=torch.float32, device=re.device)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(re)
    err = lib.masked_istft_fwd(
        re.data_ptr(), im.data_ptr(),
        None if mask is None else mask.data_ptr(), s_ri.data_ptr(),
        out.data_ptr(), n_out, n, tf, f, shift, ratio, device, stream)
    _build.check(lib, err, 'masked_istft kernel')
    masked_istft.launches += 1
    return out


def _rows_plain(re, im, mask, stft):
    from padertorch_tpu_torch.ops._stft import istft_rows
    if mask is not None:
        reps = mask.shape[0] // re.shape[0]
        re = re.repeat(reps, 1, 1) * mask
        im = im.repeat(reps, 1, 1) * mask
    return istft_rows(re, im, stft)


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
        kernel (or raise).
    """
    _check_geometry(stft)
    re, im, mask, lead = _split(stft_signal, mask, stft)
    if mask is not None and mask.device != re.device:
        raise ValueError(f'mask on {mask.device}, spectrogram on '
                         f'{re.device}')
    if re.device.type == 'cpu':
        rows = _rows_plain(re, im, mask, stft)
    elif re.device.type == 'cuda':
        rows = _launch(re, im, mask, stft)
    else:
        raise ValueError(f'no kernel for device {re.device}')
    return stft.crop_fading(rows.reshape(*lead, rows.shape[-1]))


def masked_istft_plain(stft_signal, mask=None, *, stft):
    """Plain PyTorch version of :func:`masked_istft` (same contract)."""
    _check_geometry(stft)
    re, im, mask, lead = _split(stft_signal, mask, stft)
    rows = _rows_plain(re, im, mask, stft)
    return stft.crop_fading(rows.reshape(*lead, rows.shape[-1]))


masked_istft.launches = 0
