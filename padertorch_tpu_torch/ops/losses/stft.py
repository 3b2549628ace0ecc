"""STFT-domain reconstruction losses for waveform generators.

Counterpart of ``padertorch_tpu/ops/losses/stft.py``: spectral convergence
and log-STFT-magnitude (Parallel WaveGAN, Yamamoto et al. 2020), at several
STFT resolutions, on the port's windowed-DFT matmul STFT
(``ops/_stft.py``).  The analysis operators are built once per resolution
and kept (their kernels are cached per device).
"""
import functools

import torch

from padertorch_tpu_torch.ops._stft import STFT

__all__ = [
    'spectral_convergence_loss',
    'log_stft_magnitude_loss',
    'stft_magnitude_loss',
    'multi_resolution_stft_loss',
]


@functools.lru_cache(maxsize=32)
def _stft(size, shift, window, window_length):
    return STFT(size=size, shift=shift, window=window,
                window_length=window_length, fading=None,
                complex_representation='concat')


def _magnitude(signal, stft, eps):
    """|STFT| of a batch of waveforms: [..., T] -> [..., frames, bins]."""
    real, imag = torch.chunk(stft(signal), 2, dim=-1)
    return torch.sqrt(torch.square(real) + torch.square(imag) + eps)


def spectral_convergence_loss(estimate_mag, target_mag, eps=1e-7):
    """|| |T| - |E| ||_F / || |T| ||_F over the last two axes."""
    num = torch.sqrt(torch.sum(
        torch.square(target_mag - estimate_mag), dim=(-2, -1)) + eps)
    den = torch.sqrt(torch.sum(torch.square(target_mag), dim=(-2, -1)) + eps)
    return torch.mean(num / den)


def log_stft_magnitude_loss(estimate_mag, target_mag, eps=1e-7):
    """Mean L1 distance between log magnitudes."""
    return torch.mean(torch.abs(
        torch.log(target_mag + eps) - torch.log(estimate_mag + eps)))


def stft_magnitude_loss(estimate, target, *, size=1024, shift=256,
                        window_length=None, window='hann', eps=1e-7):
    """Single-resolution STFT loss: spectral convergence + log magnitude.

    Args:
        estimate, target: waveforms ``[..., T]`` (shapes must match).

    Returns:
        ``(sc_loss, mag_loss)`` pair of scalars.

    >>> import numpy as np
    >>> x = torch.from_numpy(np.random.RandomState(0).randn(2, 4000))
    >>> sc, mag = stft_magnitude_loss(x, x)
    >>> bool(sc < 1e-3), bool(mag < 1e-3)
    (True, True)
    """
    stft = _stft(size, shift, window, window_length or size)
    est = _magnitude(estimate, stft, eps)
    tgt = _magnitude(target, stft, eps)
    return (spectral_convergence_loss(est, tgt, eps),
            log_stft_magnitude_loss(est, tgt, eps))


def multi_resolution_stft_loss(
        estimate, target, *,
        sizes=(1024, 2048, 512),
        shifts=(120, 240, 50),
        window_lengths=(600, 1200, 240),
        window='hann',
        eps=1e-7,
):
    """Multi-resolution STFT loss (Parallel WaveGAN eq. 4-6 defaults): the
    single-resolution losses averaged over the resolutions; returns the
    sum of the averaged spectral convergence and log-magnitude terms.

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> x = torch.from_numpy(rng.randn(2, 4000).astype('float32'))
    >>> y = torch.from_numpy(rng.randn(2, 4000).astype('float32'))
    >>> float(multi_resolution_stft_loss(x, x)) < 1e-3
    True
    >>> float(multi_resolution_stft_loss(x, y)) > 0.5
    True
    """
    assert len(sizes) == len(shifts) == len(window_lengths), (
        sizes, shifts, window_lengths)
    sc_total = 0.0
    mag_total = 0.0
    for size, shift, wl in zip(sizes, shifts, window_lengths):
        sc, mag = stft_magnitude_loss(
            estimate, target, size=size, shift=shift,
            window_length=wl, window=window, eps=eps)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(sizes)
    return sc_total / n + mag_total / n
