"""Helpers that make review dicts and convert tensorboard payloads.

Counterpart of ``padertorch_tpu/summary/tbx_utils.py`` (reference
``padertorch/summary/tbx_utils.py``): dB-scaled spectrogram images, mask
images and ``review_dict``.  Images are grayscale: the colormaps of the
JAX package come from matplotlib, which the port does not import.
``audio`` normalises a signal for the event writer's ``add_audio``; the
``figure`` helpers wait for ``add_figure``.
"""
import operator
from typing import Optional, Tuple

import numpy as np
import torch


def _to_numpy_float(x):
    """Host array for the image conversion; low-precision floats (which
    numpy cannot hold or does not treat as inexact) -> float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    x = np.asarray(x)
    if x.dtype.name == 'float16':
        x = x.astype(np.float32)
    return x

__all__ = [
    'mask_to_image',
    'stft_to_image',
    'spectrogram_to_image',
    'review_dict',
    'audio',
]


def _remove_batch_axis(array, batch_first, ndim=2):
    if array.ndim == ndim:
        pass
    elif array.ndim == ndim + 1:
        if batch_first is True:
            array = array[0]
        elif batch_first is False:
            array = array[:, 0]
        elif batch_first is None:
            raise ValueError(
                '"remove batch axis" is disabled (batch_first=None) but '
                f'the array still has a batch axis. Shape: {array.shape}')
    else:
        raise ValueError(
            f'Either the signal has ndim {ndim} or {ndim + 1}', array.shape)
    return array


def _apply_origin(image, origin):
    """origin='lower' flips the feature axis (for speech usually lower)."""
    assert origin in ['upper', 'lower'], origin
    if origin == 'lower':
        image = image[..., ::-1, :]
    return image


def _colorize(image, color):
    """(features, frames) -> (1, features, frames): one gray channel.

    The JAX package maps ``color`` through a matplotlib colormap where
    matplotlib is installed and falls back to grayscale where it is not.
    The port never imports matplotlib, so its images are the same on
    every machine; ``color`` is accepted and not used.

    >>> print(_colorize(np.arange(6).reshape([2, 3]), 'viridis'))
    [[[0 1 2]
      [3 4 5]]]
    """
    del color
    return image[None, :, :]


def mask_to_image(mask, batch_first: bool = False,
                  color: Optional[str] = None,
                  origin: str = 'lower') -> np.ndarray:
    """Image (color, features, frames) from a [0, 1] mask (frames, feats).

    >>> mask_to_image(np.random.uniform(size=(10, 4))).shape
    (1, 4, 10)
    """
    mask = _to_numpy_float(mask)
    clipped = np.sum((mask < 0) | (mask > 1))
    if clipped:
        import warnings
        warnings.warn(
            f'Mask value passed to mask_to_image out of range ([0, 1])! '
            f'{clipped} values are clipped!')
    image = np.clip(mask * 255, 0, 255).astype(np.uint8)
    image = _remove_batch_axis(image, batch_first=batch_first)
    return _colorize(_apply_origin(image.T, origin), color)


def stft_to_image(signal, batch_first: bool = False, color: str = 'viridis',
                  origin: str = 'lower',
                  visible_dB: float = 50) -> np.ndarray:
    """Image from an STFT signal (frames, features), magnitude or complex.

    >>> data = [1, 0.004, 0.003, 0.00105, 0.001]
    >>> np.squeeze(stft_to_image(
    ...     np.array(data)[:, None], color=None)).tolist()
    [255, 10, 0, 0, 0]
    >>> np.squeeze(stft_to_image(
    ...     np.array(data)[:, None], color=None, visible_dB=60)).tolist()
    [255, 51, 40, 1, 0]
    """
    signal = _to_numpy_float(signal)
    return spectrogram_to_image(
        signal.real ** 2 + signal.imag ** 2,
        batch_first=batch_first, color=color, origin=origin,
        visible_dB=visible_dB)


def spectrogram_to_image(signal, batch_first: bool = False,
                         color: str = 'viridis', origin: str = 'lower',
                         log: bool = True,
                         visible_dB: float = 50) -> np.ndarray:
    """Image from a power spectrogram; log scale shows ``visible_dB`` dB."""
    signal = _to_numpy_float(signal)
    signal = signal / (np.max(np.abs(signal))
                       + np.finfo(np.asarray(signal).dtype).tiny)
    signal = _remove_batch_axis(signal, batch_first=batch_first)
    if log:
        floor = 10 ** (-visible_dB / 10)
        signal = np.maximum(signal, floor)
        signal = (10 / visible_dB) * np.log10(signal) + 1
    signal = (signal * 255).astype(np.uint8)
    return _colorize(_apply_origin(signal.T, origin=origin), color)


def audio(signal, sampling_rate: int = 16000, batch_first: bool = False,
          normalize: bool = True) -> Tuple[np.ndarray, int]:
    """(signal, sampling_rate) tuple, normalized to 0.95 peak.

    >>> sig, sr = audio(np.array([0.0, 0.5, -0.25]))
    >>> sr, float(np.abs(sig).max())
    (16000, 0.95)
    >>> audio(torch.tensor([[0.0, 2.0]], dtype=torch.float64), 8000,
    ...       batch_first=True)[0].tolist()
    [0.0, 0.95]
    """
    signal = _to_numpy_float(signal)
    if signal.dtype.kind == 'c':
        raise ValueError(
            f'Complex dtype ({signal.dtype}) is not supported for audio.')
    signal = _remove_batch_axis(signal, batch_first=batch_first, ndim=1)
    if normalize:
        denominator = np.max(np.abs(signal))
        if denominator > 0:
            signal = signal / denominator * 0.95
    return signal, sampling_rate


def review_dict(
        *,
        loss=None,
        losses: dict = None,
        scalars: dict = None,
        histograms: dict = None,
        audios: dict = None,
        images: dict = None,
        figures: dict = None,
        texts: dict = None,
):
    """Typed helper to build a review dict (exactly one of loss/losses)."""
    review = locals()
    for k, v in list(review.items()):
        if v is None:
            del review[k]
    assert operator.xor(loss is None, losses is None), (loss, losses)
    return review
