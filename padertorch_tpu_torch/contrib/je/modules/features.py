"""Mel/log-mel feature extraction.

Counterpart of ``padertorch_tpu/contrib/je/modules/features.py`` (reference
``padertorch/contrib/je/modules/features.py``): ``MelTransform`` (HTK or
Slaney mel triangular filterbank as one matmul, invertible),
``NormalizedLogMelExtractor`` (mel + log + input normalization + optional
deltas + SpecAugment-style masking), ``DeltaExtractor`` (Savitzky-Golay
deltas as a depthwise conv) and ``FusedAudioLogMelExtractor`` (raw audio ->
normalized log-mel on the model's device, through the fused kernel of
``ops/kernels/logmel.py`` on a CUDA tensor).
"""
from typing import Optional

import numpy as np
import torch

from padertorch_tpu_torch.modules.normalization import (
    Normalization, InputNormalization,
)

__all__ = [
    'get_fbanks',
    'MelTransform',
    'NormalizedLogMelExtractor',
    'FusedAudioLogMelExtractor',
    'DeltaExtractor',
    'hz2mel',
    'mel2hz',
]


def hz2mel(f, htk_mel=True):
    """Convert Hz to mel (HTK or Slaney convention).

    >>> round(float(hz2mel(1000.)), 1)
    1000.0
    """
    f = np.asarray(f, dtype=np.float64)
    if htk_mel:
        return 2595.0 * np.log10(1 + f / 700.0)
    # Slaney: linear below 1 kHz
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mel,
    )


def mel2hz(m, htk_mel=True):
    m = np.asarray(m, dtype=np.float64)
    if htk_mel:
        return 700.0 * (10 ** (m / 2595.0) - 1)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel,
        min_log_hz * np.exp(logstep * (m - min_log_mel)),
        m * f_sp,
    )


def get_fbanks(sample_rate, stft_size, number_of_filters,
               lowest_frequency=50.0, highest_frequency=None, htk_mel=True):
    """Triangular mel filterbank, shape (number_of_filters, stft_size//2+1).

    (Native replacement for ``paderbox.transform.module_fbank.get_fbanks``.)

    >>> fb = get_fbanks(16000, 512, 40)
    >>> fb.shape
    (40, 257)
    >>> bool((fb >= 0).all())
    True
    """
    if highest_frequency is None:
        highest_frequency = sample_rate / 2
    elif highest_frequency < 0:
        highest_frequency = sample_rate / 2 + highest_frequency
    n_bins = stft_size // 2 + 1
    freqs = np.linspace(0, sample_rate / 2, n_bins)
    mel_edges = np.linspace(
        hz2mel(lowest_frequency, htk_mel),
        hz2mel(highest_frequency, htk_mel),
        number_of_filters + 2,
    )
    hz_edges = mel2hz(mel_edges, htk_mel)
    lower = hz_edges[:-2][:, None]
    center = hz_edges[1:-1][:, None]
    upper = hz_edges[2:][:, None]
    up_ramp = (freqs[None, :] - lower) / np.maximum(center - lower, 1e-10)
    down_ramp = (upper - freqs[None, :]) / np.maximum(upper - center, 1e-10)
    fbanks = np.maximum(0.0, np.minimum(up_ramp, down_ramp))
    return fbanks.astype(np.float64)


def _normalized_fbanks(sample_rate, stft_size, number_of_filters,
                       lowest_frequency, highest_frequency, htk_mel=True):
    """(F, M) float32 filterbank, each filter normalised by its sum."""
    fbanks = get_fbanks(
        sample_rate=sample_rate, stft_size=stft_size,
        number_of_filters=number_of_filters,
        lowest_frequency=lowest_frequency,
        highest_frequency=highest_frequency, htk_mel=htk_mel,
    ).astype(np.float32)
    fbanks = fbanks / (fbanks.sum(axis=-1, keepdims=True) + 1e-6)
    return torch.from_numpy(np.ascontiguousarray(fbanks.T))


class MelTransform(torch.nn.Module):
    """Linear power spectrogram (..., frames, F) -> (log) mel (..., frames, M).

    Reference parity: ``contrib/je/modules/features.py:214``.

    >>> mel = MelTransform(16000, 512, 40)
    >>> spec = torch.ones((3, 1, 100, 257))
    >>> tuple(mel(spec).shape)
    (3, 1, 100, 40)
    >>> tuple(mel.inverse(mel(spec)).shape)
    (3, 1, 100, 257)
    """

    def __init__(
            self,
            sample_rate: int,
            stft_size: int,
            number_of_filters: int,
            lowest_frequency: Optional[float] = 50.0,
            highest_frequency: Optional[float] = None,
            htk_mel=True,
            log: bool = True,
            eps=1e-12,
    ):
        super().__init__()
        self.sample_rate = sample_rate
        self.stft_size = stft_size
        self.number_of_filters = number_of_filters
        self.lowest_frequency = lowest_frequency
        self.highest_frequency = highest_frequency
        self.htk_mel = htk_mel
        self.log = log
        self.eps = eps
        self.register_buffer('fbanks', _normalized_fbanks(
            sample_rate, stft_size, number_of_filters, lowest_frequency,
            highest_frequency, htk_mel))  # (F, M)

    def forward(self, x):
        x = x @ self.fbanks
        if self.log:
            x = torch.log(x + self.eps)
        return x

    def inverse(self, x):
        """Pseudo-inverse of the filterbank transform."""
        ifbanks = self.fbanks.T  # (M, F)
        ifbanks = ifbanks / (ifbanks.sum(dim=-2, keepdim=True) + 1e-6)
        if self.log:
            x = torch.exp(x)
        return torch.clamp(x @ ifbanks, min=0.0)


class DeltaExtractor(torch.nn.Module):
    """Savitzky-Golay delta features over the time axis of (B, C, M, T).

    Reference parity: ``contrib/je/modules/features.py:341``.
    """

    def __init__(self, width=5, order=1):
        super().__init__()
        from scipy.signal import savgol_coeffs
        self.width = width
        self.order = order
        coeffs = savgol_coeffs(width, order, deriv=order, delta=1.0)
        self.register_buffer(
            'coeffs', torch.from_numpy(coeffs[::-1].copy()).float())

    def forward(self, x, seq_len=None):
        b, c, m, t = x.shape
        pad = self.width // 2
        xp = torch.nn.functional.pad(
            x.reshape(b * c, 1, m, t), (pad, pad, 0, 0), mode='replicate')
        y = torch.nn.functional.conv2d(
            xp, self.coeffs.reshape(1, 1, 1, -1).to(x.dtype))
        return y.reshape(b, c, m, t)


def _spec_augment(y, generator, n_time_masks, max_masked_time_steps,
                  max_masked_time_rate, n_frequency_masks,
                  max_masked_frequency_bands, max_masked_frequency_rate):
    """SpecAugment-style time/frequency masking of (B, C, M, T): per
    example and mask a width in [0, max] and an onset, drawn from
    ``generator`` (a CPU ``torch.Generator``, or None for the global one)."""
    b, c, m, t = y.shape

    def draw(high):
        return torch.randint(0, high, (b, 1, 1, 1),
                             generator=generator).to(y.device)

    max_t = min(max_masked_time_steps, int(t * max_masked_time_rate))
    for _ in range(n_time_masks):
        width, onset = draw(max_t + 1), draw(t)
        idx = torch.arange(t, device=y.device).reshape(1, 1, 1, t)
        mask = (idx < onset) | (idx >= onset + width)
        y = y * mask.to(y.dtype)
    max_f = min(max_masked_frequency_bands,
                int(m * max_masked_frequency_rate))
    for _ in range(n_frequency_masks):
        width, onset = draw(max_f + 1), draw(m)
        idx = torch.arange(m, device=y.device).reshape(1, 1, m, 1)
        mask = (idx < onset) | (idx >= onset + width)
        y = y * mask.to(y.dtype)
    return y


class NormalizedLogMelExtractor(torch.nn.Module):
    """STFT (stacked re/im) -> normalized log-mel (+ deltas, + masking).

    Input: (B, C, T, F, 2) stacked-complex STFT.
    Output: ((B, C', M, T), seq_len) with C' = C * (1+deltas+delta_deltas).
    Reference parity: ``contrib/je/modules/features.py:17``.  The masks of
    the training mode are drawn from ``self.generator`` (a CPU
    ``torch.Generator``; None is the global generator).

    >>> x = torch.ones((10, 1, 100, 257, 2))
    >>> tuple(NormalizedLogMelExtractor(16000, 512, 40).eval()(x)[0].shape)
    (10, 1, 40, 100)
    >>> tuple(NormalizedLogMelExtractor(
    ...     16000, 512, 40, add_deltas=True,
    ...     add_delta_deltas=True).eval()(x)[0].shape)
    (10, 3, 40, 100)
    """

    def __init__(
            self, sample_rate, stft_size, number_of_filters, *,
            num_channels=1,
            lowest_frequency=50, highest_frequency=None, htk_mel=True,
            add_deltas=False, add_delta_deltas=False,
            norm_statistics_axis='bt', norm_eps=1e-5, batch_norm=False,
            clamp=6,
            n_time_masks=0, max_masked_time_steps=70,
            max_masked_time_rate=1.,
            n_frequency_masks=0, max_masked_frequency_bands=20,
            max_masked_frequency_rate=1.,
    ):
        super().__init__()
        self.mel_transform = MelTransform(
            sample_rate=sample_rate,
            stft_size=stft_size,
            number_of_filters=number_of_filters,
            lowest_frequency=lowest_frequency,
            highest_frequency=highest_frequency,
            htk_mel=htk_mel,
            log=True,
        )
        self.deltas_extractor = DeltaExtractor(order=1) if add_deltas \
            else None
        self.delta_deltas_extractor = DeltaExtractor(order=2) \
            if add_delta_deltas else None
        norm_cls = Normalization if batch_norm else InputNormalization
        self.norm = norm_cls(
            data_format='bcft',
            shape=(
                None,
                (1 + add_deltas + add_delta_deltas) * num_channels,
                number_of_filters,
                None,
            ),
            statistics_axis=norm_statistics_axis,
            shift=True,
            scale=True,
            eps=norm_eps,
            independent_axis=None,
            momentum=None,
        )
        self.clamp = clamp
        self.n_time_masks = n_time_masks
        self.max_masked_time_steps = max_masked_time_steps
        self.max_masked_time_rate = max_masked_time_rate
        self.n_frequency_masks = n_frequency_masks
        self.max_masked_frequency_bands = max_masked_frequency_bands
        self.max_masked_frequency_rate = max_masked_frequency_rate
        self.generator = None

    def forward(self, x, seq_len=None):
        # (B, C, T, F, 2) -> power -> mel -> (B, C, M, T)
        power = x[..., 0] ** 2 + x[..., 1] ** 2
        y = self.mel_transform(power)  # (B, C, T, M)
        y = y.transpose(-2, -1)  # (B, C, M, T)
        feats = [y]
        if self.deltas_extractor is not None:
            feats.append(self.deltas_extractor(y))
        if self.delta_deltas_extractor is not None:
            feats.append(self.delta_deltas_extractor(y))
        y = torch.cat(feats, dim=1)
        y = self.norm(y, sequence_lengths=seq_len)
        if self.clamp is not None:
            y = torch.clamp(y, -self.clamp, self.clamp)
        if self.training and (self.n_time_masks or self.n_frequency_masks):
            y = _spec_augment(
                y, self.generator, self.n_time_masks,
                self.max_masked_time_steps, self.max_masked_time_rate,
                self.n_frequency_masks, self.max_masked_frequency_bands,
                self.max_masked_frequency_rate)
        return y, seq_len

    def inverse(self, x):
        return self.mel_transform.inverse(
            self.norm.inverse(x).transpose(-2, -1))


class FusedAudioLogMelExtractor(torch.nn.Module):
    """Raw audio -> normalized log-mel, computed on the model's device.

    The whole front end (framing, windowed DFT, mel matmul, log,
    normalization) runs inside the model's step, so the data pipeline
    ships raw audio instead of host-computed STFTs (a 4 s utterance is
    64 kB of audio against about 1 MB of stacked-complex STFT).

    ``backend='auto'`` takes the fused kernel (``ops/kernels/logmel.py``)
    on a CUDA tensor and the composed path (``STFT`` -> power -> filterbank
    -> log) on a CPU tensor; both give ``log(power @ fbanks + eps)`` with
    the same filterbank.  ``backend='pallas'`` is accepted as the name of
    the fused route, so one ``config.json`` serves this package and the JAX
    package; it keeps the JAX module's rule that the hop must divide the
    window (the CUDA kernel itself takes any hop, and 'auto' uses it for
    any hop).  ``backend='jnp'`` names the composed path.

    Output matches ``NormalizedLogMelExtractor``'s layout:
    ``((B, 1, M, frames), seq_len_frames)``.

    >>> ex = FusedAudioLogMelExtractor(16000, 512, 128, 40).eval()
    >>> y, seq_len = ex(torch.ones((2, 4000)), seq_len=[4000, 2000])
    >>> tuple(y.shape), seq_len.tolist()
    ((2, 1, 40, 35), [35, 19])
    """

    def __init__(
            self, sample_rate, stft_size, shift, number_of_filters, *,
            window_length=None, window='blackman', fading='full',
            lowest_frequency=50, highest_frequency=None,
            norm_statistics_axis='bt', norm_eps=1e-5, clamp=6,
            backend='auto',
    ):
        super().__init__()
        from padertorch_tpu_torch.ops._stft import STFT
        from padertorch_tpu_torch.ops.kernels.logmel import LogMelFrontend
        if backend not in ('auto', 'pallas', 'jnp'):
            raise ValueError(f'unknown backend {backend!r}')
        self.sample_rate = sample_rate
        self.stft_size = stft_size
        self.shift = shift
        self.window_length = window_length or stft_size
        self.number_of_filters = number_of_filters
        self.backend = backend
        # the composed path's building blocks (also the numerics oracle)
        self._stft = STFT(
            stft_size, shift, window_length=window_length, window=window,
            fading=fading, complex_representation='stacked',
            dtype='float32')
        # buffer, NOT a parameter: a trained filterbank can go negative
        # and log(power @ fbanks) NaNs
        self.register_buffer('fbanks', _normalized_fbanks(
            sample_rate, stft_size, number_of_filters, lowest_frequency,
            highest_frequency))  # (F, M)
        self._frontend = LogMelFrontend(
            sample_rate=sample_rate, size=stft_size, shift=shift,
            window_length=self.window_length, n_mels=number_of_filters,
            window=window, lowest_frequency=lowest_frequency,
            highest_frequency=highest_frequency, fading=fading)
        self.norm = InputNormalization(
            data_format='bcft',
            shape=(None, 1, number_of_filters, None),
            statistics_axis=norm_statistics_axis,
            shift=True, scale=True, eps=norm_eps,
            independent_axis=None, momentum=None,
        )
        self.clamp = clamp

    def _use_fused(self, audio):
        if self.backend == 'jnp':
            return False
        if self.backend == 'pallas':
            if self.window_length % self.shift:
                raise ValueError(
                    "backend='pallas' requires shift | window_length; "
                    f'{self.window_length} % {self.shift} != 0')
            return True
        return audio.is_cuda

    def _samples_to_frames(self, samples):
        """Vectorized version of ``STFT.samples_to_frames``."""
        size, shift = self.window_length, self.shift
        fading = self._stft.fading
        if fading == 'half':
            samples = samples + (size - shift) // 2 + -(-(size - shift) // 2)
        elif fading not in (None, False):
            samples = samples + 2 * (size - shift)
        return torch.clamp(-(-(samples - size + shift) // shift), min=1)

    def forward(self, audio, seq_len=None):
        """audio: (B, T_samples) or (B, 1, T_samples) float in [-1, 1].

        The front end computes in float32 whatever the audio's type (the
        fused kernel widens it, as the JAX package's does: bf16 audio under
        the trainer's policy is read as its float32 value), with the
        filterbank in float32 too; the normalization reads its running
        statistics in their own type (bf16 casts under the policy, as in
        the JAX package) and returns float32."""
        if audio.dim() == 3:
            audio = audio[:, 0]
        audio = audio.to(torch.float32)
        if self._use_fused(audio):
            logmel = self._frontend(audio)
        else:
            spec = self._stft(audio)  # (B, frames, F, 2)
            power = spec[..., 0] ** 2 + spec[..., 1] ** 2
            logmel = torch.log(power @ self.fbanks.to(torch.float32) + 1e-12)
        y = logmel.transpose(-2, -1)[:, None]  # (B, 1, M, frames)
        if seq_len is not None:
            seq_len = self._samples_to_frames(
                torch.as_tensor(seq_len, device=audio.device))
        y = self.norm(y, sequence_lengths=seq_len)
        if self.clamp is not None:
            y = torch.clamp(y, -self.clamp, self.clamp)
        return y, seq_len
