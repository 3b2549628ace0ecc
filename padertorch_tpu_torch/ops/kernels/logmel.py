"""Fused STFT -> power -> mel -> log front end.

Counterpart of ``padertorch_tpu/ops/pallas/logmel.py`` (``LogMelFrontend``,
``fused_logmel``).  On CUDA tensors :class:`LogMelFrontend` launches the
hand-written kernel of ``csrc/fused_logmel.cu``: framing, both windowed-DFT
products, the power and the mel product stay on chip and only the
(B, frames, n_mels) log-mel features are written.  On CPU tensors it runs
the plain version (frames -> two products -> power -> mel -> log).

The TPU kernel frames with rolls and so needs ``shift | window_length``;
the CUDA kernel reads each frame at its own offset and takes any shift.
It is inference-shaped as in the JAX package (audio needs no gradient and
the filterbank is a buffer): there is no backward kernel, and an input
that requires a gradient is refused.
"""
import numpy as np
import torch

from padertorch_tpu_torch.ops._stft import get_stft_kernel, _get_window
from padertorch_tpu_torch.ops.kernels import _build

__all__ = ['fused_logmel', 'fused_logmel_plain', 'LogMelFrontend']

EPS = 1e-12


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
        # kernel's four bins per thread (zeros beyond F): a row holds
        # [re, im] of the first two bins of every group of four, then
        # [re, im] of every group's last two
        groups = -(-f // 4)
        interleaved = np.zeros((window_length, 4 * groups, 2), np.float32)
        interleaved[:, :f, 0] = kernel[:f].T
        interleaved[:, :f, 1] = kernel[f:].T
        interleaved = interleaved.reshape(
            window_length, groups, 2, 2, 2).transpose(0, 2, 1, 3, 4)
        self._bases_np = tuple(
            np.ascontiguousarray(a, dtype=np.float32)
            for a in (kernel[:f].T, kernel[f:].T, fb.T,
                      interleaved.reshape(window_length, -1)))
        self._bases_on_device = {}

    def bases_on(self, device):
        """(wr (L, F), wi (L, F), fbanks (F, M), the kernel's interleaved
        basis (L, 2 F')) float32 tensors on ``device``, cached per device."""
        device = torch.device(device)
        if device not in self._bases_on_device:
            self._bases_on_device[device] = tuple(
                torch.from_numpy(a).to(device) for a in self._bases_np)
        return self._bases_on_device[device]

    def _pad(self, signal):
        t = signal.shape[-1]
        lo = hi = 0
        if self.fading == 'full':
            lo = hi = self.window_length - self.shift
        elif self.fading == 'half':
            pad = self.window_length - self.shift
            lo, hi = pad // 2, -(-pad // 2)
        total = t + lo + hi
        if total < self.window_length:
            hi += self.window_length - total
        else:
            remainder = (total - self.window_length) % self.shift
            if remainder:
                hi += self.shift - remainder
        return torch.nn.functional.pad(signal, (lo, hi))

    def _prepare(self, signal):
        if signal.ndim == 1:
            signal = signal[None]
        if signal.ndim != 2:
            raise ValueError(f'audio must be (B, T) or (T,), got '
                             f'{tuple(signal.shape)}')
        return self._pad(signal.to(torch.float32))

    def plain(self, signal):
        """The plain PyTorch version of :meth:`__call__`."""
        signal = self._prepare(signal)
        wr, wi, fbanks, _ = self.bases_on(signal.device)
        frames = signal.unfold(-1, self.window_length, self.shift)
        real, imag = frames @ wr, frames @ wi
        return torch.log((real * real + imag * imag) @ fbanks + EPS)

    def __call__(self, signal):
        if torch.is_grad_enabled() and signal.requires_grad:
            raise ValueError(
                'fused_logmel is an inference-shaped front end without a '
                'backward: audio that requires a gradient is not taken '
                '(detach it, or use the composed path)')
        if signal.device.type == 'cpu':
            return self.plain(signal)
        if signal.device.type != 'cuda':
            raise ValueError(f'no kernel for device {signal.device}')
        signal = self._prepare(signal).contiguous()
        _, _, fbanks, basis = self.bases_on(signal.device)
        b, t_padded = signal.shape
        n_frames = (t_padded - self.window_length) // self.shift + 1
        out = torch.empty((b, n_frames, self.n_mels), dtype=torch.float32,
                          device=signal.device)
        lib = _build.load_library()
        stream, device = _build.stream_and_device(signal)
        err = lib.fused_logmel_fwd(
            signal.data_ptr(), basis.data_ptr(), fbanks.data_ptr(),
            out.data_ptr(), b, t_padded, n_frames, self.window_length,
            fbanks.shape[0], basis.shape[1], self.n_mels, self.shift, EPS,
            device, stream)
        _build.check(lib, err, 'fused_logmel kernel')
        fused_logmel.launches += 1
        return out


def fused_logmel(signal, **kwargs):
    """One-shot helper: ``LogMelFrontend(**kwargs)(signal)``.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (or raise).
    ``fused_logmel.launches`` counts the launches (of this helper and of
    every :class:`LogMelFrontend`)."""
    return LogMelFrontend(**kwargs)(signal)


def fused_logmel_plain(signal, **kwargs):
    """Plain PyTorch version of :func:`fused_logmel` (same contract)."""
    return LogMelFrontend(**kwargs).plain(signal)


fused_logmel.launches = 0
