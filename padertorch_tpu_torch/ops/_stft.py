"""STFT / iSTFT as windowed-DFT matmuls.

Counterpart of ``padertorch_tpu/ops/_stft.py``, with the same window,
kernel and fading semantics (the numpy helpers are copies): the analysis
is a framed matmul with a [real; imag] windowed-DFT kernel, the synthesis
a matmul with the biorthogonal-window iSTFT kernels followed by an
overlap-add.  :class:`STFT` works on torch tensors on any device;
:class:`HostSTFT` computes ``__call__``/``inverse`` with numpy on the host,
as data pipelines do, and sends ``masked_inverse`` to the CUDA kernel when
asked for a CUDA device.
"""
import typing
from math import ceil

import numpy as np
import torch

__all__ = ['STFT', 'HostSTFT', 'istft_rows', 'synthesis_rows', 'tables_on']


def _get_window(window, symmetric_window, window_length):
    """Window by name (scipy) or callable; periodic unless symmetric."""
    import scipy.signal
    if callable(window):
        if symmetric_window:
            return np.asarray(window(window_length))
        return np.asarray(window(window_length + 1))[:-1]
    return scipy.signal.get_window(
        window, window_length, fftbins=not symmetric_window)


def _roll_zeropad(a, shift):
    out = np.zeros_like(a)
    if shift == 0:
        out[:] = a
    elif shift > 0:
        out[shift:] = a[:-shift]
    else:
        out[:shift] = a[-shift:]
    return out


def _biorthogonal_window_fastest(analysis_window, shift):
    """Biorthogonal synthesis window (paderbox semantics).

    b[n] = w[n] / sum_k w[n + k*shift]^2 — perfect reconstruction dual
    window for weighted overlap-add.
    """
    size = len(analysis_window)
    influence_width = (size - 1) // shift
    denominator = np.zeros_like(analysis_window)
    sq = analysis_window ** 2
    for i in range(-influence_width, influence_width + 1):
        denominator += _roll_zeropad(sq, shift * i)
    return analysis_window / denominator


def get_stft_kernel(size, window):
    """[real; imag] windowed DFT kernel, shape (size + 2, window_length)."""
    length = len(window)
    n = np.arange(size // 2 + 1)[:, None]
    k = np.arange(length)[None, :]
    phase = -2 * np.pi / size * n * k
    real = np.cos(phase) * window[None, :]
    imag = np.sin(phase) * window[None, :]
    return np.concatenate([real, imag], axis=0)


def get_istft_kernel(size, shift, window):
    """Synthesis kernels (real, imag), each of shape (size, window_length)."""
    window = _biorthogonal_window_fastest(window, shift) / size
    length = len(window)
    f = np.arange(size)[:, None]
    n = np.arange(length)[None, :]
    kernel_real = np.cos(2 * np.pi / size * f * n) * window[None, :]
    kernel_imag = np.sin(-2 * np.pi / size * f * n) * window[None, :]
    return kernel_real, kernel_imag


def _samples_to_stft_frames(samples, size, shift, *, pad=True, fading='full'):
    if fading not in [None, False]:
        if fading == 'half':
            samples = samples + (size - shift) // 2 + ceil(
                (size - shift) / 2)
        else:
            samples = samples + 2 * (size - shift)
    if pad:
        return max(1, ceil((samples - size + shift) / shift))
    return (samples - size + shift) // shift


def _stft_frames_to_samples(frames, size, shift, fading='full'):
    samples = frames * shift + size - shift
    if fading not in [None, False]:
        pad_width = (size - shift) if fading != 'half' else (
            (size - shift) // 2 + ceil((size - shift) / 2))
        samples -= pad_width if fading == 'half' else 2 * (size - shift)
    return samples


def _sample_index_to_stft_frame_index(sample, size, shift, fading='full'):
    """Frame whose window center is nearest to ``sample``."""
    if fading in [None, False]:
        pad_width = 0
    elif fading == 'half':
        pad_width = (size - shift) // 2
    else:
        pad_width = size - shift
    center_offset = (size - 1) / 2
    frame = int(round((sample + pad_width - center_offset) / shift))
    return max(frame, 0)


def tables_on(cache, device, make):
    """``make()``'s numpy arrays as a tuple of tensors on ``device``,
    cached in the dict ``cache`` per device.  They are made as real
    tensors even while ``torch.export`` traces (a fake tensor left in the
    cache would poison every later eager call); the trace takes them as
    constants."""
    from torch.utils._python_dispatch import _disable_current_modes
    device = torch.device(device)
    if device not in cache:
        with _disable_current_modes():
            cache[device] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in make())
    return cache[device]


def istft_rows(re, im, stft):
    """Onesided (N, frames, F) real/imag parts -> (N, samples) signals,
    before the fading crop: the full-spectrum mirror, a matmul with the
    iSTFT kernels, and an overlap-add."""
    return synthesis_rows(re, im, *stft.kernels_on(re.device)[1:],
                          stft.shift)


def synthesis_rows(re, im, k_real, k_imag, shift):
    """:func:`istft_rows` with the synthesis kernels (size, L) and the
    shift given."""
    re_full = torch.cat([re, re[..., 1:-1].flip(-1)], dim=-1)
    im_full = torch.cat([im, -im[..., 1:-1].flip(-1)], dim=-1)
    contrib = re_full @ k_real + im_full @ k_imag        # (N, frames, L)
    n, frames, length = contrib.shape
    total = (frames - 1) * shift + length
    out = torch.nn.functional.fold(
        contrib.transpose(1, 2), output_size=(1, total),
        kernel_size=(1, length), stride=(1, shift))
    return out.reshape(n, total)


class STFT:
    """STFT/iSTFT operator on torch tensors (see module docstring).

    >>> stft = STFT(512, 20, window_length=40, \
                    complex_representation='concat')
    >>> x = torch.from_numpy(np.random.RandomState(0).randn(2, 6, 203))
    >>> X = stft(x)
    >>> tuple(X.shape)
    (2, 6, 12, 514)
    >>> stft = STFT(512, 20, window_length=40, \
                    complex_representation='complex')
    >>> X = stft(x)
    >>> tuple(X.shape)
    (2, 6, 12, 257)
    >>> x_hat = stft.inverse(X)
    >>> torch.allclose(x_hat[..., :203], x.float(), atol=1e-5)
    True
    """

    possible_out_types = ('concat', 'stacked', 'complex')

    def __init__(
            self,
            size: int = 1024,
            shift: int = 256,
            *,
            window: typing.Union[str, typing.Callable] = 'blackman',
            window_length: int = None,
            fading: typing.Optional[typing.Union[bool, str]] = 'full',
            pad: bool = True,
            symmetric_window: bool = False,
            complex_representation: str = 'complex',
            dtype='float32',
    ):
        assert complex_representation in self.possible_out_types, (
            f'Choose one of {self.possible_out_types}, '
            f'not {complex_representation}')
        self.complex_representation = complex_representation
        assert size % 2 == 0, 'Only even FFT sizes are supported.'
        self.size = size
        self.shift = shift
        self.window_length = (window_length if window_length is not None
                              else size)
        window = _get_window(
            window=window,
            symmetric_window=symmetric_window,
            window_length=self.window_length,
        )
        assert fading in [None, True, False, 'full', 'half'], fading
        self.fading = fading
        self.pad = pad
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype
        # float32 kernels: (2F, L) analysis, (size, L) synthesis
        self.stft_kernel = get_stft_kernel(size, window).astype(np.float32)
        k_real, k_imag = get_istft_kernel(size, shift, window)
        self.istft_kernel_real = k_real.astype(np.float32)
        self.istft_kernel_imag = k_imag.astype(np.float32)
        # float64 copies for host-side derivations (the fused masked-iSTFT
        # kernel folds its synthesis matrices from these)
        self._istft_kernel_np = (k_real, k_imag)
        self._kernels_on_device = {}

    def kernels_on(self, device):
        """(analysis, synthesis real, synthesis imag) float32 tensors on
        ``device``, cached per device."""
        return tables_on(self._kernels_on_device, device, lambda: (
            self.stft_kernel, self.istft_kernel_real,
            self.istft_kernel_imag))

    @property
    def _pad_widths(self):
        if self.fading in [False, None]:
            return (0, 0)
        if self.fading == 'half':
            return (
                (self.window_length - self.shift) // 2,
                ceil((self.window_length - self.shift) / 2),
            )
        pad = self.window_length - self.shift
        return (pad, pad)

    def __call__(self, inputs):
        """[..., T] -> [..., frames, bins] (layout per representation)."""
        org_shape = inputs.shape
        x = inputs.reshape(-1, org_shape[-1]).to(self.dtype)
        lo, hi = self._pad_widths
        length, stride = self.window_length, self.shift
        if lo or hi:
            x = torch.nn.functional.pad(x, (lo, hi))
        if self.pad:
            # up to one window, else to whole shifts past it; one
            # expression without a test on the length, so that an
            # exported program keeps a symbolic time axis
            short = length - x.shape[-1]
            x = torch.nn.functional.pad(
                x, (0, torch.sym_max(short, short % stride)))
        frames = x.unfold(-1, length, stride)           # (B, frames, L)
        kernel = self.kernels_on(x.device)[0].to(self.dtype)
        encoded = frames @ kernel.T                     # (B, frames, 2F)
        encoded = encoded.reshape(*org_shape[:-1], *encoded.shape[-2:])
        real, imag = torch.chunk(encoded, 2, dim=-1)
        if self.complex_representation == 'stacked':
            return torch.stack([real, imag], dim=-1)
        if self.complex_representation == 'concat':
            return torch.cat([real, imag], dim=-1)
        return torch.complex(real, imag)

    def _split(self, stft_signal):
        if self.complex_representation == 'stacked':
            return stft_signal[..., 0], stft_signal[..., 1]
        if self.complex_representation == 'concat':
            return torch.chunk(stft_signal, 2, dim=-1)
        return stft_signal.real, stft_signal.imag

    def crop_fading(self, time_signal):
        """Cut the fading pad off both ends of ``time_signal``."""
        if self.fading not in [None, False]:
            pad_width = self.window_length - self.shift
            if self.fading == 'half':
                pad_width /= 2
            cut_off = time_signal.shape[-1] - ceil(pad_width)
            time_signal = time_signal[..., int(pad_width):cut_off]
        return time_signal

    def inverse(self, stft_signal):
        """Inverse STFT. Input layout per ``complex_representation``."""
        real, imag = self._split(stft_signal)
        org_shape = real.shape
        real = real.reshape(-1, *org_shape[-2:]).to(torch.float32)
        imag = imag.reshape(-1, *org_shape[-2:]).to(torch.float32)
        rows = istft_rows(real, imag, self)
        return self.crop_fading(rows.reshape(*org_shape[:-2], -1))

    def masked_inverse(self, stft_signal, mask=None):
        """``inverse(stft_signal * mask)``, the separation-inference hot
        path: on CUDA tensors the fused kernel
        (``ops/kernels/masked_istft.py``), which raises for a geometry it
        does not take; on CPU tensors the composition.

        Args:
            stft_signal: frames, layout per ``complex_representation``.
            mask: optional real mask broadcastable to
                ``(..., frames, F)`` (e.g. an extra leading source
                axis); ``None`` = plain iSTFT.
        """
        if stft_signal.is_cuda:
            from padertorch_tpu_torch.ops.kernels.masked_istft import (
                masked_istft)
            return masked_istft(stft_signal, mask, stft=self)
        if mask is None:
            return self.inverse(stft_signal)
        return self.inverse(self._apply_mask(stft_signal, mask))

    def _apply_mask(self, stft_signal, mask):
        """``stft_signal * mask`` under the ``complex_representation``
        layout (mask is real, per-bin); numpy or torch."""
        if isinstance(stft_signal, np.ndarray):
            mask = np.asarray(mask)
            cat = np.concatenate
        else:
            mask = torch.as_tensor(mask, device=stft_signal.device)
            cat = torch.cat
        if self.complex_representation == 'stacked':
            return stft_signal * mask[..., None]
        if self.complex_representation == 'concat':
            return stft_signal * cat([mask, mask], -1)
        return stft_signal * mask

    def samples_to_frames(self, samples):
        """Number of STFT frames for a number of time samples."""
        return _samples_to_stft_frames(
            samples, self.window_length, self.shift,
            pad=self.pad, fading=self.fading)

    def sample_index_to_frame_index(self, sample_index):
        """Best (center-nearest) frame index for a sample index."""
        return _sample_index_to_stft_frame_index(
            sample_index, self.window_length, self.shift,
            fading=self.fading)

    def frames_to_samples(self, frames):
        """Number of time samples for a number of STFT frames."""
        return _stft_frames_to_samples(
            frames, self.window_length, self.shift, fading=self.fading)


class HostSTFT(STFT):
    """The same transform computed with numpy on the host CPU.

    Data pipelines run in prefetch threads and must not touch the
    accelerator.  ``__call__``/``inverse`` use numpy with the SAME kernel
    matrices; ``masked_inverse`` takes a ``device`` and, for a CUDA
    device, runs the fused kernel there and returns numpy.
    """

    def __call__(self, inputs):
        x = np.asarray(inputs)
        org_shape = x.shape
        x = x.reshape(-1, org_shape[-1]).astype(np.float32)
        lo, hi = self._pad_widths
        if lo or hi:
            x = np.pad(x, ((0, 0), (lo, hi)))
        length, stride = self.window_length, self.shift
        if self.pad:
            if x.shape[-1] < length:
                x = np.pad(x, ((0, 0), (0, length - x.shape[-1])))
            elif stride != 1 and (x.shape[-1] + stride - length) % stride:
                x = np.pad(x, ((0, 0), (
                    0, stride - (x.shape[-1] + stride - length) % stride)))
        n_frames = (x.shape[-1] - length) // stride + 1
        frames = np.lib.stride_tricks.as_strided(
            x, (x.shape[0], n_frames, length),
            (x.strides[0], stride * x.strides[1], x.strides[1]))
        # (B, frames, 2F) — identical math to the device transform
        encoded = frames @ self.stft_kernel.T
        encoded = encoded.reshape(*org_shape[:-1], n_frames, -1)
        real, imag = np.split(encoded, 2, axis=-1)
        if self.complex_representation == 'stacked':
            return np.stack([real, imag], axis=-1)
        if self.complex_representation == 'concat':
            return np.concatenate([real, imag], axis=-1)
        return real + 1j * imag

    def inverse(self, stft_signal):
        stft_signal = np.asarray(stft_signal)
        if self.complex_representation == 'stacked':
            real, imag = stft_signal[..., 0], stft_signal[..., 1]
        elif self.complex_representation == 'concat':
            real, imag = np.split(stft_signal, 2, axis=-1)
        else:
            real, imag = np.real(stft_signal), np.imag(stft_signal)
        org_shape = real.shape
        real = real.reshape(-1, *org_shape[-2:]).astype(np.float32)
        imag = imag.reshape(-1, *org_shape[-2:]).astype(np.float32)
        # mirror to the full spectrum (imag part reflected negated)
        real_full = np.concatenate([real, real[..., 1:-1][..., ::-1]], -1)
        imag_full = np.concatenate([imag, -imag[..., 1:-1][..., ::-1]], -1)
        contrib = (real_full @ self.istft_kernel_real
                   + imag_full @ self.istft_kernel_imag)  # (B, fr, L)
        batch, n_frames, length = contrib.shape
        stride = self.shift
        total = (n_frames - 1) * stride + length
        ratio = -(-length // stride)
        # grouped overlap-add: frames g, g+ratio, g+2*ratio, ... do not
        # overlap, so each group adds via one strided (reshaped) view
        out = np.zeros(
            (batch, total + ratio * stride), dtype=np.float32)
        for g in range(min(ratio, n_frames)):
            sub = contrib[:, g::ratio]  # (B, n_g, L)
            n_g = sub.shape[1]
            view = out[:, g * stride:
                       g * stride + n_g * ratio * stride]
            view = view.reshape(batch, n_g, ratio * stride)
            view[:, :, :length] += sub
        time_signal = out[:, :total].reshape(*org_shape[:-2], total)
        return self.crop_fading(time_signal)

    def masked_inverse(self, stft_signal, mask=None, device=None):
        """Same contract as :meth:`STFT.masked_inverse`, numpy in/out.

        With a CUDA ``device`` the complex frames are split into real and
        imaginary parts on the host, uploaded with the mask, synthesized
        by the fused kernel (``ops/kernels/masked_istft.py``) and
        returned as numpy; a geometry the kernel does not take raises
        before anything is uploaded.  Otherwise it is the numpy
        composition.
        """
        if device is not None and torch.device(device).type == 'cuda':
            from padertorch_tpu_torch.ops.kernels.masked_istft import (
                _check_geometry, masked_istft)
            _check_geometry(self)
            spec = np.asarray(stft_signal)
            if self.complex_representation == 'stacked':
                real, imag = spec[..., 0], spec[..., 1]
            elif self.complex_representation == 'concat':
                real, imag = np.split(spec, 2, axis=-1)
            else:
                real, imag = spec.real, spec.imag
            stacked = torch.from_numpy(np.stack(
                [real, imag], axis=-1).astype(np.float32)).to(device)
            twin = self.__dict__.get('_stacked_twin')
            if twin is None:
                import copy
                twin = copy.copy(self)
                twin.complex_representation = 'stacked'
                # the kernel caches its synthesis matrices on the stft
                # object it is handed; keep the twin so they persist
                self._stacked_twin = twin
            out = masked_istft(
                stacked, None if mask is None else torch.from_numpy(
                    np.asarray(mask, dtype=np.float32)).to(device),
                stft=twin)
            return out.cpu().numpy()
        if mask is None:
            return self.inverse(stft_signal)
        return self.inverse(
            self._apply_mask(np.asarray(stft_signal), mask))
