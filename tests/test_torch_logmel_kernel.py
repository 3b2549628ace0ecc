"""The port's ``fused_logmel`` (its plain version: these tensors lie on the
CPU) against the JAX package's ``LogMelFrontend(interpret=True)`` and the
composed oracle (``STFT`` -> power -> filterbank -> log), on the same
numpy-seeded audio, at the two cases of ``tests/test_ops/test_pallas.py``
and at the wavenet recipe's 1024/200/800.  Limit 1e-4 on log-mel values of
size 1 to 10 against the Pallas kernel (f32 sums of 512 products in another
order, then a log); the oracle at that test's own 1e-3 / 1e-4 relative.
The padding (``'full'``, ``'half'``, none, and the remainder to a whole
frame) gives the frame counts of the JAX class; a shift that does not
divide the window, which the TPU kernel refuses, is held against the
composed path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops.pallas.logmel import (
    LogMelFrontend as JaxLogMelFrontend)
from padertorch_tpu_torch.contrib.je.modules.features import get_fbanks
from padertorch_tpu_torch.ops._stft import STFT
from padertorch_tpu_torch.ops.kernels.logmel import (
    LogMelFrontend, fused_logmel, fused_logmel_plain)

TOL = 1e-4
CASES = [(512, 128, 512, 40), (256, 64, 128, 40), (1024, 200, 800, 80)]


def audio(b=2, t=4000, seed=0):
    return np.random.RandomState(seed).randn(b, t).astype('float32')


def oracle(x, size, shift, wl, n_mels, fading='full'):
    stft = STFT(size, shift, window_length=wl, fading=fading,
                complex_representation='stacked', dtype='float32')
    spec = stft(torch.from_numpy(x))
    power = spec[..., 0] ** 2 + spec[..., 1] ** 2
    fb = get_fbanks(16000, size, n_mels).astype('float32')
    fb = fb / (fb.sum(-1, keepdims=True) + 1e-6)
    return torch.log(power @ torch.from_numpy(fb.T) + 1e-12).numpy()


@pytest.mark.parametrize('size,shift,wl,n_mels', CASES)
def test_matches_pallas_kernel_and_oracle(size, shift, wl, n_mels):
    x = audio()
    want = np.asarray(JaxLogMelFrontend(
        sample_rate=16000, size=size, shift=shift, window_length=wl,
        n_mels=n_mels, interpret=True)(jnp.asarray(x)))
    kwargs = dict(sample_rate=16000, size=size, shift=shift,
                  window_length=wl, n_mels=n_mels)
    got = fused_logmel(torch.from_numpy(x), **kwargs).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(
        got, fused_logmel_plain(torch.from_numpy(x), **kwargs).numpy())
    np.testing.assert_allclose(got, oracle(x, size, shift, wl, n_mels),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize('fading', ['full', 'half', None])
@pytest.mark.parametrize('t', [4000, 4096, 515])
def test_padding_and_frame_count_match_the_jax_class(fading, t):
    x = audio(t=t, seed=1)
    want = np.asarray(JaxLogMelFrontend(
        size=512, shift=128, n_mels=40, fading=fading,
        interpret=True)(jnp.asarray(x)))
    got = LogMelFrontend(size=512, shift=128, n_mels=40,
                         fading=fading)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_a_shift_that_does_not_divide_the_window():
    """512/160/400 (the speaker recipe's host STFT geometry): the TPU
    kernel's roll-based framing refuses it, the port's front end takes it
    and agrees with the composed path."""
    with pytest.raises(AssertionError, match='shift'):
        JaxLogMelFrontend(size=512, shift=160, window_length=400)
    x = audio(t=3000, seed=2)
    got = fused_logmel(torch.from_numpy(x), size=512, shift=160,
                       window_length=400, n_mels=64).numpy()
    want = oracle(x, 512, 160, 400, 64)
    assert got.shape == want.shape == (2, 21, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_one_signal_a_short_signal_and_what_is_refused():
    frontend = LogMelFrontend(size=512, shift=128, n_mels=64)
    x = torch.from_numpy(audio(b=1, t=2000, seed=3))
    np.testing.assert_array_equal(frontend(x[0]).numpy(),
                                  frontend(x).numpy())
    short = LogMelFrontend(size=512, shift=128, n_mels=64, fading=None)(
        torch.ones(1, 10))                   # shorter than one window
    assert tuple(short.shape) == (1, 1, 64)
    assert bool(torch.isfinite(short).all())
    with pytest.raises(ValueError, match='gradient'):
        frontend(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match=r'\(B, T\)'):
        frontend(torch.ones(2, 3, 100))
    with pytest.raises(ValueError, match='fading'):
        LogMelFrontend(fading='both')
    before = fused_logmel.launches
    frontend(x)
    assert fused_logmel.launches == before   # a CPU tensor launches nothing
    wr, wi, fb, basis = frontend.bases_on('cpu')
    assert tuple(wr.shape) == tuple(wi.shape) == (512, 257)
    assert tuple(fb.shape) == (257, 64)
    # the kernel's basis: [re, im] of bin b at columns 2b and 2b + 1, in
    # chunks of 32 bins (nine at F = 257), zeros beyond bin 256; per (chunk,
    # stage of 32 positions) its TF32 hi and lo planes, each laid out per
    # k-step of 8 positions as wgmma's K-major core matrices (column group
    # of 8, position group of 4, column, position)
    assert tuple(basis.shape) == (9, 16, 2, 2048)
    planes = basis.double().reshape(9, 16, 2, 4, 8, 2, 8, 4)
    interleaved = planes.permute(2, 1, 3, 5, 7, 0, 4, 6).reshape(
        2, 512, 288, 2)
    bins = interleaved[0] + interleaved[1]            # hi + lo
    assert float((bins[:, :257, 0] - wr).abs().max()) <= 2.0 ** -22
    assert float((bins[:, :257, 1] - wi).abs().max()) <= 2.0 ** -22
    assert not bool(bins[:, 257:].any())
    assert not bool((basis.view(torch.int32) & 0x1fff).any())   # TF32
