"""The arithmetic of the ``fused_logmel`` kernel's DFT product
(``csrc/fused_logmel.cu``), emulated on the CPU: 3xTF32 tensor-core
products (each operand split into hi, the float32 value rounded to TF32,
and lo, the rest rounded to TF32; lo*hi + hi*lo + hi*hi per 8 window
positions, the small terms first), each stage of 32
positions summed from zero with the tensor core's sums rounding toward
zero (the pessimistic model of its float32 accumulation), and the stages
added in float32.  Then the power, the mel product and the log, as the
kernel does them.

Against float64 and against the JAX package's
``LogMelFrontend(interpret=True)`` on the same numpy-seeded audio, at the
two window lengths the recipes run (512 and 800): the emulation holds the
card's limit of 1e-5 (``chip_smoke.py`` ``LOGMEL_TOL``), and the hi*hi
product alone, a plain TF32 product, does not.  The kernel itself is held
against its plain version on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py`` phase 16).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops.pallas.logmel import (
    LogMelFrontend as JaxLogMelFrontend)
from padertorch_tpu_torch.ops.kernels.logmel import EPS, LogMelFrontend

LIMIT = 1e-5
STAGE = 32   # window positions a stage of the kernel sums from zero
MMA_K = 8    # positions of one tensor-core product


def tf32_round(x):
    """x rounded to the nearest TF32 value, ties away from zero (the
    kernel's ``cvt.rna.tf32.f32``): its 13 low mantissa bits cleared after
    adding half of their unit."""
    u = x.view(np.uint32).astype(np.uint64) + 0x1000
    return (u & 0xffffe000).astype(np.uint32).view(np.float32)


def toward_zero(v):
    """float64 values to float32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def dft_3xtf32(frames, basis, terms=('lo*hi', 'hi*lo', 'hi*hi')):
    """(n, L) @ (L, C) as the kernel forms it, in float32."""
    a_hi, b_hi = tf32_round(frames), tf32_round(basis)
    parts = {'hi': (a_hi, b_hi),
             'lo': (tf32_round(frames - a_hi), tf32_round(basis - b_hi))}
    total = np.zeros((frames.shape[0], basis.shape[1]), np.float32)
    length = frames.shape[1]
    for k0 in range(0, length, STAGE):
        stage = np.zeros_like(total)
        for k in range(k0, min(length, k0 + STAGE), MMA_K):
            cols = slice(k, min(length, k + MMA_K))
            for term in terms:
                a = parts[term[:2]][0][:, cols].astype(np.float64)
                b = parts[term[3:]][1][cols].astype(np.float64)
                stage = toward_zero(stage.astype(np.float64) + a @ b)
        total = total + stage
    return total


def logmel(dft, f_bins, fbanks, dtype):
    real, imag = dft[:, :f_bins], dft[:, f_bins:]
    power = (real * real + imag * imag).astype(dtype)
    return np.log(power @ fbanks.astype(dtype) + EPS)


# (size, shift, window length, mels): the speaker recipe's front end and
# the vocoder's
CASES = [(512, 128, 512, 64), (1024, 200, 800, 80)]


@pytest.fixture(scope='module', params=CASES, ids=['L=512', 'L=800'])
def case(request):
    size, shift, length, n_mels = request.param
    x = (np.random.RandomState(length).randn(2, 8000) * 0.1).astype(
        'float32')
    frontend = LogMelFrontend(size=size, shift=shift, window_length=length,
                              n_mels=n_mels)
    frames = frontend._prepare(torch.from_numpy(x)).unfold(
        -1, length, shift).reshape(-1, length).numpy()
    wr, wi, fbanks, _ = (t.numpy() for t in frontend.bases_on('cpu'))
    basis = np.concatenate([wr, wi], axis=1)
    f_bins = wr.shape[1]
    exact = logmel(frames.astype(np.float64) @ basis.astype(np.float64),
                   f_bins, fbanks, np.float64)
    jax_out = np.asarray(JaxLogMelFrontend(
        sample_rate=16000, size=size, shift=shift, window_length=length,
        n_mels=n_mels, interpret=True)(jnp.asarray(x))).reshape(exact.shape)
    return frames, basis, f_bins, fbanks, exact, jax_out


def test_3xtf32_holds_the_limit_against_float64_and_the_pallas_kernel(case):
    frames, basis, f_bins, fbanks, exact, jax_out = case
    got = logmel(dft_3xtf32(frames, basis), f_bins, fbanks, np.float32)
    assert np.abs(got - exact).max() <= LIMIT / 2
    assert np.abs(got - jax_out).max() <= LIMIT


def test_the_hi_product_alone_fails_the_limit(case):
    """A plain TF32 product (hi*hi) is the control the limit must tell
    apart: it misses by far more than the limit."""
    frames, basis, f_bins, fbanks, exact, _ = case
    got = logmel(dft_3xtf32(frames, basis, terms=('hi*hi',)), f_bins,
                 fbanks, np.float32)
    assert np.abs(got - exact).max() > 10 * LIMIT


def test_the_split_is_exact_but_for_the_rounded_rest():
    """hi + lo is the float32 value up to lo's rounding to TF32 (lo is at
    most half a unit in hi's last bit, 2^-11 of the value; its rounding
    at most 2^-22 of the value), and both parts are TF32 values."""
    x = np.random.RandomState(0).randn(10000).astype(np.float32)
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    assert np.all(np.abs(x - hi) <= 2.0 ** -11 * np.abs(x))
    assert np.all(hi.view(np.uint32) & 0x1fff == 0)
    assert np.all(lo.view(np.uint32) & 0x1fff == 0)
    assert np.abs((hi.astype(np.float64) + lo) - x).max() <= \
        2.0 ** -22 * np.abs(x).max()
