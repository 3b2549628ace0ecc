"""The ``masked_istft`` kernel's fft route (``csrc/masked_istft.cu``) on
the CPU: its planner, a replay of its tiles, and an emulation of its
arithmetic.

The planner (``fft_plan``, ``dft_plan``, ``route``) at an H100's limits
(132 SMs, 232,448 bytes of shared memory a block): every power-of-two size
from 16 to 8192 takes the fft route and a few other sizes the dft route;
every plan fits the shared memory, and the request shape of the uPIT
recipe gets a block for nearly every SM.  A replay of the fft kernel's
loops (tiles of ``rows`` output rows, ``frames`` frames at a time) shows
that every output row is owned by one block and sums exactly the frames
it overlaps, in increasing order, under every plan: so a signal's output
is the same bits alone, in a batch and under any plan.

The emulation does in float32 what the kernel does: the mask multiplied
in, the even/odd packing of the real transform onto size / 2 complex
points, twiddles from the float64 table rounded once, Stockham passes
(radix 2 first where log2 of size / 2 is odd, then radix 4), the first L
samples times the window, and the overlap-add in frame order.  Fused
multiply-adds are taken in float64 and rounded once to float32.  It is
held against the JAX package's Pallas kernel in interpret mode and
``HostSTFT.masked_inverse(backend='jnp')`` at 1e-5 on signals of unit
scale (the limit of ``tests/test_torch_masked_istft.py``), at the recipe's
geometry, a window shorter than the size and sizes 4096 and 8192.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops._stft import HostSTFT as JaxHostSTFT
from padertorch_tpu.ops.pallas.masked_istft import (
    masked_istft as jax_masked_istft)
from padertorch_tpu_torch.ops._stft import STFT
from padertorch_tpu_torch.ops.kernels.masked_istft import (
    FFT_MAX_THREADS, _split, dft_plan, fft_plan, fft_smem, fft_tables, route)

N_SM, MAX_SMEM = 132, 232448   # an H100's SMs and opt-in shared memory
ATOL = 1e-5

POWERS = [2 ** e for e in range(4, 14)]   # 16 ... 8192
OTHER_SIZES = [320, 400, 1000, 6000]
RATIOS = [2, 4, 8, 16, 32]
# (signal rows, frames): one frame, the uPIT request (K=2, T=127), a
# batch of 32 long signals, and 70,000 rows of a few frames
SHAPES = [(1, 1), (2, 127), (32, 500), (70000, 5)]


@pytest.mark.parametrize('size', POWERS + OTHER_SIZES)
def test_route_by_size(size):
    want = 'fft' if size in POWERS else 'dft'
    assert route(size, size) == want
    assert route(size, size // 2) == want
    assert route(size, 2 * size) == 'dft'   # a window longer than the size


def replay_fft(plan, n_frames, ratio):
    """The fft kernel's loops for one signal row: for each output row, the
    frames its block adds into it, in the order they are added."""
    n_rows = n_frames + ratio - 1
    tiles = -(-n_rows // plan.rows)
    added = {}
    for tile in range(tiles):
        r0 = tile * plan.rows
        rows_here = min(plan.rows, n_rows - r0)
        t_lo = max(0, r0 - (ratio - 1))
        t_hi = min(n_frames - 1, r0 + rows_here - 1)
        for t0 in range(t_lo, t_hi + 1, plan.frames):
            t_last = min(t0 + plan.frames - 1, t_hi)
            for row in range(max(r0, t0),
                             min(r0 + rows_here - 1, t_last + ratio - 1) + 1):
                for t in range(max(t0, row - ratio + 1), min(t_last, row) + 1):
                    added.setdefault(row, []).append((tile, t))
    return tiles, added


@pytest.mark.parametrize('size', POWERS)
def test_fft_plan_fits_and_covers_every_row_once(size):
    for ratio in RATIOS:
        if size % ratio:
            continue
        shift = size // ratio
        for n_signals, n_frames in SHAPES:
            plan = fft_plan(n_signals, n_frames, size, shift, ratio, N_SM,
                            MAX_SMEM)
            assert plan is not None
            assert plan.smem == fft_smem(size, shift, plan.rows,
                                         plan.frames) <= MAX_SMEM
            assert plan.threads == plan.frames * size // 2 // plan.per_thread
            assert plan.threads <= FFT_MAX_THREADS
            assert plan.per_thread == (4 if size <= 2048 else size // 512)
            tiles, added = replay_fft(plan, min(n_frames, 40), ratio)
            assert plan.blocks == n_signals * -(
                -(n_frames + ratio - 1) // plan.rows)
            for row in range(min(n_frames, 40) + ratio - 1):
                frames = [t for _, t in added[row]]
                assert frames == [t for t in range(row - ratio + 1, row + 1)
                                  if 0 <= t < min(n_frames, 40)]
                assert len({tile for tile, _ in added[row]}) == 1


def test_request_shape_fills_the_card():
    """The uPIT request: two masks on one mixture of 127 frames."""
    plan = fft_plan(2, 127, 512, 128, 4, N_SM, MAX_SMEM)
    assert plan.blocks >= 120
    big = fft_plan(32, 500, 512, 128, 4, N_SM, MAX_SMEM)
    assert big.rows == 32 and big.blocks == 32 * 16


@pytest.mark.parametrize('size', OTHER_SIZES + [4096, 8192])
def test_dft_plan_stages_any_width_of_bins(size):
    for ratio in (2, 4, 8):
        for n_signals, n_frames in SHAPES:
            plan = dft_plan(n_signals, n_frames, size // 2 + 1,
                            size // ratio, ratio, MAX_SMEM)
            assert plan is not None and plan.smem <= MAX_SMEM
            assert 1 <= plan.chunk <= size // 2 + 1
            assert plan.threads <= 256
    # 2049 bins of 19 frames do not fit at once: two chunks
    assert dft_plan(2, 127, 2049, 1024, 4, MAX_SMEM).chunk < 2049


# ---------------------------------------------------------------- emulation


def fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def cmul(ar, ai, wr, wi):
    return fma(ar, wr, -(ai * wi)), fma(ar, wi, ai * wr)


def fft_route(re, im, mask, stft):
    """(N, frames, F) float32 parts and mask -> (N, samples) rows, as the
    kernel computes them."""
    twiddles, window = fft_tables(stft)
    tr, ti = twiddles[:, 0], twiddles[:, 1]
    m = stft.size // 2
    if mask is not None:
        re, im = re * mask, im * mask
    im = im.copy()
    im[..., 0] = im[..., m] = 0
    k = np.arange(m)
    ar, ai = re[..., k], im[..., k]
    br, bi = re[..., m - k], -im[..., m - k]
    dr, di = cmul(ar - br, ai - bi, tr[k], ti[k])
    zr, zi = (ar + br) - di, (ai + bi) + dr
    ns = 1
    for radix in ([2] if (m.bit_length() - 1) % 2 else []) + [4] * (
            (m.bit_length() - 1) // 2):
        quarter = m // radix
        j = np.arange(quarter)
        kk = j & (ns - 1)
        ur = [zr[..., j + r * quarter] for r in range(radix)]
        ui = [zi[..., j + r * quarter] for r in range(radix)]
        if ns > 1:
            step = 2 * kk * (quarter // ns)
            for r in range(1, radix):
                ur[r], ui[r] = cmul(ur[r], ui[r], tr[r * step], ti[r * step])
        if radix == 2:
            vr = [ur[0] + ur[1], ur[0] - ur[1]]
            vi = [ui[0] + ui[1], ui[0] - ui[1]]
        else:
            t0r, t0i = ur[0] + ur[2], ui[0] + ui[2]
            t1r, t1i = ur[0] - ur[2], ui[0] - ui[2]
            t2r, t2i = ur[1] + ur[3], ui[1] + ui[3]
            t3r, t3i = -(ui[1] - ui[3]), ur[1] - ur[3]
            vr = [t0r + t2r, t1r + t3r, t0r - t2r, t1r - t3r]
            vi = [t0i + t2i, t1i + t3i, t0i - t2i, t1i - t3i]
        zr, zi = np.empty_like(zr), np.empty_like(zi)
        dst = (j - kk) * radix + kk
        for s in range(radix):
            zr[..., dst + s * ns], zi[..., dst + s * ns] = vr[s], vi[s]
        ns *= radix
    y = np.stack([zr, zi], -1).reshape(*zr.shape[:-1], 2 * m)
    shift, length = stft.shift, stft.window_length
    ratio = length // shift
    n, frames = y.shape[:2]
    acc = np.zeros((n, frames + ratio - 1, shift), np.float32)
    for k in reversed(range(ratio)):   # each row's frames in increasing order
        chunk = slice(k * shift, (k + 1) * shift)
        acc[:, k:k + frames] = fma(window[chunk], y[..., chunk],
                                   acc[:, k:k + frames])
    return acc.reshape(n, -1)


def emulate(spec, mask, stft):
    re, im, rows_mask, lead = _split(
        torch.from_numpy(spec), None if mask is None else torch.from_numpy(
            mask), stft)
    re, im = re.numpy(), im.numpy()
    if rows_mask is not None:
        reps = rows_mask.shape[0] // re.shape[0]
        re, im = np.tile(re, (reps, 1, 1)), np.tile(im, (reps, 1, 1))
        rows_mask = rows_mask.numpy()
    rows = fft_route(re, im, rows_mask, stft)
    return stft.crop_fading(rows.reshape(*lead, rows.shape[-1]))


# (size, shift, window_length, samples): the recipe, a window shorter than
# the size (the port's doc example and a wider one), size 4096 at both
# shifts, size 8192 (the route's largest), and small sizes (16: one radix-2 and one radix-4 pass)
CASES = [(512, 128, None, 1500), (512, 100, 400, 1500), (512, 20, 40, 203),
         (4096, 1024, None, 9000), (4096, 2048, None, 9000),
         (8192, 2048, None, 10000),
         (64, 16, None, 300), (128, 32, None, 600), (16, 4, None, 100)]


@pytest.mark.parametrize('fading', [None, 'half', 'full'])
@pytest.mark.parametrize('size,shift,window_length,samples', CASES)
def test_emulation_matches_jax(size, shift, window_length, samples, fading):
    kwargs = dict(window_length=window_length, fading=fading,
                  complex_representation='stacked')
    jax_stft = JaxHostSTFT(size, shift, dtype='float32', **kwargs)
    stft = STFT(size, shift, **kwargs)
    assert route(size, stft.window_length) == 'fft'
    rng = np.random.RandomState(size + shift)
    spec = jax_stft(rng.randn(2, samples).astype('float32'))[None]
    mask = rng.rand(3, 2, spec.shape[-3], size // 2 + 1).astype('float32')
    want_kernel = np.asarray(jax_masked_istft(
        jnp.asarray(spec), jnp.asarray(mask), stft=jax_stft,
        interpret=True))
    want_host = jax_stft.masked_inverse(spec, mask, backend='jnp')
    got = emulate(spec, mask, stft)
    assert got.shape == want_kernel.shape == want_host.shape
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_host, atol=ATOL, rtol=0)
    if fading == 'full':
        # far closer to float64 than the limit
        x = (spec[..., 0] + 1j * spec[..., 1]).astype(np.complex128) * mask
        seg = np.fft.irfft(x, size)[..., :stft.window_length] * (
            size * stft._istft_kernel_np[0][0])
        frames, length = seg.shape[-2:]
        out = np.zeros(seg.shape[:-2] + ((frames - 1) * shift + length,))
        for t in range(frames):
            out[..., t * shift:t * shift + length] += seg[..., t, :]
        assert np.abs(got - stft.crop_fading(out)).max() < ATOL / 10
