"""The bf16 LSTM forwards' ``mma`` route on the CPU: its plan replayed at an
H100's limits, and its arithmetic emulated against the JAX package.

- **Plan** (``ops/kernels/lstm.py`` ``mma_plan(..., 'lstm_fwd')``, the
  mirror of ``csrc/lstm_common.cuh``'s): at the uPIT layer (16 rows a
  direction, H = 600), the DPRNN's chunk rows (260 and 400 rows, H = 128),
  an odd H = 75 and unidirectional layers, one block an SM in one wave,
  each (direction, row, unit) owned by one block, each k-step of K = H
  summed by one chunk of one warp (for all four gates), the chunks in
  order, every 8-row tile of a staged chunk taken once.  The route
  (``fwd_route``) is ``mma`` exactly where the staged search stages and
  the plan fits, else ``streamed``.
- **Arithmetic**: a numpy emulation of the kernels' forward (bf16(h_{t-1})
  times bf16(W_hh) summed on the tensor cores chunk by chunk from zero,
  the chunks added in float32 in chunk order, then gx; the cell in
  float32; out, the gates and c_{t-1} stored as bf16).  With bf16 products
  it matches the Pallas forward's step run in JAX with its own
  ``_dir_matmul(..., cast=bfloat16)``, and the port's plain training
  forward with ``compute_dtype='bfloat16'`` (the card's yardstick), while
  the float32-product control fails that limit; with float32 products it
  matches the Pallas kernel in interpret mode with
  ``compute_dtype='bfloat16'`` (whose interpret mode keeps the products
  float32 and the streams bf16, ``padertorch_tpu/ops/pallas/lstm.py``
  ``_fwd_call``).  Limit (``chip_smoke.py`` phase 23's): each stream
  element within one bf16 unit in the last place plus 1e-3, at most 5% of
  them other, the float32 states within 1e-5 over the 16 steps here.
  Weights as the modules draw them, uniform in +-1/sqrt(H).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.ops.pallas import lstm as jax_lstm
from padertorch_tpu_torch.ops.kernels.lstm import (
    FWD_MMA_KC_MAX, FWD_MMA_RED, MMA_THREADS, MMA_UNITS, MMA_WARPS, fwd_route,
    lstm_cell_scan_train_plain, mma_plan, mma_smem, scan_grid)

torch.set_num_threads(2)

N_SM, MAX_SMEM = 132, 232448   # an H100
STREAM_ATOL, STATE_ATOL, SHARE = 1e-3, 1e-5, 0.05

# (directions, rows per direction, H): the uPIT layer, the DPRNN's two, an
# odd H, unidirectional layers, staged chunks of rows, one row
PLAN_SHAPES = [(2, 16, 600), (2, 260, 128), (2, 400, 128), (2, 5, 75),
               (1, 16, 256), (1, 8, 1280), (2, 100, 600), (2, 1, 1000)]


@pytest.mark.parametrize('n_dir,rows,hdim', PLAN_SHAPES)
def test_fwd_mma_plan_owns_every_pair_and_k_step_once(n_dir, rows, hdim):
    plan = mma_plan(n_dir, rows, hdim, N_SM, MAX_SMEM, 'lstm_fwd')
    assert plan is not None
    assert fwd_route(n_dir, rows, hdim, True, N_SM, MAX_SMEM) == 'mma'
    # one block an SM, in one wave
    assert plan.blocks <= N_SM and plan.smem <= MAX_SMEM
    assert plan.smem == mma_smem(plan.KT, plan.KCH, plan.RB, plan.RS,
                                 FWD_MMA_RED)
    assert MMA_THREADS == 32 * MMA_WARPS == 512
    owned = np.zeros((n_dir, rows, hdim), int)
    for b in range(plan.blocks):
        ub, rb = b % plan.n_ub, b // plan.n_ub % plan.n_rb
        d = b // (plan.n_ub * plan.n_rb)
        r_lo = rb * plan.RB
        r_hi = min(rows, r_lo + plan.RB)
        assert r_lo < r_hi   # no block without rows
        owned[d, r_lo:r_hi, ub * MMA_UNITS:(ub + 1) * MMA_UNITS] += 1
    assert (owned == 1).all()
    # K = H in KT k-steps of 16, zero-padded; a warp holds KC of each of
    # the four gates' M tiles in registers
    assert 16 * (plan.KT - 1) < hdim <= 16 * plan.KT
    assert plan.KC <= FWD_MMA_KC_MAX and 4 * 4 * plan.KC <= 80
    # every k-step in one chunk, the chunks in order; each chunk's warps
    # take each 8-row tile of a staged chunk once
    steps = []
    for chunk in range(plan.KCH):
        lo = chunk * plan.KC
        steps += list(range(lo, min(plan.KT, lo + plan.KC)))
    assert steps == list(range(plan.KT))
    assert plan.KCH * plan.NG <= MMA_WARPS
    tiles = -(-plan.RS // 8)
    for chunk in range(plan.KCH):
        groups = [w // plan.KCH for w in range(MMA_WARPS)
                  if w % plan.KCH == chunk and w // plan.KCH < plan.NG]
        assert groups == list(range(plan.NG))
        taken = sorted(nt for ng in groups for nt in range(ng, tiles,
                                                           plan.NG))
        assert taken == list(range(tiles))
    # the staged chunks of rows cover a range
    assert plan.RS <= plan.RB < plan.RS * (-(-plan.RB // plan.RS) + 1)


def test_the_recipe_shapes_take_one_block_an_sm():
    """About one block an SM: 76 blocks at the uPIT layer (38 slices of 16
    units a direction, one range of 16 rows), 128 at the DPRNN's shapes (8
    slices, 8 ranges of rows)."""
    upit = mma_plan(2, 16, 600, N_SM, MAX_SMEM, 'lstm_fwd')
    assert (upit.blocks, upit.n_rb, upit.RB, upit.KT, upit.KC) == (
        76, 1, 16, 38, 3)
    for rows in (260, 400):
        dprnn = mma_plan(2, rows, 128, N_SM, MAX_SMEM, 'lstm_fwd')
        assert (dprnn.blocks, dprnn.n_rb, dprnn.KC) == (128, 8, 1)
        assert dprnn.RS == dprnn.RB   # every row staged at once


@pytest.mark.parametrize('n_dir,rows', [(2, 16), (2, 2), (1, 16)])
def test_the_route_is_mma_where_the_staged_search_stages_and_it_fits(
        n_dir, rows):
    for hdim in list(range(8, 1400, 24)) + [1056, 1057, 1280, 1290]:
        grid = scan_grid('lstm_fwd', n_dir, rows, hdim, N_SM, MAX_SMEM, 2)
        plan = mma_plan(n_dir, rows, hdim, N_SM, MAX_SMEM, 'lstm_fwd')
        want = ('streamed' if grid.streamed or plan is None else 'mma')
        assert fwd_route(n_dir, rows, hdim, True, N_SM, MAX_SMEM) == want
        assert fwd_route(n_dir, rows, hdim, False, N_SM, MAX_SMEM) == (
            'streamed' if scan_grid('lstm_fwd', n_dir, rows, hdim, N_SM,
                                    MAX_SMEM).streamed else 'cooperative')


def test_the_route_boundaries_on_an_h100():
    """Two directions: ``mma`` to H = 1056 (66 slices of 16 units a
    direction fill the 132 SMs), ``streamed`` above: at 16 rows the
    staged search streams from 1057 too; at two rows (H = 1100) it would
    stage, and the FMA grid that did is gone.  One direction: ``mma`` to
    H = 1280 (a warp's five k-steps of each gate), ``streamed`` above."""
    assert fwd_route(2, 16, 1056, True, N_SM, MAX_SMEM) == 'mma'
    assert fwd_route(2, 16, 1057, True, N_SM, MAX_SMEM) == 'streamed'
    assert scan_grid('lstm_fwd', 2, 16, 1057, N_SM, MAX_SMEM, 2).streamed
    assert not scan_grid('lstm_fwd', 2, 2, 1100, N_SM, MAX_SMEM, 2).streamed
    assert mma_plan(2, 2, 1100, N_SM, MAX_SMEM, 'lstm_fwd') is None
    assert fwd_route(2, 2, 1100, True, N_SM, MAX_SMEM) == 'streamed'
    assert fwd_route(1, 16, 1280, True, N_SM, MAX_SMEM) == 'mma'
    assert fwd_route(1, 16, 1290, True, N_SM, MAX_SMEM) == 'streamed'


def bf16(x):
    """x rounded to bf16 (to nearest even) and widened to float32."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def sigmoid(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def emulate(gx, w, mask, h0, c0, n_dir, kc, products):
    """The kernels' training forward in numpy: each direction's product in
    chunks of ``kc`` k-steps of 16 (each chunk's sum from zero), the chunks
    added in float32 in order, then gx; the cell in float32; the streams
    stored as bf16.  ``products`` 'bf16': bf16(h_{t-1}) times bf16(W_hh),
    the kernels'; 'float32': h_{t-1} times W_hh (the Pallas kernel's
    interpret mode, and the control).  Returns (out, c_seq, gates, h_T,
    c_T)."""
    t_len, rows, width = gx.shape
    hdim, per_dir = width // 4, rows // n_dir
    k_steps = -(-hdim // 16)
    wq = bf16(w) if products == 'bf16' else np.float32(w)
    h, c = np.float32(h0), np.float32(c0)
    out = np.zeros((t_len, rows, hdim), np.float32)
    c_seq = np.zeros((t_len, rows, hdim), np.float32)
    acts = np.zeros((t_len, rows, width), np.float32)
    for t in range(t_len):
        hq = bf16(h) if products == 'bf16' else h
        z = np.zeros((rows, width), np.float32)
        for d in range(n_dir):
            part = slice(d * per_dir, (d + 1) * per_dir)
            acc = None
            for step in range(0, k_steps, kc):
                ks = slice(16 * step, min(hdim, 16 * (step + kc)))
                chunk = np.float32(hq[part, ks] @ wq[d][ks, :])
                acc = chunk if acc is None else np.float32(acc + chunk)
            z[part] = np.float32(gx[t][part] + acc)
        i, f = sigmoid(z[:, :hdim]), sigmoid(z[:, hdim:2 * hdim])
        g, o = np.tanh(z[:, 2 * hdim:3 * hdim]), sigmoid(z[:, 3 * hdim:])
        c_new = f * c + i * g
        h_new = o * np.tanh(c_new)
        m = (np.ones((rows, 1), np.float32) if mask is None
             else mask[t][:, None])
        acts[t] = bf16(np.concatenate([i, f, g, o], -1))
        c_seq[t] = bf16(c)
        h_new = np.where(m > 0, h_new, h)
        c_new = np.where(m > 0, c_new, c)
        out[t] = bf16(h_new * m)
        h, c = h_new, c_new
    return out, c_seq, acts, h, c


def jax_step_reference(gx, w, mask, h0, c0, n_dir):
    """The Pallas forward kernel's step (``_fwd_kernel``) run in JAX with
    its own product ``_dir_matmul(h, W_hh, cast=bfloat16)``, as the kernel
    runs it on the device: the streams bf16, the states float32."""
    w16 = jnp.asarray(w).astype(jnp.bfloat16)
    h, c = jnp.asarray(h0), jnp.asarray(c0)
    hdim = w.shape[1]
    outs, c_seq, acts = [], [], []

    def stored(x):
        return np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32))

    for t in range(gx.shape[0]):
        gates = jnp.asarray(gx[t]) + jax_lstm._dir_matmul(
            h, w16, n_dir, cast=jnp.bfloat16)
        i = jax.nn.sigmoid(gates[:, :hdim])
        f = jax.nn.sigmoid(gates[:, hdim:2 * hdim])
        g = jnp.tanh(gates[:, 2 * hdim:3 * hdim])
        o = jax.nn.sigmoid(gates[:, 3 * hdim:])
        c_new = f * c + i * g
        h_new = o * jnp.tanh(c_new)
        if mask is None:
            h_out = h_new
        else:
            m = jnp.asarray(mask[t])[:, None]
            h_new = jnp.where(m > 0, h_new, h)
            c_new = jnp.where(m > 0, c_new, c)
            h_out = h_new * m
        acts.append(stored(jnp.concatenate([i, f, g, o], -1)))
        c_seq.append(stored(c))
        outs.append(stored(h_out))
        h, c = h_new, c_new
    return (np.stack(outs), np.stack(c_seq), np.stack(acts), np.asarray(h),
            np.asarray(c))


def bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float64))
    exponent = np.floor(np.log2(np.where(x > 0, x, 1.0)))
    return np.where(x > 0, 2.0 ** (exponent - 7), 0.0)


def distance(got, want, valid=None):
    """Over the streams: (largest difference beyond one bf16 unit of the
    larger value plus STREAM_ATOL, share of elements that differ), the
    share over the (step, row) pairs where ``valid`` (T, rows) holds."""
    worst, differ, total = -np.inf, 0, 0
    for g, w_ in zip(got, want):
        g, w_ = np.asarray(g, np.float64), np.asarray(w_, np.float64)
        if valid is not None:
            g, w_ = g[valid], w_[valid]
        diff = np.abs(g - w_)
        excess = diff - bf16_ulp(np.maximum(np.abs(g), np.abs(w_))) \
            - STREAM_ATOL
        worst = max(worst, float(excess.max()))
        differ += int((diff > 0).sum())
        total += diff.size
    return worst, differ / total


# (T, rows per direction, H, directions, mask): H = 75 pads K = 75 to 80 and
# copies rows of h two bytes at a time; H = 264 sums two k-steps a chunk
EMULATION_CASES = [(16, 3, 75, 2, 'suffix'), (16, 4, 40, 1, None),
                   (16, 3, 72, 2, 'prefix'), (16, 3, 12, 2, 'suffix'),
                   (16, 2, 264, 2, 'suffix')]


@pytest.fixture(scope='module', params=EMULATION_CASES,
                ids=[f'H{c[2]}-{c[3]}dir-{c[4]}' for c in EMULATION_CASES])
def case(request):
    """Inputs (gx rounded to bf16, the stream the kernels read), the
    chunks of the card's plan, and the Pallas training forward in
    interpret mode (float32 products, bf16 streams)."""
    t_len, per_dir, hdim, n_dir, kind = request.param
    rng = np.random.RandomState(hdim + 1)
    rows = n_dir * per_dir
    gx = bf16(rng.uniform(-1, 1, (t_len, rows, 4 * hdim)))
    w = (rng.uniform(-1, 1, (n_dir, hdim, 4 * hdim))
         / np.sqrt(hdim)).astype('float32')
    h0, c0 = (rng.uniform(-0.1, 0.1, (rows, hdim)).astype('float32')
              for _ in range(2))
    mask = None
    if kind is not None:
        lens = rng.randint(t_len // 2, t_len + 1, size=rows)
        lens[0] = t_len
        mask = (np.arange(t_len)[:, None] < lens[None, :]).astype('float32')
        if kind == 'prefix':
            mask = mask[::-1].copy()
    pallas = jax_lstm._fwd_call(
        jnp.asarray(gx).astype(jnp.bfloat16),
        jnp.asarray(w if n_dir > 1 else w[0]),
        None if mask is None else jnp.asarray(mask), jnp.asarray(h0),
        jnp.asarray(c0), True, 'bfloat16')
    pallas = tuple(np.array(x.astype(jnp.float32)) for x in pallas)
    plan = mma_plan(n_dir, per_dir, hdim, N_SM, MAX_SMEM, 'lstm_fwd')
    return (gx, w, mask, h0, c0), n_dir, plan.KC, pallas


def assert_within(got, want, name):
    excess, share = distance(got[:3], want[:3])
    assert excess <= 0 and share <= SHARE, (name, excess, share)
    for g, w_ in zip(got[3:], want[3:]):
        assert np.abs(g - w_).max() <= STATE_ATOL, name


def test_float32_products_match_the_interpret_kernel(case):
    inputs, n_dir, kc, pallas = case
    got = emulate(*inputs, n_dir, kc, 'float32')
    assert_within(got, pallas, 'emulation vs Pallas interpret')


def test_bf16_products_match_the_kernels_step_and_plain(case):
    inputs, n_dir, kc, _ = case
    got = emulate(*inputs, n_dir, kc, 'bf16')
    want = jax_step_reference(*inputs, n_dir)
    assert_within(got, want, 'emulation vs the JAX step')
    # the card's yardstick, the port's plain version, within the same limit
    gx, w, mask, h0, c0 = inputs
    plain = lstm_cell_scan_train_plain(
        torch.from_numpy(gx).bfloat16(),
        torch.from_numpy(w if n_dir > 1 else w[0]),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(h0), torch.from_numpy(c0), 'bfloat16')
    assert_within(got, [x.float().numpy() for x in plain],
                  'emulation vs plain')
    # the float32-product control fails the share, over the valid steps
    # (a masked step's output is 0 whatever the product)
    control = emulate(*inputs, n_dir, kc, 'float32')
    _, share = distance(control[:3], want[:3],
                        None if mask is None else mask > 0)
    assert share > SHARE, share
