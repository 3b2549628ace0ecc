"""The bf16 LSTM backward's ``mma`` route on the CPU: its plan replayed at
an H100's limits, and its arithmetic emulated against the JAX package.

- **Plan** (``ops/kernels/lstm.py`` ``mma_plan``, the mirror of
  ``csrc/lstm_cell_scan_bwd.cu``'s): at the uPIT layer (16 rows a
  direction, H = 600), the DPRNN's chunk rows (260 and 400 rows, H = 128)
  and an odd H = 75, one block an SM in one wave, each (direction, row,
  unit) owned by one block, each k-step of K = 4H summed by one chunk of
  one warp, the chunks in order, every 8-row tile of a staged chunk
  taken once.  The route (``bwd_route``) is ``mma`` exactly where the
  staged search stages and the plan fits; above, ``streamed``.
- **Arithmetic**: a numpy emulation of the kernel's backward (the cell
  part in float32, dz stored as bf16, the product ``bf16(dz) @
  bf16(W_hh)^T`` summed on the tensor cores chunk by chunk from zero, the
  chunks added in float32 in chunk order).  With float32 products it
  matches the Pallas kernel in interpret mode with
  ``compute_dtype='bfloat16'`` (whose interpret mode keeps the products
  float32 and the streams bf16, ``padertorch_tpu/ops/pallas/lstm.py``
  ``_bwd_call``); with bf16 products it matches the Pallas kernel's step
  run in JAX with its own ``_dir_matmul(..., cast=bfloat16)``, and the
  port's plain version with ``compute_dtype='bfloat16'`` (the card's
  yardstick), while the float32-product control fails that limit.
  Limit: each dgates_x element within one bf16 unit in the last place plus
  1e-5, at most 5% of them other, the float32 states within 1e-5.  A dz
  that rounds the other way moves the later steps by a fraction of a unit,
  and such moves add up along a sequence: the sequences here are 16 steps
  (the card holds the kernel at 500 steps to one unit plus 2e-3,
  ``chip_smoke.py`` phase 23).  Weights as the modules draw them,
  uniform in +-1/sqrt(H).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops.pallas import lstm as jax_lstm
from padertorch_tpu_torch.ops.kernels.lstm import (
    MMA_KC_MAX, MMA_THREADS, MMA_UNITS, MMA_WARPS, bwd_route,
    lstm_cell_scan_bwd_plain, mma_plan, mma_smem, scan_grid)

torch.set_num_threads(2)

N_SM, MAX_SMEM = 132, 232448   # an H100
STREAM_ATOL, STATE_ATOL, SHARE = 1e-5, 1e-5, 0.05

# (rows per direction, H): the uPIT layer, the DPRNN's two, an odd H
PLAN_SHAPES = [(16, 600), (260, 128), (400, 128), (5, 75)]


@pytest.mark.parametrize('rows,hdim', PLAN_SHAPES + [(64, 256), (1, 1000)])
def test_mma_plan_owns_every_pair_and_chunk_once(rows, hdim):
    plan = mma_plan(2, rows, hdim, N_SM, MAX_SMEM)
    assert plan is not None and bwd_route(2, rows, hdim, True, N_SM,
                                          MAX_SMEM) == 'mma'
    # one block an SM, in one wave
    assert plan.blocks <= N_SM and plan.smem <= MAX_SMEM
    assert plan.smem == mma_smem(plan.KT, plan.KCH, plan.RB, plan.RS)
    assert MMA_THREADS == 32 * MMA_WARPS == 512
    owned = np.zeros((2, rows, hdim), int)
    for b in range(plan.blocks):
        ub, rb = b % plan.n_ub, b // plan.n_ub % plan.n_rb
        d = b // (plan.n_ub * plan.n_rb)
        r_lo = rb * plan.RB
        r_hi = min(rows, r_lo + plan.RB)
        assert r_lo < r_hi   # no block without rows
        owned[d, r_lo:r_hi, ub * MMA_UNITS:(ub + 1) * MMA_UNITS] += 1
    assert (owned == 1).all()
    # K = 4H in KT k-steps of 16, zero-padded
    assert 16 * (plan.KT - 1) < 4 * hdim <= 16 * plan.KT
    assert plan.KC <= MMA_KC_MAX
    # every k-step in one chunk, the chunks in order; each chunk's warps
    # take each 8-row tile of a staged chunk once
    steps = []
    for chunk in range(plan.KCH):
        lo = chunk * plan.KC
        steps += list(range(lo, min(plan.KT, lo + plan.KC)))
    assert steps == list(range(plan.KT))
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


def test_the_route_streams_where_the_staged_search_or_the_plan_does():
    """Two directions of 16 rows: ``mma`` to H = 1056 (66 slices of 16
    units a direction fill the 132 SMs), ``streamed`` from 1057, where the
    staged search streams too; one row a direction at H = 1100, which the
    staged search stages, streams (the plan's slices outnumber the SMs)."""
    for hdim in list(range(16, 1057, 16)) + [1056]:
        assert bwd_route(2, 16, hdim, True, N_SM, MAX_SMEM) == 'mma', hdim
    for hdim in (1057, 1536, 2048):
        assert scan_grid('lstm_bwd', 2, 16, hdim, N_SM, MAX_SMEM, 2).streamed
        assert bwd_route(2, 16, hdim, True, N_SM, MAX_SMEM) == 'streamed'
    assert not scan_grid('lstm_bwd', 2, 1, 1100, N_SM, MAX_SMEM, 2).streamed
    assert mma_plan(2, 1, 1100, N_SM, MAX_SMEM) is None
    assert bwd_route(2, 1, 1100, True, N_SM, MAX_SMEM) == 'streamed'


def bf16(x):
    """x rounded to bf16 (to nearest even) and widened to float32."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def emulate(gates, c_seq, w, mask, d_out, dh_t, dc_t, n_dir, kc,
            products):
    """The kernel's backward in numpy: the cell part in float32, dz stored
    as bf16, each direction's product in chunks of ``kc`` k-steps of 16
    (each chunk's sum from zero), the chunks added in float32 in order.
    ``products`` 'bf16': the stored bf16 dz times bf16(W_hh), the kernel's;
    'float32': the float32 dz times W_hh (the Pallas kernel's interpret
    mode, and the control)."""
    t_len, rows, width = gates.shape
    hdim, per_dir = width // 4, rows // n_dir
    k_steps = -(-width // 16)
    wq = bf16(w) if products == 'bf16' else np.float32(w)
    dh, dc = np.float32(dh_t), np.float32(dc_t)
    dgx = np.zeros(gates.shape, np.float32)
    for t in reversed(range(t_len)):
        i, f, g, o = np.split(gates[t], 4, -1)
        c_prev = c_seq[t]
        tanh_c = np.tanh(f * c_prev + i * g)
        dhh = dh + d_out[t]
        d_o = dhh * tanh_c
        dcc = dc + dhh * o * (1 - tanh_c * tanh_c)
        m = (np.ones((rows, 1), np.float32) if mask is None
             else mask[t][:, None])
        dz = np.concatenate([dcc * g * i * (1 - i), dcc * c_prev * f * (1 - f),
                             dcc * i * (1 - g * g), d_o * o * (1 - o)],
                            -1) * m
        dgx[t] = bf16(dz)
        z = dgx[t] if products == 'bf16' else np.float32(dz)
        new = np.zeros((rows, hdim), np.float32)
        for d in range(n_dir):
            part = slice(d * per_dir, (d + 1) * per_dir)
            acc = None
            for step in range(0, k_steps, kc):
                ks = slice(16 * step, min(width, 16 * (step + kc)))
                chunk = np.float32(z[part, ks] @ wq[d][:, ks].T)
                acc = chunk if acc is None else np.float32(acc + chunk)
            new[part] = acc
        dh = np.where(m > 0, new, dh)
        dc = np.where(m > 0, dcc * f, dc)
    return dgx, dh, dc


def jax_step_reference(gates, c_seq, w, mask, d_out, dh_t, dc_t, n_dir):
    """The Pallas backward kernel's step (``_bwd_kernel``) run in JAX with
    its own product ``_dir_matmul(dz, W_hh, transpose=True,
    cast=bfloat16)``, as the kernel runs it on the device: dgates_x bf16,
    the states float32."""
    w16 = jnp.asarray(w).astype(jnp.bfloat16)
    dh, dc = jnp.asarray(dh_t), jnp.asarray(dc_t)
    hdim = w.shape[1]
    dgx = []
    for t in reversed(range(gates.shape[0])):
        gt = jnp.asarray(gates[t])
        i, f = gt[:, :hdim], gt[:, hdim:2 * hdim]
        g, o = gt[:, 2 * hdim:3 * hdim], gt[:, 3 * hdim:]
        c_prev = jnp.asarray(c_seq[t])
        tanh_c = jnp.tanh(f * c_prev + i * g)
        dhh = dh + jnp.asarray(d_out[t])
        d_o = dhh * tanh_c
        dcc = dc + dhh * o * (1 - tanh_c * tanh_c)
        dz = jnp.concatenate([dcc * g * i * (1 - i), dcc * c_prev * f * (1 - f),
                              dcc * i * (1 - g * g), d_o * o * (1 - o)], -1)
        dh_prev = None
        if mask is not None:
            m = jnp.asarray(mask[t])[:, None]
            dz = dz * m
        dh_prev = jax_lstm._dir_matmul(dz, w16, n_dir, transpose=True,
                                       cast=jnp.bfloat16)
        dc_prev = dcc * f
        if mask is not None:
            dh_prev = jnp.where(m > 0, dh_prev, dh)
            dc_prev = jnp.where(m > 0, dc_prev, dc)
        dgx.append(np.asarray(dz.astype(jnp.bfloat16).astype(jnp.float32)))
        dh, dc = dh_prev, dc_prev
    return np.stack(dgx[::-1]), np.asarray(dh), np.asarray(dc)


def bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float64))
    exponent = np.floor(np.log2(np.where(x > 0, x, 1.0)))
    return np.where(x > 0, 2.0 ** (exponent - 7), 0.0)


def distance(got, want):
    """(largest difference beyond one bf16 unit of the larger value plus
    STREAM_ATOL, share of elements that differ)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    excess = diff - bf16_ulp(np.maximum(np.abs(got), np.abs(want))) \
        - STREAM_ATOL
    return float(excess.max()), float((diff > 0).mean())


# (T, rows per direction, H, directions, mask): H = 75 pads K = 300 to 304
EMULATION_CASES = [(16, 3, 75, 2, 'suffix'), (16, 4, 40, 1, None),
                   (16, 3, 72, 2, 'prefix'), (16, 3, 12, 2, 'suffix')]


@pytest.fixture(scope='module', params=EMULATION_CASES,
                ids=[f'H{c[2]}-{c[3]}dir-{c[4]}' for c in EMULATION_CASES])
def case(request):
    """Inputs, the Pallas kernel's residuals (interpret mode) and its
    backward (interpret mode: float32 products, bf16 streams)."""
    t_len, per_dir, hdim, n_dir, kind = request.param
    rng = np.random.RandomState(hdim)
    rows = n_dir * per_dir
    gates_x = rng.uniform(-1, 1, (t_len, rows, 4 * hdim)).astype('float32')
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
    d_out = bf16(rng.uniform(-1, 1, (t_len, rows, hdim)))
    dh_t, dc_t = (rng.uniform(-1, 1, (rows, hdim)).astype('float32')
                  for _ in range(2))
    m = None if mask is None else jnp.asarray(mask)
    w_j = jnp.asarray(w if n_dir > 1 else w[0])
    out, c_seq, gates, _, _ = jax_lstm._fwd_call(
        jnp.asarray(gates_x).astype(jnp.bfloat16), w_j, m, jnp.asarray(h0),
        jnp.asarray(c0), True, 'bfloat16')
    pallas = jax_lstm._bwd_call(
        (w_j, m, jnp.asarray(h0), out, c_seq, gates),
        (jnp.asarray(d_out).astype(jnp.bfloat16), jnp.asarray(dh_t),
         jnp.asarray(dc_t)), True, 'bfloat16')
    inputs = (np.array(gates.astype(jnp.float32)),
              np.array(c_seq.astype(jnp.float32)), w, mask, d_out, dh_t,
              dc_t)
    pallas = tuple(np.array(x.astype(jnp.float32))
                   for x in (pallas[0], pallas[2], pallas[3]))
    plan = mma_plan(n_dir, per_dir, hdim, N_SM, MAX_SMEM)
    return inputs, n_dir, plan.KC, pallas


def assert_within(got, want, name):
    excess, share = distance(got[0], want[0])
    assert excess <= 0 and share <= SHARE, (name, excess, share)
    for g, w_ in zip(got[1:], want[1:]):
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
    gates, c_seq, w, mask, d_out, dh_t, dc_t = inputs
    plain = lstm_cell_scan_bwd_plain(
        torch.from_numpy(gates).bfloat16(), torch.from_numpy(c_seq).bfloat16(),
        torch.from_numpy(w if n_dir > 1 else w[0]),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(d_out).bfloat16(), torch.from_numpy(dh_t),
        torch.from_numpy(dc_t), 'bfloat16')
    assert_within(got, [x.float().numpy() for x in plain],
                  'emulation vs plain')
    # the float32-product control fails the share
    control = emulate(*inputs, n_dir, kc, 'float32')
    _, share = distance(control[0], want[0])
    assert share > SHARE, share
