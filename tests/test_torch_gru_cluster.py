"""The lean bf16 GRU forward's ``cluster`` route on the CPU: its plan
replayed at an H100's limits, its route, and its arithmetic emulated
against the port's plain version and the JAX package.

Run alone with
``env JAX_PLATFORMS=cpu PYTHONPATH= python -m pytest tests/test_torch_gru_cluster.py -q``.

- **Plan** (``ops/kernels/gru.py`` ``cluster_plan``, the mirror of
  ``gru_cluster_plan`` in ``csrc/lstm_common.cuh``): a cluster of C CTAs
  owns a direction and a range of rows; CTA c the unit tiles [c n_ut / C,
  (c + 1) n_ut / C) of 16 units; warp w of a CTA a tile's three gates and a
  chunk of k-steps.  Replayed: every (unit, gate, k-step) of ``W_hh[d]``
  held by exactly one warp of one CTA, the chunks in order, every
  (direction, row) in one cluster, each CTA's (row, unit) pairs at most two
  a thread, at most 48 registers of ``W_hh`` a thread, C the smallest
  portable size that holds it (H = 256: C = 4, 48 registers), none above
  the reach (H = 320 on an H100).
- **Route** (``kernel_route('fwd', ..., bf16=True)``): ``mma`` exactly where
  the training forward's is, ``cluster`` from ``GRU_CLUSTER_MIN_H`` to the
  reach, the old routes above (the cooperative grid, as the card's planner
  says).
- **Arithmetic**: the route's per-unit arithmetic is the ``mma`` route's:
  bf16(h_{t-1}) times bf16(W_hh) in chunks of KC k-steps, each chunk's sum
  from zero, the chunks added in float32 in order, the cell in float32
  (the emulation of ``tests/test_torch_gru_mma.py`` at the cluster plan's
  KC).  It matches ``gru_cell_scan_plain(..., 'bfloat16')`` (the card's
  yardstick) and the Pallas kernel's step run in JAX with its own
  ``_dir_matmul(..., cast=bfloat16)``; with float32 products it matches
  the JAX ``gru_cell_scan`` lean forward with ``compute_dtype='bfloat16'``
  in interpret mode (which keeps the products float32), and that control
  fails the bf16 limit.  Limit (``chip_smoke.py`` phase 28's): each stream
  element within one bf16 unit in the last place plus 1e-3, at most 5% of
  them other, h_T within 1e-5 over the 12 steps here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops.pallas import gru as jax_gru
from padertorch_tpu_torch.ops.kernels.gru import (
    CLUSTER_SIZES, GRU_CLUSTER_KC, GRU_CLUSTER_MIN_H, GRU_MMA_MAX_H,
    MMA_ROWS, MMA_THREADS, MMA_WARPS, cluster_plan, cluster_shape,
    cluster_smem, gru_cell_scan_plain, kernel_route, mma_plan,
    resident_plan)
from tests.test_torch_gru_mma import (
    STATE_ATOL, SHARE, STREAM_ATOL, bf16, distance, emulate_fwd,
    jax_fwd_step_reference)

torch.set_num_threads(2)

N_SM, MAX_SMEM = 132, 232448   # an H100
REACH = 320                     # the widest H the plan takes there
# the clusters of 2, 4 and 8 CTAs of the route's kernel an H100 runs at
# once (cudaOccupancyMaxActiveClusters, as the card reported it)
H100_CLUSTERS = {2: 66, 4: 30, 8: 15}

# (directions, rows per direction, H): the class defaults' H = 256 (16
# rows, one direction), H just above the mma route's, the boundary
# shapes timed against the resident route (160, 192), odd H, rows in
# several chunks, and the reach
PLAN_SHAPES = [(1, 16, 256), (2, 5, 129), (1, 3, 160), (2, 40, 192),
               (1, 7, 200), (2, 16, 256), (1, 1000, 256), (1, 2, 300),
               (2, 9, REACH)]


def owned_tiles(plan, hdim, c):
    """CTA c's unit tiles [c n_ut / C, (c + 1) n_ut / C)."""
    n_ut = -(-hdim // 16)
    return range(c * n_ut // plan.C, (c + 1) * n_ut // plan.C)


@pytest.mark.parametrize('n_dir,rows,hdim', PLAN_SHAPES)
def test_cluster_plan_holds_every_weight_and_row_once(n_dir, rows, hdim):
    size = cluster_shape(hdim, MAX_SMEM)[0]
    for max_clusters in (H100_CLUSTERS[size], 3):
        plan = cluster_plan(n_dir, rows, hdim, MAX_SMEM, max_clusters)
        assert plan is not None
        assert plan.C in CLUSTER_SIZES
        per_dir = max_clusters // n_dir
        assert plan.n_rb <= per_dir
        assert plan.clusters == n_dir * plan.n_rb
        assert plan.blocks == plan.C * plan.clusters <= N_SM
        assert plan.smem == cluster_smem(plan.KT, plan.KCH, plan.TPC) \
            <= MAX_SMEM
        # every (direction, row) in one cluster, rows 8 at most at a time
        owned = np.zeros((n_dir, rows), int)
        for k in range(plan.clusters):
            d, rb = k // plan.n_rb, k % plan.n_rb
            r_lo, r_hi = rb * plan.RB, min(rows, (rb + 1) * plan.RB)
            assert r_lo < r_hi
            owned[d, r_lo:r_hi] += 1
        assert (owned == 1).all()
        assert plan.RS <= MMA_ROWS
        # K = H in KT k-steps of 16, zero-padded
        n_ut = -(-hdim // 16)
        assert plan.KT == n_ut and 16 * (n_ut - 1) < hdim <= 16 * n_ut
        # every (unit tile, gate, k-step) held by one warp of one CTA,
        # the three gates of a tile by the same warp, the chunks in order
        held = np.zeros((n_ut, 3, plan.KT), int)
        wpt = MMA_WARPS // plan.TPC
        for c in range(plan.C):
            tiles = owned_tiles(plan, hdim, c)
            assert 1 <= len(tiles) <= plan.TPC
            # the CTA's (row, unit) pairs: at most two a thread
            assert plan.RS * 16 * len(tiles) <= 2 * MMA_THREADS
            for w in range(MMA_WARPS):
                lt, chunk = w // wpt, w % wpt
                if lt >= len(tiles) or chunk >= plan.KCH:
                    continue
                lo = chunk * plan.KC
                steps = range(lo, min(plan.KT, lo + plan.KC))
                assert len(steps) >= 1
                held[tiles[lt], :, steps] += 1
        assert (held == 1).all()
        # a warp's W_hh: three gates x KC k-steps x 4 registers
        assert 12 * plan.KC <= 12 * GRU_CLUSTER_KC == 48


def test_the_smallest_cluster_that_fits():
    """C is the smallest portable size whose warps hold at most 48
    registers of W_hh; H = 256 gives C = 4, four tiles a CTA, four chunks
    of four k-steps: 48 registers a thread."""
    for hdim in range(GRU_CLUSTER_MIN_H, REACH + 1):
        c, tpc, k_steps, kc, chunks, _ = cluster_shape(hdim, MAX_SMEM)
        n_ut = -(-hdim // 16)
        for smaller in (s for s in CLUSTER_SIZES if s < c):
            t = -(-n_ut // smaller)
            assert -(-n_ut // min(MMA_WARPS // t, n_ut)) > GRU_CLUSTER_KC
        assert kc <= GRU_CLUSTER_KC
    plan = cluster_plan(1, 16, 256, MAX_SMEM, H100_CLUSTERS[4])
    assert (plan.C, plan.TPC, plan.KT, plan.KC, plan.KCH) == (4, 4, 16, 4, 4)
    assert 3 * plan.KC * 4 == 48
    # the class defaults' 16 rows: one row a cluster of four CTAs
    assert (plan.RB, plan.n_rb, plan.blocks) == (1, 16, 64)
    assert cluster_shape(129, MAX_SMEM)[0] == 2
    assert cluster_shape(192, MAX_SMEM)[0] == 4
    assert cluster_shape(REACH, MAX_SMEM)[0] == 8
    # more rows than clusters: a direction's rows over 30 clusters of 4,
    # 8 at most staged at a time
    wide = cluster_plan(1, 1000, 256, MAX_SMEM, H100_CLUSTERS[4])
    assert (wide.n_rb, wide.RB, wide.RS, wide.blocks) == (30, 34, 7, 120)


@pytest.mark.parametrize('hdim', [REACH + 1, 400, 600, 1024, 2048])
def test_the_plan_refuses_above_its_reach(hdim):
    assert cluster_shape(hdim, MAX_SMEM) is None
    assert all(cluster_plan(1, 16, hdim, MAX_SMEM, n) is None
               for n in H100_CLUSTERS.values())
    assert kernel_route('fwd', 1, 16, hdim, True, N_SM, MAX_SMEM) != \
        'cluster'


@pytest.mark.parametrize('n_dir,rows', [(2, 260), (2, 5), (1, 8), (1, 16)])
def test_the_lean_route_by_width(n_dir, rows):
    for hdim in range(1, 420, 3):
        lean = kernel_route('fwd', n_dir, rows, hdim, True, N_SM, MAX_SMEM)
        train = kernel_route('fwd_train', n_dir, rows, hdim, True, N_SM,
                             MAX_SMEM)
        if hdim <= GRU_MMA_MAX_H:
            # mma exactly where the training forward's is
            assert lean == train, hdim
            assert train == ('mma' if resident_plan(
                n_dir, rows, hdim, N_SM, MAX_SMEM, elem=2) else None)
            assert mma_plan('fwd_train', n_dir, rows, hdim, N_SM,
                            MAX_SMEM) is not None
        elif hdim <= REACH:
            assert hdim >= GRU_CLUSTER_MIN_H
            assert lean == 'cluster', hdim
        else:
            # the old routes: no resident plan holds W_hh that wide
            assert resident_plan(n_dir, rows, hdim, N_SM, MAX_SMEM,
                                 elem=2) is None
            assert lean is None, hdim
        # the float32 lean forward keeps its routes
        f32 = resident_plan(n_dir, rows, hdim, N_SM, MAX_SMEM)
        assert kernel_route('fwd', n_dir, rows, hdim, False, N_SM,
                            MAX_SMEM) == (None if f32 is None
                                          else 'resident')


# (T, rows per direction, H, directions, mask): the class defaults' H
# = 256 in one direction, ragged (held against the JAX kernel), and
# H = 144 in two directions under prefix padding (against plain)
H256 = (12, 3, 256, 1, 'ragged')
H144 = (12, 3, 144, 2, 'prefix')


def layer(t_len, per_dir, hdim, n_dir, kind):
    """Inputs from a seed: gx rounded to bf16 (the stream the kernel
    reads), W_hh as the modules draw it, h0, the mask."""
    rng = np.random.RandomState(hdim + 5)
    rows = n_dir * per_dir
    gx = bf16(rng.uniform(-1, 1, (t_len, rows, 3 * hdim)))
    w = (rng.uniform(-1, 1, (n_dir, hdim, 3 * hdim))
         / np.sqrt(hdim)).astype('float32')
    h0 = rng.uniform(-0.1, 0.1, (rows, hdim)).astype('float32')
    lens = rng.randint(t_len // 2, t_len + 1, size=rows)
    lens[0] = t_len
    mask = (np.arange(t_len)[:, None] < lens[None, :]).astype('float32')
    if kind == 'prefix':
        mask = mask[::-1].copy()
    return gx, w, mask, h0


def plain_lean(gx, w, mask, h0, n_dir, compute_dtype='bfloat16'):
    out, h_t = gru_cell_scan_plain(
        torch.from_numpy(gx).bfloat16(),
        torch.from_numpy(w if n_dir > 1 else w[0]),
        torch.from_numpy(mask), torch.from_numpy(h0), compute_dtype)
    return out.float().numpy(), h_t.numpy()


def assert_within(got, want, name):
    """The lean forward's (out, h_T) within phase 28's limits."""
    excess, share = distance(got[:1], want[:1], STREAM_ATOL['fwd_train'])
    assert excess <= 0 and share <= SHARE, (name, excess, share)
    assert np.abs(np.asarray(got[1]) - np.asarray(want[1])).max() \
        <= STATE_ATOL, name


@pytest.fixture(scope='module')
def h256():
    """The class defaults' width: the inputs, the cluster plan's KC, and
    the JAX lean forward in interpret mode (float32 products, bf16
    streams), computed once for the module."""
    t_len, per_dir, hdim, n_dir, _ = H256
    inputs = layer(*H256)
    gx, w, mask, h0 = inputs
    out, h_t = jax_gru.gru_cell_scan(
        jnp.asarray(gx).astype(jnp.bfloat16), jnp.asarray(w[0]),
        jnp.asarray(mask), jnp.asarray(h0), True, 'bfloat16')
    kc = cluster_plan(n_dir, per_dir, hdim, MAX_SMEM,
                      H100_CLUSTERS[cluster_shape(hdim, MAX_SMEM)[0]]).KC
    return dict(inputs=inputs, kc=kc, n_dir=n_dir,
                pallas=(np.asarray(out.astype(jnp.float32)),
                        np.asarray(h_t)))


def test_float32_products_match_the_jax_lean_forward_in_interpret_mode(
        h256):
    got = emulate_fwd(*h256['inputs'], h256['n_dir'], h256['kc'],
                      'float32')
    assert_within((got[0], got[4]), h256['pallas'],
                  'emulation vs the Pallas lean forward in interpret mode')


def test_bf16_products_match_the_kernels_step_and_plain(h256):
    inputs, n_dir, kc = h256['inputs'], h256['n_dir'], h256['kc']
    got = emulate_fwd(*inputs, n_dir, kc, 'bf16')
    got = (got[0], got[4])
    step = jax_fwd_step_reference(*inputs, n_dir)
    assert_within(got, (step[0], step[4]), 'emulation vs the JAX step')
    assert_within(got, plain_lean(*inputs, n_dir), 'emulation vs plain')
    # the float32-product control fails the share over the valid steps
    control = emulate_fwd(*inputs, n_dir, kc, 'float32')
    _, share = distance(control[:1], step[:1], STREAM_ATOL['fwd_train'],
                        inputs[2] > 0)
    assert share > SHARE, share


def test_two_directions_under_prefix_padding_match_plain():
    t_len, per_dir, hdim, n_dir, _ = H144
    inputs = layer(*H144)
    kc = cluster_plan(n_dir, per_dir, hdim, MAX_SMEM,
                      H100_CLUSTERS[cluster_shape(hdim, MAX_SMEM)[0]]).KC
    got = emulate_fwd(*inputs, n_dir, kc, 'bf16')
    assert_within((got[0], got[4]), plain_lean(*inputs, n_dir),
                  'emulation vs plain')
    control = plain_lean(*inputs, n_dir, compute_dtype=None)
    _, share = distance(control[:1], got[:1], STREAM_ATOL['fwd_train'],
                        inputs[2] > 0)
    assert share > SHARE, share
