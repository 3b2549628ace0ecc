"""The bf16 GRU training forward's and backward's ``mma`` route on the CPU:
its plan replayed at an H100's limits, and its arithmetic emulated against
the JAX package.

- **Plan** (``ops/kernels/gru.py`` ``mma_plan``, the mirror of
  ``gru_mma_plan`` in ``csrc/lstm_common.cuh``): at the DPRNN's chunk RNNs
  (260 and 400 rows a direction, H = 128), a served request's (33 and 100
  rows), the speaker classifier recipe's GRU (8 rows, H = 64, one
  direction), H = 12 and H = 100, rows in several chunks, and the widest H
  (``GRU_MMA_MAX_H``): one block an SM in one wave, each (direction, row,
  unit) owned by one block, each (row, unit) pair of a staged chunk by one
  thread, each k-step of each tile of 16 units summed by one warp, the
  chunks in order, at most 48 registers of ``W_hh`` a thread.  The route
  (``kernel_route``) is ``mma`` for the bf16 training forward and backward
  exactly where the bf16 resident plan exists and H <= 128, for the lean
  bf16 forward where the training forward's is (above, its ``cluster``
  route: ``test_torch_gru_cluster.py``); the float32 kernels never take
  it.
- **Arithmetic**: a numpy emulation of both kernels (the training forward:
  bf16(h_{t-1}) times bf16(W_hh) chunk by chunk, each chunk's sum from
  zero, the chunks added in float32 in chunk order, then the cell in
  float32, out, the gates, gh_n and bf16(h_{t-1}) stored as bf16; the
  backward: the adjoints in float32 from the stored bf16 residuals, dgx
  and dgh stored as bf16, dh_{t-1} = bf16(dgh) times bf16(W_hh)^T chunk by
  chunk the same way, plus dh * z).  With bf16 products it matches the
  Pallas kernels' steps run in JAX with their own ``_dir_matmul(...,
  cast=bfloat16)``, and the port's plain versions with
  ``compute_dtype='bfloat16'`` (the card's yardstick), while the
  float32-product control fails that limit; with float32 products it
  matches the Pallas kernels in interpret mode with
  ``compute_dtype='bfloat16'`` (interpret mode keeps the products float32
  and the streams bf16, ``padertorch_tpu/ops/pallas/gru.py`` ``_fwd_call``
  and ``_bwd_call``).  Limit (``chip_smoke.py`` phase 23's): each stream
  element within one bf16 unit in the last place plus 1e-3 (2e-3 in the
  backward), at most 5% of them other, the float32 states within 1e-5
  over the 16 steps here.  Weights as the modules draw them, uniform in
  +-1/sqrt(H).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.ops.pallas import gru as jax_gru
from padertorch_tpu.ops.pallas import lstm as jax_lstm
from padertorch_tpu_torch.ops.kernels.gru import (
    GRU_MMA_FWD_CHUNKS, GRU_MMA_MAX_H, MMA_KC, MMA_ROWS,
    MMA_THREADS, MMA_WARPS,
    gru_cell_scan_bwd_plain, gru_cell_scan_train_plain, kernel_route,
    mma_plan, mma_smem, resident_bwd_plan, resident_plan)

torch.set_num_threads(2)

N_SM, MAX_SMEM = 132, 232448   # an H100
STATE_ATOL, SHARE = 1e-5, 0.05
STREAM_ATOL = {'fwd_train': 1e-3, 'bwd': 2e-3}
KERNELS = ('fwd_train', 'bwd')

# (directions, rows per direction, H): the DPRNN's intra and inter chunk
# RNNs, a served request's two, the classifier recipe's GRU, H = 12 and
# 100, rows in two chunks of 8, the widest H in one direction
PLAN_SHAPES = [(2, 260, 128), (2, 400, 128), (2, 33, 128), (2, 100, 128),
               (1, 8, 64), (2, 3, 12), (1, 5, 100), (2, 1000, 128),
               (1, 20, GRU_MMA_MAX_H)]


@pytest.mark.parametrize('kernel', KERNELS)
@pytest.mark.parametrize('n_dir,rows,hdim', PLAN_SHAPES)
def test_mma_plan_owns_every_pair_and_k_step_once(kernel, n_dir, rows,
                                                   hdim):
    plan = mma_plan(kernel, n_dir, rows, hdim, N_SM, MAX_SMEM)
    assert plan is not None
    assert kernel_route(kernel, n_dir, rows, hdim, True, N_SM,
                        MAX_SMEM) == 'mma'
    # one block an SM, in one wave
    assert plan.blocks == n_dir * plan.n_rb <= N_SM
    assert plan.smem == mma_smem(kernel, hdim, plan.KT, plan.KCH) <= MAX_SMEM
    assert MMA_THREADS == 32 * MMA_WARPS == 512
    # every (direction, row, unit) in one block: a block owns all units
    owned = np.zeros((n_dir, rows), int)
    for b in range(plan.blocks):
        d, rb = b // plan.n_rb, b % plan.n_rb
        r_lo = rb * plan.RB
        r_hi = min(rows, r_lo + plan.RB)
        assert r_lo < r_hi   # no block without rows
        owned[d, r_lo:r_hi] += 1
        # the block's rows in chunks of RS <= 8 (one N tile), each chunk's
        # (row, unit) pairs owned by thread q % 512, its pair q // 512 < 2
        chunks = list(range(r_lo, r_hi, plan.RS))
        assert plan.RS <= MMA_ROWS
        pairs = np.zeros((MMA_THREADS, 2), int)
        for rc in chunks:
            nr = min(plan.RS, r_hi - rc)
            q = np.arange(nr * hdim)
            assert q.max() < 2 * MMA_THREADS
            pairs[q % MMA_THREADS, q // MMA_THREADS] += 1
        assert pairs.max() <= len(chunks)
    assert (owned == 1).all()
    # K (H forward, 3H backward) in KT k-steps of 16, zero-padded; warp w
    # takes tile w // KCH of 16 units and chunk w % KCH of KC k-steps
    k_len = 3 * hdim if kernel == 'bwd' else hdim
    assert 16 * (plan.KT - 1) < k_len <= 16 * plan.KT
    tiles = -(-hdim // 16)
    assert tiles * plan.KCH <= MMA_WARPS
    assert kernel == 'bwd' or plan.KCH <= GRU_MMA_FWD_CHUNKS
    taken = np.zeros((tiles, plan.KT), int)
    for w in range(MMA_WARPS):
        tile, chunk = w // plan.KCH, w % plan.KCH
        if tile >= tiles:
            continue
        lo = chunk * plan.KC
        assert lo < plan.KT
        steps = list(range(lo, min(plan.KT, lo + plan.KC)))
        # the chunks in order: chunk c follows chunk c - 1 without a gap
        assert steps[0] == chunk * plan.KC
        taken[tile, steps] += 1
    assert (taken == 1).all()
    # a warp's W_hh in registers: the instantiation that holds KC k-steps,
    # at most 48 registers (three gates' tiles forward, one backward)
    kcr = min(k for k in MMA_KC[kernel] if k >= plan.KC)
    assert (12 if kernel == 'fwd_train' else 4) * kcr <= 48


def test_the_recipe_shapes_take_one_block_an_sm():
    """Rows spread over the SMs (on an H100 faster than blocks of a whole
    N tile of 8 at both DPRNN shapes): 130 blocks of 4 rows at the intra
    shape, 116 of 7 at the inter shape, two warps a tile of 16 units at
    H = 128; the classifier recipe's 8 rows in 8 blocks."""
    for kernel, kt, kc in (('fwd_train', 8, 4), ('bwd', 24, 12)):
        intra = mma_plan(kernel, 2, 260, 128, N_SM, MAX_SMEM)
        inter = mma_plan(kernel, 2, 400, 128, N_SM, MAX_SMEM)
        assert (intra.blocks, intra.RB, intra.RS) == (130, 4, 4)
        assert (inter.blocks, inter.RB, inter.RS) == (116, 7, 7)
        for plan in (intra, inter):
            assert (plan.KT, plan.KC, plan.KCH) == (kt, kc, 2)
        clf = mma_plan(kernel, 1, 8, 64, N_SM, MAX_SMEM)
        assert (clf.blocks, clf.RB) == (8, 1)
        # the forward's four k-steps in two chunks (GRU_MMA_FWD_CHUNKS),
        # the backward's twelve in four
        assert (clf.KC, clf.KCH) == ((2, 2) if kernel == 'fwd_train'
                                     else (3, 4))


@pytest.mark.parametrize('n_dir,rows', [(2, 260), (2, 5), (1, 8), (1, 16)])
def test_the_route_is_mma_where_the_resident_plan_exists_to_the_widest_h(
        n_dir, rows):
    for hdim in range(1, 260, 3):
        for kernel, planner in (('fwd_train', resident_plan),
                                ('bwd', resident_bwd_plan)):
            resident = planner(n_dir, rows, hdim, N_SM, MAX_SMEM, elem=2)
            want = (None if resident is None
                    else 'mma' if hdim <= GRU_MMA_MAX_H else 'resident')
            assert kernel_route(kernel, n_dir, rows, hdim, True, N_SM,
                                MAX_SMEM) == want, (kernel, hdim)
            assert (mma_plan(kernel, n_dir, rows, hdim, N_SM, MAX_SMEM)
                    is not None) == (hdim <= GRU_MMA_MAX_H)
            # the float32 kernels keep their routes
            f32 = planner(n_dir, rows, hdim, N_SM, MAX_SMEM)
            assert kernel_route(kernel, n_dir, rows, hdim, False, N_SM,
                                MAX_SMEM) == (None if f32 is None
                                              else 'resident')
        # the lean bf16 forward takes mma where the training forward does
        # and the cluster route above (tests/test_torch_gru_cluster.py)
        assert kernel_route('fwd', n_dir, rows, hdim, True, N_SM,
                            MAX_SMEM) == (
            kernel_route('fwd_train', n_dir, rows, hdim, True, N_SM,
                         MAX_SMEM) if hdim <= GRU_MMA_MAX_H else 'cluster')


def test_the_widest_h_and_one_above():
    """H = 128: eight tiles of 16 units, two warps each; H = 129 would give
    a tile one warp holding all of K (108 registers of W_hh), so it keeps
    the resident FMA route, as do the classifier defaults' H = 256 (the
    cooperative grid) and wider layers."""
    assert GRU_MMA_MAX_H == 128
    for kernel in KERNELS:
        assert kernel_route(kernel, 2, 5, 128, True, N_SM, MAX_SMEM) == 'mma'
        assert mma_plan(kernel, 2, 5, 129, N_SM, MAX_SMEM) is None
        assert kernel_route(kernel, 2, 5, 129, True, N_SM,
                            MAX_SMEM) == 'resident'
        assert kernel_route(kernel, 1, 16, 256, True, N_SM, MAX_SMEM) is None
        assert kernel_route(kernel, 2, 16, 600, True, N_SM, MAX_SMEM) is None


def bf16(x):
    """x rounded to bf16 (to nearest even) and widened to float32."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def sigmoid(x):
    return np.float32(1) / (np.float32(1) + np.exp(-x))


def chunked(x, w, kc):
    """x (rows, K) @ w (K, N) in chunks of ``kc`` k-steps of 16, each
    chunk's sum from zero, the chunks added in float32 in order."""
    acc = None
    for lo in range(0, x.shape[1], 16 * kc):
        part = np.float32(x[:, lo:lo + 16 * kc] @ w[lo:lo + 16 * kc])
        acc = part if acc is None else np.float32(acc + part)
    return acc


def emulate_fwd(gx, w, mask, h0, n_dir, kc, products):
    """The training forward in numpy: returns (out, acts, gh_n, h_prev,
    h_T), the streams bf16.  ``products`` 'bf16': bf16(h_{t-1}) times
    bf16(W_hh), the kernel's; 'float32': the Pallas kernel's interpret
    mode, and the control."""
    t_len, rows, width = gx.shape
    hdim, per_dir = width // 3, rows // n_dir
    wq = bf16(w) if products == 'bf16' else np.float32(w)
    h = np.float32(h0)
    outs, acts, ghns, hprevs = [], [], [], []
    for t in range(t_len):
        hq = bf16(h) if products == 'bf16' else h
        gh = np.concatenate([
            chunked(hq[d * per_dir:(d + 1) * per_dir], wq[d], kc)
            for d in range(n_dir)])
        r = sigmoid(gx[t][:, :hdim] + gh[:, :hdim])
        z = sigmoid(gx[t][:, hdim:2 * hdim] + gh[:, hdim:2 * hdim])
        n = np.tanh(gx[t][:, 2 * hdim:] + r * gh[:, 2 * hdim:])
        h_new = (1 - z) * n + z * h
        m = (np.ones((rows, 1), np.float32) if mask is None
             else mask[t][:, None])
        acts.append(bf16(np.concatenate([r, z, n], -1)))
        ghns.append(bf16(gh[:, 2 * hdim:]))
        hprevs.append(bf16(h))
        h_new = np.where(m > 0, h_new, h)
        outs.append(bf16(h_new * m))
        h = h_new
    return (np.stack(outs), np.stack(acts), np.stack(ghns),
            np.stack(hprevs), h)


def emulate_bwd(acts, gh_n, h_prev, w, mask, d_out, dh_t, n_dir, kc,
                products):
    """The backward in numpy from bf16 residuals: returns (dgx, dgh, dh0).
    ``products`` 'bf16': bf16(dgh) times bf16(W_hh)^T, the kernel's;
    'float32': the float32 dgh times W_hh^T."""
    t_len, rows, width = acts.shape
    hdim, per_dir = width // 3, rows // n_dir
    wq = bf16(w) if products == 'bf16' else np.float32(w)
    carry = np.float32(dh_t)
    dgx, dgh = np.zeros_like(acts), np.zeros_like(acts)
    for t in reversed(range(t_len)):
        r, z, n = np.split(acts[t], 3, -1)
        dh = carry + d_out[t]
        dz_pre = dh * (h_prev[t] - n) * z * (1 - z)
        da_n = dh * (1 - z) * (1 - n * n)
        da_r = da_n * gh_n[t] * r * (1 - r)
        m = (np.ones((rows, 1), np.float32) if mask is None
             else mask[t][:, None])
        dgx[t] = bf16(np.concatenate([da_r, dz_pre, da_n], -1) * m)
        g = np.concatenate([da_r, dz_pre, da_n * r], -1) * m
        dgh[t] = bf16(g)
        operand = dgh[t] if products == 'bf16' else np.float32(g)
        product = np.concatenate([
            chunked(operand[d * per_dir:(d + 1) * per_dir], wq[d].T, kc)
            for d in range(n_dir)])
        carry = np.where(m > 0, product + dh * z, carry)
    return dgx, dgh, carry


def stored(x):
    return np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32))


def jax_fwd_step_reference(gx, w, mask, h0, n_dir):
    """The Pallas training forward's step (``_fwd_kernel``) run in JAX with
    its own product ``_dir_matmul(h, W_hh, cast=bfloat16)``, as the kernel
    runs it on the device: (out, acts, gh_n, h_prev, h_T)."""
    w16 = jnp.asarray(w).astype(jnp.bfloat16)
    h = jnp.asarray(h0)
    hdim = w.shape[1]
    outs, acts, ghns, hprevs = [], [], [], []
    for t in range(gx.shape[0]):
        gh = jax_lstm._dir_matmul(h, w16, n_dir, cast=jnp.bfloat16)
        g = jnp.asarray(gx[t])
        r = jax.nn.sigmoid(g[:, :hdim] + gh[:, :hdim])
        z = jax.nn.sigmoid(g[:, hdim:2 * hdim] + gh[:, hdim:2 * hdim])
        n = jnp.tanh(g[:, 2 * hdim:] + r * gh[:, 2 * hdim:])
        h_new = (1 - z) * n + z * h
        h_out = h_new
        if mask is not None:
            m = jnp.asarray(mask[t])[:, None]
            h_new = jnp.where(m > 0, h_new, h)
            h_out = h_new * m
        acts.append(stored(jnp.concatenate([r, z, n], -1)))
        ghns.append(stored(gh[:, 2 * hdim:]))
        hprevs.append(stored(h))
        outs.append(stored(h_out))
        h = h_new
    return (np.stack(outs), np.stack(acts), np.stack(ghns), np.stack(hprevs),
            np.asarray(h))


def jax_bwd_step_reference(acts, gh_n, h_prev, w, mask, d_out, dh_t, n_dir):
    """The Pallas backward's step (``_bwd_kernel``) run in JAX with its own
    product ``_dir_matmul(dgh, W_hh, transpose=True, cast=bfloat16)``:
    (dgx, dgh, dh0)."""
    w16 = jnp.asarray(w).astype(jnp.bfloat16)
    carry = jnp.asarray(dh_t)
    hdim = w.shape[1]
    dgx, dgh = [], []
    for t in reversed(range(acts.shape[0])):
        a = jnp.asarray(acts[t])
        r, z, n = a[:, :hdim], a[:, hdim:2 * hdim], a[:, 2 * hdim:]
        dh = carry + jnp.asarray(d_out[t])
        dz_pre = dh * (jnp.asarray(h_prev[t]) - n) * z * (1 - z)
        da_n = dh * (1 - z) * (1 - n * n)
        da_r = da_n * jnp.asarray(gh_n[t]) * r * (1 - r)
        gx_t = jnp.concatenate([da_r, dz_pre, da_n], -1)
        gh_t = jnp.concatenate([da_r, dz_pre, da_n * r], -1)
        if mask is not None:
            m = jnp.asarray(mask[t])[:, None]
            gx_t, gh_t = gx_t * m, gh_t * m
        dh_prev = jax_lstm._dir_matmul(gh_t, w16, n_dir, transpose=True,
                                       cast=jnp.bfloat16) + dh * z
        if mask is not None:
            dh_prev = jnp.where(m > 0, dh_prev, carry)
        dgx.append(stored(gx_t))
        dgh.append(stored(gh_t))
        carry = dh_prev
    return np.stack(dgx[::-1]), np.stack(dgh[::-1]), np.asarray(carry)


def bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float64))
    exponent = np.floor(np.log2(np.where(x > 0, x, 1.0)))
    return np.where(x > 0, 2.0 ** (exponent - 7), 0.0)


def distance(got, want, atol, valid=None):
    """Over the streams: (largest difference beyond one bf16 unit of the
    larger value plus ``atol``, share of elements that differ), the share
    over the (step, row) pairs where ``valid`` (T, rows) holds."""
    worst, differ, total = -np.inf, 0, 0
    for g, w_ in zip(got, want):
        g, w_ = np.asarray(g, np.float64), np.asarray(w_, np.float64)
        if valid is not None:
            g, w_ = g[valid], w_[valid]
        diff = np.abs(g - w_)
        excess = diff - bf16_ulp(np.maximum(np.abs(g), np.abs(w_))) - atol
        worst = max(worst, float(excess.max()))
        differ += int((diff > 0).sum())
        total += diff.size
    return worst, differ / total


def assert_within(got, want, kernel, n_streams, name):
    excess, share = distance(got[:n_streams], want[:n_streams],
                             STREAM_ATOL[kernel])
    assert excess <= 0 and share <= SHARE, (name, excess, share)
    for g, w_ in zip(got[n_streams:], want[n_streams:]):
        assert np.abs(np.asarray(g) - np.asarray(w_)).max() <= STATE_ATOL, \
            name


# (T, rows per direction, H, directions, mask): H = 12 under prefix
# padding (K = 36 in three k-steps backward), H = 40 and 100 in one
# direction (K padded to 48 and 112), H = 72, and the DPRNN's H = 128
EMULATION_CASES = [(16, 3, 12, 2, 'prefix'), (16, 4, 40, 1, None),
                   (16, 3, 72, 2, 'suffix'), (16, 2, 100, 1, 'suffix'),
                   (16, 2, 128, 2, 'suffix')]


@pytest.fixture(scope='module', params=EMULATION_CASES,
                ids=[f'H{c[2]}-{c[3]}dir-{c[4]}' for c in EMULATION_CASES])
def case(request):
    """Inputs (gx rounded to bf16, the stream the kernels read), the
    Pallas training forward and backward in interpret mode (float32
    products, bf16 streams), the backward's residuals as the JAX backward
    reads them (h_prev rebuilt from its bf16 out), and the chunks of the
    card's plans."""
    t_len, per_dir, hdim, n_dir, kind = request.param
    rng = np.random.RandomState(hdim + 3)
    rows = n_dir * per_dir
    gx = bf16(rng.uniform(-1, 1, (t_len, rows, 3 * hdim)))
    w = (rng.uniform(-1, 1, (n_dir, hdim, 3 * hdim))
         / np.sqrt(hdim)).astype('float32')
    h0 = rng.uniform(-0.1, 0.1, (rows, hdim)).astype('float32')
    d_out = bf16(rng.uniform(-1, 1, (t_len, rows, hdim)))
    dh_t = rng.uniform(-1, 1, (rows, hdim)).astype('float32')
    mask = None
    if kind is not None:
        lens = rng.randint(t_len // 2, t_len + 1, size=rows)
        lens[0] = t_len
        mask = (np.arange(t_len)[:, None] < lens[None, :]).astype('float32')
        if kind == 'prefix':
            mask = mask[::-1].copy()
    m = None if mask is None else jnp.asarray(mask)
    w_j = jnp.asarray(w if n_dir > 1 else w[0])
    out, acts, ghn, h_t = jax_gru._fwd_call(
        jnp.asarray(gx).astype(jnp.bfloat16), w_j, m, jnp.asarray(h0), True,
        'bfloat16')
    dgx, _, dh0 = jax_gru._bwd_call(
        (w_j, m, jnp.asarray(h0), out, acts, ghn),
        (jnp.asarray(d_out).astype(jnp.bfloat16), jnp.asarray(dh_t)), True,
        'bfloat16')
    # the JAX backward's h_prev: h0 then out shifted, plus h0 where a valid
    # step follows a masked one
    h0s = bf16(h0)
    out_np = np.array(out.astype(jnp.float32))
    h_prev = np.concatenate([h0s[None], out_np[:-1]])
    if mask is not None:
        starts = (mask[1:] * (1 - mask[:-1]))[..., None]
        h_prev[1:] = bf16(h_prev[1:] + starts * h0s[None])
    f32 = (lambda x: np.array(jnp.asarray(x).astype(jnp.float32)))
    pallas_fwd = (f32(out), f32(acts), f32(ghn), f32(h_t))
    residuals = (f32(acts), f32(ghn), h_prev)
    pallas_bwd = (f32(dgx), f32(dh0))
    kc = {kernel: mma_plan(kernel, n_dir, per_dir, hdim, N_SM, MAX_SMEM).KC
          for kernel in KERNELS}
    return dict(inputs=(gx, w, mask, h0), cot=(d_out, dh_t), n_dir=n_dir,
                kc=kc, pallas_fwd=pallas_fwd, residuals=residuals,
                pallas_bwd=pallas_bwd)


def test_forward_float32_products_match_the_interpret_kernel(case):
    got = emulate_fwd(*case['inputs'], case['n_dir'], case['kc']['fwd_train'],
                      'float32')
    # out, acts, gh_n (the interpret kernel keeps no h_prev), then h_T
    assert_within((*got[:3], got[4]), case['pallas_fwd'], 'fwd_train', 3,
                  'forward emulation vs Pallas interpret')


def test_forward_bf16_products_match_the_kernels_step_and_plain(case):
    inputs, n_dir = case['inputs'], case['n_dir']
    kc = case['kc']['fwd_train']
    got = emulate_fwd(*inputs, n_dir, kc, 'bf16')
    want = jax_fwd_step_reference(*inputs, n_dir)
    assert_within(got, want, 'fwd_train', 4, 'forward emulation vs the JAX '
                  'step')
    gx, w, mask, h0 = inputs
    plain = gru_cell_scan_train_plain(
        torch.from_numpy(gx).bfloat16(),
        torch.from_numpy(w if n_dir > 1 else w[0]),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(h0), 'bfloat16')
    assert_within(got, [x.float().numpy() for x in plain], 'fwd_train', 4,
                  'forward emulation vs plain')
    # the float32-product control fails the share over the valid steps (a
    # masked step's output is 0 whatever the product)
    control = emulate_fwd(*inputs, n_dir, kc, 'float32')
    _, share = distance(control[:4], want[:4], STREAM_ATOL['fwd_train'],
                        None if mask is None else mask > 0)
    assert share > SHARE, share


def test_backward_float32_products_match_the_interpret_kernel(case):
    _, w, mask, _ = case['inputs']
    got = emulate_bwd(*case['residuals'], w, mask, *case['cot'],
                      case['n_dir'], case['kc']['bwd'], 'float32')
    # dgx, then dh0 (the interpret kernel's dgh stays inside its VJP)
    assert_within((got[0], got[2]), case['pallas_bwd'], 'bwd', 1,
                  'backward emulation vs Pallas interpret')


def test_backward_bf16_products_match_the_kernels_step_and_plain(case):
    _, w, mask, _ = case['inputs']
    n_dir, kc = case['n_dir'], case['kc']['bwd']
    args = (*case['residuals'], w, mask, *case['cot'])
    got = emulate_bwd(*args, n_dir, kc, 'bf16')
    want = jax_bwd_step_reference(*args, n_dir)
    assert_within(got, want, 'bwd', 2, 'backward emulation vs the JAX step')
    acts, gh_n, h_prev = case['residuals']
    d_out, dh_t = case['cot']
    plain = gru_cell_scan_bwd_plain(
        *(torch.from_numpy(x).bfloat16() for x in (acts, gh_n, h_prev)),
        torch.from_numpy(w if n_dir > 1 else w[0]),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(d_out).bfloat16(), torch.from_numpy(dh_t),
        'bfloat16')
    assert_within(got, [x.float().numpy() for x in plain], 'bwd', 2,
                  'backward emulation vs plain')
    control = emulate_bwd(*args, n_dir, kc, 'float32')
    _, share = distance(control[:2], want[:2], STREAM_ATOL['bwd'])
    assert share > SHARE, share
