"""The GRU backward's resident route on the CPU: its planner
(``resident_bwd_plan``) at an H100's limits (132 SMs, 232,448 bytes of
shared memory a block may opt in to), its bytes written out, and a Python
replay of the kernel's split (``csrc/gru_cell_scan_bwd.cu``,
``gru_bwd_resident_kernel``): blocks, chunks, cell groups and K slices,
every (row, unit) owned once, every slice of the 3H columns covered once
and the slices' sums added in slice order.  The replay's adjoints equal
``gru_cell_scan_bwd_plain``'s at narrow shapes under contiguous-valid
masks, in float64 (``tests/test_torch_gru_kernel.py`` holds the plain
version against the JAX package's Pallas kernel at the same shapes).  The
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 8).
"""
import numpy as np
import pytest
import torch

from padertorch_tpu_torch.ops.kernels.gru import (
    RESIDENT_MAX_RS, RESIDENT_MAX_THREADS, ResidentPlan,
    gru_cell_scan_bwd_plain, gru_cell_scan_train_plain, resident_bwd_plan,
    resident_bwd_smem, resident_plan)

N_SM = 132
MAX_SMEM = 232_448

# (directions, rows per direction, H)
RESIDENT = {
    'DPRNN intra at 4 x 32000 samples': (2, 260, 128),
    'DPRNN inter at 4 x 32000 samples': (2, 400, 128),
    'classifier recipe': (1, 8, 64),
}
COOPERATIVE = {
    'classifier defaults': (1, 16, 256),
    'uPIT width': (2, 16, 600),
}
SHAPES = list(RESIDENT.values()) + [
    (2, 1000, 128), (2, 263, 128), (2, 3, 37), (1, 1, 8), (2, 5, 137),
    (1, 300, 16), (2, 33, 128), (2, 100, 128), (1, 37, 64),
]


@pytest.mark.parametrize('name', sorted(RESIDENT))
def test_main_path_shapes_take_the_resident_backward(name):
    plan = resident_bwd_plan(*RESIDENT[name], N_SM, MAX_SMEM)
    assert isinstance(plan, ResidentPlan)


@pytest.mark.parametrize('name', sorted(COOPERATIVE))
def test_wide_layers_keep_the_cooperative_backward(name):
    assert resident_bwd_plan(*COOPERATIVE[name], N_SM, MAX_SMEM) is None


def test_dprnn_shapes_get_the_grid_the_design_names():
    """520 rows: 130 blocks of 4; 800 rows: 116 blocks of 7, one chunk
    each, four K slices; H = 128 fits beside an 8-row stage and four
    slices' sums (225,280 bytes)."""
    intra = resident_bwd_plan(2, 260, 128, N_SM, MAX_SMEM)
    inter = resident_bwd_plan(2, 400, 128, N_SM, MAX_SMEM)
    assert (intra.RB, intra.RS, intra.KS, intra.blocks) == (4, 4, 4, 130)
    assert (inter.RB, inter.RS, inter.KS, inter.blocks) == (7, 7, 4, 116)
    assert intra.threads == inter.threads == 512
    assert resident_bwd_smem(128, 8, 4) == 225_280


@pytest.mark.parametrize('hdim,rs,ks', [
    (128, 4, 4), (128, 7, 4), (128, 8, 4), (64, 1, 4), (37, 3, 2),
    (137, 1, 1), (8, 1, 1), (100, 5, 2)])
def test_bytes_are_the_layout_written_out(hdim, rs, ks):
    """dgh of a chunk transposed, (3H, RS rounded up to 4); the K slices'
    sums, (KS, RS, H rounded up to 32), when KS > 1; W_hh[d] transposed,
    (3H, H); four bytes each."""
    rsp = -(-rs // 4) * 4
    hp = -(-hdim // 32) * 32
    floats = 3 * hdim * rsp + (ks * rs * hp if ks > 1 else 0) \
        + 3 * hdim * hdim
    assert resident_bwd_smem(hdim, rs, ks) == 4 * floats


@pytest.mark.parametrize('n_dir,rows_per_dir,hdim', SHAPES)
def test_planned_grid_fits_the_card(n_dir, rows_per_dir, hdim):
    plan = resident_bwd_plan(n_dir, rows_per_dir, hdim, N_SM, MAX_SMEM)
    hp = -(-hdim // 32) * 32
    assert plan.blocks == n_dir * -(-rows_per_dir // plan.RB) <= N_SM
    assert plan.RB == -(-rows_per_dir // (N_SM // n_dir))
    assert plan.smem == resident_bwd_smem(hdim, plan.RS, plan.KS) <= MAX_SMEM
    assert 1 <= plan.RS <= min(plan.RB, RESIDENT_MAX_RS)
    assert plan.KS in (1, 2, 4)
    assert plan.threads == (1 if plan.KS == 1 else 4) * hp
    assert plan.threads <= RESIDENT_MAX_THREADS
    if plan.KS > 1:
        assert -(-3 * hdim // plan.KS) >= 16       # each K slice


def test_route_switch_sits_one_unit_below_the_forwards():
    """The backward stages 3H columns of dgh where the forward stages H of
    h: its widest resident layer is H = 137, the forwards' 138."""
    for n_dir, rows in ((1, 1), (2, 260), (2, 400)):
        assert resident_bwd_plan(n_dir, rows, 137, N_SM, MAX_SMEM)
        assert resident_bwd_plan(n_dir, rows, 138, N_SM, MAX_SMEM) is None
        assert resident_plan(n_dir, rows, 138, N_SM, MAX_SMEM)


def replay(acts, gh_n, h_prev, w, mask, d_out, dh_t, plan):
    """The resident backward kernel's arithmetic, block by block, chunk
    by chunk, in the kernel's index arithmetic.  Returns (dgx, dgh, dh0,
    the count of cells each (direction, row) got, the K slices in the
    order they are added)."""
    t_len, rows, g3 = acts.shape
    hdim = g3 // 3
    n_dir = w.shape[0]
    bd = rows // n_dir
    hp = -(-hdim // 32) * 32
    groups = plan.threads // hp
    n_rb = -(-bd // plan.RB)
    k_len = -(-g3 // plan.KS)
    slices = [(min(g3, ks * k_len), min(g3, min(g3, ks * k_len) + k_len))
              for ks in range(plan.KS)]
    if mask is None:
        mask = torch.ones(t_len, rows, dtype=acts.dtype)
    dgx, dgh = torch.zeros_like(acts), torch.zeros_like(acts)
    dh0 = torch.full_like(dh_t, float('nan'))
    cells = {}
    for block in range(plan.blocks):
        d, r_lo = block // n_rb, block % n_rb * plan.RB
        r_hi = min(bd, r_lo + plan.RB)
        wt = w[d].t()                                  # (3H, H), as staged
        for rc in range(r_lo, r_hi, plan.RS):
            nr = min(plan.RS, r_hi - rc)
            for cg in range(groups):                   # a group's cells
                for r in range(cg, nr, groups):
                    key = (d, rc + r)
                    cells[key] = cells.get(key, 0) + 1
            idx = d * bd + rc + torch.arange(nr)
            carry = dh_t[idx].clone()
            for t in reversed(range(t_len)):
                r_, z_, n_ = acts[t, idx].split(hdim, dim=-1)
                m = mask[t, idx][:, None]
                dh = carry + d_out[t, idx]
                dz_pre = dh * (h_prev[t, idx] - n_) * z_ * (1 - z_)
                da_n = dh * (1 - z_) * (1 - n_ * n_)
                da_r = da_n * gh_n[t, idx] * r_ * (1 - r_)
                dgx[t, idx] = torch.cat([da_r, dz_pre, da_n], -1) * m
                g = torch.cat([da_r, dz_pre, da_n * r_], -1) * m
                dgh[t, idx] = g
                total = torch.zeros_like(carry)
                for lo, hi in slices:                  # in slice order
                    total = total + g[:, lo:hi] @ wt[lo:hi]
                carry = torch.where(m > 0, total + dh * z_, carry)
            dh0[idx] = carry
    return dgx, dgh, dh0, cells, slices


def _inputs(n_dir, bd, hdim, t_len, seed):
    """float64 residuals of the plain training forward under a suffix
    (contiguous-valid) mask, and cotangents."""
    rng = np.random.RandomState(seed)
    rows = n_dir * bd
    lens = rng.randint(1, t_len + 1, size=rows)
    lens[0] = t_len
    mask = torch.from_numpy(
        (np.arange(t_len)[:, None] < lens[None, :]).astype('float64'))
    gx = torch.from_numpy(rng.randn(t_len, rows, 3 * hdim) * 0.5)
    w = torch.from_numpy(rng.randn(n_dir, hdim, 3 * hdim) / np.sqrt(hdim))
    h0 = torch.from_numpy(rng.randn(rows, hdim) * 0.3)
    d_out = torch.from_numpy(rng.randn(t_len, rows, hdim))
    dh_t = torch.from_numpy(rng.randn(rows, hdim))
    _, acts, gh_n, h_prev, _ = gru_cell_scan_train_plain(gx, w, mask, h0)
    return acts, gh_n, h_prev, w, mask, d_out, dh_t


# (directions, rows per direction, H, T): the replay shapes of
# test_torch_gru_kernel.py's RESIDENT_REPLAY_SHAPES, then rows split over
# several blocks and chunks of a card with fewer SMs
REPLAY = [(2, 5, 37, 12, N_SM), (1, 8, 64, 12, N_SM),
          (2, 21, 40, 7, 8), (1, 19, 16, 5, 2)]


@pytest.mark.parametrize('n_dir,bd,hdim,t_len,n_sm', REPLAY)
def test_replayed_split_owns_every_cell_once_and_equals_plain(
        n_dir, bd, hdim, t_len, n_sm):
    plan = resident_bwd_plan(n_dir, bd, hdim, n_sm, MAX_SMEM)
    args = _inputs(n_dir, bd, hdim, t_len, seed=bd + hdim)
    dgx, dgh, dh0, cells, slices = replay(*args, plan)
    assert cells == {(d, r): 1 for d in range(n_dir) for r in range(bd)}
    assert slices[0][0] == 0 and slices[-1][1] == 3 * hdim
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    want = gru_cell_scan_bwd_plain(*args)
    for got, ref in zip((dgx, dgh, dh0), want):
        torch.testing.assert_close(got, ref, atol=1e-12, rtol=0)


def test_replay_splits_rows_into_chunks_and_slices():
    """The replay reaches the kernel's loops: the last REPLAY case runs
    blocks of ten rows (the second nine) in chunks of five on a two-SM
    card, with two K slices; the third, blocks of six rows with four."""
    plan = resident_bwd_plan(1, 19, 16, 2, MAX_SMEM)
    assert (plan.RB, plan.RS, plan.KS, plan.blocks) == (10, 5, 2, 2)
    plan = resident_bwd_plan(2, 21, 40, 8, MAX_SMEM)
    assert (plan.RB, plan.RS, plan.KS, plan.blocks) == (6, 6, 4, 8)
