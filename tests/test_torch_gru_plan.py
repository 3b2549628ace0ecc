"""The GRU forwards' choice of route, made from the shape alone before the
launch: ``resident_plan`` at an H100's limits (132 SMs, 232,448 bytes of
shared memory a block may opt in to).  The resident kernel's index
arithmetic (``csrc/gru_cell_scan.cu``, ``gru_fwd_resident_kernel``) is
replayed here in Python, so that every planned grid is shown to give each
row of each direction to exactly one block, chunk and cell.  The bf16
variants' plans (``elem=2``: ``W_hh`` staged as bf16) likewise, for the
forwards and the backward, whose bf16 resident routes reach H = 195 and
192; the float32 plans are unchanged.
"""
import pytest

from padertorch_tpu_torch.ops.kernels.gru import (
    RESIDENT_MAX_RS, RESIDENT_MAX_THREADS, ResidentPlan, resident_bwd_plan,
    resident_bwd_smem, resident_plan, resident_smem)

N_SM = 132
MAX_SMEM = 232_448

# (directions, rows per direction, H)
RESIDENT = {
    'DPRNN intra at 4 x 32000 samples': (2, 260, 128),
    'DPRNN inter at 4 x 32000 samples': (2, 400, 128),
    'served request, intra': (2, 33, 128),
    'served request, inter': (2, 100, 128),
    'classifier recipe': (1, 8, 64),
}
COOPERATIVE = {
    'classifier defaults': (1, 16, 256),
    'uPIT width': (2, 16, 600),
    'does not fit any grid': (2, 2, 2048),
}
# odd rows per direction (Bd not a multiple of RB), rows beyond one chunk,
# ragged and tiny widths, one row
SHAPES = list(RESIDENT.values()) + [
    (2, 1000, 128), (2, 263, 128), (1, 131, 128), (1, 133, 128),
    (2, 1, 128), (1, 1, 138), (2, 70, 130), (2, 3, 37), (1, 300, 16),
    (1, 40, 32), (1, 1, 8), (2, 17, 64), (1, 5000, 64), (2, 7, 100),
    (2, 1000, 138),
]


def replay(n_dir, rows_per_dir, hdim, plan):
    """How many times the kernel would apply the cell to each (direction,
    row) (a thread group covers every unit of a row): its block, chunk and
    cell-group arithmetic."""
    hp = -(-hdim // 32) * 32
    groups = plan.threads // hp
    n_rb = -(-rows_per_dir // plan.RB)
    cells_per_thread = -(-plan.RS // groups)
    seen = {}
    for block in range(plan.blocks):
        d, r_lo = block // n_rb, block % n_rb * plan.RB
        r_hi = min(rows_per_dir, r_lo + plan.RB)
        for rc in range(r_lo, r_hi, plan.RS):
            nr = min(plan.RS, r_hi - rc)
            for cg in range(groups):
                for j in range(cells_per_thread):
                    r = cg + j * groups
                    if r >= nr:
                        break
                    key = (d, rc + r)
                    seen[key] = seen.get(key, 0) + 1
    return seen


@pytest.mark.parametrize('name', sorted(RESIDENT))
def test_main_path_shapes_take_the_resident_route(name):
    plan = resident_plan(*RESIDENT[name], N_SM, MAX_SMEM)
    assert isinstance(plan, ResidentPlan)


def test_dprnn_shapes_get_the_grid_the_design_names():
    """520 rows: 130 blocks of 4; 800 rows: 116 blocks of 7, one chunk
    each."""
    intra = resident_plan(2, 260, 128, N_SM, MAX_SMEM)
    inter = resident_plan(2, 400, 128, N_SM, MAX_SMEM)
    assert (intra.RB, intra.RS, intra.blocks) == (4, 4, 130)
    assert (inter.RB, inter.RS, inter.blocks) == (7, 7, 116)


@pytest.mark.parametrize('name', sorted(COOPERATIVE))
def test_wide_layers_keep_the_cooperative_route(name):
    assert resident_plan(*COOPERATIVE[name], N_SM, MAX_SMEM) is None


@pytest.mark.parametrize('n_dir,rows_per_dir,hdim', SHAPES)
def test_planned_grid_fits_the_card(n_dir, rows_per_dir, hdim):
    plan = resident_plan(n_dir, rows_per_dir, hdim, N_SM, MAX_SMEM)
    hp = -(-hdim // 32) * 32
    assert plan.blocks == n_dir * -(-rows_per_dir // plan.RB)
    assert plan.blocks <= N_SM                      # one wave
    assert plan.smem == resident_smem(hdim, plan.RS, plan.KS) <= MAX_SMEM
    assert 1 <= plan.RS <= min(plan.RB, RESIDENT_MAX_RS)
    assert plan.KS in (1, 2, 4)
    assert plan.threads == (1 if plan.KS == 1 else 4) * hp
    assert plan.threads <= RESIDENT_MAX_THREADS
    if plan.KS > 1:
        assert -(-hdim // plan.KS) >= 16            # each K slice


@pytest.mark.parametrize('n_dir,rows_per_dir,hdim', SHAPES)
def test_planned_grid_applies_every_cell_once(n_dir, rows_per_dir, hdim):
    plan = resident_plan(n_dir, rows_per_dir, hdim, N_SM, MAX_SMEM)
    seen = replay(n_dir, rows_per_dir, hdim, plan)
    assert seen == {(d, r): 1 for d in range(n_dir)
                    for r in range(rows_per_dir)}


@pytest.mark.parametrize('n_dir,rows_per_dir,hdim', SHAPES)
def test_rows_spread_as_evenly_as_one_wave_allows(n_dir, rows_per_dir, hdim):
    """RB is the fewest rows a block can take with at most one block per SM
    for each direction's share of the SMs."""
    plan = resident_plan(n_dir, rows_per_dir, hdim, N_SM, MAX_SMEM)
    assert plan.RB == -(-rows_per_dir // (N_SM // n_dir))


def largest_resident_width(max_smem):
    """The largest H whose packed W_hh (3 H^2 floats) plus one row's
    staging (h transposed and padded to 4 rows: 4 H floats) fits."""
    hdim = 1
    while 4 * (3 * (hdim + 1) ** 2 + 4 * (hdim + 1)) <= max_smem:
        hdim += 1
    return hdim


@pytest.mark.parametrize('max_smem', [MAX_SMEM, 101_376, 166_912])
def test_route_switch_sits_at_the_largest_width_that_fits(max_smem):
    widest = largest_resident_width(max_smem)
    for n_dir, rows in ((1, 1), (2, 260), (2, 400)):
        assert resident_plan(n_dir, rows, widest, N_SM, max_smem) is not None
        assert resident_plan(n_dir, rows, widest + 1, N_SM, max_smem) is None
    if max_smem == MAX_SMEM:
        assert widest == 138


@pytest.mark.parametrize('n_dir,rows_per_dir,hdim', SHAPES)
def test_a_block_takes_the_fewest_chunks_that_fit(n_dir, rows_per_dir, hdim):
    """A block walks its rows in the fewest chunks of at most
    RESIDENT_MAX_RS rows whose staging fits beside W_hh, evened out."""
    plan = resident_plan(n_dir, rows_per_dir, hdim, N_SM, MAX_SMEM)
    chunks = -(-plan.RB // plan.RS)
    assert plan.RS == -(-plan.RB // chunks)
    if chunks > -(-plan.RB // RESIDENT_MAX_RS):
        fewer = -(-plan.RB // (chunks - 1))
        assert resident_smem(hdim, fewer, 1) > MAX_SMEM


# the bf16 variants stage W_hh as bf16 (2 bytes an element): the same
# planners with ``elem=2``; the float32 plans above are the default
BF16_SHAPES = SHAPES + [(2, 260, 192), (1, 8, 192), (2, 400, 160),
                        (2, 5, 150), (1, 1, 192)]


def largest_bf16_width(max_smem, bwd=False):
    """The largest H whose W_hh in bf16 (3 H^2 halves) fits beside one
    row's staging, float32: h (H) or dgh (3H) transposed and padded to 4
    rows."""
    stage = 12 if bwd else 4
    hdim = 1
    while 2 * 3 * (hdim + 1) ** 2 + 4 * stage * (hdim + 1) <= max_smem:
        hdim += 1
    return hdim


def test_float32_plans_are_the_default():
    for n_dir, rows, hdim in SHAPES + list(COOPERATIVE.values()):
        assert resident_plan(n_dir, rows, hdim, N_SM, MAX_SMEM) == \
            resident_plan(n_dir, rows, hdim, N_SM, MAX_SMEM, elem=4)
        assert resident_bwd_plan(n_dir, rows, hdim, N_SM, MAX_SMEM) == \
            resident_bwd_plan(n_dir, rows, hdim, N_SM, MAX_SMEM, elem=4)


@pytest.mark.parametrize('hdim,rs,ks', [(128, 4, 4), (195, 1, 1),
                                        (64, 8, 2), (37, 3, 1)])
def test_bf16_bytes_are_the_layout_written_out(hdim, rs, ks):
    """W_hh at 2 bytes an element, the staging and the K slices' sums at
    4, as the kernels lay them out."""
    hp, rsp = -(-hdim // 32) * 32, -(-rs // 4) * 4
    red = ks * rs * 3 * hp if ks > 1 else 0
    assert resident_smem(hdim, rs, ks, 2) == \
        4 * (hdim * rsp + red) + 2 * 3 * hdim * hdim
    red = ks * rs * hp if ks > 1 else 0
    assert resident_bwd_smem(hdim, rs, ks, 2) == \
        4 * (3 * hdim * rsp + red) + 2 * 3 * hdim * hdim
    assert resident_smem(hdim, rs, ks, 4) == resident_smem(hdim, rs, ks)


@pytest.mark.parametrize('plan_fn,smem_fn', [
    (resident_plan, resident_smem), (resident_bwd_plan, resident_bwd_smem)])
@pytest.mark.parametrize('n_dir,rows_per_dir,hdim', BF16_SHAPES)
def test_bf16_planned_grid_fits_and_applies_every_cell_once(
        plan_fn, smem_fn, n_dir, rows_per_dir, hdim):
    plan = plan_fn(n_dir, rows_per_dir, hdim, N_SM, MAX_SMEM, elem=2)
    hp = -(-hdim // 32) * 32
    assert plan.blocks == n_dir * -(-rows_per_dir // plan.RB) <= N_SM
    assert plan.smem == smem_fn(hdim, plan.RS, plan.KS, 2) <= MAX_SMEM
    assert 1 <= plan.RS <= min(plan.RB, RESIDENT_MAX_RS)
    assert plan.threads == (1 if plan.KS == 1 else 4) * hp
    assert plan.threads <= RESIDENT_MAX_THREADS
    assert replay(n_dir, rows_per_dir, hdim, plan) == {
        (d, r): 1 for d in range(n_dir) for r in range(rows_per_dir)}


@pytest.mark.parametrize('max_smem', [MAX_SMEM, 101_376, 166_912])
def test_bf16_route_switch_sits_at_the_largest_width_that_fits(max_smem):
    """The bf16 resident routes reach H = 195 (forwards) and 192
    (backward) on an H100, where float32 stops at 138 and 137; the
    classifier defaults' H = 256 stays cooperative."""
    for plan_fn, bwd in ((resident_plan, False), (resident_bwd_plan, True)):
        widest = largest_bf16_width(max_smem, bwd)
        for n_dir, rows in ((1, 1), (2, 260), (2, 400)):
            assert plan_fn(n_dir, rows, widest, N_SM, max_smem,
                           elem=2) is not None
            assert plan_fn(n_dir, rows, widest + 1, N_SM, max_smem,
                           elem=2) is None
        if max_smem == MAX_SMEM:
            assert widest == (192 if bwd else 195)
    for plan_fn in (resident_plan, resident_bwd_plan):
        assert plan_fn(1, 16, 256, N_SM, MAX_SMEM, elem=2) is None
        assert plan_fn(1, 8, 64, N_SM, MAX_SMEM, elem=2) is not None


def test_bf16_dprnn_shapes_take_one_chunk_a_block():
    """In bf16 the inter-chunk rows (800: 116 blocks of 7) fit in one
    chunk of seven beside W_hh in both kernels, as the float32 forward's
    do; four K slices."""
    for plan_fn in (resident_plan, resident_bwd_plan):
        intra = plan_fn(2, 260, 128, N_SM, MAX_SMEM, elem=2)
        inter = plan_fn(2, 400, 128, N_SM, MAX_SMEM, elem=2)
        assert (intra.RB, intra.RS, intra.KS, intra.blocks) == (4, 4, 4, 130)
        assert (inter.RB, inter.RS, inter.KS, inter.blocks) == (7, 7, 4, 116)
