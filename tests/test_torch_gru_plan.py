"""The GRU forwards' choice of route, made from the shape alone before the
launch: ``resident_plan`` at an H100's limits (132 SMs, 232,448 bytes of
shared memory a block may opt in to).  The resident kernel's index
arithmetic (``csrc/gru_cell_scan.cu``, ``gru_fwd_resident_kernel``) is
replayed here in Python, so that every planned grid is shown to give each
row of each direction to exactly one block, chunk and cell.
"""
import pytest

from padertorch_tpu_torch.ops.kernels.gru import (
    RESIDENT_MAX_RS, RESIDENT_MAX_THREADS, ResidentPlan, resident_plan,
    resident_smem)

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
