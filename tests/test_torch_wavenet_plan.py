"""The WaveNet sampler's choice of route, made from the shape and the card's
limits before the launch: ``cluster_plan`` at an H100's limits (132 SMs,
232,448 bytes of shared memory a block may opt in to, and the counts of
clusters of 2, 4, 8 and 16 CTAs that ``cudaOccupancyMaxActiveClusters``
gives for an H100 80GB HBM3 at the plan's shared memory, as
``chip_smoke.py`` phase 15e prints them: 66, 30, 15, 7) and at smaller
ones.

The kernel's column arithmetic (``csrc/wavenet_sample.cu``,
``wavenet_sample_kernel`` with ``group_products``) is replayed here in
Python, so that every cluster size is shown to give each output column of
the four products and each ring channel to exactly one CTA and one lane
group, and ``cluster_weights`` to hand each CTA the one-block route's K
vector of every column it owns (so a column's sum is the same on every
route).
"""
import pytest
import torch

from padertorch_tpu_torch.ops.kernels.wavenet import (
    ClusterPlan, cluster_plan, cluster_weights, owned_columns, sample_smem)

N_SM = 132
MAX_SMEM = 232_448
H100_CLUSTERS = {2: 66, 4: 30, 8: 15, 16: 7}
FULL = (16, 64, 256, 256, 510)   # L, R, S, O, slots of the recipe's model


def h100_clusters(n, smem):
    assert MAX_SMEM // 2 < smem <= MAX_SMEM, smem
    return H100_CLUSTERS[n]


# the kernel's threads per CTA and columns a lane group takes at a time
# (Units<N>: A for the dilated layers, in pairs; B skip and residual; O
# w_out and w_end)
def units(n):
    threads = 256 if n >= 8 else 512
    a = 8 if n == 1 else (4 if n == 2 else 2)
    b = 10 if n == 1 else (5 if n == 2 else (3 if n in (4, 8) else 2))
    o = 8 if n <= 2 else (4 if n in (4, 8) else 2)
    return threads, a, b, o


def ceil(a, b):
    return -(-a // b)


def group_lanes(k):
    """The kernel's lanes per column of a product over k inputs: the
    smallest power of two that covers k / 4, at most a warp.  It depends on
    K alone, so a column's lanes and their K chunks (lane l takes 4 l,
    4 l + 4 G, ...) are the same on every route."""
    g = 1
    while g < 32 and 4 * g < k:
        g *= 2
    return g


def emitted(n, c, k, n_local, n_cols, u, pair=False):
    """Global columns that CTA c's groups hand to put for a product over K
    inputs whose CTA has ``n_local`` columns (units, with ``pair``), and
    that put keeps (those below ``n_cols``), as group_products runs it."""
    threads = units(n)[0]
    g = group_lanes(k)
    groups = threads // g
    per = 2 if pair else 1
    tasks = per * ceil(n_local, groups)
    used = min(groups, n_local)
    out = []
    for grp in range(groups):
        if n > 1 and (grp * g // 32 * 32) // g >= used:
            continue   # the warp only loads ahead
        for task in range(0, ceil(tasks, u) * u, per):
            local = grp + groups * (task // per)
            col = c + n * local
            if task < tasks and local < n_local and col < n_cols:
                out.append(col)
    return out


CONFIGS = {
    'recipe model': FULL,
    'small': (4, 16, 32, 256, 10),
    'odd widths': (3, 12, 20, 132, 9),
    'narrow': (2, 8, 16, 256, 3),
}
ROUTES = [(name, n) for name, cfg in CONFIGS.items()
          for n in (1, 2, 4, 8, 16) if n <= min(cfg[1:4])]


@pytest.mark.parametrize('name,n', ROUTES)
def test_every_column_and_channel_has_one_owner(name, n):
    n_layers, r, s, o, _ = CONFIGS[name]
    _, ua, ub, uo = units(n)
    products = {
        'dilated units': (2 * r, ceil(r, n), r, ua, True),
        'skip and residual': (r, ceil(s + r, n), s + r, ub, False),
        'skip, last layer': (r, ceil(s + r, n), s, ub, False),
        'w_out': (s, ceil(o, n), o, uo, False),
        'w_end': (o, ceil(o, n), o, uo, False),
    }
    for product, (k, n_local, n_cols, u, pair) in products.items():
        cols = sorted(col for c in range(n)
                      for col in emitted(n, c, k, n_local, n_cols, u, pair))
        assert cols == list(range(n_cols)), (product, n)
    # ring channels: CTA c keeps channels c, c + n, ...; after a layer it
    # sends each of them to every CTA once (the kernel's ``share``)
    ru = ceil(r, n)
    sent = sorted((c + n * (e // n), e % n) for c in range(n)
                  for e in range(n * ru) if c + n * (e // n) < r)
    assert sent == [(u, p) for u in range(r) for p in range(n)]
    owned = owned_columns(r, n)
    assert sorted(owned[owned >= 0].tolist()) == list(range(r))


@pytest.mark.parametrize('name,n', ROUTES)
def test_each_cta_gets_the_one_block_routes_k_vector_of_its_columns(name,
                                                                    n):
    n_layers, r, s, o, _ = CONFIGS[name]
    gen = torch.Generator().manual_seed(n)

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    weights = {'w_prev': rand(n_layers, r, 2 * r),
               'w_curr': rand(n_layers, r, 2 * r),
               'b_dil': rand(n_layers, 2 * r),
               'w_res': rand(n_layers - 1, r, r), 'b_res': rand(n_layers - 1, r),
               'w_skip': rand(n_layers, r, s), 'b_skip': rand(n_layers, s),
               'w_out': rand(s, o), 'w_end': rand(o, o)}
    one, many = cluster_weights(weights, 1), cluster_weights(weights, n)
    for c in range(n):
        for lu in range(ceil(r, n)):
            u = c + n * lu
            for h in range(2):
                got = many['wa'][c, :, 2 * lu + h]
                want = one['wa'][0, :, 2 * u + h] if u < r else 0 * got
                assert torch.equal(got, want)
                got = many['b_dil'][c, :, h, lu]
                want = one['b_dil'][0, :, h, u] if u < r else 0 * got
                assert torch.equal(got, want)
        for name_, n_cols in (('wb', s + r), ('b_sr', s + r), ('wo', o),
                              ('we', o)):
            for lj in range(many[name_].shape[-2 if name_ in ('wo', 'we')
                                              else 2]):
                j = c + n * lj
                pick = (lambda x, i: x[..., i, :]) if name_ != 'b_sr' \
                    else (lambda x, i: x[..., i])
                got = pick(many[name_][c], lj)
                want = pick(one[name_][0], j) if j < n_cols else 0 * got
                assert torch.equal(got, want), (name_, c, lj)


@pytest.mark.parametrize('batch', [1, 2, 5, 7])
def test_few_rows_take_the_largest_cluster_at_full_width(batch):
    plan = cluster_plan(batch, *FULL, N_SM, MAX_SMEM, h100_clusters)
    assert plan == ClusterPlan(16, True, sample_smem(*FULL, 16, True))
    assert plan.smem <= MAX_SMEM


@pytest.mark.parametrize('batch,n', [(8, 8), (15, 8), (16, 4), (30, 4),
                                     (33, 2), (66, 2)])
def test_more_rows_take_smaller_clusters_in_one_wave(batch, n):
    plan = cluster_plan(batch, *FULL, N_SM, MAX_SMEM, h100_clusters)
    assert (plan.n, plan.resident) == (n, False)
    assert batch * plan.n <= N_SM and H100_CLUSTERS[n] >= batch
    assert MAX_SMEM // 2 < plan.smem <= MAX_SMEM
    assert plan.smem >= sample_smem(*FULL, n, False)


@pytest.mark.parametrize('batch', [67, 132, 264])
def test_throughput_batches_take_one_block_per_row(batch):
    plan = cluster_plan(batch, *FULL, N_SM, MAX_SMEM, h100_clusters)
    assert plan == ClusterPlan(1, False, sample_smem(*FULL, 1, False))
    assert plan.smem <= MAX_SMEM


@pytest.mark.parametrize('n_sm,max_smem,clusters', [
    (114, 232_448, {2: 57, 4: 28, 8: 14, 16: 0}),     # fewer SMs, no 16
    (132, 166_912, {2: 66, 4: 33, 8: 16, 16: 8}),     # less shared memory
    (16, 101_376, {2: 8, 4: 4, 8: 2, 16: 1}),
])
@pytest.mark.parametrize('batch', [1, 5, 132])
def test_every_plan_fits_and_runs_in_one_wave(n_sm, max_smem, clusters,
                                              batch):
    plan = cluster_plan(batch, *FULL, n_sm, max_smem,
                        lambda n, smem: clusters[n])
    need = sample_smem(*FULL, plan.n, plan.resident)
    if plan.n == 1:
        assert plan.smem == need
        # no cluster size serves the batch in one wave on this card
        assert all(batch * n > n_sm or clusters[n] < batch
                   or max(sample_smem(*FULL, n, False), max_smem // 2 + 16)
                   > max_smem for n in clusters)
    elif batch * plan.n > n_sm:
        # one block cannot hold a row (a card with less shared memory): the
        # smallest cluster whose CTAs hold their share, its rows in waves
        assert sample_smem(*FULL, 1, False) > max_smem
        assert need <= plan.smem <= max_smem
        assert all(max(sample_smem(*FULL, n, False), max_smem // 2 + 16)
                   > max_smem for n in clusters if n < plan.n)
    else:
        assert need <= plan.smem <= max_smem and plan.smem > max_smem // 2
        assert batch * plan.n <= n_sm and clusters[plan.n] >= batch
        # the largest such cluster
        assert all(clusters[n] < batch or batch * n > n_sm
                   for n in clusters if n > plan.n)
        assert plan.resident == (sample_smem(*FULL, plan.n, True)
                                 <= max_smem)


def test_a_cluster_never_has_more_ctas_than_units():
    # R = 8: at most 8 CTAs, each owning one unit
    plan = cluster_plan(1, 2, 8, 16, 256, 3, N_SM, MAX_SMEM, h100_clusters)
    assert plan.n == 8
    plan = cluster_plan(1, 2, 4, 4, 256, 3, N_SM, MAX_SMEM, h100_clusters)
    assert plan.n == 4
