"""GRU cell recurrence over time: inference forward, training forward and
backward.

Counterpart of ``padertorch_tpu/ops/pallas/gru.py`` ``gru_cell_scan`` with
its custom VJP (torch semantics, one fused input bias inside ``gates_x``)::

    gh = h_prev @ W_hh                   # (rows, 3H): r, z, n blocks
    r  = sigmoid(gx_r + gh_r)
    z  = sigmoid(gx_z + gh_z)
    n  = tanh(gx_n + r * gh_n)
    h  = (1 - z) * n + z * h_prev

On a CUDA tensor :func:`gru_cell_scan` launches hand-written kernels, one
launch each for all T steps and both directions: without gradients the
lean forward of ``csrc/gru_cell_scan.cu``; when a gradient is asked for,
through :class:`GRUCellScan`, the training forward of the same file and,
in ``backward``, the adjoint recurrence of ``csrc/gru_cell_scan_bwd.cu``.
``dW_hh`` is a matrix product outside the kernels, as in the JAX package.

All three kernels have two routes, chosen by shape before the launch:
:func:`resident_plan` (the forwards) and :func:`resident_bwd_plan` (the
backward) give the resident route's plan where one direction's whole
``W_hh`` fits one block's shared memory beside what the block stages
(on an H100, H <= 138 for the float32 forwards and H <= 137 for the
float32 backward, 195 and 192 for the bf16 training kernels: a DPRNN's
chunk RNNs, the speaker classifier recipe's GRU); a block then owns a few
rows and runs all T steps with no grid-wide sync.  Otherwise
the cooperative kernel splits units and rows over the grid and syncs it
once per step, with each block's slice of ``W_hh`` in shared memory, or,
where no such grid is co-resident (on an H100 two float32 directions from
H = 896; the planner is :func:`padertorch_tpu_torch.ops.kernels.lstm.
scan_grid`), the ``streamed`` route: the same grid and arithmetic with the
weights read from device memory every step, as the slots a block would
stage, packed once a launch into scratch the wrapper allocates
(:func:`padertorch_tpu_torch.ops.kernels.lstm.packed_bytes`).  All three
bf16 kernels take a third route, ``mma``, where the bf16 resident plan
exists and H <= ``GRU_MMA_MAX_H`` (128): the resident grid with ``W_hh``
as bf16 tensor-core operands held in registers (:func:`mma_plan`, the
mirror of ``gru_mma_plan`` in ``csrc/lstm_common.cuh``).  The lean bf16
forward takes a fourth, ``cluster``, from ``GRU_CLUSTER_MIN_H`` (129) to
the planner's reach (320 on an H100): a thread-block cluster of 2, 4 or 8
CTAs a direction and a range of rows, each CTA holding its unit tiles'
``W_hh`` in registers, the CTAs sharing bf16(h) through distributed
shared memory (``csrc/gru_cell_scan_cluster.cu``; :func:`cluster_plan`,
the mirror of ``gru_cluster_plan``).  :func:`kernel_route` names each
launch's route.  A launch that fails on its route raises; it is never
retried on another.  ``gru_cell_scan.routes`` counts the launches by
kernel and route (``routes['fwd_train_bf16']['mma']``,
``routes['fwd_bf16']['cluster']``).

The training forward stores, per step, the gates ``acts`` = r|z|n and
``gh_n`` as computed (also on a masked step), and ``h_prev``, the state the
step started from.  The JAX package rebuilds ``h_prev`` from the shifted
outputs plus a segment-start term, which is exact only for
contiguous-valid masks; the kernel has ``h_prev`` in shared memory anyway,
so it writes it out, and the backward is exact for any mask.

On a CPU tensor :func:`gru_cell_scan` runs :func:`gru_cell_scan_plain`, a
Python time loop of per-direction matmuls that autograd differentiates.
:func:`gru_cell_scan_train_plain` and :func:`gru_cell_scan_bwd_plain`
repeat the two training kernels' arithmetic step by step; tests hold the
kernels against them.

bf16, as in the JAX package and as for the LSTM
(:mod:`padertorch_tpu_torch.ops.kernels.lstm`), along two axes.  The
*streams* (``out``, the training residuals ``acts``, ``gh_n`` and
``h_prev``, and the backward's ``dgx`` and ``dgh``) follow
``gates_x.dtype``; ``h0``, the carries, ``h_T`` and ``dh0`` stay float32.
``compute_dtype='bfloat16'`` makes the recurrent *products* bf16:
``bf16(h) @ bf16(W_hh)`` forward and ``bf16(dgh) @ bf16(W_hh)^T``
backward, each summed in float32; ``dW_hh`` sums ``bf16(h_{t-1})^T
bf16(dgh)`` in float32 and is float32.  The plain versions take all four
combinations; the kernels take float32 streams with float32 products, and
bf16 streams with bf16 products (the ``BF16`` variants of both files, on
both routes, which stage ``W_hh`` in shared memory as bf16: the resident
route reaches a wider H, up to 195 for the training forward and 192 for
the backward on an H100; all three on the ``mma`` route up to H = 128 and
the lean forward on the ``cluster`` route above, the products on the
tensor cores; the lean bf16 forward has no resident route), and raise for
the other two.  ``h_prev`` of the bf16
variant is ``bf16(h_{t-1})``, what the JAX backward rebuilds from its bf16
``out``.
"""
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from padertorch_tpu_torch.ops.kernels import _build, _ops
from padertorch_tpu_torch.ops.kernels.lstm import (
    MMA_THREADS, MMA_WARPS, _check, _contiguous, _norm_w, _packed,
    _recurrent_product, _route, _variant, product_dtype, sum_outer)

__all__ = ['gru_cell_scan', 'gru_cell_scan_plain', 'GRUCellScan',
           'gru_cell_scan_train_plain', 'gru_cell_scan_bwd_plain',
           'recurrent_weight_grad', 'ResidentPlan', 'resident_plan',
           'resident_smem', 'resident_bwd_plan', 'resident_bwd_smem',
           'MmaPlan', 'mma_plan', 'mma_smem', 'kernel_route',
           'device_mma_plan', 'device_limits', 'element_size',
           'ClusterPlan', 'cluster_shape', 'cluster_plan', 'cluster_smem',
           'device_cluster_plan', 'gru_cell_scan_op']


def _cell(gx, gh, h, hdim):
    """One GRU step from the two projections -> (r, z, n, gh_n, h_new)."""
    gx_r, gx_z, gx_n = gx.split(hdim, dim=-1)
    gh_r, gh_z, gh_n = gh.split(hdim, dim=-1)
    r = torch.sigmoid(gx_r + gh_r)
    z = torch.sigmoid(gx_z + gh_z)
    n = torch.tanh(gx_n + r * gh_n)
    return r, z, n, gh_n, (1 - z) * n + z * h


def gru_cell_scan_train_plain(gates_x, w_hh, mask, h0, compute_dtype=None):
    """Plain PyTorch version of the training forward kernel.

    Returns ``(out, acts, gh_n, h_prev, h_T)``: beside the outputs of
    :func:`gru_cell_scan_plain`, ``acts`` (T, rows, 3H) holds the gates
    r, z, n and ``gh_n`` (T, rows, H) the n block of ``h_prev @ W_hh``, both
    as computed (also on a masked step), and ``h_prev`` (T, rows, H) the
    state every step started from (through padding, the frozen state).
    ``out``, ``acts``, ``gh_n`` and ``h_prev`` are in the stream dtype
    (``gates_x.dtype``; a bf16 ``h_prev`` is ``bf16(h_{t-1})``, what the
    JAX backward rebuilds from the bf16 ``out``), ``h_T`` float32;
    ``compute_dtype='bfloat16'`` rounds the recurrent product's operands to
    bf16 (float32 sums), as the LSTM's plain versions do.
    """
    w, n_dir = _norm_w(w_hh)
    cd = product_dtype(compute_dtype)
    stream = gates_x.dtype
    hdim = gates_x.shape[-1] // 3
    h = h0.float()
    outs, acts, ghns, h_prevs = [], [], [], []
    for t in range(gates_x.shape[0]):
        gh = _recurrent_product(h, w, n_dir, cd)
        r, z, n, gh_n, h_new = _cell(gates_x[t].float(), gh, h, hdim)
        if mask is None:
            h_out = h_new
        else:
            m = mask[t][:, None]
            h_new = torch.where(m > 0, h_new, h)
            h_out = h_new * m
        acts.append(torch.cat([r, z, n], dim=-1).to(stream))
        ghns.append(gh_n.to(stream))
        h_prevs.append(h.to(stream))
        outs.append(h_out.to(stream))
        h = h_new
    return (torch.stack(outs), torch.stack(acts), torch.stack(ghns),
            torch.stack(h_prevs), h)


def gru_cell_scan_plain(gates_x, w_hh, mask, h0, compute_dtype=None):
    """Plain PyTorch version of :func:`gru_cell_scan` (same contract)."""
    out, _, _, _, h_t = gru_cell_scan_train_plain(gates_x, w_hh, mask, h0,
                                                  compute_dtype)
    return out, h_t


def gru_cell_scan_bwd_plain(acts, gh_n, h_prev, w_hh, mask, d_out, dh_t,
                            compute_dtype=None):
    """Plain PyTorch version of the backward kernel: the adjoint recurrence
    in reverse time from the stored residuals.

    Returns ``(dgates_x, dgh, dh0)``: the adjoints of the two
    pre-activation streams, both (T, rows, 3H), which differ in the n block
    (``da_n`` against ``da_n * r``); ``dgh`` feeds ``dh_prev`` and
    ``dW_hh``, ``dgates_x`` the input projection.  Both are in the stream
    dtype (``acts.dtype``), ``dh0`` float32.  With bf16 products
    ``dh_{t-1}`` takes ``bf16(dgh) @ bf16(W_hh)^T`` (the dgh that is
    stored, in a bf16 stream), summed in float32; without, the float32
    dgh.
    """
    w, n_dir = _norm_w(w_hh)
    cd = product_dtype(compute_dtype)
    stream = acts.dtype
    # the arithmetic's type: float32 for bf16 or float32 streams (a
    # float64 stream, as tests give it, stays float64)
    wide = torch.promote_types(stream, torch.float32)
    t_len, rows, g3 = acts.shape
    hdim = g3 // 3
    w_t = w.transpose(1, 2)
    dh_carry = dh_t.to(wide)
    dgx, dgh = [None] * t_len, [None] * t_len
    for t in reversed(range(t_len)):
        r, z, n = acts[t].to(wide).split(hdim, dim=-1)
        dh = dh_carry + d_out[t].to(wide)
        dz_pre = dh * (h_prev[t].to(wide) - n) * z * (1 - z)
        da_n = dh * (1 - z) * (1 - n * n)
        da_r = da_n * gh_n[t].to(wide) * r * (1 - r)
        dgx_t = torch.cat([da_r, dz_pre, da_n], dim=-1)
        dgh_t = torch.cat([da_r, dz_pre, da_n * r], dim=-1)
        if mask is not None:
            m = mask[t][:, None]
            dgx_t = dgx_t * m
            dgh_t = dgh_t * m
        if cd is None:
            product = torch.bmm(dgh_t.reshape(n_dir, rows // n_dir, g3),
                                w_t).reshape(rows, hdim)
        else:
            product = _recurrent_product(dgh_t, w_t, n_dir, cd)
        dh_prev = product + dh * z
        if mask is not None:
            dh_prev = torch.where(m > 0, dh_prev, dh_carry)
        dgx[t], dgh[t] = dgx_t.to(stream), dgh_t.to(stream)
        dh_carry = dh_prev
    return torch.stack(dgx), torch.stack(dgh), dh_carry


def recurrent_weight_grad(dgh, h_prev, n_dir, compute_dtype=None):
    """``dW_hh`` (D, H, 3H) = sum_t h_{t-1}^T dgh_t per direction, float32,
    from the stored ``h_prev`` (``dgh`` is zero on masked steps).  With
    bf16 products the operands are rounded to bf16 (in a bf16 stream they
    are bf16 already) and the sums stay float32."""
    cd = product_dtype(compute_dtype)
    if cd is not None:
        dgh, h_prev = dgh.to(cd), h_prev.to(cd)
    return sum_outer(h_prev, dgh, n_dir)


# the resident kernels' limits (csrc/gru_cell_scan.cu and
# csrc/gru_cell_scan_bwd.cu): rows a thread carries (their template range)
# and threads a block
RESIDENT_MAX_RS = 8
RESIDENT_MAX_THREADS = 512


class ResidentPlan(NamedTuple):
    """How a resident kernel divides a layer: ``RB`` rows a block,
    ``RS`` of them at a time, ``KS`` K slices (1, 2 or 4) of the product,
    ``blocks`` (``n_dir * ceil(rows_per_dir / RB)``), ``threads`` (groups
    of H rounded up to 32, one with ``KS`` = 1, else four: the first
    ``KS`` run the product, all of them the cells) and ``smem`` bytes."""
    RB: int
    RS: int
    KS: int
    blocks: int
    threads: int
    smem: int


def _round_up(x, to):
    return -(-x // to) * to


def element_size(stream):
    """Bytes of a staged ``W_hh`` element in the kernels of a stream dtype:
    4 for float32, 2 for bf16 (its variants stage ``W_hh`` as bf16)."""
    return 2 if stream == torch.bfloat16 else 4


def resident_smem(hdim, rs, ks, elem=4):
    """Bytes of shared memory the resident forward needs: h of a chunk
    transposed (H, RS rounded up to 4) and the K slices' sums (KS, RS, 3,
    H rounded up to 32) when KS > 1, float32, and all of W_hh[d] (H, 3H)
    at ``elem`` bytes an element (2 in the bf16 variant)."""
    red = ks * rs * 3 * _round_up(hdim, 32) if ks > 1 else 0
    return 4 * (hdim * _round_up(rs, 4) + red) + elem * 3 * hdim * hdim


def resident_bwd_smem(hdim, rs, ks, elem=4):
    """Bytes of shared memory the resident backward needs: dgh of a chunk
    transposed (3H, RS rounded up to 4) and the K slices' sums (KS, RS, H
    rounded up to 32) when KS > 1, float32, and all of W_hh[d] transposed
    (3H, H) at ``elem`` bytes an element (2 in the bf16 variant)."""
    red = ks * rs * _round_up(hdim, 32) if ks > 1 else 0
    return 4 * (3 * hdim * _round_up(rs, 4) + red) + elem * 3 * hdim * hdim


def _plan(n_dir, rows_per_dir, hdim, n_sm, max_smem, smem, k_len):
    """The plan of :func:`resident_plan` with the bytes ``smem(hdim, rs,
    ks)`` and a product whose K range is ``k_len`` long."""
    per_dir = n_sm // n_dir
    if per_dir < 1 or rows_per_dir < 1:
        return None
    rb = -(-rows_per_dir // per_dir)
    blocks = n_dir * -(-rows_per_dir // rb)
    hp = _round_up(hdim, 32)
    for chunks in range(-(-rb // RESIDENT_MAX_RS), rb + 1):
        rs = -(-rb // chunks)
        for ks in (4, 2, 1):
            threads = (4 if ks > 1 else 1) * hp
            if threads > RESIDENT_MAX_THREADS or (ks > 1 and k_len < 16 * ks):
                continue
            n_bytes = smem(hdim, rs, ks)
            if n_bytes <= max_smem:
                return ResidentPlan(rb, rs, ks, blocks, threads, n_bytes)
    return None


@functools.lru_cache(maxsize=None)
def resident_plan(n_dir, rows_per_dir, hdim, n_sm, max_smem, elem=4):
    """The resident forwards' plan for a layer of ``n_dir`` directions of
    ``rows_per_dir`` rows and ``hdim`` units on a card of ``n_sm`` SMs
    whose blocks may opt in to ``max_smem`` bytes of shared memory, with
    ``W_hh`` staged at ``elem`` bytes an element (:func:`element_size`), or
    None where one direction's ``W_hh`` does not fit beside one row's
    staging (the cooperative route).

    The rows are spread so that the grid has at most one block per SM (all
    blocks in one wave, none waiting for another); a block takes the
    fewest chunks of at most ``RESIDENT_MAX_RS`` rows that fit beside
    ``W_hh``, evened out, then the most K slices (4, 2, 1) that fit the
    shared memory, each at least 16 units of K long; with more than one
    slice, four groups of threads share the cells (so more than one slice
    needs H <= 128).  On an H100 (132 SMs, 232,448 bytes) the float32
    plan reaches H = 138 and the bf16 one H = 195.
    """
    return _plan(n_dir, rows_per_dir, hdim, n_sm, max_smem,
                 functools.partial(resident_smem, elem=elem), hdim)


@functools.lru_cache(maxsize=None)
def resident_bwd_plan(n_dir, rows_per_dir, hdim, n_sm, max_smem, elem=4):
    """The resident backward's plan, as :func:`resident_plan` with the
    backward's bytes (:func:`resident_bwd_smem`) and its product's K range
    of 3H (each slice at least 16 columns long), or None (the cooperative
    route).  At H = 128 the DPRNN's 520 rows get 130 blocks of 4, its 800
    rows 116 blocks of 7, four K slices each.  On an H100 the float32 plan
    reaches H = 137 and the bf16 one H = 192."""
    return _plan(n_dir, rows_per_dir, hdim, n_sm, max_smem,
                 functools.partial(resident_bwd_smem, elem=elem), 3 * hdim)


# the bf16 `mma` routes of the training forward and the backward
# (csrc/lstm_common.cuh; blocks of MMA_WARPS warps as the LSTM's): rows
# staged 8 at a time (one N tile), the widest H (two warps share each tile
# of 16 units: at most 48 registers of W_hh a thread)
MMA_ROWS = 8
GRU_MMA_MAX_H = 128
# the training forward's K chunks a tile, at most
GRU_MMA_FWD_CHUNKS = 2
# the k-steps a warp holds, at most, in the kernels' instantiations (the
# training forward: of each gate's M tile; the backward)
MMA_KC = {'fwd_train': (1, 2, 4), 'bwd': (1, 3, 6, 12)}


class MmaPlan(NamedTuple):
    """How an ``mma`` route divides a layer: ``n_rb`` ranges of ``RB``
    rows a direction, one block each, taken ``RS`` (<= 8) at a time; K (H
    in the training forward, 3H in the backward) in ``KT`` k-steps of 16,
    ``KCH`` chunks of ``KC``; ``blocks`` and ``smem`` bytes."""
    n_rb: int
    RB: int
    RS: int
    KT: int
    KC: int
    KCH: int
    blocks: int
    smem: int


def mma_smem(kernel, hdim, k_steps, chunks):
    """Bytes of shared memory of an ``mma`` block (``gru_mma_smem``): the
    staged bf16 rows (8, 16 ``k_steps`` + 8) and the ``chunks``' partial
    sums, 8 rows each of 16 ceil(H / 16) + 1 float4s (the training
    forward's three gates) or + 4 floats (``kernel`` 'bwd')."""
    units = 16 * -(-hdim // 16)
    red = 4 * (units + 4) if kernel == 'bwd' else 16 * (units + 1)
    return 2 * MMA_ROWS * (16 * k_steps + 8) + red * chunks * MMA_ROWS


@functools.lru_cache(maxsize=None)
def mma_plan(kernel, n_dir, rows_per_dir, hdim, n_sm, max_smem):
    """``gru_mma_plan`` of ``csrc/lstm_common.cuh``: the ``mma`` plan of
    the bf16 ``kernel`` ('fwd_train' or 'bwd') on a card of ``n_sm`` SMs
    whose blocks may opt in to ``max_smem`` bytes, or None where none fits
    (H above ``GRU_MMA_MAX_H``, more directions than SMs).  One block an
    SM in one wave: a direction's rows are spread over ``n_sm // n_dir``
    blocks, staged 8 at most at a time, evened out; each tile of 16 units gets ``16 // tiles``
    warps, at most one a k-step (the training forward at most
    ``GRU_MMA_FWD_CHUNKS``), and K is cut into that many chunks."""
    per_dir = n_sm // n_dir if n_dir > 0 else 0
    if not 1 <= hdim <= GRU_MMA_MAX_H or rows_per_dir < 1 or per_dir < 1:
        return None
    tiles = -(-hdim // 16)
    k_steps = -(-(3 * hdim if kernel == 'bwd' else hdim) // 16)
    warps = min(MMA_WARPS // tiles, k_steps)
    if kernel != 'bwd':
        warps = min(warps, GRU_MMA_FWD_CHUNKS)
    kc = -(-k_steps // warps)
    chunks = -(-k_steps // kc)
    rb = -(-rows_per_dir // per_dir)
    n_rb = -(-rows_per_dir // rb)
    rs = -(-rb // -(-rb // MMA_ROWS))
    smem = mma_smem(kernel, hdim, k_steps, chunks)
    if smem > max_smem:
        return None
    return MmaPlan(n_rb, rb, rs, k_steps, kc, chunks, n_dir * n_rb, smem)


# the lean bf16 forward's cluster route (csrc/gru_cell_scan_cluster.cu,
# `gru_cluster_plan` in csrc/lstm_common.cuh): the portable cluster sizes,
# a warp's k-steps of each gate at most (48 registers of W_hh, as the mma
# route's at H = 128), and the narrowest H that takes it
CLUSTER_SIZES = (2, 4, 8)
GRU_CLUSTER_KC = 4
GRU_CLUSTER_MIN_H = GRU_MMA_MAX_H + 1


class ClusterPlan(NamedTuple):
    """How the cluster route divides a layer: ``C`` CTAs a cluster, each
    of at most ``TPC`` tiles of 16 units (CTA c the tiles [c n_ut / C,
    (c + 1) n_ut / C), n_ut = ceil(H / 16)); K = H in ``KT`` k-steps,
    ``KCH`` chunks of ``KC`` a tile, a warp each (warp w: local tile w //
    (16 // TPC), chunk w % (16 // TPC)); ``n_rb`` ranges of ``RB`` rows a
    direction, a cluster each, taken ``RS`` (<= 8) at a time;
    ``clusters`` (``n_dir * n_rb``), ``blocks`` (``C * clusters``) and
    ``smem`` bytes a CTA."""
    C: int
    TPC: int
    KT: int
    KC: int
    KCH: int
    n_rb: int
    RB: int
    RS: int
    clusters: int
    blocks: int
    smem: int


def cluster_smem(k_steps, chunks, tiles):
    """Bytes of shared memory of a cluster route's CTA
    (``gru_cluster_smem``): two mbarriers (16 bytes), two staged tiles of
    bf16(h) (8 rows of 16 ``k_steps`` + 8) and two sets of the
    ``chunks``' partial sums, 8 rows each of 16 ``tiles`` + 1 float4s."""
    return (16 + 2 * 2 * MMA_ROWS * (16 * k_steps + 8)
            + 16 * 2 * chunks * MMA_ROWS * (16 * tiles + 1))


@functools.lru_cache(maxsize=None)
def cluster_shape(hdim, max_smem):
    """``gru_cluster_shape``: (C, TPC, KT, KC, KCH, smem) of the cluster
    route at ``hdim``, the smallest portable cluster size whose CTAs each
    own a tile of 16 units and whose warps hold at most
    ``GRU_CLUSTER_KC`` k-steps of ``W_hh``, or None (H = 256: C = 4, four
    tiles a CTA, four chunks of four k-steps; on an H100 it reaches
    H = 320 with C = 8)."""
    n_ut = -(-hdim // 16)
    for c in CLUSTER_SIZES:
        if hdim < 1 or n_ut < c:
            return None
        tpc = -(-n_ut // c)
        warps = min(MMA_WARPS // tpc, n_ut)
        if warps < 1 or -(-n_ut // warps) > GRU_CLUSTER_KC:
            continue
        kc = -(-n_ut // warps)
        chunks = -(-n_ut // kc)
        smem = cluster_smem(n_ut, chunks, tpc)
        if smem > max_smem:
            return None
        return c, tpc, n_ut, kc, chunks, smem
    return None


@functools.lru_cache(maxsize=None)
def cluster_plan(n_dir, rows_per_dir, hdim, max_smem, max_clusters):
    """``gru_cluster_plan`` of ``csrc/lstm_common.cuh``: the lean bf16
    forward's cluster plan on a card whose blocks may opt in to
    ``max_smem`` bytes and which runs ``max_clusters`` clusters of the
    shape's size at once (the card's own count comes from
    :func:`device_cluster_plan`), or None where no shape fits
    (:func:`cluster_shape`) or fewer clusters than directions run at
    once.  A direction's rows are spread over
    ``max_clusters // n_dir`` clusters, staged 8 at most at a time,
    evened out."""
    shape = cluster_shape(hdim, max_smem)
    if shape is None or rows_per_dir < 1 or n_dir < 1:
        return None
    c, tpc, k_steps, kc, chunks, smem = shape
    per_dir = max_clusters // n_dir
    if per_dir < 1:
        return None
    rb = -(-rows_per_dir // per_dir)
    n_rb = -(-rows_per_dir // rb)
    rs = -(-rb // -(-rb // MMA_ROWS))
    return ClusterPlan(c, tpc, k_steps, kc, chunks, n_rb, rb, rs,
                       n_dir * n_rb, c * n_dir * n_rb, smem)


@functools.lru_cache(maxsize=None)
def kernel_route(kernel, n_dir, rows_per_dir, hdim, bf16, n_sm, max_smem):
    """The route of ``kernel`` ('fwd', 'fwd_train' or 'bwd'; ``bf16``: its
    bf16 variant) on a card of ``n_sm`` SMs and ``max_smem`` bytes a
    block: 'resident' where :func:`resident_plan` (the forwards) or
    :func:`resident_bwd_plan` gives a plan, but 'mma' for the three bf16
    kernels where :func:`mma_plan` fits too (the lean forward where the
    training forward's does); the lean bf16 forward otherwise 'cluster'
    from ``GRU_CLUSTER_MIN_H`` to the reach of :func:`cluster_shape` (the
    card's planner spreads the rows over the clusters it runs at once),
    never 'resident'; None where the cooperative grid runs (cooperative or
    streamed, as the card's planner says)."""
    planner = resident_bwd_plan if kernel == 'bwd' else resident_plan
    if planner(n_dir, rows_per_dir, hdim, n_sm, max_smem,
               elem=2 if bf16 else 4) is not None:
        if bf16 and mma_plan('bwd' if kernel == 'bwd' else 'fwd_train',
                             n_dir, rows_per_dir, hdim, n_sm,
                             max_smem) is not None:
            return 'mma'
        if not (bf16 and kernel == 'fwd'):
            return 'resident'
    if (bf16 and kernel == 'fwd' and hdim >= GRU_CLUSTER_MIN_H
            and cluster_shape(hdim, max_smem) is not None):
        return 'cluster'
    return None


@functools.lru_cache(maxsize=None)
def device_mma_plan(kernel, n_dir, rows_per_dir, hdim, device):
    """The ``mma`` plan the card's own planner gives ``kernel``
    ('fwd_train' or 'bwd') on ``device`` (an index), as an
    :class:`MmaPlan` (blocks 0 where none fits)."""
    out = (ctypes.c_int * 8)()
    lib = _build.load_library()
    err = lib.gru_cell_scan_mma_plan(int(kernel == 'bwd'), n_dir,
                                     rows_per_dir, hdim, device,
                                     ctypes.addressof(out))
    _build.check(lib, err, 'gru_cell_scan_mma_plan')
    return MmaPlan(*out)


@functools.lru_cache(maxsize=None)
def device_cluster_plan(n_dir, rows_per_dir, hdim, device):
    """The cluster plan the card's own planner gives the lean bf16 forward
    on ``device`` (an index), as a :class:`ClusterPlan` (blocks 0 where
    none fits), and the clusters of its size the card runs at once."""
    out = (ctypes.c_int * 12)()
    lib = _build.load_library()
    err = lib.gru_cell_scan_cluster_plan(n_dir, rows_per_dir, hdim, device,
                                         ctypes.addressof(out))
    _build.check(lib, err, 'gru_cell_scan_cluster_plan')
    return ClusterPlan(*out[:11]), out[11]


@functools.lru_cache(maxsize=None)
def device_limits(device):
    """(SMs, shared memory a block may opt in to, in bytes) of the card
    ``device`` (an index), as the CUDA runtime reports them."""
    out = (ctypes.c_int * 2)()
    lib = _build.load_library()
    err = lib.gru_cell_scan_device_limits(device, ctypes.addressof(out))
    _build.check(lib, err, 'gru_cell_scan device limits')
    return out[0], out[1]


def _launch(gates_x, w, n_dir, mask, h0, train=False):
    """Launch the forward kernel of ``gates_x``'s stream dtype on the
    route :func:`kernel_route` picks for the shape; with ``train`` the
    variant that also returns the residuals ``acts``, ``gh_n`` and
    ``h_prev`` (in the stream dtype)."""
    t_len, rows, g3 = gates_x.shape
    hdim = g3 // 3
    entry = _variant(gates_x.dtype)
    kernel = 'fwd_train' if train else 'fwd'

    def empty(*shape, dtype=gates_x.dtype):
        return torch.empty(shape, dtype=dtype, device=gates_x.device)

    out, h_t = empty(t_len, rows, hdim), empty(rows, hdim,
                                               dtype=torch.float32)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(gates_x)
    limits = device_limits(device)
    inputs = (gates_x.data_ptr(), w.data_ptr(),
              None if mask is None else mask.data_ptr(),
              h0.data_ptr(), out.data_ptr())
    sizes = (t_len, n_dir, rows // n_dir, hdim)
    route = kernel_route(kernel, n_dir, rows // n_dir, hdim, bool(entry),
                         *limits)
    if route in ('mma', 'cluster'):
        suffix, tail = f'_{route}' + entry, (*sizes, device, stream)
    elif route is None:
        hbuf = empty(2, rows, hdim, dtype=torch.float32)
        tail = (hbuf.data_ptr(), *sizes, device, stream)
        route = _route('gru_fwd', n_dir, rows // n_dir, hdim, bool(entry),
                       device, train)
        wpack = _packed(route, 'gru_fwd', n_dir, hdim, bool(entry),
                        gates_x.device)
        inputs = (*inputs[:2], None if wpack is None else wpack.data_ptr(),
                  *inputs[2:])
        suffix = entry
    else:
        plan = resident_plan(n_dir, rows // n_dir, hdim, *limits,
                             elem=element_size(gates_x.dtype))
        tail = (*sizes, plan.RB, plan.RS, plan.KS, plan.threads, plan.smem,
                device, stream)
        suffix = '_resident' + entry
    if train:
        acts, gh_n, h_prev = (empty(t_len, rows, g3),
                              empty(t_len, rows, hdim),
                              empty(t_len, rows, hdim))
        err = getattr(lib, 'gru_cell_scan_fwd_train' + suffix)(
            *inputs, acts.data_ptr(), gh_n.data_ptr(), h_prev.data_ptr(),
            h_t.data_ptr(), *tail)
        _build.check(lib, err,
                     f'gru_cell_scan{entry} training forward kernel')
        gru_cell_scan.launches['fwd_train' + entry] += 1
        gru_cell_scan.routes['fwd_train' + entry][route] += 1
        return out, acts, gh_n, h_prev, h_t
    err = getattr(lib, 'gru_cell_scan_fwd' + suffix)(
        *inputs, h_t.data_ptr(), *tail)
    _build.check(lib, err, f'gru_cell_scan{entry} kernel')
    gru_cell_scan.launches['fwd' + entry] += 1
    gru_cell_scan.routes['fwd' + entry][route] += 1
    return out, h_t


def _launch_bwd(acts, gh_n, h_prev, w, n_dir, mask, d_out, dh_t):
    """Launch the backward kernel of the residuals' stream dtype on the
    route :func:`kernel_route` picks for the shape."""
    t_len, rows, g3 = acts.shape
    hdim = g3 // 3
    entry = _variant(acts.dtype)
    dgx = torch.empty_like(acts)
    dgh = torch.empty_like(acts)
    dh0 = torch.empty_like(dh_t)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(acts)
    limits = device_limits(device)
    plan = resident_bwd_plan(n_dir, rows // n_dir, hdim, *limits,
                             elem=element_size(acts.dtype))
    route = kernel_route('bwd', n_dir, rows // n_dir, hdim, bool(entry),
                         *limits)
    args = (acts.data_ptr(), gh_n.data_ptr(), h_prev.data_ptr(),
            w.data_ptr(), None if mask is None else mask.data_ptr(),
            d_out.data_ptr(), dh_t.data_ptr(), dgx.data_ptr(),
            dgh.data_ptr(), dh0.data_ptr(), t_len, n_dir, rows // n_dir,
            hdim)
    if route == 'mma':
        err = getattr(lib, 'gru_cell_scan_bwd_mma' + entry)(
            *args, device, stream)
    elif plan is None:
        route = _route('gru_bwd', n_dir, rows // n_dir, hdim, bool(entry),
                       device)
        wpack = _packed(route, 'gru_bwd', n_dir, hdim, bool(entry),
                        acts.device)
        err = getattr(lib, 'gru_cell_scan_bwd' + entry)(
            *args[:4], None if wpack is None else wpack.data_ptr(),
            *args[4:], device, stream)
    else:
        err = getattr(lib, 'gru_cell_scan_bwd_resident' + entry)(
            *args, plan.RB, plan.RS, plan.KS, plan.threads, plan.smem,
            device, stream)
    _build.check(lib, err, f'gru_cell_scan{entry} backward kernel')
    gru_cell_scan.launches['bwd' + entry] += 1
    gru_cell_scan.routes['bwd' + entry][route] += 1
    return dgx, dgh, dh0


class GRUCellScan(torch.autograd.Function):
    """:func:`gru_cell_scan` on CUDA tensors with a gradient: ``forward``
    is the training forward kernel, ``backward`` the backward kernel plus
    the ``dW_hh`` matrix product.  ``w`` is (D, H, 3H) float32; the
    kernels of ``gates_x``'s dtype run (bf16 streams: bf16 products), and
    ``dgates_x`` comes back in that dtype, ``dW_hh`` in float32."""

    @staticmethod
    def forward(ctx, gates_x, w, mask, h0):
        out, acts, gh_n, h_prev, h_t = _launch(
            gates_x, w, w.shape[0], mask, h0, train=True)
        ctx.save_for_backward(w, mask, acts, gh_n, h_prev)
        return out, h_t

    @staticmethod
    def backward(ctx, d_out, dh_t):
        w, mask, acts, gh_n, h_prev = ctx.saved_tensors
        n_dir = w.shape[0]
        d_out = (torch.zeros_like(gh_n) if d_out is None
                 else d_out.to(gh_n.dtype).contiguous())
        dh_t = (torch.zeros_like(gh_n[0], dtype=torch.float32)
                if dh_t is None else dh_t.float().contiguous())
        dgx, dgh, dh0 = _launch_bwd(
            acts, gh_n, h_prev, w, n_dir, mask, d_out, dh_t)
        return dgx, recurrent_weight_grad(dgh, h_prev, n_dir), None, dh0


def gru_cell_scan(gates_x, w_hh, mask, h0, compute_dtype=None):
    """Run the GRU cell recurrence over time.

    Args:
        gates_x: (T, rows, 3H), the precomputed ``x @ W_ih + b`` (gate
            order r, z, n), float32 or bfloat16: its dtype is the dtype of
            the streams (``out`` here; the residuals and ``dgates_x`` of
            the training path).  For a direction-stacked call,
            rows = D * B and row block d belongs to direction d.
        w_hh: (H, 3H) recurrent weights, or (D, H, 3H) per direction
            (``h @ w_hh`` layout), float32 masters; there is no hidden
            bias.
        mask: (T, rows) validity mask or None; where it is 0, h keeps its
            value and the output is 0.
        h0: (rows, H) initial state, float32.
        compute_dtype: None (float32 products) or 'bfloat16': the
            recurrent products' operands rounded to bf16, summed in
            float32 (see the module docstring).

    Returns:
        (out (T, rows, H) in the stream dtype, h_T float32).  CPU tensors
        run the plain version; CUDA tensors launch the kernels (or raise):
        the lean forward, or, when grad mode is on and an input requires a
        gradient, the training forward, whose ``backward`` is a kernel
        too.  Without a gradient the call is the custom operator
        ``torch.ops.ptt.gru_cell_scan`` (``ops/kernels/_ops.py``), which
        ``torch.export`` records.  The kernels take float32 streams with ``compute_dtype=None``
        and bfloat16 streams with ``compute_dtype='bfloat16'``; anything
        else raises.  ``gru_cell_scan.launches`` counts the launches per
        kernel (``fwd``, ``fwd_train``, ``bwd``, and ``fwd_bf16``,
        ``fwd_train_bf16``, ``bwd_bf16``), ``gru_cell_scan.routes`` them
        by kernel and route (``routes['bwd_bf16']['mma']``; the routes
        ``resident``, ``cooperative``, ``streamed`` and, for the bf16
        kernels, ``mma`` and, for the lean bf16 forward, ``cluster``:
        :func:`kernel_route`).
    """
    w, n_dir = _norm_w(w_hh)
    cd = product_dtype(compute_dtype)
    if not (torch.is_grad_enabled() and any(
            x.requires_grad for x in (gates_x, w, h0))):
        if gates_x.is_cuda and not torch.compiler.is_compiling():
            # an eager call keeps the kernels' contract; the operator
            # also takes the other strides a traced graph may give it
            _check(gates_x, w, n_dir, mask, h0, n_gates=3,
                   stream=torch.float32 if cd is None else cd)
        return _ops.call(gru_cell_scan_op, gates_x, w, mask, h0,
                         cd is not None)
    if gates_x.device.type == 'cpu':
        return gru_cell_scan_plain(gates_x, w_hh, mask, h0, compute_dtype)
    if gates_x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {gates_x.device}')
    _check(gates_x, w, n_dir, mask, h0, n_gates=3,
           stream=torch.float32 if cd is None else cd)
    return GRUCellScan.apply(gates_x, w, mask, h0)


gru_cell_scan.launches = {'fwd': 0, 'fwd_train': 0, 'bwd': 0,
                          'fwd_bf16': 0, 'fwd_train_bf16': 0, 'bwd_bf16': 0}
gru_cell_scan.routes = {
    name: {'resident': 0, 'cooperative': 0, 'streamed': 0, 'mma': 0,
           'cluster': 0}
    for name in gru_cell_scan.launches}


def _op_plain(gates_x: torch.Tensor, w: torch.Tensor,
              mask: Optional[torch.Tensor], h0: torch.Tensor,
              bf16_products: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return gru_cell_scan_plain(gates_x, w, mask, h0,
                               torch.bfloat16 if bf16_products else None)


def _op_launch(gates_x, w, mask, h0, bf16_products):
    gates_x, w, mask, h0 = _contiguous(gates_x, w, mask, h0)
    n_dir = w.shape[0]
    _check(gates_x, w, n_dir, mask, h0, n_gates=3,
           stream=torch.bfloat16 if bf16_products else torch.float32)
    return _launch(gates_x, w, n_dir, mask, h0)


def _op_fake(gates_x, w, mask, h0, bf16_products):
    t_len, rows, width = gates_x.shape
    return (gates_x.new_empty((t_len, rows, width // 3)),
            h0.new_empty((rows, width // 3), dtype=torch.float32))


# the lean forward as ``torch.ops.ptt.gru_cell_scan(gates_x, w (D, H, 3H),
# mask, h0, bf16_products)`` -> (out, h_T)
gru_cell_scan_op = _ops.define('gru_cell_scan', _op_plain, _op_launch,
                               _op_fake)
