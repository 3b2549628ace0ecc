"""LSTM cell recurrence over time: inference forward, training forward
and backward.

Counterpart of ``padertorch_tpu/ops/pallas/lstm.py`` ``lstm_cell_scan``
with its custom VJP.  On a CUDA tensor :func:`lstm_cell_scan` launches
hand-written kernels, one cooperative launch each for all T steps and both
directions: without gradients the lean forward of
``csrc/lstm_cell_scan.cu``; when a gradient is asked for, through
:class:`LSTMCellScan`, the training forward of the same file (which also
stores the activated gates and c_{t-1}) and, in ``backward``, the adjoint
recurrence of ``csrc/lstm_cell_scan_bwd.cu``.  ``dW_hh`` is a matrix
product outside the kernels, as in the JAX package.

On a CPU tensor it runs :func:`lstm_cell_scan_plain`, a Python time loop
of per-direction matmuls that autograd differentiates.
:func:`lstm_cell_scan_train_plain` and :func:`lstm_cell_scan_bwd_plain`
repeat the two training kernels' arithmetic step by step; tests hold the
kernels against them.

The backward is exact for contiguous-valid masks (suffix padding, or
prefix padding as the flipped direction of a bidirectional layer has it),
which is what sequence lengths produce.

bf16, as in the JAX package, along two axes.  The *streams* (``out``, the
training residuals ``gates`` and ``c_seq``, and ``dgates_x``) follow
``gates_x.dtype``; ``h0``, ``c0``, the carries and the final states stay
float32.  ``compute_dtype='bfloat16'`` makes the recurrent *products*
bf16: ``bf16(h) @ bf16(W_hh)`` forward and ``bf16(dz) @ bf16(W_hh)^T``
backward, each summed in float32; ``dW_hh`` sums ``bf16(h_{t-1})^T
bf16(dz)`` in float32 and is float32.  The plain versions take all four
combinations; the kernels take float32 streams with float32 products, and
bfloat16 streams with bfloat16 products (``csrc/lstm_cell_scan.cu`` and
``csrc/lstm_cell_scan_bwd.cu``, ``BF16`` variants, which stage ``W_hh``
in shared memory as bf16), and raise for the other two.

Every kernel runs one cooperative grid, on one of two routes that
:func:`scan_grid` mirrors: ``cooperative`` (each block stages its slice of
``W_hh`` in shared memory) or, for a layer whose ``W_hh`` no co-resident
grid can hold (on an H100 two directions of 16 rows from H = 896 in
float32, 1057 in bf16), ``streamed`` (the same grid and arithmetic, the
weights read from device memory every step, as the slots a block would
stage, packed by the kernel's launcher into scratch of
:func:`packed_bytes` that the wrapper allocates).  The bf16 kernels take a
third route where :func:`scan_grid` would stage: ``mma`` (bf16
``mma.sync`` tensor-core products with ``W_hh``'s slice in registers, on
the grid of :func:`mma_plan`: the forwards' in ``csrc/lstm_cell_scan.cu``,
``bf16(h) @ bf16(W_hh)`` with the four gates' columns of 16 units along M
and h exchanged as bf16 rows, the backward's in
``csrc/lstm_cell_scan_bwd.cu``; ``streamed`` where that plan does not
fit: :func:`fwd_route`, :func:`bwd_route`).  ``lstm_cell_scan.routes``
counts the launches by kernel and route.
"""
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from padertorch_tpu_torch.ops.kernels import _build, _ops

__all__ = ['lstm_cell_scan', 'lstm_cell_scan_plain', 'LSTMCellScan',
           'lstm_cell_scan_train_plain', 'lstm_cell_scan_bwd_plain',
           'recurrent_weight_grad', 'sum_outer', 'time_groups',
           'product_dtype', 'matmul_f32', 'ScanGrid', 'scan_grid',
           'scan_smem', 'device_grid', 'packed_bytes', 'MmaPlan',
           'mma_plan', 'mma_smem', 'fwd_route', 'bwd_route',
           'lstm_cell_scan_op']


def _norm_w(w_hh):
    """-> (w (D, H, gates * H), D)."""
    if w_hh.dim() == 2:
        return w_hh[None], 1
    return w_hh, w_hh.shape[0]


def product_dtype(compute_dtype):
    """``compute_dtype`` (None, 'bfloat16', a torch dtype) -> None or
    ``torch.bfloat16``: the dtype the recurrent products round their
    operands to."""
    if compute_dtype is None:
        return None
    dtype = (compute_dtype if isinstance(compute_dtype, torch.dtype)
             else getattr(torch, str(compute_dtype)))
    if dtype == torch.float32:
        return None
    if dtype != torch.bfloat16:
        raise ValueError(f'compute_dtype={compute_dtype!r}: float32 or '
                         'bfloat16')
    return dtype


def _rounded(x, dtype):
    """x rounded to ``dtype`` (round to nearest even) and widened to
    float32 again; x widened alone where ``dtype`` is None."""
    return (x if dtype is None else x.to(dtype)).float()


def _recurrent_product(h, w, n_dir, cd):
    """(rows, K) @ per-direction (D, K, N) -> (rows, N), float32 sums of
    the operands rounded to ``cd``."""
    rows, k = h.shape
    return torch.bmm(_rounded(h, cd).reshape(n_dir, rows // n_dir, k),
                     _rounded(w, cd)).reshape(rows, -1)


def _scan_plain(gates_x, w_hh, mask, h0, c0, compute_dtype, residuals):
    w, n_dir = _norm_w(w_hh)
    cd = product_dtype(compute_dtype)
    stream = gates_x.dtype
    h, c = h0.float(), c0.float()
    outs, c_seq, acts = [], [], []
    for t in range(gates_x.shape[0]):
        z_i, z_f, z_g, z_o = (gates_x[t].float() + _recurrent_product(
            h, w, n_dir, cd)).chunk(4, -1)
        i, f, g, o = (torch.sigmoid(z_i), torch.sigmoid(z_f),
                      torch.tanh(z_g), torch.sigmoid(z_o))
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if mask is None:
            h_out = h_new
        else:
            m = mask[t][:, None]
            h_new = torch.where(m > 0, h_new, h)
            c_new = torch.where(m > 0, c_new, c)
            h_out = h_new * m
        if residuals:
            acts.append(torch.cat([i, f, g, o], dim=-1).to(stream))
            c_seq.append(c.to(stream))
        outs.append(h_out.to(stream))
        h, c = h_new, c_new
    if not residuals:
        return torch.stack(outs), h, c
    return torch.stack(outs), torch.stack(c_seq), torch.stack(acts), h, c


def lstm_cell_scan_plain(gates_x, w_hh, mask, h0, c0, compute_dtype=None):
    """Plain PyTorch version of :func:`lstm_cell_scan` (same contract)."""
    return _scan_plain(gates_x, w_hh, mask, h0, c0, compute_dtype, False)


def lstm_cell_scan_train_plain(gates_x, w_hh, mask, h0, c0,
                               compute_dtype=None):
    """Plain PyTorch version of the training forward kernel.

    Returns ``(out, c_seq, gates, h_T, c_T)``: beside the outputs of
    :func:`lstm_cell_scan_plain`, ``c_seq`` (T, rows, H) holds c_{t-1} of
    every step (on a masked step the frozen c) and ``gates`` (T, rows, 4H)
    the activated gates i, f, g, o as computed (also on a masked step);
    both in the stream dtype (``gates_x.dtype``), as ``out``.
    """
    return _scan_plain(gates_x, w_hh, mask, h0, c0, compute_dtype, True)


def lstm_cell_scan_bwd_plain(gates, c_seq, w_hh, mask, d_out, dh_t, dc_t,
                             compute_dtype=None):
    """Plain PyTorch version of the backward kernel: the adjoint recurrence
    in reverse time from the stored residuals.

    Returns ``(dgates_x (T, rows, 4H), dh0, dc0)``; ``dgates_x`` in the
    stream dtype (``gates.dtype``), ``dh0`` and ``dc0`` float32.  With
    bf16 products ``dh_{t-1}`` is ``bf16(dz) @ bf16(W_hh)^T``, the dz
    that is stored; without, the float32 dz.
    """
    w, n_dir = _norm_w(w_hh)
    cd = product_dtype(compute_dtype)
    stream = gates.dtype
    w_t = w.transpose(1, 2)
    dh_carry, dc_carry = dh_t.float(), dc_t.float()
    dgx = [None] * gates.shape[0]
    for t in reversed(range(gates.shape[0])):
        i, f, g, o = gates[t].float().chunk(4, dim=-1)
        c_prev = c_seq[t].float()
        tanh_c = torch.tanh(f * c_prev + i * g)
        dh = dh_carry + d_out[t].float()
        d_o = dh * tanh_c
        dc = dc_carry + dh * o * (1 - tanh_c * tanh_c)
        dz = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f),
                        dc * i * (1 - g * g), d_o * o * (1 - o)], dim=-1)
        if mask is not None:
            m = mask[t][:, None]
            dz = dz * m
        dh_prev = _recurrent_product(dz, w_t, n_dir, cd)
        dc_prev = dc * f
        if mask is not None:
            dh_prev = torch.where(m > 0, dh_prev, dh_carry)
            dc_prev = torch.where(m > 0, dc_prev, dc_carry)
        dgx[t] = dz.to(stream)
        dh_carry, dc_carry = dh_prev, dc_prev
    return torch.stack(dgx), dh_carry, dc_carry


def matmul_f32(a, b):
    """Batched ``a @ b`` with float32 sums and a float32 result.  bf16
    operands on the card take one bf16 GEMM with a float32 output
    (``torch.bmm(..., out_dtype=torch.float32)``: cuBLAS sums in float32
    and writes the sums unrounded); anything else is widened to float32
    first, which is exact for bf16 values.  That GEMM has no derivative in
    torch, so where autograd records (an operand requires a gradient) the
    operands are widened too, and autograd differentiates the float32
    product (its gradients cast back to bf16)."""
    if (a.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def time_groups(t_len, out_rows, out_cols, n_dir, device):
    """Into how many groups of steps to cut a weight-gradient product that
    reduces over (T, rows) into ``n_dir`` results of (out_rows, out_cols).

    With a small result and many rows (a dual-path RNN's chunk batches:
    26,000 rows into 128 x 384) one product has too few output tiles to
    occupy the card.  The groups become a batch axis and their partial
    results are summed, so that about one tile per multiprocessor is in
    flight.  The answer divides ``t_len`` and is 1 where the result is
    large enough by itself, and on the CPU."""
    if device.type != 'cuda':
        return 1
    tiles = n_dir * -(-out_rows // 128) * -(-out_cols // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, sms // tiles)
    return max(g for g in range(1, min(want, t_len) + 1) if t_len % g == 0)


def sum_outer(a, b, n_dir):
    """sum over t and rows of a_t^T b_t per direction: a (T, D*B, M) or
    (T, D, B, M), b likewise with N -> (D, M, N), float32 for either
    dtype, in :func:`time_groups` groups of steps: one batched product
    (:func:`matmul_f32`) with the directions and groups as its batch axis.
    Both operands go in as (D * groups, rows, width), their last axis kept
    contiguous (a copy that moves it is uncoalesced; a direction-major
    operand needs no copy), ``a`` transposed."""
    t_len, m, n = a.shape[0], a.shape[-1], b.shape[-1]
    groups = time_groups(t_len, m, n, n_dir, a.device)

    def grouped(x):
        return x.reshape(groups, t_len // groups, n_dir, -1,
                         x.shape[-1]).permute(2, 0, 1, 3, 4).reshape(
            n_dir * groups, -1, x.shape[-1])

    out = matmul_f32(grouped(a).transpose(1, 2), grouped(b))
    return out.reshape(n_dir, groups, m, n).sum(1)


def recurrent_weight_grad(dgx, out, h0, mask, n_dir, compute_dtype=None):
    """``dW_hh`` (D, H, 4H) = sum_t h_{t-1}^T dz_t per direction, float32.

    h_{t-1} is ``out`` shifted by one step.  ``out`` is zero in the padding,
    but a valid step whose predecessor is masked carries the frozen
    initial state; with contiguous-valid masks that is the segment start
    alone, whose dz joins step 0's in the ``h0`` term.  With bf16 products
    the operands are rounded to bf16 (``out`` and ``dgx`` are bf16 streams
    already) and the sums stay float32.
    """
    cd = product_dtype(compute_dtype)
    t_len = dgx.shape[0]
    dz0 = dgx[0]
    if mask is not None and t_len > 1:
        starts = mask[1:] * (1.0 - mask[:-1])
        dz0 = (dz0.float() + torch.einsum(
            'tb,tbg->bg', starts, dgx[1:].float())).to(dgx.dtype)

    def operand(x):
        return x if cd is None else x.to(cd)

    dw = sum_outer(operand(h0[None]), operand(dz0[None]), n_dir)
    if t_len > 1:
        dw = dw + sum_outer(operand(out[:-1]), operand(dgx[1:]), n_dir)
    return dw


class ScanGrid(NamedTuple):
    """How a cooperative cell-scan kernel divides a layer (``ScanGrid`` of
    ``csrc/lstm_common.cuh``): ``U`` units a block, ``n_ub`` unit slices,
    ``n_rb`` row ranges of ``RB`` rows, ``RS`` of them staged at once,
    ``KS`` K slices, ``blocks``, ``threads`` and ``smem`` bytes a block,
    and whether ``W_hh`` is read from device memory (``streamed``) or
    staged in shared memory."""
    U: int
    n_ub: int
    n_rb: int
    RB: int
    RS: int
    KS: int
    blocks: int
    threads: int
    smem: int
    streamed: bool


# the kernels' candidate unit slices, widest first, and their block limit
SCAN_UNITS = (32, 16, 8, 4)
SCAN_MAX_THREADS = 1024
# registers a thread of a kernel launched with 1024 threads at most
SCAN_REGS = 64


def scan_smem(kernel, hdim, unit, rb, rs, ks, elem=4, streamed=False):
    """Bytes of shared memory a block of the cooperative ``kernel``
    ('lstm_fwd', 'lstm_bwd', 'gru_fwd', 'gru_bwd') needs with ``unit``
    units, ``rb`` rows, ``rs`` staged at once and ``ks`` K slices, its
    weights at ``elem`` bytes an element (four of them a slot), none of
    them ``streamed``: the host's sums of ``csrc/``."""
    slot = 4 * elem
    g4 = -(-3 * hdim // 4)
    width = g4 if kernel == 'gru_bwd' else hdim
    weights = 0 if streamed else slot * width * unit
    if kernel in ('lstm_fwd', 'gru_fwd'):
        rest = 4 * ((ks - 1) * rs * unit * 4 + rs * hdim
                    + (rb * unit if kernel == 'lstm_fwd' else 0))
    else:
        rest = slot * rs * width + 4 * ((ks - 1) * rs * unit + 2 * rb * unit)
    return weights + rest


def _pick_scan_grid(n_dir, rows_per_dir, hdim, k_len, n_sm, max_smem,
                    smem, regs, max_threads=SCAN_MAX_THREADS):
    """``pick_scan_grid`` of ``csrc/lstm_common.cuh`` with the occupancy
    of a block taken from its threads, shared memory (of an SM's 1 KB more
    than a block may opt in to, less 1 KB a block) and ``regs`` registers
    a thread; ``smem(U, RB, RS, KS)`` the kernel's bytes; at most
    ``max_threads`` a block."""
    best = None
    for unit in SCAN_UNITS:
        if unit > 4 and unit >= 2 * hdim:
            continue
        n_ub = -(-hdim // unit)
        n_rb = min(max(n_sm // (n_dir * n_ub), 1), rows_per_dir)
        rb = -(-rows_per_dir // n_rb)
        n_rb = -(-rows_per_dir // rb)
        blocks = n_dir * n_ub * n_rb
        rs = min(rb, max_threads // unit)
        while rs > 0 and smem(unit, rb, rs, 8) > max_smem:
            rs -= 1
        if rs == 0:
            continue
        rs = -(-rb // -(-rb // rs))
        ks = max(1, min(8, max_threads // (rs * unit), k_len))
        n_bytes = smem(unit, rb, rs, ks)
        threads = -(-ks * rs * unit // 32) * 32
        per_sm = min(2048 // threads, 32, 65536 // (regs * threads),
                     (max_smem + 1024) // (n_bytes + 1024))
        if per_sm == 0 or blocks > per_sm * n_sm:
            continue
        if best is None or blocks > best[6]:
            best = (unit, n_ub, n_rb, rb, rs, ks, blocks, threads, n_bytes)
        if 2 * blocks >= n_sm:
            break
    return best


def scan_grid(kernel, n_dir, rows_per_dir, hdim, n_sm, max_smem, elem=4,
              regs=SCAN_REGS):
    """The grid and route of the cooperative ``kernel`` ('lstm_fwd',
    'lstm_bwd', 'gru_fwd', 'gru_bwd') for a layer of ``n_dir`` directions
    of ``rows_per_dir`` rows and ``hdim`` units, ``W_hh`` at ``elem`` bytes
    an element (2 in the bf16 variants), on a card of ``n_sm`` SMs whose
    blocks may opt in to ``max_smem`` bytes: a :class:`ScanGrid`, or None
    where no grid is co-resident even with the weights streamed.

    The staged grid is taken where one is co-resident, else the streamed
    one, with blocks of at most 1024, then 512, 256, ... 32 threads
    (``pick_route`` of ``csrc/lstm_common.cuh``).  Unit slices are
    tried widest first; for each the rows are split until the grid has
    about one block per SM, the rows staged at once are as many as the
    threads and shared memory allow, evened out, and the K slices as many
    as 1024 threads allow (at most 8); the first co-resident grid that
    fills half the SMs is taken, else the co-resident one with the most
    blocks.  The card decides co-residency with the kernel's own register
    count; this mirror assumes ``regs`` a thread (the kernels' launch
    bound), which the card's tests hold it to.  For the bf16 kernels
    (``elem=2``) a staged grid here only says that the weights need not
    stream: they then run on :func:`mma_plan` (:func:`fwd_route`,
    :func:`bwd_route`).
    """
    k_len = -(-3 * hdim // 4) if kernel == 'gru_bwd' else hdim
    tries = [(False, SCAN_MAX_THREADS)] + [
        (True, SCAN_MAX_THREADS >> i) for i in range(6)]
    for streamed, max_threads in tries:
        found = _pick_scan_grid(
            n_dir, rows_per_dir, hdim, k_len, n_sm, max_smem,
            functools.partial(_scan_smem_of, kernel, hdim, elem, streamed),
            regs, max_threads)
        if found is not None:
            return ScanGrid(*found, streamed)
    return None


def _scan_smem_of(kernel, hdim, elem, streamed, unit, rb, rs, ks):
    return scan_smem(kernel, hdim, unit, rb, rs, ks, elem, streamed)


class MmaPlan(NamedTuple):
    """How a bf16 kernel's ``mma`` route divides a layer (``MmaPlan`` of
    ``csrc/lstm_common.cuh``): a block owns a direction, one of ``n_ub``
    slices of ``MMA_UNITS`` units and one of ``n_rb`` ranges of ``RB``
    rows, ``RS`` of them staged at once; the product's K (4H backward, H
    forward) is ``KT`` k-steps of 16 in ``KCH`` chunks of ``KC`` (one
    warp's, its ``W_hh`` fragments in registers), each chunk's warps
    splitting the 8-row tiles ``NG`` ways; ``blocks`` of ``MMA_THREADS``
    threads and ``smem`` bytes."""
    n_ub: int
    n_rb: int
    RB: int
    RS: int
    KT: int
    KC: int
    KCH: int
    NG: int
    blocks: int
    smem: int


# the mma routes' block: 16 units (an M tile), 16 warps; a partial-sum row
# of the backward (16 + 4 floats) and of the forwards (16 + 1 units of four
# gates)
MMA_UNITS, MMA_WARPS, MMA_RED = 16, 16, 20
FWD_MMA_RED = 4 * (MMA_UNITS + 1)
MMA_THREADS = 32 * MMA_WARPS
# the most k-steps a warp holds of each M tile: the backward's, the
# forwards'
MMA_KC_MAX, FWD_MMA_KC_MAX = 18, 5
# per kernel: a partial-sum row's floats, the product's K per unit of H,
# and MMA_KC_MAX
_MMA_SHAPE = {'lstm_fwd': (FWD_MMA_RED, 1, FWD_MMA_KC_MAX),
              'lstm_bwd': (MMA_RED, 4, MMA_KC_MAX)}


def mma_smem(k_steps, chunks, rb, rs, red_row=MMA_RED):
    """Bytes of shared memory of an ``mma`` block: ``rs`` staged rows
    (padded to 8) of 16 ``k_steps`` bf16 values and 16 bytes, the
    ``chunks``' partial sums (``red_row`` floats a staged row: the
    backward's ``MMA_RED``, the forwards' ``FWD_MMA_RED``), and two float32
    carries of ``rb`` rows of 16 units."""
    rsp = -(-rs // 8) * 8
    return (2 * rsp * (16 * k_steps + 8)
            + 4 * (chunks * rsp * red_row + 2 * rb * MMA_UNITS))


def mma_plan(n_dir, rows_per_dir, hdim, n_sm, max_smem, kernel='lstm_bwd'):
    """``mma_plan`` of ``csrc/lstm_common.cuh``: the ``mma`` grid of the
    bf16 ``kernel`` ('lstm_fwd': both forwards; 'lstm_bwd') on a card of
    ``n_sm`` SMs whose blocks may opt in to ``max_smem`` bytes, or None
    where none fits (the unit slices of all directions outnumber the SMs,
    or a warp's K chunk would exceed ``MMA_KC_MAX`` k-steps, the forwards'
    ``FWD_MMA_KC_MAX``).  One block an SM: the rows are split until the
    grid has about one block per SM, and staged in as few chunks as shared
    memory allows, evened out."""
    red_row, k_per_unit, kc_max = _MMA_SHAPE[kernel]
    n_ub = -(-hdim // MMA_UNITS)
    cols = n_dir * n_ub
    k_steps = -(-k_per_unit * hdim // 16)
    kc = -(-k_steps // MMA_WARPS)
    if cols > n_sm or kc > kc_max:
        return None
    chunks = -(-k_steps // kc)
    n_rb = min(max(n_sm // cols, 1), rows_per_dir)
    rb = -(-rows_per_dir // n_rb)
    n_rb = -(-rows_per_dir // rb)
    rs = rb
    while rs > 0 and mma_smem(k_steps, chunks, rb, rs, red_row) > max_smem:
        rs -= 1
    if rs == 0:
        return None
    rs = -(-rb // -(-rb // rs))
    return MmaPlan(n_ub, n_rb, rb, rs, k_steps, kc, chunks,
                   MMA_WARPS // chunks, cols * n_rb,
                   mma_smem(k_steps, chunks, rb, rs, red_row))


def _mma_route(kernel, n_dir, rows_per_dir, hdim, bf16, n_sm, max_smem):
    grid = scan_grid(kernel, n_dir, rows_per_dir, hdim, n_sm, max_smem,
                     elem=2 if bf16 else 4)
    if grid is None:
        return None
    if grid.streamed:
        return 'streamed'
    if not bf16:
        return 'cooperative'
    found = mma_plan(n_dir, rows_per_dir, hdim, n_sm, max_smem, kernel)
    return 'streamed' if found is None else 'mma'


def fwd_route(n_dir, rows_per_dir, hdim, bf16, n_sm, max_smem):
    """The forward kernels' route (lean and training alike) on a card of
    ``n_sm`` SMs and ``max_smem`` bytes a block: 'cooperative' or
    'streamed' as :func:`scan_grid` names them, but for the bf16 variants
    'mma' where :func:`scan_grid` would stage and :func:`mma_plan` of
    'lstm_fwd' fits ('streamed' where it does not); None where no grid is
    co-resident."""
    return _mma_route('lstm_fwd', n_dir, rows_per_dir, hdim, bf16, n_sm,
                      max_smem)


def bwd_route(n_dir, rows_per_dir, hdim, bf16, n_sm, max_smem):
    """The backward kernel's route, as :func:`fwd_route` names the
    forwards' (its ``mma`` plan that of 'lstm_bwd')."""
    return _mma_route('lstm_bwd', n_dir, rows_per_dir, hdim, bf16, n_sm,
                      max_smem)


_GRID_ENTRIES = {'lstm_fwd': 'lstm_cell_scan_fwd_grid',
                 'lstm_bwd': 'lstm_cell_scan_bwd_grid',
                 'gru_fwd': 'gru_cell_scan_fwd_grid',
                 'gru_bwd': 'gru_cell_scan_bwd_grid'}


@functools.lru_cache(maxsize=None)
def device_grid(kernel, n_dir, rows_per_dir, hdim, bf16, device,
                train=False):
    """The grid the card takes for the cooperative ``kernel`` (see
    :func:`scan_grid`; ``bf16``: its bf16 variant, ``train``: the training
    forward) on ``device`` (an index), from the C side's own planner:
    {'U', 'n_rb', 'RB', 'RS', 'KS', 'blocks', 'streamed'} (blocks 0 when
    no grid is co-resident), and for the LSTM kernels 'mma' (1 on the bf16
    ``mma`` route, whose U is 16 and KS its K chunks, :func:`mma_plan`)."""
    out = (ctypes.c_int * 8)()
    lib = _build.load_library()
    entry = _GRID_ENTRIES[kernel]
    args = (n_dir, rows_per_dir, hdim, int(bf16))
    if kernel.endswith('fwd'):
        args += (int(train),)
    err = getattr(lib, entry)(*args, device, ctypes.addressof(out))
    _build.check(lib, err, f'{entry}')
    keys = ('U', 'n_rb', 'RB', 'RS', 'KS', 'blocks', 'streamed')
    if kernel.startswith('lstm'):
        keys += ('mma',)
    return dict(zip(keys, out))


def _route(kernel, n_dir, rows_per_dir, hdim, bf16, device, train=False):
    """'streamed', 'cooperative' or (the bf16 LSTM kernels) 'mma': the
    route the card's planner takes."""
    grid = device_grid(kernel, n_dir, rows_per_dir, hdim, bf16, device,
                       train)
    if grid.get('mma'):
        return 'mma'
    return 'streamed' if grid['streamed'] else 'cooperative'


def packed_bytes(kernel, n_dir, hdim, bf16):
    """Bytes of the streamed route's packed weights for the cooperative
    ``kernel`` ('lstm_fwd', 'lstm_bwd', 'gru_fwd', 'gru_bwd'; ``bf16``:
    its bf16 variant), ``packed_slots_bytes`` of ``csrc/lstm_common.cuh``:
    a slot of four float32 or bf16 values per (direction, row k, unit)
    in the forwards, per (direction, four columns, unit) in the
    backwards."""
    gates = 4 if kernel.startswith('lstm') else 3
    width = hdim if kernel.endswith('fwd') else -(-gates * hdim // 4)
    return n_dir * hdim * width * (8 if bf16 else 16)


def _packed(route, kernel, n_dir, hdim, bf16, device):
    """Scratch for the streamed route's packed weights (None on the
    cooperative route, whose blocks stage them)."""
    if route != 'streamed':
        return None
    return torch.empty(packed_bytes(kernel, n_dir, hdim, bf16),
                       dtype=torch.uint8, device=device)


def _check(gates_x, w, n_dir, mask, h0, c0=None, n_gates=4,
           stream=torch.float32):
    """Raise for what the cell-scan kernels do not take (shapes, dtypes,
    one device, contiguity).  ``n_gates``: gate blocks per hidden unit
    (4 for the LSTM; the GRU wrapper passes 3 and no ``c0``).  ``gates_x``
    must be of the ``stream`` dtype, everything else float32."""
    if gates_x.dim() != 3 or gates_x.shape[0] < 1:
        raise ValueError(f'gates_x must be (T >= 1, rows, {n_gates}H), got '
                         f'{tuple(gates_x.shape)}')
    t_len, rows, width = gates_x.shape
    if width % n_gates or rows % n_dir:
        raise ValueError(f'gates_x {tuple(gates_x.shape)} does not split '
                         f'into {n_gates} gates and {n_dir} directions')
    hdim = width // n_gates
    expected = {'gates_x': (gates_x, (t_len, rows, width)),
                'w_hh': (w, (n_dir, hdim, width)),
                'mask': (mask, (t_len, rows)),
                'h0': (h0, (rows, hdim)), 'c0': (c0, (rows, hdim))}
    for name, (tensor, shape) in expected.items():
        if tensor is None:
            continue
        if tuple(tensor.shape) != shape:
            raise ValueError(f'{name}: expected shape {shape}, got '
                             f'{tuple(tensor.shape)}')
        want = stream if name == 'gates_x' else torch.float32
        if tensor.dtype != want:
            raise TypeError(f'{name}: the kernel takes {want}, got '
                            f'{tensor.dtype}')
        if tensor.device != gates_x.device:
            raise ValueError(f'{name} is on {tensor.device}, gates_x on '
                             f'{gates_x.device}')
        if not tensor.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _variant(stream):
    """The suffix of the C entries and launch counts of the kernels of a
    stream dtype: the float32 kernels, or the bf16-stream, bf16-product
    ones."""
    return '_bf16' if stream == torch.bfloat16 else ''


def _launch(gates_x, w, n_dir, mask, h0, c0, train=False, wpack=None):
    """Launch the forward kernel of ``gates_x``'s stream dtype; with
    ``train`` the variant that also returns the residuals ``c_seq`` and
    ``gates`` (in the stream dtype).  ``wpack``: the streamed route's
    scratch (:func:`packed_bytes`; allocated here when None)."""
    t_len, rows, g4 = gates_x.shape
    hdim = g4 // 4
    entry = _variant(gates_x.dtype)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=gates_x.device)

    out = empty(t_len, rows, hdim, dtype=gates_x.dtype)
    h_t, c_t = empty(rows, hdim), empty(rows, hdim)
    hbuf = empty(2, rows, hdim)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(gates_x)
    sizes = (t_len, n_dir, rows // n_dir, hdim, device, stream)
    route = _route('lstm_fwd', *sizes[1:4], bool(entry), device, train)
    if wpack is None:
        wpack = _packed(route, 'lstm_fwd', n_dir, hdim, bool(entry),
                        gates_x.device)
    inputs = (gates_x.data_ptr(), w.data_ptr(),
              None if wpack is None else wpack.data_ptr(),
              None if mask is None else mask.data_ptr(),
              h0.data_ptr(), c0.data_ptr(), out.data_ptr())
    if train:
        c_seq = empty(t_len, rows, hdim, dtype=gates_x.dtype)
        gates = empty(t_len, rows, g4, dtype=gates_x.dtype)
        err = getattr(lib, 'lstm_cell_scan_fwd_train' + entry)(
            *inputs, c_seq.data_ptr(), gates.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr(), hbuf.data_ptr(), *sizes)
        _build.check(lib, err,
                     f'lstm_cell_scan{entry} training forward kernel')
        lstm_cell_scan.launches['fwd_train' + entry] += 1
        lstm_cell_scan.routes['fwd_train' + entry][route] += 1
        return out, c_seq, gates, h_t, c_t
    err = getattr(lib, 'lstm_cell_scan_fwd' + entry)(
        *inputs, h_t.data_ptr(), c_t.data_ptr(), hbuf.data_ptr(), *sizes)
    _build.check(lib, err, f'lstm_cell_scan{entry} kernel')
    lstm_cell_scan.launches['fwd' + entry] += 1
    lstm_cell_scan.routes['fwd' + entry][route] += 1
    return out, h_t, c_t


def _launch_bwd(gates, c_seq, w, n_dir, mask, d_out, dh_t, dc_t):
    t_len, rows, g4 = gates.shape
    entry = _variant(gates.dtype)
    dgx = torch.empty_like(gates)
    dh0 = torch.empty_like(dh_t)
    dc0 = torch.empty_like(dc_t)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(gates)
    route = _route('lstm_bwd', n_dir, rows // n_dir, g4 // 4, bool(entry),
                   device)
    wpack = _packed(route, 'lstm_bwd', n_dir, g4 // 4, bool(entry),
                    gates.device)
    err = getattr(lib, 'lstm_cell_scan_bwd' + entry)(
        gates.data_ptr(), c_seq.data_ptr(), w.data_ptr(),
        None if wpack is None else wpack.data_ptr(),
        None if mask is None else mask.data_ptr(), d_out.data_ptr(),
        dh_t.data_ptr(), dc_t.data_ptr(), dgx.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), t_len, n_dir, rows // n_dir, g4 // 4, device, stream)
    _build.check(lib, err, f'lstm_cell_scan{entry} backward kernel')
    lstm_cell_scan.launches['bwd' + entry] += 1
    lstm_cell_scan.routes['bwd' + entry][route] += 1
    return dgx, dh0, dc0


def bwd_grid(n_dir, rows_per_dir, hdim, bf16=False):
    """The grid the backward kernel (``bf16``: its bf16 variant) takes for
    a layer of ``n_dir`` directions of ``rows_per_dir`` rows and ``hdim``
    units on the current card: {'U', 'n_rb', 'RB', 'RS', 'KS', 'blocks',
    'streamed', 'mma'} (unit slice, row ranges, rows per range, rows
    staged at once, K slices or, on the ``mma`` route, K chunks, blocks, 1
    on the streamed route, 1 on the ``mma`` route; blocks 0 when no grid
    is co-resident)."""
    return device_grid('lstm_bwd', n_dir, rows_per_dir, hdim, bool(bf16),
                       torch.cuda.current_device())


class LSTMCellScan(torch.autograd.Function):
    """:func:`lstm_cell_scan` on CUDA tensors with a gradient: ``forward``
    is the training forward kernel, ``backward`` the backward kernel plus
    the ``dW_hh`` matrix product.  ``w`` is (D, H, 4H) float32; the
    kernels of ``gates_x``'s dtype run (bf16 streams: bf16 products), and
    ``dgates_x`` comes back in that dtype, ``dW_hh`` in float32."""

    @staticmethod
    def forward(ctx, gates_x, w, mask, h0, c0):
        n_dir = w.shape[0]
        out, c_seq, gates, h_t, c_t = _launch(
            gates_x, w, n_dir, mask, h0, c0, train=True)
        # gates_x itself is not needed again: `gates` has its shape
        ctx.save_for_backward(w, mask, h0, out, c_seq, gates)
        return out, h_t, c_t

    @staticmethod
    def backward(ctx, d_out, dh_t, dc_t):
        w, mask, h0, out, c_seq, gates = ctx.saved_tensors
        n_dir = w.shape[0]
        d_out, dh_t, dc_t = (
            torch.zeros_like(like) if grad is None
            else grad.to(like.dtype).contiguous()
            for grad, like in ((d_out, out), (dh_t, h0), (dc_t, h0)))
        dgx, dh0, dc0 = _launch_bwd(
            gates, c_seq, w, n_dir, mask, d_out, dh_t, dc_t)
        dw = recurrent_weight_grad(
            dgx, out, h0, mask, n_dir,
            torch.bfloat16 if dgx.dtype == torch.bfloat16 else None)
        return dgx, dw, None, dh0, dc0


def lstm_cell_scan(gates_x, w_hh, mask, h0, c0, compute_dtype=None):
    """Run the LSTM cell recurrence over time.

    Args:
        gates_x: (T, rows, 4H), the precomputed ``x @ W_ih + b`` (gate
            order i, f, g, o), float32 or bfloat16: its dtype is the
            dtype of the streams (``out`` here; the residuals and
            ``dgates_x`` of the training path).  For a direction-stacked
            call, rows = D * B and row block d belongs to direction d.
        w_hh: (H, 4H) recurrent weights, or (D, H, 4H) per direction
            (``h @ w_hh`` layout), float32 masters.
        mask: (T, rows) validity mask or None; where it is 0, h and c
            keep their values and the output is 0.
        h0, c0: (rows, H) initial state, float32.
        compute_dtype: None (float32 products) or 'bfloat16': the
            recurrent products' operands rounded to bf16, summed in
            float32 (see the module docstring).

    Returns:
        (out (T, rows, H) in the stream dtype, h_T, c_T float32).  CPU
        tensors run the plain version; CUDA tensors launch the kernels (or
        raise): the lean forward, or, when grad mode is on and an input
        requires a gradient, the training forward, whose ``backward`` is a
        kernel too.  Without a gradient the call is the custom operator
        ``torch.ops.ptt.lstm_cell_scan`` (``ops/kernels/_ops.py``), which
        ``torch.export`` records.  The kernels take float32 streams with
        ``compute_dtype=None`` and bfloat16 streams with
        ``compute_dtype='bfloat16'``; anything else raises.
        ``lstm_cell_scan.launches`` counts the launches per kernel
        (``fwd``, ``fwd_train``, ``bwd``, and ``fwd_bf16``,
        ``fwd_train_bf16``, ``bwd_bf16``), ``lstm_cell_scan.routes`` them
        by kernel and route (``routes['fwd_bf16']['mma']``; the routes
        ``cooperative``, ``streamed``, and ``mma`` for the bf16 kernels;
        :func:`scan_grid`, :func:`fwd_route`, :func:`bwd_route`).
    """
    w, n_dir = _norm_w(w_hh)
    cd = product_dtype(compute_dtype)
    if not (torch.is_grad_enabled() and any(
            x.requires_grad for x in (gates_x, w, h0, c0))):
        if gates_x.is_cuda and not torch.compiler.is_compiling():
            # an eager call keeps the kernels' contract; the operator
            # also takes the other strides a traced graph may give it
            _check(gates_x, w, n_dir, mask, h0, c0,
                   stream=torch.float32 if cd is None else cd)
        return _ops.call(lstm_cell_scan_op, gates_x, w, mask, h0, c0,
                         cd is not None)
    if gates_x.device.type == 'cpu':
        return lstm_cell_scan_plain(gates_x, w_hh, mask, h0, c0,
                                    compute_dtype)
    if gates_x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {gates_x.device}')
    _check(gates_x, w, n_dir, mask, h0, c0,
           stream=torch.float32 if cd is None else cd)
    return LSTMCellScan.apply(gates_x, w, mask, h0, c0)


lstm_cell_scan.launches = {'fwd': 0, 'fwd_train': 0, 'bwd': 0,
                           'fwd_bf16': 0, 'fwd_train_bf16': 0,
                           'bwd_bf16': 0}
lstm_cell_scan.routes = {
    name: {'cooperative': 0, 'streamed': 0, 'mma': 0}
    for name in lstm_cell_scan.launches}


def _op_plain(gates_x: torch.Tensor, w: torch.Tensor,
              mask: Optional[torch.Tensor], h0: torch.Tensor,
              c0: torch.Tensor, bf16_products: bool
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return lstm_cell_scan_plain(gates_x, w, mask, h0, c0,
                                torch.bfloat16 if bf16_products else None)


def _op_launch(gates_x, w, mask, h0, c0, bf16_products):
    # an exported graph drops a ``.contiguous()`` that was a no-op at the
    # traced shapes, so the operator takes any strides
    gates_x, w, mask, h0, c0 = _contiguous(gates_x, w, mask, h0, c0)
    n_dir = w.shape[0]
    _check(gates_x, w, n_dir, mask, h0, c0,
           stream=torch.bfloat16 if bf16_products else torch.float32)
    return _launch(gates_x, w, n_dir, mask, h0, c0)


def _contiguous(*tensors):
    return tuple(None if t is None else t.contiguous() for t in tensors)


def _op_fake(gates_x, w, mask, h0, c0, bf16_products):
    t_len, rows, width = gates_x.shape
    state = h0.new_empty((rows, width // 4), dtype=torch.float32)
    return (gates_x.new_empty((t_len, rows, width // 4)), state,
            torch.empty_like(state))


# the lean forward as ``torch.ops.ptt.lstm_cell_scan(gates_x, w (D, H, 4H),
# mask, h0, c0, bf16_products)`` -> (out, h_T, c_T)
lstm_cell_scan_op = _ops.define('lstm_cell_scan', _op_plain, _op_launch,
                                _op_fake)
