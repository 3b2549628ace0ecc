"""Weight-only int8 matrix product ``x @ (w_q * scale) [+ bias]``.

Counterpart of ``padertorch_tpu/ops/pallas/int8_matmul.py``
(``int8_matmul``): activations ``x`` (..., K) in float32 or bf16, weights
``w_q`` (K, N) in int8, one float32 ``scale`` per output column (symmetric,
no zero point) and an optional ``bias``; the result (..., N) in ``x``'s
type, summed in float32.  The scale multiplies the sum, not the weight.

On a CUDA tensor :func:`int8_matmul` launches the hand-written kernels of
``csrc/int8_matmul.cu``, which read the weights only as int8, widen them in
registers and sum every output element in one fixed order (the same for
every M, so a row of a batch equals the row alone, bit for bit): for bf16
x one launch whose products run on the tensor cores (``wgmma``; the last
block of each column tile adds the splits, scales and adds the bias), for
float32 x the CUDA-core kernel and its epilogue.  On a CPU tensor it runs
:func:`int8_matmul_plain`, the kernel's arithmetic in plain tensor code.
Inference only, as in the JAX package: an input that requires a gradient
under grad mode is refused.

Not ported: the JAX wrapper pads K and N to 128-lane tiles for the TPU;
here nothing is padded.
"""
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from padertorch_tpu_torch.ops.kernels import _build, _ops

__all__ = ['int8_matmul', 'int8_matmul_plain', 'matmul_rows', 'composed',
           'split_rows', 'bf16_split_rows', 'INT8_KERNEL_MAX_ROWS',
           'int8_matmul_op']

# ``QuantizedLinear(use_kernel=None)`` on a CUDA tensor takes the kernel
# for at most this many rows of x and the composed route (cuBLAS on the
# weight dequantized per call) above: where the kernel's device time is at
# most the composed route's at all three of the 12-layer decoder's weight
# shapes on an H100 (bf16; chip_smoke.py phase 20's table by rows, PERF.md
# "int8_matmul dispatch").  At 128 rows the kernel loses at (1024, 1024):
# every tile of 64 columns reads x again and the partial sums grow with M.
INT8_KERNEL_MAX_ROWS = 64

_BN = 128              # columns per block of the float32 kernel
_K_LANES = 32          # threads of a block that share a column
_TARGET_BLOCKS = 264   # about two blocks on each of an H100's 132 SMs
_TC_BN = 64            # columns per block of the bf16 kernel: the MMA's M
_TC_ROWS = 256         # its weight rows per split: four warpgroups x 64
_SMS = 132             # an H100's SMs: at most one block on each
_COUNTERS = 1 << 16    # column tiles the bf16 kernel's counters cover


def split_rows(k, n):
    """Weight rows per split of the float32 kernel's first pass, from
    (K, N) alone: about ``_TARGET_BLOCKS`` blocks, a multiple of 32 rows
    from 64 to 1024.  It never depends on M, so the order of every sum is
    the same whatever the number of rows of x.

    >>> [split_rows(1024, 1024), split_rows(1024, 4096), split_rows(4096, 1024)]
    [64, 128, 128]
    """
    tiles = -(-n // _BN)
    splits = -(-_TARGET_BLOCKS // tiles)
    rows = -(-k // splits)
    rows = -(-rows // _K_LANES) * _K_LANES
    return min(max(rows, 2 * _K_LANES), 1024)


@functools.lru_cache(maxsize=None)
def bf16_split_rows(k, n):
    """Weight rows per split of the bf16 kernel, from (K, N) alone: as many
    splits as leave at most one block of 64 columns on each SM, in rows
    that are a multiple of 256 (its four warpgroups take 64 each in turn)
    up to 1024 (its shared memory).  As :func:`split_rows`, it never
    depends on M.

    >>> [bf16_split_rows(1024, 1024), bf16_split_rows(1024, 4096),
    ...  bf16_split_rows(4096, 1024), bf16_split_rows(1000, 1030)]
    [256, 512, 512, 256]
    """
    tiles = -(-n // _TC_BN)
    splits = max(1, _SMS // tiles)
    rows = -(-k // splits)
    rows = -(-rows // _TC_ROWS) * _TC_ROWS
    return min(rows, 1024)


_counters = {}


def _tile_counters(index, stream, tiles):
    """The bf16 kernel's per-tile counters (int32 zeros, at least ``tiles``
    of them) for a split launch on CUDA device ``index`` and ``stream``
    (its raw handle).

    Eager launches share one buffer per (device, stream), made once: each
    launch leaves its counters at zero, and launches on one stream run one
    after another, so no two launches count into the same tiles at once.
    (One buffer per device, as before, let split launches on two streams
    take each other's counts: a block could take itself for the last one
    of its tile, the output was wrong and the counters stayed non-zero.)
    A launch captured into a CUDA graph gets counters of its own, zeroed
    by a memset node before it: a graph may be replayed on any stream,
    beside eager calls and other graphs, so no buffer shared with anything
    else is safe there; the node costs about a microsecond per replayed
    split launch.
    """
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(tiles, dtype=torch.int32, device=f'cuda:{index}')
    key = (index, stream)
    counters = _counters.get(key)
    if counters is None:
        counters = _counters[key] = torch.zeros(
            _COUNTERS, dtype=torch.int32, device=f'cuda:{index}')
    return counters


def _prepare(x, w_q, scale, bias, out_features, k_logical):
    """Check the contract; -> (x2 (M, K_w), w_q, scale, bias or None,
    lead shape, output columns)."""
    if w_q.dtype != torch.int8:
        raise ValueError(f'w_q must be int8, got {w_q.dtype}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'x is {x.dtype}: int8_matmul takes float32 or '
                        'bfloat16 activations')
    device = x.device
    for name, t in (('w_q', w_q), ('scale', scale), ('bias', bias)):
        if t is not None and t.device != device:
            raise ValueError(f'{name} is on {t.device}, x on {device}')
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias)):
        raise ValueError(
            'int8_matmul is inference only (int8 weights carry no '
            'gradient): call it under torch.no_grad() or on detached inputs')
    *lead, k = x.shape
    k_w, n = w_q.shape
    if k_w != k and not (k_w > k and k == k_logical):
        raise ValueError(
            f'contraction mismatch: x K={k}, w_q K={k_w}'
            + ('' if k_logical is None
               else f' (declared k_logical={k_logical})'))
    if scale.shape != (n,):
        raise ValueError(f'scale of shape {tuple(scale.shape)} for N={n}')
    x2 = x.reshape(-1, k)
    if k_w > k:
        # declared zero-padding rows of the weight: pad x to match
        x2 = F.pad(x2, (0, k_w - k))
    if bias is not None:
        if bias.dim() != 1 or bias.shape[0] not in (
                {n} | ({out_features} if out_features is not None else set())):
            raise ValueError(
                f'bias length {tuple(bias.shape)} matches neither N={n} nor '
                f'out_features={out_features}')
        if bias.shape[0] != n:
            bias = F.pad(bias, (0, n - bias.shape[0]))
    n_out = n if out_features is None else out_features
    return x2, w_q, scale, bias, lead, n_out


def _finish(out, lead, n, n_out):
    if n_out != n:
        out = out[:, :n_out]
    if len(lead) == 1:
        return out
    return out.reshape(*lead, n_out)


def _plain_2d(x2, w_q, scale, bias):
    y = (x2.float() @ w_q.float()) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2.dtype)


def _launch(x2, w_q, scale, bias):
    m, k = x2.shape
    n = w_q.shape[1]
    if m == 0:
        return x2.new_empty((0, n))
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    if not w_q.is_contiguous():
        w_q = w_q.contiguous()
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    bias_kind = 0
    if bias is not None:
        if bias.dtype not in (torch.float32, torch.bfloat16):
            bias = bias.float()
        bias = bias.contiguous()
        bias_kind = 1 if bias.dtype == torch.float32 else 2
    place = x2.device
    out = torch.empty((m, n), dtype=x2.dtype, device=place)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(x2)
    bias_ptr = None if bias is None else bias.data_ptr()
    if x2.dtype == torch.bfloat16:
        rows = bf16_split_rows(k, n)
        splits = -(-k // rows)
        if -(-n // _TC_BN) > _COUNTERS:
            raise ValueError(f'N={n}: more column tiles than the bf16 '
                             f'kernel counts ({_COUNTERS})')
        ws = counters = None
        if splits > 1:
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=place)
            counters = _tile_counters(device, stream, -(-n // _TC_BN))
        err = lib.int8_matmul_bf16_fwd(
            x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias_ptr,
            bias_kind, out.data_ptr(), None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, k, n, rows,
            device, stream)
    else:
        rows = split_rows(k, n)
        ws = torch.empty((-(-k // rows), m, n), dtype=torch.float32,
                         device=place)
        err = lib.int8_matmul_fwd(
            x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias_ptr,
            bias_kind, out.data_ptr(), ws.data_ptr(), m, k, n, rows, device,
            stream)
    _build.check(lib, err, 'int8_matmul kernel')
    int8_matmul.launches += 1
    return out


def int8_matmul(x, w_q, scale, bias=None, *, out_features=None,
                k_logical=None):
    """``x @ (w_q * scale) [+ bias]`` with the weight read as int8.

    Args:
        x: (..., K) float32 or bfloat16 activations.
        w_q: (K, N) int8 weights.
        scale: (N,) per-output-column scales (used as float32).
        bias: optional (N,) or (``out_features``,) bias, float32 or bf16
            (added in float32; a shorter one is zero-padded).
        out_features: cut the output to this many columns (defaults to N).
        k_logical: declare that ``w_q``'s rows beyond this count are zero
            padding; an x with K == ``k_logical`` is then zero-padded to
            match.  Any other K mismatch raises.

    Returns:
        (..., out_features) in ``x``'s type.  A CPU tensor runs
        :func:`int8_matmul_plain`; a CUDA tensor launches the kernel (or
        raises).  The product is the custom operator
        ``torch.ops.ptt.int8_matmul`` (``ops/kernels/_ops.py``), which
        ``torch.export`` records.  ``int8_matmul.launches`` counts the kernel's calls.
    """
    return matmul_rows(x, w_q, scale, bias, out_features=out_features,
                       k_logical=k_logical)


def matmul_rows(x, w_q, scale, bias=None, *, out_features=None,
                k_logical=None, max_kernel_rows=-1):
    """:func:`int8_matmul`, or, for more than ``max_kernel_rows`` rows of x
    (-1: no limit), the composed route :func:`composed` (the one place
    where the operator runs another product: ``QuantizedLinear``'s
    dispatch by rows, decided where the rows are concrete)."""
    x2, w_q, scale, bias, lead, n_out = _prepare(
        x, w_q, scale, bias, out_features, k_logical)
    out = _ops.call(int8_matmul_op, x2, w_q, scale, bias, max_kernel_rows)
    return _finish(out, lead, w_q.shape[1], n_out)


def composed(x, w_q, scale, bias=None):
    """``QuantizedLinear``'s composed route: ``x @ (w_q * scale)`` with the
    weight dequantized to x's type, then the bias."""
    y = x @ (w_q.to(x.dtype) * scale.to(x.dtype))
    if bias is not None:
        y = y + bias
    return y


def int8_matmul_plain(x, w_q, scale, bias=None, *, out_features=None,
                      k_logical=None):
    """Plain PyTorch version of :func:`int8_matmul` (same contract): the
    kernel's arithmetic, ``((x.float() @ w_q.float()) * scale + bias)`` cast
    to ``x``'s type.  (The composed route of ``QuantizedLinear``,
    ``x @ (w_q * scale)`` in ``x``'s type, rounds each weight and is
    another function.)"""
    x2, w_q, scale, bias, lead, n_out = _prepare(
        x, w_q, scale, bias, out_features, k_logical)
    return _finish(_plain_2d(x2, w_q, scale, bias), lead, w_q.shape[1],
                   n_out)


int8_matmul.launches = 0


def _op_plain(x2: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor],
              max_kernel_rows: int) -> torch.Tensor:
    if 0 <= max_kernel_rows < x2.shape[0]:
        return composed(x2, w_q, scale, bias).to(x2.dtype)
    return _plain_2d(x2, w_q, scale, bias)


def _op_launch(x2, w_q, scale, bias, max_kernel_rows):
    if 0 <= max_kernel_rows < x2.shape[0]:
        return composed(x2, w_q, scale, bias).to(x2.dtype)
    return _launch(x2, w_q, scale, bias)


def _op_fake(x2, w_q, scale, bias, max_kernel_rows):
    return x2.new_empty((x2.shape[0], w_q.shape[1]))


# the product as ``torch.ops.ptt.int8_matmul(x2 (M, K), w_q (K, N), scale,
# bias, max_kernel_rows)`` -> (M, N) in x2's type; above
# ``max_kernel_rows`` rows (-1: never) the composed route, its result cast
# to x2's type
int8_matmul_op = _ops.define('int8_matmul', _op_plain, _op_launch, _op_fake)
