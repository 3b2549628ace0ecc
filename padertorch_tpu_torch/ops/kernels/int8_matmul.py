"""Weight-only int8 matrix product ``x @ (w_q * scale) [+ bias]``.

Counterpart of ``padertorch_tpu/ops/pallas/int8_matmul.py``
(``int8_matmul``): activations ``x`` (..., K) in float32 or bf16, weights
``w_q`` (K, N) in int8, one float32 ``scale`` per output column (symmetric,
no zero point) and an optional ``bias``; the result (..., N) in ``x``'s
type, summed in float32.  The scale multiplies the sum, not the weight.

On a CUDA tensor :func:`int8_matmul` launches the hand-written kernel of
``csrc/int8_matmul.cu``, which reads the weights only as int8 and widens
them in registers, sums every output element in one fixed order (the same
for every M, so a row of a batch equals the row alone, bit for bit) and
adds the scale and the bias in its second pass.  On a CPU tensor it runs
:func:`int8_matmul_plain`, the kernel's arithmetic in plain tensor code.
Inference only, as in the JAX package: an input that requires a gradient
under grad mode is refused.

Not ported: the JAX wrapper pads K and N to 128-lane tiles for the TPU;
here nothing is padded.
"""
import torch
import torch.nn.functional as F

from padertorch_tpu_torch.ops.kernels import _build

__all__ = ['int8_matmul', 'int8_matmul_plain', 'split_rows',
           'INT8_KERNEL_MAX_ROWS']

# ``QuantizedLinear(use_kernel=None)`` on a CUDA tensor takes the kernel
# for at most this many rows of x and the composed route (cuBLAS on the
# weight dequantized per call) above: where the kernel's device time is at
# most the composed route's at all three of the 12-layer decoder's weight
# shapes on an H100 (bf16; chip_smoke.py phase 20's table by rows, PERF.md
# "int8_matmul dispatch").  At 32 rows the kernel loses at (1024, 1024).
INT8_KERNEL_MAX_ROWS = 16

_BN = 128              # columns per block of the kernel's first pass
_K_LANES = 32          # threads of a block that share a column
_TARGET_BLOCKS = 264   # about two blocks on each of an H100's 132 SMs


def split_rows(k, n):
    """Weight rows per split of the kernel's first pass, from (K, N) alone:
    about ``_TARGET_BLOCKS`` blocks, a multiple of 32 rows from 64 to 1024.
    It never depends on M, so the order of every sum is the same whatever
    the number of rows of x.

    >>> [split_rows(1024, 1024), split_rows(1024, 4096), split_rows(4096, 1024)]
    [64, 128, 128]
    """
    tiles = -(-n // _BN)
    splits = -(-_TARGET_BLOCKS // tiles)
    rows = -(-k // splits)
    rows = -(-rows // _K_LANES) * _K_LANES
    return min(max(rows, 2 * _K_LANES), 1024)


def _prepare(x, w_q, scale, bias, out_features, k_logical):
    """Check the contract; -> (x2 (M, K_w), w_q, scale, bias or None,
    lead shape, output columns)."""
    if w_q.dtype != torch.int8:
        raise ValueError(f'w_q must be int8, got {w_q.dtype}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'x is {x.dtype}: int8_matmul takes float32 or '
                        'bfloat16 activations')
    for name, t in (('w_q', w_q), ('scale', scale), ('bias', bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')
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
    x2 = x2.contiguous()
    w_q = w_q.contiguous()
    scale = scale.to(torch.float32).contiguous()
    bias_kind = 0
    if bias is not None:
        if bias.dtype not in (torch.float32, torch.bfloat16):
            bias = bias.float()
        bias = bias.contiguous()
        bias_kind = 1 if bias.dtype == torch.float32 else 2
    rows = split_rows(k, n)
    ws = torch.empty((-(-k // rows), m, n), dtype=torch.float32,
                     device=x2.device)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(x2)
    err = lib.int8_matmul_fwd(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), w_q.data_ptr(),
        scale.data_ptr(), None if bias is None else bias.data_ptr(),
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
        raises).  ``int8_matmul.launches`` counts the kernel's calls.
    """
    x2, w_q, scale, bias, lead, n_out = _prepare(
        x, w_q, scale, bias, out_features, k_logical)
    if x2.device.type == 'cpu':
        out = _plain_2d(x2, w_q, scale, bias)
    elif x2.device.type == 'cuda':
        out = _launch(x2, w_q, scale, bias)
    else:
        raise ValueError(f'no kernel for device {x2.device}')
    return _finish(out, lead, w_q.shape[1], n_out)


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
