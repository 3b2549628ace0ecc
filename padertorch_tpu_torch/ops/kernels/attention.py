"""Fused (flash) multi-head attention: forward and backward.

Counterpart of ``padertorch_tpu/ops/pallas/attention.py``
(``flash_attention`` with its custom VJP, ``should_use_flash``): exact
softmax attention ``softmax(q k^T / sqrt(D) + mask) v`` with key-padding,
causal and sliding-window masks that never writes the (Tq, Tk) weights to
device memory, neither in the forward nor in the backward pass (the
backward recomputes the probabilities tile by tile from the stored
log-sum-exp).

On a CUDA tensor :func:`flash_attention` launches hand-written kernels:
without gradients the forward of ``csrc/flash_attention.cu`` with no
log-sum-exp kept; when a gradient is asked for, through
:class:`FlashAttention`, the same forward writing the log-sum-exp and, in
``backward``, the dk/dv and dq kernels of ``csrc/flash_attention_bwd.cu``.
``delta = sum(dO * O, -1)`` is one elementwise product and sum outside the
kernels, as in the JAX package.  float32 only: the kernels' bf16 operands
(``padertorch_tpu/ops/pallas/attention.py`` under the bf16 policy) are not
ported yet (ROADMAP.md); ``use_flash='auto'`` takes the dense path for
bf16.

The kernels take head sizes 16, 32, 64 and 128; another head size up to
128 is zero-padded to the next of these inside the wrapper (zeros change
neither the logits nor the kept part of the output), a larger one raises.
Sequence lengths are free: ragged ``Tq``/``Tk`` are bounds checks in the
kernels, nothing is padded along time.

On a CPU tensor :func:`flash_attention` runs :func:`flash_attention_plain`,
the masked-softmax formula with an explicit zero for masked probabilities,
which autograd differentiates.  Fully masked query rows give 0 output and 0
gradient in both.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from padertorch_tpu_torch.ops.kernels import _build

__all__ = ['flash_attention', 'flash_attention_plain',
           'flash_attention_fwd_plain', 'FlashAttention', 'should_use_flash']

_NEG = -1e30
HEAD_SIZES = (16, 32, 64, 128)

def should_use_flash(device, dtype=torch.float32, head_size=None):
    """Dispatch of ``use_flash='auto'``: the fused kernels for float32
    tensors on a CUDA device with a head size the kernels take (at most
    ``HEAD_SIZES[-1]``; ``head_size`` None asks for any they take), the
    dense path otherwise (the kernels take float32 only, and raise for a
    wider head).  The sequence lengths and the mask do not enter: since
    both kernels' tile products run on the tensor cores (3xTF32) they beat
    the dense path at every row of the dispatch table that chip_smoke.py
    phase 12 measures on an H100 (PERF.md, "Attention dispatch": 12 heads
    of 64 at T = 512 ... 4096, full, causal and windowed, and 8 heads of 16
    at T = 66 and 100, forward alone and forward plus backward)."""
    return (torch.device(device).type == 'cuda' and dtype == torch.float32
            and (head_size is None or head_size <= HEAD_SIZES[-1]))


def _norm_window(window):
    if window is None:
        return None, None
    left, right = window
    assert left is None or left >= 0, window
    assert right is None or right >= 0, window
    return (None if left is None else int(left),
            None if right is None else int(right))


def _lens_tensor(key_padding_lens, batch, device):
    """(B,) int32 valid key counts on ``device``, or None.  A host sequence
    is copied over; nothing is read back from the device."""
    if key_padding_lens is None:
        return None
    if isinstance(key_padding_lens, torch.Tensor):
        lens = key_padding_lens.to(device=device, dtype=torch.int32)
    else:
        lens = torch.from_numpy(
            np.asarray(key_padding_lens).astype(np.int32)).to(device)
    assert lens.shape == (batch,), (lens.shape, batch)
    return lens.contiguous()


def visible_mask(tq, tk, lens, causal, window, device):
    """Boolean (B or 1, 1, Tq, Tk): may query i attend key j?"""
    left, right = _norm_window(window)
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    valid = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (cols <= rows)
    if left is not None:
        valid = valid & (rows - cols <= left)
    if right is not None:
        valid = valid & (cols - rows <= right)
    valid = valid[None, None]
    if lens is not None:
        valid = valid & (cols[None, None] < lens.clamp(max=tk)[:, None, None,
                                                                None])
    return valid


def flash_attention_fwd_plain(q, k, v, *, causal=False, key_padding_lens=None,
                              window=None):
    """Plain PyTorch version of the forward kernel: ``(o, lse)`` with
    ``lse`` (B, H, Tq) = m + log(max(l, 1e-30)), the row's log-sum-exp
    (-1e30 for a fully masked row, whose output is 0)."""
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    assert h % h_kv == 0, (h, h_kv)
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    lens = _lens_tensor(key_padding_lens, b, q.device)
    valid = visible_mask(tq, tk, lens, causal, window, q.device)
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    s = torch.where(valid, s, s.new_tensor(_NEG))
    if tk == 0:
        m = s.new_full((b, h, tq, 1), _NEG)
    else:
        m = s.max(dim=-1, keepdim=True).values.detach()
    p = torch.where(valid, torch.exp(s - m), s.new_zeros(()))
    l_safe = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.matmul(p, v) / l_safe
    return o, (m + torch.log(l_safe))[..., 0]


def flash_attention_plain(q, k, v, *, causal=False, key_padding_lens=None,
                          window=None):
    """Plain PyTorch version of :func:`flash_attention` (same contract)."""
    return flash_attention_fwd_plain(
        q, k, v, causal=causal, key_padding_lens=key_padding_lens,
        window=window)[0]


def tf32_round(x):
    """float32 ``x`` as a TF32 tensor-core product reads it: the 13 low
    mantissa bits cleared.  The backward kernels split an operand into
    this part and the rest (3xTF32); emulations of that arithmetic, and of
    plain TF32, round with it."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _check(q, k, v):
    for name, x in (('q', q), ('k', k), ('v', v)):
        if x.dtype != torch.float32:
            raise TypeError(
                f'{name} is {x.dtype}: the attention kernels take float32 '
                'only; their bf16 operands '
                '(padertorch_tpu/ops/pallas/attention.py) are not ported '
                'yet (ROADMAP.md)')
        if x.device != q.device:
            raise ValueError(f'{name} is on {x.device}, q on {q.device}')
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    if h % h_kv != 0 or k.shape != (b, h_kv, tk, d) or v.shape != k.shape:
        raise ValueError(
            f'shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, '
            f'v {tuple(v.shape)}')
    if d > HEAD_SIZES[-1]:
        raise ValueError(
            f'head size {d}: the attention kernels take at most '
            f'{HEAD_SIZES[-1]}')


def _aligned(x):
    """Contiguous and 16-byte aligned (the kernels load float4)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _mask_args(causal, left, right):
    return (int(bool(causal)), -1 if left is None else left,
            -1 if right is None else right)


def _launch_fwd(q, k, v, lens, causal, left, right, scale, train):
    """Launch the forward kernel on (B, H, T, D) tensors with D one of
    HEAD_SIZES; with ``train`` it also returns the log-sum-exp."""
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if train else None)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b * h, h, h // h_kv, tq, tk,
        d, *_mask_args(causal, left, right), scale, device, stream)
    _build.check(lib, err, 'flash_attention forward kernel')
    flash_attention.launches['fwd_train' if train else 'fwd'] += 1
    return o, lse


def _launch_bwd(q, k, v, lens, d_o, lse, delta, causal, left, right, scale):
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(q)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), d_o.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b * h, h, h // h_kv, tq, tk, d,
        *_mask_args(causal, left, right), scale, device, stream)
    _build.check(lib, err, 'flash_attention backward kernels')
    flash_attention.launches['bwd'] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` on CUDA tensors with a gradient: ``forward``
    is the forward kernel keeping the log-sum-exp, ``backward`` the dk/dv
    and dq kernels.  Tensors are (B, H, T, D) float32, contiguous, D one of
    ``HEAD_SIZES``; ``lens`` (B,) int32 on the device or None."""

    @staticmethod
    def forward(ctx, q, k, v, lens, causal, left, right, scale):
        o, lse = _launch_fwd(q, k, v, lens, causal, left, right, scale,
                             train=True)
        ctx.save_for_backward(q, k, v, lens, o, lse)
        ctx.config = (causal, left, right, scale)
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, lens, o, lse = ctx.saved_tensors
        d_o = _aligned(d_o)
        delta = (d_o * o).sum(dim=-1)
        dq, dk, dv = _launch_bwd(q, k, v, lens, d_o, lse, delta, *ctx.config)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=False, key_padding_lens=None,
                    window=None):
    """Fused attention over (B, H, T, D) tensors; differentiable.

    Args:
        q: (B, H, Tq, D) queries.
        k, v: (B, Hkv, Tk, D) keys/values.  ``Hkv`` may divide ``H``
            (grouped-query / multi-query attention): consecutive groups of
            ``H // Hkv`` query heads share one KV head, which the kernels
            read directly; no repeated KV tensor is made.
        causal: query i attends keys <= i (diagonal-aligned at 0).
        key_padding_lens: (B,) valid key lengths (a host sequence or a
            tensor); keys beyond are masked.
        window: optional ``(left, right)`` sliding window: query i attends
            keys j with ``i - left <= j <= i + right``; either side may be
            ``None`` for unbounded.  Key tiles outside the band are
            skipped, not masked.  Composes with ``causal`` and
            ``key_padding_lens``.

    Returns:
        (B, H, Tq, D) attention output; fully masked query rows return 0.
        CPU tensors run the plain version; CUDA tensors launch the kernels
        (or raise): the forward alone, or, when grad mode is on and an
        input requires a gradient, the forward that keeps the log-sum-exp,
        whose ``backward`` is kernels too.  ``flash_attention.launches``
        counts the launches (``fwd``, ``fwd_train``, ``bwd``).

    >>> q = torch.ones((2, 4, 5, 16))
    >>> out = flash_attention(q, q[:, :2], q[:, :2], causal=True,
    ...                       key_padding_lens=[5, 0])
    >>> out.shape, float(out[0].min()), float(out[1].abs().max())
    (torch.Size([2, 4, 5, 16]), 1.0, 0.0)
    """
    if q.device.type == 'cpu':
        return flash_attention_plain(
            q, k, v, causal=causal, key_padding_lens=key_padding_lens,
            window=window)
    if q.device.type != 'cuda':
        raise ValueError(f'no kernel for device {q.device}')
    _check(q, k, v)
    b, h, tq, d = q.shape
    left, right = _norm_window(window)
    if tq == 0:
        return torch.zeros_like(q)
    lens = _lens_tensor(key_padding_lens, b, q.device)
    scale = 1.0 / math.sqrt(d)
    d_p = next(size for size in HEAD_SIZES if size >= d)
    if d_p != d:
        q, k, v = (F.pad(x, (0, d_p - d)) for x in (q, k, v))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        o = FlashAttention.apply(q, k, v, lens, causal, left, right, scale)
    else:
        o, _ = _launch_fwd(q, k, v, lens, causal, left, right, scale,
                           train=False)
    return o[..., :d] if d_p != d else o


flash_attention.launches = {'fwd': 0, 'fwd_train': 0, 'bwd': 0}
