"""Fused (flash) multi-head attention: forward and backward.

Counterpart of ``padertorch_tpu/ops/pallas/attention.py``
(``flash_attention`` with its custom VJP, ``should_use_flash``): exact
softmax attention ``softmax(q k^T / sqrt(D) + mask) v`` with key-padding,
causal and sliding-window masks that never writes the (Tq, Tk) weights to
device memory, neither in the forward nor in the backward pass (the
backward recomputes the probabilities tile by tile from the stored
log-sum-exp).

On a CUDA tensor :func:`flash_attention` launches hand-written kernels:
without gradients the forward of ``csrc/flash_attention.cu`` (float32) or
``csrc/flash_attention_fwd_bf16.cu`` (bf16: ``wgmma`` from tiles brought
by TMA, P rounded to bf16 in registers) with no log-sum-exp kept; when a
gradient is asked for, through :class:`FlashAttention`, the same forward
writing the log-sum-exp and, in ``backward``, the dk/dv and dq kernels of
``csrc/flash_attention_bwd.cu`` (float32) or
``csrc/flash_attention_bwd_bf16.cu`` (bf16: ``wgmma`` from tiles brought
by TMA, P and dS split into three bf16 pieces).
``delta = sum(dO * O, -1)`` is one elementwise product and sum outside the
kernels, in float32, as in the JAX package.

q, k and v are float32, or all three bf16: then the kernels' bf16 variants
run with the JAX kernel's numerics (``padertorch_tpu/ops/pallas/
attention.py``): logits are float32 sums of the bf16 products, the softmax
and its sums float32, the probabilities rounded to bf16 only as the operand
of ``P V``, the output rounded once; in the backward P and dS stay float32,
every sum is float32, and dq, dk, dv are rounded once.  A mix of types
raises.

The kernels take head sizes 16, 32, 64, 128 and 256; another head size up
to 256 is zero-padded to the next of these inside the wrapper (zeros change
neither the logits nor the kept part of the output; the JAX kernel pads to
a multiple of 128 the same way), a larger one raises.  At 256 each block
of the float32 forward computes half of the output's columns
(``csrc/flash_attention.cu``).
Sequence lengths are free: ragged ``Tq``/``Tk`` are bounds checks in the
kernels, nothing is padded along time.

On a CPU tensor :func:`flash_attention` runs :func:`flash_attention_plain`,
the masked-softmax formula with an explicit zero for masked probabilities,
which autograd differentiates in float32; in bf16 its gradient is
:func:`flash_attention_bwd_plain`, the backward kernels' plain version
(autograd of the bf16 forward would round dP to bf16 where the JAX kernel
keeps it float32).  Fully masked query rows give 0 output and 0 gradient in
both.
"""
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from padertorch_tpu_torch.ops.kernels import _build, _ops

__all__ = ['flash_attention', 'flash_attention_plain',
           'flash_attention_fwd_plain', 'flash_attention_bwd_plain',
           'FlashAttention', 'should_use_flash', 'flash_attention_op']

_NEG = -1e30
HEAD_SIZES = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# the widest head 'auto' sends to the kernels, by type: the dispatch table
# of chip_smoke.py phase 12 (PERF.md, "Dispatch tables") measures the fused
# MultiheadAttention against the dense one at heads of 64, 16, 192 and 256;
# above 128 the dense path wins every float32 training row, while in bf16
# the kernels win every training row (up to 1.8 times) and the causal
# forwards, and lose the full forwards by 7% to 13%
AUTO_MAX_HEAD = {torch.float32: 128, torch.bfloat16: 256}
# keys per tile of the bf16 forward kernel: it rounds a tile's
# probabilities to bf16 against the running maximum of the tiles so far
BF16_KEY_TILE = 64

def should_use_flash(device, dtype=torch.float32, head_size=None):
    """Dispatch of ``use_flash='auto'``: the fused kernels for float32 or
    bf16 tensors on a CUDA device with a head size of at most
    ``AUTO_MAX_HEAD[dtype]`` (``head_size`` None asks for any they take),
    the dense path otherwise (the kernels take no other type, and raise for
    a head above ``HEAD_SIZES[-1]``).  The sequence lengths and the mask
    do not enter: the
    kernels beat the dense path at every row of the dispatch table that
    chip_smoke.py phase 12 measures on an H100, in float32 (3xTF32 tensor
    cores) and in bf16 (PERF.md, "Attention dispatch": 12 heads of 64 at
    T = 512 ... 4096, full, causal and windowed, and 8 heads of 16 at
    T = 66 and 100, forward alone and forward plus backward)."""
    return (torch.device(device).type == 'cuda' and dtype in DTYPES
            and (head_size is None or head_size <= AUTO_MAX_HEAD[dtype]))


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


def _wide(x):
    """x in float32, or float64 where it is that: bf16 widens exactly."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _expand_kv(k, v, heads):
    h_kv = k.shape[1]
    assert heads % h_kv == 0, (heads, h_kv)
    if h_kv != heads:
        k = k.repeat_interleave(heads // h_kv, dim=1)
        v = v.repeat_interleave(heads // h_kv, dim=1)
    return k, v


def flash_attention_fwd_plain(q, k, v, *, causal=False, key_padding_lens=None,
                              window=None, key_tile=None):
    """Plain PyTorch version of the forward kernel: ``(o, lse)`` with
    ``lse`` (B, H, Tq) = m + log(max(l, 1e-30)), the row's log-sum-exp
    (-1e30 for a fully masked row, whose output is 0).

    For bf16 inputs the JAX kernel's dtypes, step by step: logits, maxima,
    probabilities and their sum float32 (bf16 values widen exactly), the
    probabilities rounded to bf16 only as the operand of ``P V`` (a float32
    sum), ``o`` rounded to bf16 once, ``lse`` float32.  In float32 every
    cast is the identity.

    ``key_tile``: take the keys in tiles of this many with a running
    maximum, as the Pallas kernel takes its blocks of ``block_k`` and the
    bf16 kernel its ``BF16_KEY_TILE``: a tile's probabilities are rounded
    to bf16 against the maximum of the tiles so far, and the sums rescaled
    as it grows.  None: one tile, the row's maximum."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    k, v = _expand_kv(k, v, h)
    lens = _lens_tensor(key_padding_lens, b, q.device)
    valid = visible_mask(tq, tk, lens, causal, window, q.device)
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))
    s = torch.where(valid, s, s.new_tensor(_NEG))
    m = s.new_full((b, h, tq, 1), _NEG)
    l = s.new_zeros((b, h, tq, 1))
    acc = s.new_zeros((b, h, tq, d))
    tile = key_tile or max(tk, 1)
    for j in range(0, tk, tile):
        cols = slice(j, j + tile)
        m_new = torch.maximum(
            m, s[..., cols].max(dim=-1, keepdim=True).values.detach())
        p = torch.where(valid[..., cols], torch.exp(s[..., cols] - m_new),
                        s.new_zeros(()))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(_wide(p.to(v.dtype)),
                                         _wide(v[..., cols, :]))
        m = m_new
    l_safe = l.clamp(min=1e-30)
    return (acc / l_safe).to(q.dtype), (m + torch.log(l_safe))[..., 0]


def flash_attention_plain(q, k, v, *, causal=False, key_padding_lens=None,
                          window=None):
    """Plain PyTorch version of :func:`flash_attention` (same contract)."""
    return flash_attention_fwd_plain(
        q, k, v, causal=causal, key_padding_lens=key_padding_lens,
        window=window)[0]


def flash_attention_bwd_plain(q, k, v, o, lse, d_o, *, causal=False,
                              key_padding_lens=None, window=None):
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)`` from
    the forward's ``o`` and ``lse`` and the cotangent ``d_o``, with the JAX
    kernel's dtypes (``padertorch_tpu/ops/pallas/attention.py``
    ``_bwd_call``): ``delta = sum(f32(dO) f32(O))``, the probabilities
    recomputed in float32 from the stored ``lse``, every product and sum
    float32, the KV heads' query groups summed in float32, and each
    gradient rounded once to its input's dtype."""
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf, dof = _wide(q), _wide(d_o)
    kf, vf = _expand_kv(_wide(k), _wide(v), h)
    lens = _lens_tensor(key_padding_lens, b, q.device)
    valid = visible_mask(tq, tk, lens, causal, window, q.device)
    delta = (dof * _wide(o)).sum(dim=-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(valid, torch.exp(torch.where(valid, s, s.new_tensor(
        _NEG)) - lse.to(s.dtype)[..., None]), s.new_zeros(()))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    if h_kv != h:
        dk = dk.reshape(b, h_kv, h // h_kv, tk, d).sum(dim=2)
        dv = dv.reshape(b, h_kv, h // h_kv, tk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class PlainFlashAttention(torch.autograd.Function):
    """:func:`flash_attention` on bf16 CPU tensors with a gradient: the
    plain forward and, as its backward, :func:`flash_attention_bwd_plain`
    (the JAX kernel's float32 backward)."""

    @staticmethod
    def forward(ctx, q, k, v, masks):
        o, lse = flash_attention_fwd_plain(q, k, v, **masks)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = masks
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd_plain(q, k, v, o, lse, d_o,
                                           **ctx.masks), None)


def tf32_round(x):
    """float32 ``x`` as a TF32 tensor-core product reads it: the 13 low
    mantissa bits cleared.  The backward kernels split an operand into
    this part and the rest (3xTF32); emulations of that arithmetic, and of
    plain TF32, round with it."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _check(q, k, v):
    if q.dtype not in DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f'q, k, v are {q.dtype}, {k.dtype}, {v.dtype}: the attention '
            'kernels take float32 or bfloat16, the three alike')
    for name, x in (('k', k), ('v', v)):
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


def _variant(q):
    """The kernels' C-entry suffix and launch-count suffix for q's type."""
    return '_bf16' if q.dtype == torch.bfloat16 else ''


def _launch_fwd(q, k, v, lens, causal, left, right, scale, train):
    """Launch the forward kernel (float32 or bf16 by q's type) on (B, H, T,
    D) tensors with D one of HEAD_SIZES; with ``train`` it also returns the
    float32 log-sum-exp."""
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if train else None)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(q)
    variant = _variant(q)
    err = getattr(lib, 'flash_attention_fwd' + variant)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b * h, h, h // h_kv, tq, tk,
        d, *_mask_args(causal, left, right), scale, device, stream)
    _build.check(lib, err, 'flash_attention forward kernel')
    flash_attention.launches[('fwd_train' if train else 'fwd') + variant] += 1
    return o, lse


def _launch_bwd(q, k, v, lens, d_o, lse, delta, causal, left, right, scale):
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(q)
    variant = _variant(q)
    err = getattr(lib, 'flash_attention_bwd' + variant)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), d_o.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b * h, h, h // h_kv, tq, tk, d,
        *_mask_args(causal, left, right), scale, device, stream)
    _build.check(lib, err, 'flash_attention backward kernels')
    flash_attention.launches['bwd' + variant] += 1
    return dq, dk, dv


def _padded(q, k, v):
    """q, k, v with the head size zero-padded to the next of
    ``HEAD_SIZES``, contiguous and 16-byte aligned, and that size."""
    d = q.shape[-1]
    d_p = next(size for size in HEAD_SIZES if size >= d)
    if d_p != d:
        q, k, v = (F.pad(x, (0, d_p - d)) for x in (q, k, v))
    return _aligned(q), _aligned(k), _aligned(v), d_p


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` on CUDA tensors with a gradient: ``forward``
    is the forward kernel keeping the log-sum-exp, ``backward`` the dk/dv
    and dq kernels.  Tensors are (B, H, T, D) float32 or bf16, contiguous,
    D one of ``HEAD_SIZES``; ``lens`` (B,) int32 on the device or None."""

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
        d_o = _aligned(d_o.to(q.dtype))
        # float32 products and sum, as the JAX package's (a bf16 sum
        # would round every partial sum)
        delta = (d_o.float() * o.float()).sum(dim=-1)
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
        whose ``backward`` is kernels too.  Without a gradient the call is
        the custom operator ``torch.ops.ptt.flash_attention``
        (``ops/kernels/_ops.py``), which ``torch.export`` records.
        ``flash_attention.launches``
        counts the launches (``fwd``, ``fwd_train``, ``bwd``, and for bf16
        tensors ``fwd_bf16``, ``fwd_train_bf16``, ``bwd_bf16``).

    >>> q = torch.ones((2, 4, 5, 16))
    >>> out = flash_attention(q, q[:, :2], q[:, :2], causal=True,
    ...                       key_padding_lens=[5, 0])
    >>> out.shape, float(out[0].min()), float(out[1].abs().max())
    (torch.Size([2, 4, 5, 16]), 1.0, 0.0)
    """
    records = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    if not records:
        left, right = _norm_window(window)
        lens = _lens_tensor(key_padding_lens, q.shape[0], q.device)
        return _ops.call(flash_attention_op, q, k, v, lens, bool(causal),
                         -1 if left is None else left,
                         -1 if right is None else right)
    if q.device.type == 'cpu':
        masks = dict(causal=causal, key_padding_lens=key_padding_lens,
                     window=window)
        if q.dtype == torch.bfloat16:
            return PlainFlashAttention.apply(q, k, v, masks)
        return flash_attention_plain(q, k, v, **masks)
    if q.device.type != 'cuda':
        raise ValueError(f'no kernel for device {q.device}')
    _check(q, k, v)
    b, h, tq, d = q.shape
    left, right = _norm_window(window)
    if tq == 0:
        return torch.zeros_like(q)
    lens = _lens_tensor(key_padding_lens, b, q.device)
    q, k, v, d_p = _padded(q, k, v)
    o = FlashAttention.apply(q, k, v, lens, causal, left, right,
                             1.0 / math.sqrt(d))
    return o[..., :d] if d_p != d else o


flash_attention.launches = {'fwd': 0, 'fwd_train': 0, 'bwd': 0,
                            'fwd_bf16': 0, 'fwd_train_bf16': 0,
                            'bwd_bf16': 0}


def _op_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lens: Optional[torch.Tensor], causal: bool, left: int,
              right: int) -> torch.Tensor:
    return flash_attention_plain(
        q, k, v, causal=causal, key_padding_lens=lens,
        window=_op_window(left, right))


def _op_window(left, right):
    """The operator's window ints (-1: unbounded) as ``window``."""
    if left < 0 and right < 0:
        return None
    return (None if left < 0 else left, None if right < 0 else right)


def _op_launch(q, k, v, lens, causal, left, right):
    _check(q, k, v)
    if lens is not None:
        lens = lens.to(torch.int32).contiguous()
    d = q.shape[-1]
    if q.shape[2] == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    q, k, v, d_p = _padded(q, k, v)
    o, _ = _launch_fwd(q, k, v, lens, causal, left, right,
                       1.0 / math.sqrt(d), train=False)
    return o[..., :d] if d_p != d else o


def _op_fake(q, k, v, lens, causal, left, right):
    b, h, tq, d = q.shape
    d_p = next((size for size in HEAD_SIZES if size >= d), d)
    if q.device.type == 'cuda' and d_p != d:
        # the launch's output is a view of the padded heads' output
        return q.new_empty((b, h, tq, d_p))[..., :d]
    return q.new_empty((b, h, tq, d))


# the forward as ``torch.ops.ptt.flash_attention(q, k, v, lens, causal,
# left, right)`` (-1: an unbounded side of the window) -> o
flash_attention_op = _ops.define('flash_attention', _op_plain, _op_launch,
                                 _op_fake)
