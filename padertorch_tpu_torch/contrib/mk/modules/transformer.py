"""Transformer encoder and decoder with RoPE, KV-cache decoding and
generation.

Counterpart of ``padertorch_tpu/contrib/mk/modules/transformer.py``
(reference ``padertorch/contrib/mk/modules/transformer.py``): ``RoPE``
(rotary embeddings), ``MultiheadAttention`` (key padding, causal and
sliding-window masks, grouped-query attention, qk-norm, bias token,
distance bias) with its KV-cache methods, ``TransformerEncoderLayer``/
``TransformerEncoder``, ``TransformerDecoderLayer``/``TransformerDecoder``,
``DynamicTanh`` and ``CondLayerNorm`` normalizations,
``set_attention_backend``, and the three generation loops
``autoregressive_generate`` (greedy or sampled), ``beam_search_generate``
and ``speculative_generate``.

Attention runs on one of two backends.  The fused one
(``ops/kernels/attention.py``) is exact softmax attention that never
writes the (B, H, Tq, Tk) logits to device memory, in hand-written kernels
on a CUDA tensor (float32, or bf16 with the reference kernel's float32
statistics); the dense one (:func:`dense_attention`) is plain tensor code
with float32 logits and softmax, and takes what the kernels do not (an
additive ``attn_bias``, active attention dropout, the bias token).  The two differ only on fully masked query
rows: the fused backend returns 0 there, the dense one the mean of the
values.  The decode methods always run the dense formula, as in the JAX
package: masked logits are filled with ``finfo.min``, never ``-inf``, so a
row that sees no key (an unused slot of ``serve.ContinuousBatcher``) gives
the mean of the values and no NaN.

KV caches are preallocated ``{'k', 'v'}`` tensors of (B, Hkv, T_max, Dh).
Where the JAX package returns an updated copy
(``lax.dynamic_update_slice``), ``decode_step`` writes the new keys and
values into the cache in place and returns the same tensors: a caller who
needs the old cache clones it first (``beam_search_generate`` reorders by
gathering into new tensors).  ``dynamic_update_slice`` also clamps a start
that would run past the cache; here such a write raises.  The generation
loops are Python loops over the preallocated caches that keep tokens,
``done`` flags and lengths on the device: ``autoregressive_generate`` reads
nothing back per step, ``speculative_generate`` one number per round (its
trip test).  Sampling draws from an explicit ``torch.Generator`` where the
JAX package takes a PRNG key.

Not ported yet (ROADMAP.md): ring attention over a sequence mesh
(``set_sequence_mesh``), ``MPLinear`` and ``magnitude_preserving``,
``ScaledDotProductAttention``, ``TransformerNormBlock``,
``PositionalConvEmbedding``, ``PositionalEncoding``,
``positional_embedding`` and ``interleave``: no caller of the port needs
them yet.
"""
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, should_use_flash)
from padertorch_tpu_torch.ops.kernels.lstm import matmul_f32
from padertorch_tpu_torch.ops.sequence.mask import compute_mask

__all__ = [
    'RoPE',
    'MultiheadAttention',
    'EncoderLayer',
    'TransformerEncoderLayer',
    'TransformerEncoder',
    'TransformerDecoderLayer',
    'TransformerDecoder',
    'DynamicTanh',
    'CondLayerNorm',
    'set_attention_backend',
    'autoregressive_generate',
    'beam_search_generate',
    'speculative_generate',
]

# the activations of ``jax.nn`` that ``_FFN`` takes by name; ``jax.nn.gelu``
# is the tanh approximation by default, torch's the exact erf form
_ACTIVATIONS = {
    'gelu': lambda x: F.gelu(x, approximate='tanh'),
    'relu': F.relu,
    'silu': F.silu,
    'swish': F.silu,
    'elu': F.elu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'softplus': F.softplus,
}


def _not_ported(what):
    return NotImplementedError(
        f'{what} is not ported yet: it waits in '
        'padertorch_tpu/contrib/mk/modules/transformer.py (ROADMAP.md)')


# public names of the JAX module that wait
_WAITING = frozenset({
    'ScaledDotProductAttention', 'TransformerNormBlock',
    'PositionalConvEmbedding', 'PositionalEncoding', 'positional_embedding',
    'interleave', 'MPLinear'})


def __getattr__(name):
    if name in _WAITING:
        raise _not_ported(f'{__name__}.{name}')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def dense_attention(q, k, v, *, causal=False, key_padding_lens=None,
                    window=None, attn_bias=None, keep_last_key=False,
                    dropout=None):
    """The dense attention of :class:`MultiheadAttention` (the reference's
    non-fused path) over q (B, H, Tq, D) and k, v (B, Hkv, Tk, D): the
    (B, H, Tq, Tk) logits as float32 sums (the reference's
    ``preferred_element_type=float32``: bf16 q, k are not rounded after
    the product), masked with ``finfo.min``, a float32 softmax cast to q's
    type, then ``weights @ v``.  ``keep_last_key``: the appended bias
    token of ``add_bias_kv`` stays attendable under padding; ``dropout``
    is applied to the weights."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    group = h // k.shape[1]
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    logits = matmul_f32(
        q.reshape(b * h, tq, d), k.reshape(b * h, tk, d).transpose(1, 2)
    ).reshape(b, h, tq, tk) * (1.0 / math.sqrt(d))
    if attn_bias is not None:
        logits = logits + attn_bias
    lowest = torch.finfo(logits.dtype).min
    cols = torch.arange(tk, device=q.device)
    if key_padding_lens is not None:
        lens = torch.as_tensor(key_padding_lens, device=q.device)
        pad = cols[None, :] >= lens[:, None]
        if keep_last_key:
            pad = pad & (cols[None, :] != tk - 1)
        logits = logits.masked_fill(pad[:, None, None, :], lowest)
    diff = cols[None, :] - torch.arange(tq, device=q.device)[:, None]
    if causal:
        logits = logits.masked_fill((diff > 0)[None, None], lowest)
    if window is not None:
        left, right = window
        outside = torch.zeros_like(diff, dtype=torch.bool)
        if left is not None:
            outside = outside | (diff < -left)
        if right is not None:
            outside = outside | (diff > right)
        logits = logits.masked_fill(outside[None, None], lowest)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout is not None:
        weights = dropout(weights)
    return torch.matmul(weights, v)


class RoPE(nn.Float32Buffers):
    """Rotary position embeddings (Su et al. 2021), split-half rotation.
    Reference: mk/transformer.py:231.  ``inv_freq`` stays float32 in a
    bf16 model, and the angles are computed in float32.

    >>> RoPE(4)(torch.ones((1, 1, 3, 4))).shape
    torch.Size([1, 1, 3, 4])
    """

    float32_buffers = ('inv_freq',)

    def __init__(self, d_head, base=10000.0):
        super().__init__()
        assert d_head % 2 == 0, d_head
        self.d_head = d_head
        self.base = base
        inv_freq = 1.0 / (base ** (
            torch.arange(0, d_head, 2, dtype=torch.float64) / d_head))
        self.register_buffer('inv_freq', inv_freq.to(torch.float32))

    def forward(self, x, offset=0):
        """x: (B, H, T, D) -> rotated; ``offset`` is a scalar or a per-row
        (B,) vector (each batch row at its own position)."""
        t = x.shape[-2]
        if isinstance(offset, int):  # no host-to-device copy
            pos = torch.arange(offset, offset + t, device=x.device)
            angles = pos[:, None] * self.inv_freq               # (T, D/2)
        else:
            steps = torch.arange(t, device=x.device)
            offset = torch.as_tensor(offset, device=x.device)
            if offset.dim() == 1:  # per-row positions
                pos = offset[:, None] + steps[None, :]          # (B, T)
                angles = (pos[..., None] * self.inv_freq)[:, None]
            else:
                angles = (offset + steps)[:, None] * self.inv_freq
        sin, cos = torch.sin(angles), torch.cos(angles)
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)


class DynamicTanh(nn.Module):
    """DyT normalization-free layer (Zhu 2025). Reference: mk/transformer.py:459."""

    def __init__(self, d_model, alpha0=0.5):
        super().__init__()
        self.alpha = torch.nn.Parameter(torch.full((1,), float(alpha0)))
        self.weight = torch.nn.Parameter(torch.ones((d_model,)))
        self.bias = torch.nn.Parameter(torch.zeros((d_model,)))

    def forward(self, x):
        return self.weight * torch.tanh(self.alpha * x) + self.bias


class MultiheadAttention(nn.Module):
    """MHA with optional RoPE, causal, window and key-padding masks.

    Reference parity: ``mk/modules/transformer.py:549``.

    >>> _ = torch.manual_seed(0)
    >>> mha = MultiheadAttention(16, 4, use_rope=True, use_flash=True)
    >>> mha(torch.ones((2, 5, 16)), key_padding_lens=[5, 3]).shape
    torch.Size([2, 5, 16])
    """

    def __init__(self, d_model, num_heads, dropout=0.0, use_rope=False,
                 d_kv=None, use_flash='auto', bias=True, d_v=None,
                 qk_norm=None, add_bias_kv=False,
                 linear_attention_bias=False,
                 magnitude_preserving=False, num_kv_heads=None):
        """Long-tail reference options (``mk/transformer.py:549-645``):
        ``bias`` (projection bias), ``d_kv``/``d_v`` (separate key / value
        input dims, the reference's kdim/vdim), ``qk_norm`` in
        {'rms', 'l2'} ('rms' = per-head RMSNorm on q and k before RoPE;
        'l2' = unit-normalize q and k after RoPE), ``add_bias_kv`` (a
        learned extra key/value token), ``linear_attention_bias``
        (symmetric distance penalty ``-|i - j| * slope_h``, slopes
        ``linspace(8/H, 8, H)``), ``num_kv_heads`` (grouped-query
        attention: groups of ``H // Hkv`` query heads share a KV head).

        ``use_flash``: ``True`` forces the fused backend, ``False`` the
        dense one, ``'auto'`` (the default) asks ``should_use_flash`` per
        call.  The fused backend is eligible without ``attn_bias``, bias
        token and active attention dropout."""
        super().__init__()
        assert d_model % num_heads == 0, (d_model, num_heads)
        if magnitude_preserving:
            raise _not_ported('magnitude_preserving (MPLinear)')
        self.d_model = d_model
        self.num_heads = num_heads
        self.d_head = d_model // num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        assert num_heads % self.num_kv_heads == 0, (num_heads, num_kv_heads)
        d_kv_out = self.num_kv_heads * self.d_head
        d_kv = d_kv or d_model
        d_v = d_v or d_kv
        self.q_proj = nn.Linear(d_model, d_model, bias=bias)
        self.k_proj = nn.Linear(d_kv, d_kv_out, bias=bias)
        self.v_proj = nn.Linear(d_v, d_kv_out, bias=bias)
        self.out_proj = nn.Linear(d_model, d_model, bias=bias)
        assert qk_norm in (None, 'rms', 'l2'), qk_norm
        self.qk_norm = qk_norm
        if qk_norm == 'rms':
            self.q_norm = nn.RMSNorm(self.d_head)
            self.k_norm = nn.RMSNorm(self.d_head)
        if add_bias_kv:
            # concatenated to the PRE-projection key/value inputs
            # (mk/transformer.py:666-682), sized for the input dims
            std_k, std_v = (math.sqrt(2.0 / (1 + d)) for d in (d_kv, d_v))
            self.bias_k = torch.nn.Parameter(
                std_k * torch.randn((1, 1, d_kv)))
            self.bias_v = torch.nn.Parameter(
                std_v * torch.randn((1, 1, d_v)))
        else:
            self.bias_k = self.bias_v = None
        self.linear_attention_bias = linear_attention_bias
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.rope = RoPE(self.d_head) if use_rope else None
        self.use_flash = use_flash

    def set_sequence_mesh(self, mesh, axis='seq'):
        raise _not_ported('ring attention over a sequence mesh')

    def _split(self, x, heads):
        b, t, _ = x.shape
        return x.reshape(b, t, heads, self.d_head).transpose(1, 2)

    def _merge(self, out):
        b, h, t, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, t, h * d))

    def forward(self, query, key=None, value=None, key_padding_lens=None,
                causal=False, attn_bias=None, attn_window=None):
        """query (B, Tq, D); key/value default to query (self-attention).

        ``attn_bias``: additive logits bias broadcastable to
        (B, H, Tq, Tk).  ``attn_window``: ``(left, right)`` sliding-window
        attention, query i attends keys in ``[i - left, i + right]``
        (either side ``None`` = unbounded); the fused backend skips
        out-of-band key tiles.  ``key_padding_lens``: (B,) valid key
        counts, a host sequence or a tensor (a tensor on the device costs
        no copy and nothing is read back).
        """
        if key is None:
            key = query
        if value is None:
            value = key
        bias_kv = self.bias_k is not None
        if bias_kv:
            assert not causal and attn_window is None, \
                'add_bias_kv composes with padding, not causal/window'
            n = key.shape[0]
            key = torch.cat(
                [key, self.bias_k.expand(n, 1, key.shape[-1])], dim=1)
            value = torch.cat(
                [value, self.bias_v.expand(n, 1, value.shape[-1])], dim=1)
        q = self._split(self.q_proj(query), self.num_heads)
        k = self._split(self.k_proj(key), self.num_kv_heads)
        v = self._split(self.v_proj(value), self.num_kv_heads)
        if self.qk_norm == 'rms':
            q = self.q_norm(q)
            k = self.k_norm(k)
        if self.rope is not None:
            q = self.rope(q)
            k = self.rope(k)
        if self.qk_norm == 'l2':
            q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(
                min=1e-12)
            k = k / torch.linalg.norm(k, dim=-1, keepdim=True).clamp(
                min=1e-12)
        tq, tk = q.shape[2], k.shape[2]
        if self.linear_attention_bias:
            if self.use_flash is True:
                warnings.warn(
                    'linear_attention_bias is an additive bias: the fused '
                    'attention backend is bypassed and the dense O(T^2) '
                    'path runs.', stacklevel=2)
            # symmetric ALiBi-style distance penalty (reference
            # mk/transformer.py:707-724): -|i - j| * slope_h
            dist = -(torch.arange(tk, device=q.device)[None, :]
                     - torch.arange(tq, device=q.device)[:, None]).abs().to(
                         torch.float32)
            slopes = torch.linspace(8.0 / self.num_heads, 8.0,
                                    self.num_heads, device=q.device)
            lin = (slopes[:, None, None] * dist[None])[None]
            attn_bias = lin if attn_bias is None else attn_bias + lin
        use_flash = self.use_flash
        if (use_flash and attn_bias is None and not bias_kv
                and (self.dropout is None or not self.training)):
            # 'auto' takes the kernels for float32 and bf16 on the card at
            # the head sizes they take; True forces the fused backend (its plain
            # version on a CPU tensor; a head wider than the kernels take
            # raises on the card)
            if use_flash is True or should_use_flash(
                    q.device, q.dtype, head_size=q.shape[-1]):
                return self._merge(flash_attention(
                    q, k, v, causal=causal,
                    key_padding_lens=key_padding_lens, window=attn_window))
        return self._merge(dense_attention(
            q, k, v, causal=causal, key_padding_lens=key_padding_lens,
            window=attn_window, attn_bias=attn_bias, keep_last_key=bias_kv,
            dropout=self.dropout))

    # ---- KV-cache incremental decoding (serving) ----------------------

    def _device(self):
        return self.q_proj.weight.device if hasattr(self.q_proj, 'weight') \
            else self.q_proj.weight_q.device

    def init_cache(self, batch_size, max_len, dtype=torch.float32,
                   device=None):
        """Preallocate the self-attention K/V cache; under grouped-query
        attention it holds only the ``num_kv_heads`` KV heads."""
        shape = (batch_size, self.num_kv_heads, max_len, self.d_head)
        device = self._device() if device is None else device
        return {'k': torch.zeros(shape, dtype=dtype, device=device),
                'v': torch.zeros(shape, dtype=dtype, device=device)}

    def precompute_kv(self, key, value=None):
        """Project encoder memory to K/V once per sequence, for every
        decode step (cross-attention's K/V never change).  The bias token
        of ``add_bias_kv`` is appended before the projection and stays
        attendable under padding in :meth:`attend_cached`."""
        if value is None:
            value = key
        if self.bias_k is not None:
            n = key.shape[0]
            key = torch.cat(
                [key, self.bias_k.expand(n, 1, key.shape[-1])], dim=1)
            value = torch.cat(
                [value, self.bias_v.expand(n, 1, value.shape[-1])], dim=1)
        return {'k': self._split(self.k_proj(key), self.num_kv_heads),
                'v': self._split(self.v_proj(value), self.num_kv_heads)}

    def _attend(self, q, k, v, mask, bias=None):
        """Dense attention of the decode path; ``mask`` True = hidden.  The
        logits are summed in float32 (as the JAX package's
        ``preferred_element_type=float32``) and hidden ones are filled with
        ``finfo.min``, so a row that sees no key gives the mean of the
        values."""
        group = self.num_heads // self.num_kv_heads
        if group > 1:
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * (1.0 / math.sqrt(self.d_head))
        if bias is not None:
            logits = logits + bias
        logits = logits.masked_fill(mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        dtype = torch.promote_types(q.dtype, v.dtype)
        return self._merge(torch.matmul(weights.to(dtype), v.to(dtype)))

    def _qk_normalize(self, q, k, rope_offset=0):
        """forward()'s q/k normalization order for the decode path:
        per-head RMSNorm before RoPE, L2 after."""
        if self.qk_norm == 'rms':
            q = self.q_norm(q)
            k = self.k_norm(k)
        if self.rope is not None:
            q = self.rope(q, offset=rope_offset)
            k = self.rope(k, offset=rope_offset)
        if self.qk_norm == 'l2':
            q = _l2_normalize(q)
            k = _l2_normalize(k)
        return q, k

    def attend_cached(self, query, kv, key_padding_lens=None):
        """Cross-attention against :meth:`precompute_kv` output."""
        q = self._split(self.q_proj(query), self.num_heads)
        k, v = kv['k'], kv['v']
        # the cache holds raw projections: normalize both, as forward()
        if self.qk_norm == 'rms':
            q = self.q_norm(q)
            k = self.k_norm(k)
        if self.qk_norm == 'l2':
            q = _l2_normalize(q)
            k = _l2_normalize(k)
        tk = k.shape[2]
        cols = torch.arange(tk, device=q.device)
        if key_padding_lens is not None:
            lens = torch.as_tensor(key_padding_lens, device=q.device)
            mask = cols[None, :] >= lens[:, None]
            if self.bias_k is not None:
                mask = mask & (cols[None, :] != tk - 1)
            mask = mask[:, None, None, :]
        else:
            mask = torch.zeros((1, 1, 1, tk), dtype=torch.bool,
                               device=q.device)
        return self._attend(q, k, v, mask)

    def _new_kv(self, query, index):
        if self.bias_k is not None:
            raise ValueError('add_bias_kv is not supported in cached '
                             'self-attention decode')
        q = self._split(self.q_proj(query), self.num_heads)
        k_new = self._split(self.k_proj(query), self.num_kv_heads)
        v_new = self._split(self.v_proj(query), self.num_kv_heads)
        q, k_new = self._qk_normalize(q, k_new, rope_offset=index)
        return q, k_new, v_new

    def _distance_bias(self, cols, rows):
        """``linear_attention_bias`` between key positions ``cols`` and
        query positions ``rows`` (broadcast to (., 1, Tq, Tk))."""
        dist = -(cols - rows).abs().to(torch.float32)
        slopes = torch.linspace(8.0 / self.num_heads, 8.0, self.num_heads,
                                device=cols.device)
        return slopes[None, :, None, None] * dist

    def decode_step(self, query, cache, index):
        """Causal self-attention for new tokens at ``[index, index + Tq)``.

        Mirrors :meth:`forward`'s options where they are defined for
        incremental decoding: RoPE (absolute offset), ``qk_norm`` and
        ``linear_attention_bias``; ``add_bias_kv`` (its extra token has no
        cache position) raises.

        Args:
            query: (B, Tq, D); Tq = 1 decodes one token, Tq > 1 prefills a
                chunk in one call (still causal).
            cache: from :meth:`init_cache`; written in place.
            index: first position of ``query``: an int, or per-row
                positions (B,) (each batch row at its own position), from
                the host (checked against the cache) or a device tensor
                (not read back: the caller keeps it in range).

        Returns:
            ``(out, cache)``: (B, Tq, D) and the same cache, updated.
        """
        index = _decode_index(index, query.shape[1], cache['k'].shape[2],
                              query.device)
        q, k_new, v_new = self._new_kv(query, index)
        k, v = cache['k'], cache['v']
        tq, t_max = q.shape[2], k.shape[2]
        cols = torch.arange(t_max, device=q.device)
        if isinstance(index, int):
            k[:, :, index:index + tq] = k_new.to(k.dtype)
            v[:, :, index:index + tq] = v_new.to(v.dtype)
            rows = torch.arange(index, index + tq, device=q.device)
            mask = (cols[None, :] > rows[:, None])[None, None]
            dist_rows = rows[None, None, :, None]
        else:
            rows = index[:, None] + torch.arange(tq, device=q.device)
            batch = torch.arange(q.shape[0], device=q.device)[:, None]
            # (B, Tq, Hkv, D) at [b, :, rows[b, j]]
            k[batch, :, rows] = k_new.transpose(1, 2).to(k.dtype)
            v[batch, :, rows] = v_new.transpose(1, 2).to(v.dtype)
            mask = (cols[None, None, :] > rows[:, :, None])[:, None]
            dist_rows = rows[:, None, :, None]
        bias = None
        if self.linear_attention_bias:
            bias = self._distance_bias(cols[None, None, None, :], dist_rows)
        return self._attend(q, k, v, mask, bias=bias), cache

    # ---- rolling (sliding-window) cache: O(W) memory generation -------

    def init_rolling_cache(self, batch_size, window, dtype=torch.float32,
                           device=None):
        """Cache for local causal attention: only the last ``window`` keys
        and values are kept (a ring buffer indexed ``t % window``), the
        serving side of ``attn_window=(window - 1, 0)``."""
        return self.init_cache(batch_size, window, dtype=dtype,
                               device=device)

    def decode_step_rolling(self, query, cache, index):
        """One-token local-attention decode against the ring buffer
        (written in place): equals :meth:`forward` with ``causal=True,
        attn_window=(W - 1, 0)`` at position ``index`` (an int).  Keys are
        rotated by their absolute position when written, so rotations stay
        right after the ring wraps around."""
        if query.shape[1] != 1:
            raise ValueError(f'rolling decode is one token at a time, got '
                             f'{tuple(query.shape)}')
        index = int(index)
        q, k_new, v_new = self._new_kv(query, index)
        k, v = cache['k'], cache['v']
        w = k.shape[2]
        slot = index % w
        k[:, :, slot:slot + 1] = k_new.to(k.dtype)
        v[:, :, slot:slot + 1] = v_new.to(v.dtype)
        # absolute position held by each slot after this write; slots not
        # yet written resolve to negative positions and are masked
        cols = torch.arange(w, device=q.device)
        pos = index - (index - cols) % w
        mask = (pos < 0)[None, None, None, :]
        bias = None
        if self.linear_attention_bias:
            bias = self._distance_bias(pos[None, None, None, :], index)
        return self._attend(q, k, v, mask, bias=bias), cache


def _l2_normalize(x):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def _decode_index(index, tq, t_max, device):
    """A decode position as an int, or per-row positions as a (B,) int64
    tensor on ``device``.  Host positions are checked: a write past the
    cache raises (``lax.dynamic_update_slice`` would clamp its start)."""
    if isinstance(index, torch.Tensor) and index.device.type != 'cpu':
        if index.dim() == 0:
            index = int(index)
        else:
            return index.to(torch.int64)
    elif not isinstance(index, int):
        index = torch.as_tensor(np.asarray(index), dtype=torch.int64)
        if index.dim() == 0:
            index = int(index)
    last = index if isinstance(index, int) else int(index.max())
    first = index if isinstance(index, int) else int(index.min())
    if first < 0 or last + tq > t_max:
        raise ValueError(
            f'decode positions [{first}, {last + tq}) do not fit the cache '
            f'of {t_max} (the JAX package would clamp the write)')
    return index if isinstance(index, int) else index.to(device)


class _FFN(nn.Module):
    def __init__(self, d_model, d_ff, dropout=0.0, activation='gelu',
                 pre_activation=False):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f'activation {activation!r}: one of {sorted(_ACTIVATIONS)}')
        self.lin1 = nn.Linear(d_model, d_ff)
        self.lin2 = nn.Linear(d_ff, d_model)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.activation = activation
        # reference `pre_activation` MLP (mk/transformer.py:859):
        # activation also applied to the block input
        self.pre_activation = pre_activation

    def forward(self, x):
        act = _ACTIVATIONS[self.activation]
        if self.pre_activation:
            x = act(x)
        h = act(self.lin1(x))
        if self.dropout is not None:
            h = self.dropout(h)
        return self.lin2(h)


def _make_norm(norm, d_model):
    if norm == 'dyt':
        return DynamicTanh(d_model)
    if norm == 'rms':
        return nn.RMSNorm(d_model)
    return nn.LayerNorm(d_model)


class CondLayerNorm(nn.Module):
    """Conditionally-modulated LayerNorm (AdaLN).

    Reference parity: ``mk/modules/transformer.py:363-459``: normalize
    WITHOUT learned affine, then modulate with scale/shift(/layer-scale)
    projected from a conditioning vector:
    ``y = norm(x) * gamma(c) [+ beta(c)]``, returning the optional
    layer-scale ``alpha(c)`` for the residual branch (``softplus(alpha)``
    gating in the encoder layer).  ``zero_init`` zeroes the layer-scale
    head, so the gate starts at the constant ``softplus(0) = ln 2``.
    """

    def __init__(self, d_model, cond_dim, bias=True, layer_scale=False,
                 zero_init=False, eps=1e-5):
        super().__init__()
        self.d_model = d_model
        self.eps = eps
        self.shift = bias
        self.layer_scale = layer_scale
        n = 1 + bias + layer_scale
        self.cond_layer = nn.Linear(cond_dim, n * d_model)
        if layer_scale and zero_init:
            with torch.no_grad():
                self.cond_layer.weight[-d_model:].zero_()
                self.cond_layer.bias[-d_model:].zero_()

    def forward(self, x, cond=None):
        y = F.layer_norm(x, (x.shape[-1],), eps=self.eps)
        if cond is None:
            return y, None
        params = self.cond_layer(cond)
        while params.dim() < y.dim():       # (B, nD) -> (B, 1, nD)
            params = params[:, None]
        parts = params.chunk(1 + self.shift + self.layer_scale, dim=-1)
        gamma = parts[0]
        beta = parts[1] if self.shift else None
        alpha = parts[-1] if self.layer_scale else None
        y = y * gamma
        if beta is not None:
            y = y + beta
        return y, alpha


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, d_ff=None, dropout=0.0,
                 use_rope=True, norm='layer_norm', pre_norm=True,
                 cond_dim=None, normalize_skip_connections=False,
                 pre_activation=False, zero_init=False,
                 num_kv_heads=None):
        """``cond_dim``: enable AdaLN conditioning: ``forward`` takes a
        per-example ``cond`` vector, norms become :class:`CondLayerNorm`
        and the residual branches are gated by ``softplus`` of the
        conditioned layer scale (reference ``mk/transformer.py:787-899``).
        ``normalize_skip_connections``: rescale ``x + f(x)`` back to
        ``|x|`` (reference ``:965-983``)."""
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.self_attn = MultiheadAttention(
            d_model, num_heads, dropout=dropout, use_rope=use_rope,
            num_kv_heads=num_kv_heads)
        self.ffn = _FFN(d_model, d_ff, dropout=dropout,
                        pre_activation=pre_activation)
        if cond_dim is not None:
            # the layer-scale head is only consumed by the PRE-norm
            # residual gating; post-norm would train dead parameters
            self.norm1 = CondLayerNorm(
                d_model, cond_dim, layer_scale=pre_norm,
                zero_init=zero_init)
            self.norm2 = CondLayerNorm(
                d_model, cond_dim, layer_scale=pre_norm,
                zero_init=zero_init)
        else:
            self.norm1 = _make_norm(norm, d_model)
            self.norm2 = _make_norm(norm, d_model)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.pre_norm = pre_norm
        self.normalize_skip_connections = normalize_skip_connections

    def _norm(self, norm, x, cond):
        if isinstance(norm, CondLayerNorm):
            return norm(x, cond)
        return norm(x), None

    def _residual(self, inputs, outputs, alpha=None):
        if alpha is not None:
            outputs = outputs * F.softplus(alpha)
        if not self.normalize_skip_connections:
            return inputs + outputs
        # norm-preserving skip: |result| == |inputs|
        ni = torch.linalg.norm(inputs, dim=-1, keepdim=True)
        no = torch.linalg.norm(outputs, dim=-1, keepdim=True)
        cross = torch.sum(inputs * outputs, dim=-1, keepdim=True)
        scale = ni / torch.sqrt(
            (ni ** 2 + no ** 2 + 2 * cross).clamp(min=1e-12))
        return scale * (inputs + outputs)

    def forward(self, x, seq_len=None, cond=None):
        def drop(h):
            return self.dropout(h) if self.dropout is not None else h

        if self.pre_norm:
            h, alpha = self._norm(self.norm1, x, cond)
            x = self._residual(
                x, drop(self.self_attn(h, key_padding_lens=seq_len)), alpha)
            h, alpha = self._norm(self.norm2, x, cond)
            x = self._residual(x, drop(self.ffn(h)), alpha)
        else:
            x = self._norm(
                self.norm1,
                self._residual(x, drop(self.self_attn(
                    x, key_padding_lens=seq_len))), cond)[0]
            x = self._norm(
                self.norm2, self._residual(x, drop(self.ffn(x))), cond)[0]
        return x


# Reference name (mk/transformer.py:787)
EncoderLayer = TransformerEncoderLayer


class TransformerEncoder(nn.Module):
    """Reference parity: ``mk/modules/transformer.py:1127``.

    >>> _ = torch.manual_seed(0)
    >>> enc = TransformerEncoder(d_model=32, num_layers=2, num_heads=4,
    ...                          input_size=16).eval()
    >>> enc(torch.ones((2, 10, 16)), seq_len=[10, 7]).shape
    torch.Size([2, 10, 32])
    """

    def __init__(self, d_model, num_layers, num_heads, d_ff=None,
                 dropout=0.0, use_rope=True, norm='layer_norm',
                 pre_norm=True, input_size=None, cond_dim=None,
                 normalize_skip_connections=False,
                 pre_activation=False, zero_init=False,
                 num_kv_heads=None):
        super().__init__()
        self.input_proj = (nn.Linear(input_size, d_model)
                           if input_size and input_size != d_model
                           else None)
        self.layers = torch.nn.ModuleList([
            TransformerEncoderLayer(
                d_model, num_heads, d_ff=d_ff, dropout=dropout,
                use_rope=use_rope, norm=norm, pre_norm=pre_norm,
                cond_dim=cond_dim,
                normalize_skip_connections=normalize_skip_connections,
                pre_activation=pre_activation, zero_init=zero_init,
                num_kv_heads=num_kv_heads)
            for _ in range(num_layers)
        ])
        self.final_norm = _make_norm(norm, d_model) if pre_norm else None
        self.d_model = self.hidden_size = d_model

    def forward(self, x, seq_len=None, cond=None):
        if self.input_proj is not None:
            x = self.input_proj(x)
        for layer in self.layers:
            x = layer(x, seq_len=seq_len, cond=cond)
        if self.final_norm is not None:
            x = self.final_norm(x)
        if seq_len is not None:
            x = x * compute_mask(x, seq_len, 0, 1)
        return x


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, d_ff=None, dropout=0.0,
                 use_rope=True, norm='layer_norm', pre_norm=True,
                 d_memory=None, num_kv_heads=None, self_attn_window=None):
        """``self_attn_window``: local causal self-attention over the
        previous ``self_attn_window`` tokens; decoding then runs on a
        rolling cache of O(W) instead of O(T_max)."""
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.self_attn_window = self_attn_window
        self.self_attn = MultiheadAttention(
            d_model, num_heads, dropout=dropout, use_rope=use_rope,
            num_kv_heads=num_kv_heads)
        self.cross_attn = MultiheadAttention(
            d_model, num_heads, dropout=dropout, d_kv=d_memory,
            num_kv_heads=num_kv_heads)
        self.ffn = _FFN(d_model, d_ff, dropout=dropout)
        self.norm1 = _make_norm(norm, d_model)
        self.norm2 = _make_norm(norm, d_model)
        self.norm3 = _make_norm(norm, d_model)
        self.pre_norm = pre_norm
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, memory, seq_len=None, memory_seq_len=None):
        def drop(h):
            return self.dropout(h) if self.dropout is not None else h

        win = (None if self.self_attn_window is None
               else (self.self_attn_window, 0))
        if self.pre_norm:
            x = x + drop(self.self_attn(
                self.norm1(x), causal=True, attn_window=win))
            x = x + drop(self.cross_attn(
                self.norm2(x), memory, key_padding_lens=memory_seq_len))
            x = x + drop(self.ffn(self.norm3(x)))
        else:
            x = self.norm1(x + drop(self.self_attn(
                x, causal=True, attn_window=win)))
            x = self.norm2(x + drop(self.cross_attn(
                x, memory, key_padding_lens=memory_seq_len)))
            x = self.norm3(x + drop(self.ffn(x)))
        return x

    def decode_step(self, x, self_cache, cross_kv, index,
                    memory_seq_len=None):
        """One incremental step: :meth:`forward` with the self-attention KV
        cache and precomputed cross K/V."""
        step = (self.self_attn.decode_step_rolling
                if self.self_attn_window is not None
                else self.self_attn.decode_step)
        if self.pre_norm:
            h, self_cache = step(self.norm1(x), self_cache, index)
            x = x + h
            x = x + self.cross_attn.attend_cached(
                self.norm2(x), cross_kv, key_padding_lens=memory_seq_len)
            x = x + self.ffn(self.norm3(x))
        else:
            h, self_cache = step(x, self_cache, index)
            x = self.norm1(x + h)
            x = self.norm2(x + self.cross_attn.attend_cached(
                x, cross_kv, key_padding_lens=memory_seq_len))
            x = self.norm3(x + self.ffn(x))
        return x, self_cache


class TransformerDecoder(nn.Module):
    """Reference parity: ``mk/modules/transformer.py:1253``.

    >>> _ = torch.manual_seed(0)
    >>> dec = TransformerDecoder(d_model=16, num_layers=2, num_heads=4).eval()
    >>> x, memory = torch.randn(2, 5, 16), torch.randn(2, 3, 16)
    >>> cache = dec.init_cache(memory, max_len=5)
    >>> steps = [dec.decode_step(x[:, t:t + 1], cache, t)[0] for t in range(5)]
    >>> bool(torch.allclose(torch.cat(steps, 1), dec(x, memory), atol=1e-5))
    True
    """

    def __init__(self, d_model, num_layers, num_heads, d_ff=None,
                 dropout=0.0, use_rope=True, norm='layer_norm',
                 pre_norm=True, d_memory=None, num_kv_heads=None,
                 self_attn_window=None):
        super().__init__()
        self.self_attn_window = self_attn_window
        self.layers = torch.nn.ModuleList([
            TransformerDecoderLayer(
                d_model, num_heads, d_ff=d_ff, dropout=dropout,
                use_rope=use_rope, norm=norm, pre_norm=pre_norm,
                d_memory=d_memory, num_kv_heads=num_kv_heads,
                self_attn_window=self_attn_window)
            for _ in range(num_layers)
        ])
        self.final_norm = _make_norm(norm, d_model) if pre_norm else None
        self.d_model = d_model

    def forward(self, x, memory, seq_len=None, memory_seq_len=None):
        for layer in self.layers:
            x = layer(x, memory, seq_len=seq_len,
                      memory_seq_len=memory_seq_len)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x

    def init_cache(self, memory, max_len, dtype=torch.float32):
        """The decode cache on ``memory``'s device: per layer a
        preallocated self-attention K/V (a ring of ``min(window + 1,
        max_len)`` slots with ``self_attn_window``) and the cross-attention
        K/V projected from ``memory`` once."""
        batch_size = memory.shape[0]
        if self.self_attn_window is not None:
            slots = min(self.self_attn_window + 1, max_len)
            self_caches = [
                layer.self_attn.init_rolling_cache(
                    batch_size, slots, dtype, device=memory.device)
                for layer in self.layers]
        else:
            self_caches = [
                layer.self_attn.init_cache(
                    batch_size, max_len, dtype, device=memory.device)
                for layer in self.layers]
        return {'self': self_caches,
                'cross': [layer.cross_attn.precompute_kv(memory)
                          for layer in self.layers]}

    def decode_step(self, x, cache, index, memory_seq_len=None):
        """Decode tokens at ``[index, index + Tq)``: (B, Tq, d_model) in,
        (B, Tq, d_model) out, and the cache (written in place).  ``index``
        is an int or per-row positions (B,); host positions are checked and
        moved to the device once for all layers.  Chunked decoding of a
        sequence equals one :meth:`forward` over it."""
        if self.self_attn_window is None:
            index = _decode_index(index, x.shape[1],
                                  cache['self'][0]['k'].shape[2], x.device)
        if memory_seq_len is not None:
            memory_seq_len = torch.as_tensor(memory_seq_len,
                                             device=x.device)
        for layer, self_cache, cross_kv in zip(
                self.layers, cache['self'], cache['cross']):
            x, _ = layer.decode_step(x, self_cache, cross_kv, index,
                                     memory_seq_len=memory_seq_len)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x, cache


def set_attention_backend(module, use_flash=True):
    """Flip every attention block in a module tree to (``True``) or from
    (``False``) the fused attention backend, or back to the measured
    dispatch (``'auto'``).  Any submodule with a ``use_flash`` attribute
    takes part.  Returns ``module``."""
    for m in module.modules():
        if hasattr(m, 'use_flash'):
            m.use_flash = use_flash
    return module


def _lens_on(lens, device):
    return None if lens is None else torch.as_tensor(lens, device=device)


def _categorical(logits, generator):
    """One draw per row from ``softmax(logits)`` by the Gumbel-max trick
    (as ``jax.random.categorical``), with uniforms from ``generator``."""
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _top_k(x, k):
    """``jax.lax.top_k`` along the last axis: the k largest, best first,
    ties to the lower index (``torch.topk`` promises no order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def autoregressive_generate(
        decoder, memory, *, embed, logits_head, bos_id, max_len,
        memory_seq_len=None, eos_id=None, temperature=0.0, top_k=None,
        generator=None):
    """Token generation with the KV-cache decoder.

    One Python loop over the preallocated caches: embed,
    :meth:`TransformerDecoder.decode_step`, head, pick, early-stop
    bookkeeping, with tokens, ``done`` and lengths on the device (nothing is
    read back per step).

    Args:
        decoder: a :class:`TransformerDecoder` (or anything with
            ``init_cache``/``decode_step``).
        memory: (B, S, d_memory) encoder output; the caches take its type.
        embed: callable (B,) token ids -> (B, d_model).
        logits_head: callable (B, d_model) -> (B, vocab) logits.
        bos_id: start token fed at step 0.
        max_len: number of tokens to generate.
        eos_id: optional stop token; finished rows keep emitting it and
            their length is recorded.
        temperature: 0 -> greedy argmax (ties to the lower index); > 0 ->
            drawn from ``softmax(logits / temperature)``.
        top_k: optional k; restrict the draw to the k best logits.
        generator: ``torch.Generator`` of the draws (the JAX package's
            ``key``); required when ``temperature > 0``.

    Returns:
        ``(tokens, lengths)``: (B, max_len) and (B,) int32 (the generated
        length with the eos; ``max_len`` if never stopped).
    """
    sample = bool(temperature) and temperature > 0
    if sample and generator is None:
        raise ValueError('temperature > 0 needs a torch.Generator')
    batch, device = memory.shape[0], memory.device
    lens = _lens_on(memory_seq_len, device)
    cache = decoder.init_cache(memory, max_len, dtype=memory.dtype)
    token = torch.full((batch,), bos_id, dtype=torch.int64, device=device)
    tokens = torch.empty((batch, max_len), dtype=torch.int64, device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    lengths = torch.full((batch,), max_len, dtype=torch.int32, device=device)
    for t in range(max_len):
        out, cache = decoder.decode_step(
            embed(token)[:, None, :], cache, t, memory_seq_len=lens)
        logits = logits_head(out[:, 0])
        if top_k is not None:
            kth = _top_k(logits, top_k)[0][..., -1:]
            logits = logits.masked_fill(logits < kth,
                                        torch.finfo(logits.dtype).min)
        token = (_categorical(logits / temperature, generator) if sample
                 else torch.argmax(logits, dim=-1))
        if eos_id is not None:
            token = torch.where(done, eos_id, token)
            just_done = ~done & (token == eos_id)
            lengths = torch.where(just_done, t + 1, lengths)
            done = done | just_done
        tokens[:, t] = token
    return tokens.to(torch.int32), lengths


@torch.no_grad()
def beam_search_generate(
        decoder, memory, *, embed, logits_head, bos_id, max_len,
        beam_size, eos_id=None, memory_seq_len=None, length_penalty=0.0):
    """Beam search over the KV-cache decoder.

    Each step scores ``beam_size * vocab`` continuations per batch row,
    keeps the ``beam_size`` best (ties to the lower index, as
    ``jax.lax.top_k``) and reorders the self-attention caches by parent
    beam, gathering into new tensors (the cross-attention K/V are the same
    for a row's beams).  A finished beam (it emitted ``eos_id``) continues
    with one free ``eos``, which freezes its score.

    Args:
        decoder: :class:`TransformerDecoder` (or the same protocol).
        memory: (B, S, d_memory) encoder output.
        embed: (N,) ids -> (N, d_model); logits_head: (N, d_model) ->
            (N, vocab).
        bos_id, max_len, eos_id: as in :func:`autoregressive_generate`.
        beam_size: beams kept per batch row.
        memory_seq_len: optional (B,) valid memory lengths.
        length_penalty: alpha >= 0; the final ranking uses
            ``score / length ** alpha`` (0 = pure log-probability).

    Returns:
        ``(tokens, scores, lengths)``: (B, K, max_len) int32, (B, K)
        float32 cumulative log-probabilities and (B, K) int32 lengths,
        best first by the length-normalized score.
    """
    batch, k, device = memory.shape[0], beam_size, memory.device
    mem = memory.repeat_interleave(k, dim=0)                # (B*K, S, D)
    mlens = (None if memory_seq_len is None else
             _lens_on(memory_seq_len, device).repeat_interleave(k))
    cache = decoder.init_cache(mem, max_len, dtype=mem.dtype)
    tok = torch.full((batch * k,), bos_id, dtype=torch.int64, device=device)
    # only beam 0 is live at t=0 (all beams start identical)
    scores = torch.full((batch, k), -math.inf, device=device)
    scores[:, 0] = 0.0
    done = torch.zeros((batch, k), dtype=torch.bool, device=device)
    lengths = torch.full((batch, k), max_len, dtype=torch.int32,
                         device=device)
    hist = torch.zeros((batch, k, max_len), dtype=torch.int64, device=device)
    offsets = torch.arange(batch, device=device)[:, None] * k
    eos_row = None
    for t in range(max_len):
        out, cache = decoder.decode_step(
            embed(tok)[:, None, :], cache, t, memory_seq_len=mlens)
        logp = torch.log_softmax(logits_head(out[:, 0]).float(), dim=-1)
        vocab = logp.shape[-1]
        logp = logp.reshape(batch, k, vocab)
        if eos_id is not None:
            if eos_row is None:
                eos_row = torch.full((vocab,), -math.inf, device=device)
                eos_row[eos_id] = 0.0
            logp = torch.where(done[..., None], eos_row, logp)
        cand = (scores[..., None] + logp).reshape(batch, k * vocab)
        scores, idx = _top_k(cand, k)                       # (B, K)
        parent = idx // vocab
        token = idx % vocab
        done = done.gather(1, parent)
        lengths = lengths.gather(1, parent)
        hist = hist.gather(1, parent[..., None].expand(-1, -1, max_len))
        hist[:, :, t] = token
        if eos_id is not None:
            just_done = ~done & (token == eos_id)
            lengths = torch.where(just_done, t + 1, lengths)
            done = done | just_done
        flat = (offsets + parent).reshape(-1)
        cache = {'self': [{name: a.index_select(0, flat)
                           for name, a in layer_cache.items()}
                          for layer_cache in cache['self']],
                 'cross': cache['cross']}
        tok = token.reshape(batch * k)
    norm = scores
    if length_penalty:
        norm = scores / lengths.float().clamp(min=1.0) ** length_penalty
    order = torch.argsort(-norm, dim=1, stable=True)
    return (hist.gather(1, order[..., None].expand(-1, -1, max_len)).to(
                torch.int32),
            scores.gather(1, order), lengths.gather(1, order))


@torch.no_grad()
def speculative_generate(
        decoder, draft_decoder, memory, *, embed, logits_head,
        draft_embed, draft_logits_head, bos_id, max_len,
        num_draft=4, memory_seq_len=None, draft_memory=None):
    """Greedy speculative decoding: exactly the target decoder's greedy
    output, produced faster where a cheap draft agrees with it.

    Each round the draft proposes ``num_draft`` tokens one by one; the
    target scores all of them in one ``Tq = num_draft + 1`` decode step, and
    the longest agreeing prefix plus one correction token is accepted,
    truncated to the batch minimum so that the position stays one number
    (still exact: an accepted draft token is the target's greedy choice).
    The accepted count is read back once per round, for the loop's trip
    test.  Rejected speculative cache writes are never visible: a slot past
    the accepted position is causally masked until the loop passes it, and
    by then it has been overwritten.

    Args:
        decoder / draft_decoder: target and draft
            :class:`TransformerDecoder` (not with ``self_attn_window``:
            verification needs multi-token steps).
        embed / logits_head, draft_embed / draft_logits_head: the two
            models' token embeddings and output heads.
        draft_memory: the draft's encoder memory if it differs from the
            target's (defaults to ``memory``).
        num_draft: draft tokens proposed per verification step.

    Returns:
        (B, max_len) int32 tokens, equal to ``autoregressive_generate(
        decoder, ..., temperature=0, eos_id=None)``.
    """
    k = num_draft
    batch, device = memory.shape[0], memory.device
    if draft_memory is None:
        draft_memory = memory
    lens = _lens_on(memory_seq_len, device)
    budget = max_len + k + 1
    t_cache = decoder.init_cache(memory, budget, dtype=memory.dtype)
    d_cache = draft_decoder.init_cache(draft_memory, budget,
                                       dtype=draft_memory.dtype)
    tokens = torch.zeros((batch, budget), dtype=torch.int64, device=device)
    last = torch.full((batch,), bos_id, dtype=torch.int64, device=device)
    t = 0
    while t < max_len:
        # 1. the draft proposes k tokens one by one
        tok, drafts = last, []
        for i in range(k):
            out, d_cache = draft_decoder.decode_step(
                draft_embed(tok)[:, None], d_cache, t + i,
                memory_seq_len=lens)
            tok = torch.argmax(draft_logits_head(out[:, 0]), dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)               # (B, k)
        # 2. the target verifies all k + 1 positions in one step
        inputs = torch.cat([last[:, None], drafts], dim=1)
        x = embed(inputs.reshape(-1)).reshape(batch, k + 1, -1)
        out, t_cache = decoder.decode_step(x, t_cache, t,
                                           memory_seq_len=lens)
        greedy = torch.argmax(
            logits_head(out.reshape(batch * (k + 1), -1)),
            dim=-1).reshape(batch, k + 1)
        # 3. batch-minimum acceptance: the longest agreeing prefix
        agree = torch.cumprod((drafts == greedy[:, :k]).to(torch.int32),
                              dim=1)
        accept = int(agree.sum(dim=1).min())
        tokens[:, t:t + k + 1] = greedy
        last = greedy[:, accept]
        t += accept + 1
    return tokens[:, :max_len].to(torch.int32)
