"""Transformer encoder with RoPE.

Counterpart of ``padertorch_tpu/contrib/mk/modules/transformer.py``
(reference ``padertorch/contrib/mk/modules/transformer.py``), the encoder
half: ``RoPE`` (rotary embeddings), ``MultiheadAttention`` (key padding,
causal and sliding-window masks, grouped-query attention, qk-norm, bias
token, distance bias), ``TransformerEncoderLayer``/``TransformerEncoder``,
``DynamicTanh`` and ``CondLayerNorm`` normalizations, and
``set_attention_backend``.

Attention runs on one of two backends.  The fused one
(``ops/kernels/attention.py``) is exact softmax attention that never
writes the (B, H, Tq, Tk) logits to device memory, in hand-written kernels
on a CUDA tensor; the dense one is plain tensor code and takes what the
kernels do not (an additive ``attn_bias``, active attention dropout, the
bias token).  The two differ only on fully masked query rows: the fused
backend returns 0 there, the dense one the mean of the values.

Not ported yet (ROADMAP.md Queue 1): the KV-cache methods of
``MultiheadAttention`` (``init_cache``, ``decode_step``, ...), ring
attention over a sequence mesh (``set_sequence_mesh``), ``MPLinear`` and
``magnitude_preserving``, ``ScaledDotProductAttention``,
``TransformerNormBlock``, the decoder classes, ``PositionalConvEmbedding``,
``PositionalEncoding`` and the three ``*_generate`` functions.
"""
import math
import warnings

import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, should_use_flash)
from padertorch_tpu_torch.ops.sequence.mask import compute_mask

__all__ = [
    'RoPE',
    'MultiheadAttention',
    'EncoderLayer',
    'TransformerEncoderLayer',
    'TransformerEncoder',
    'DynamicTanh',
    'CondLayerNorm',
    'set_attention_backend',
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
        f'{what} is not ported yet (ROADMAP.md Queue 1)')


# public names of the JAX module that wait
_WAITING = frozenset({
    'ScaledDotProductAttention', 'TransformerNormBlock',
    'TransformerDecoderLayer', 'TransformerDecoder',
    'PositionalConvEmbedding', 'PositionalEncoding', 'positional_embedding',
    'interleave', 'MPLinear', 'autoregressive_generate',
    'beam_search_generate', 'speculative_generate'})


def __getattr__(name):
    if name in _WAITING:
        raise _not_ported(f'{__name__}.{name}')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


class RoPE(nn.Module):
    """Rotary position embeddings (Su et al. 2021), split-half rotation.
    Reference: mk/transformer.py:231.

    >>> RoPE(4)(torch.ones((1, 1, 3, 4))).shape
    torch.Size([1, 1, 3, 4])
    """

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
        steps = torch.arange(t, device=x.device)
        offset = torch.as_tensor(offset, device=x.device)
        if offset.dim() == 1:  # per-row positions
            pos = offset[:, None] + steps[None, :]              # (B, T)
            angles = (pos[..., None] * self.inv_freq)[:, None]  # (B,1,T,D/2)
        else:
            angles = (offset + steps)[:, None] * self.inv_freq  # (T, D/2)
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
            # 'auto' dispatches on the measured crossover; True forces the
            # fused backend (its plain version on a CPU tensor)
            if use_flash is True or should_use_flash(
                    tq, tk, causal=causal, window=attn_window,
                    training=torch.is_grad_enabled() and any(
                        x.requires_grad for x in (q, k, v)),
                    device=q.device):
                return self._merge(flash_attention(
                    q, k, v, causal=causal,
                    key_padding_lens=key_padding_lens, window=attn_window))
        group = self.num_heads // self.num_kv_heads
        if group > 1:
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        logits = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) \
            * (1.0 / math.sqrt(self.d_head))
        if attn_bias is not None:
            logits = logits + attn_bias
        lowest = torch.finfo(logits.dtype).min
        cols = torch.arange(tk, device=q.device)
        if key_padding_lens is not None:
            lens = torch.as_tensor(key_padding_lens, device=q.device)
            pad = cols[None, :] >= lens[:, None]
            if bias_kv:  # the appended bias token is always attendable
                pad = pad & (cols[None, :] != tk - 1)
            logits = logits.masked_fill(pad[:, None, None, :], lowest)
        diff = cols[None, :] - torch.arange(tq, device=q.device)[:, None]
        if causal:
            logits = logits.masked_fill((diff > 0)[None, None], lowest)
        if attn_window is not None:
            left, right = attn_window
            outside = torch.zeros_like(diff, dtype=torch.bool)
            if left is not None:
                outside = outside | (diff < -left)
            if right is not None:
                outside = outside | (diff > right)
            logits = logits.masked_fill(outside[None, None], lowest)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        if self.dropout is not None:
            weights = self.dropout(weights)
        return self._merge(torch.matmul(weights, v))

    def init_cache(self, *args, **kwargs):
        raise _not_ported('the KV cache (init_cache, decode_step)')

    decode_step = init_cache


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


def set_attention_backend(module, use_flash=True):
    """Flip every attention block in a module tree to (``True``) or from
    (``False``) the fused attention backend, or back to the measured
    dispatch (``'auto'``).  Any submodule with a ``use_flash`` attribute
    takes part.  Returns ``module``."""
    for m in module.modules():
        if hasattr(m, 'use_flash'):
            m.use_flash = use_flash
    return module
