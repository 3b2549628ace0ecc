"""KV-cache decoding in the port, on the CPU (mirrors
``tests/test_contrib/test_mk_decode_cache.py``).

Cached decoding must equal one-shot causal attention position by position:
stepwise, chunk-prefilled, with per-row positions and on a rolling cache.
Each module is built in both packages with the JAX weights
(``from_jax_state_dict``); the port's decode is held against its own
forward (1e-5 as in the JAX tests, 1e-4 through a whole decoder) and
against the JAX package's forward and decode on the same inputs (1e-4).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.mk.modules import transformer as jax_tf
from padertorch_tpu_torch.contrib.mk.modules import transformer as tf
from padertorch_tpu_torch.migrate import from_jax_state_dict

torch.set_num_threads(2)

ATOL = 1e-4


def _pair(name, *args, seed=0, **kwargs):
    ptrandom.seed(seed)
    jax_module = getattr(jax_tf, name)(*args, **kwargs).eval()
    port = getattr(tf, name)(*args, **kwargs).eval()
    from_jax_state_dict(port, jax_module.state_dict())
    return jax_module, port


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype('float32')


def _steps(module, x, cache, **kwargs):
    """Decode ``x`` one position at a time; (B, T, D) numpy."""
    outs = []
    with torch.no_grad():
        for t in range(x.shape[1]):
            out, cache = module.decode_step(
                torch.from_numpy(x[:, t:t + 1]), cache, t, **kwargs)
            outs.append(out)
    return torch.cat(outs, 1).numpy()


def _forward(module, *inputs, **kwargs):
    with torch.no_grad():
        return module(*[torch.from_numpy(a) for a in inputs], **kwargs).numpy()


def _jax(module, *inputs, **kwargs):
    return np.asarray(module(*[jnp.asarray(a) for a in inputs], **kwargs))


@pytest.mark.parametrize('use_rope', [False, True])
def test_mha_decode_step_equals_causal_forward(use_rope):
    jax_mha, mha = _pair('MultiheadAttention', 16, 4, use_rope=use_rope)
    x = _x((2, 12, 16), seed=1)
    want = _forward(mha, x, causal=True)
    got = _steps(mha, x, mha.init_cache(batch_size=2, max_len=12))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax(jax_mha, x, causal=True),
                               atol=ATOL, rtol=0)


def test_mha_decode_prefill_chunks():
    jax_mha, mha = _pair('MultiheadAttention', 16, 4, use_rope=True, seed=1)
    x = _x((2, 10, 16), seed=2)
    want = _forward(mha, x, causal=True)
    cache = mha.init_cache(batch_size=2, max_len=10)
    outs = []
    with torch.no_grad():
        for lo, hi in ((0, 4), (4, 8), (8, 9), (9, 10)):
            out, cache = mha.decode_step(torch.from_numpy(x[:, lo:hi]),
                                         cache, lo)
            outs.append(out)
    got = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the JAX package's own chunked decode on the same weights
    j_cache = jax_mha.init_cache(batch_size=2, max_len=10)
    j_out, j_cache = jax_mha.decode_step(jnp.asarray(x[:, 0:4]), j_cache, 0)
    np.testing.assert_allclose(got[:, 0:4], np.asarray(j_out), atol=ATOL,
                               rtol=0)


def test_mha_cache_larger_than_sequence():
    _, mha = _pair('MultiheadAttention', 16, 4, seed=2)
    x = _x((1, 6, 16), seed=3)
    got = _steps(mha, x, mha.init_cache(batch_size=1, max_len=32))
    np.testing.assert_allclose(got, _forward(mha, x, causal=True),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('pre_norm', [True, False])
def test_decoder_decode_equals_forward(pre_norm):
    jax_dec, dec = _pair('TransformerDecoder', d_model=16, num_layers=2,
                         num_heads=4, pre_norm=pre_norm, d_memory=8, seed=3)
    x = _x((2, 9, 16), seed=4)
    memory = _x((2, 7, 8), seed=5)
    lens = [5, 7]
    want = _forward(dec, x, memory, memory_seq_len=lens)
    cache = dec.init_cache(torch.from_numpy(memory), max_len=9)
    got = _steps(dec, x, cache, memory_seq_len=lens)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, _jax(jax_dec, x, memory, memory_seq_len=lens), atol=ATOL,
        rtol=0)


def test_gqa_cache_is_smaller_and_decode_matches_forward():
    jax_mha, mha = _pair('MultiheadAttention', 16, 4, num_kv_heads=2,
                         use_rope=True, seed=30)
    cache = mha.init_cache(batch_size=2, max_len=12)
    assert tuple(cache['k'].shape) == (2, 2, 12, 4)  # Hkv=2, not H=4
    x = _x((2, 12, 16), seed=31)
    got = _steps(mha, x, cache)
    np.testing.assert_allclose(got, _forward(mha, x, causal=True),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax(jax_mha, x, causal=True),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize('opts', [
    dict(qk_norm='rms', use_rope=True),
    dict(qk_norm='l2'),
    dict(linear_attention_bias=True),
])
def test_decode_respects_attention_options(opts):
    jax_mha, mha = _pair('MultiheadAttention', 16, 4, seed=40, **opts)
    x = _x((2, 10, 16), seed=41)
    got = _steps(mha, x, mha.init_cache(batch_size=2, max_len=10))
    np.testing.assert_allclose(got, _forward(mha, x, causal=True),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _jax(jax_mha, x, causal=True),
                               atol=ATOL, rtol=0)


def test_cross_attend_cached_respects_options():
    jax_mha, mha = _pair('MultiheadAttention', 16, 4, d_kv=8,
                         add_bias_kv=True, qk_norm='l2', seed=41)
    q, mem = _x((2, 5, 16), seed=42), _x((2, 7, 8), seed=43)
    want = _forward(mha, q, mem, key_padding_lens=[4, 7])
    with torch.no_grad():
        kv = mha.precompute_kv(torch.from_numpy(mem))
        got = mha.attend_cached(torch.from_numpy(q), kv,
                                key_padding_lens=[4, 7]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    j_kv = jax_mha.precompute_kv(jnp.asarray(mem))
    np.testing.assert_allclose(
        got, np.asarray(jax_mha.attend_cached(jnp.asarray(q), j_kv,
                                              key_padding_lens=[4, 7])),
        atol=ATOL, rtol=0)


def test_decode_rejects_bias_kv():
    _, mha = _pair('MultiheadAttention', 16, 4, add_bias_kv=True, seed=42)
    cache = mha.init_cache(batch_size=1, max_len=4)
    with pytest.raises(ValueError, match='add_bias_kv'):
        mha.decode_step(torch.from_numpy(_x((1, 1, 16), seed=44)), cache, 0)


@pytest.mark.parametrize('opts', [
    dict(use_rope=True),
    dict(qk_norm='rms', use_rope=True),
    dict(linear_attention_bias=True),
    dict(num_kv_heads=2),
])
def test_rolling_cache_equals_windowed_forward(opts):
    """The O(W) ring buffer equals full causal attention within a window
    of W - 1 keys to the left, past the point where the ring wraps."""
    jax_mha, mha = _pair('MultiheadAttention', 16, 4, seed=50, **opts)
    x = _x((2, 17, 16), seed=51)
    w = 5
    cache = mha.init_rolling_cache(batch_size=2, window=w)
    assert cache['k'].shape[2] == w
    outs = []
    with torch.no_grad():
        for t in range(17):
            out, cache = mha.decode_step_rolling(
                torch.from_numpy(x[:, t:t + 1]), cache, t)
            outs.append(out)
    got = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(
        got, _forward(mha, x, causal=True, attn_window=(w - 1, 0)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, _jax(jax_mha, x, causal=True, attn_window=(w - 1, 0)),
        atol=ATOL, rtol=0)


def test_decoder_local_attention_rolling_decode():
    jax_dec, dec = _pair('TransformerDecoder', d_model=16, num_layers=2,
                         num_heads=4, use_rope=True, self_attn_window=4,
                         seed=51)
    x, memory = _x((2, 15, 16), seed=52), _x((2, 5, 16), seed=53)
    cache = dec.init_cache(torch.from_numpy(memory), max_len=15)
    assert cache['self'][0]['k'].shape[2] == 5     # O(W), not 15
    got = _steps(dec, x, cache)
    np.testing.assert_allclose(got, _forward(dec, x, memory), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got, _jax(jax_dec, x, memory), atol=ATOL,
                               rtol=0)


def test_per_row_positions_equal_the_scalar_index():
    """``decode_step`` with a (B,) position vector at equal positions equals
    the call with one index; at unequal positions each row equals its own
    decode (rows of one batch at their own positions, as the batcher
    runs them)."""
    _, dec = _pair('TransformerDecoder', 16, num_layers=2, num_heads=2,
                   d_memory=12, seed=0)
    memory = torch.from_numpy(_x((3, 5, 12), seed=9))
    cache_a = dec.init_cache(memory, 8)
    cache_b = dec.init_cache(memory, 8)
    x = torch.from_numpy(_x((3, 1, 16), seed=10))
    with torch.no_grad():
        for t in range(3):
            out_a, cache_a = dec.decode_step(x, cache_a, t)
            out_b, cache_b = dec.decode_step(x, cache_b,
                                             np.full((3,), t, 'int64'))
            np.testing.assert_allclose(out_a.numpy(), out_b.numpy(),
                                       atol=1e-6, rtol=0)
        # row 1 one step behind the others: it equals row 1 decoded alone
        xs = torch.from_numpy(_x((3, 4, 16), seed=11))
        cache = dec.init_cache(memory, 8)
        dec.decode_step(xs[:, 0:1], cache, np.array([0, 0, 0]))
        dec.decode_step(xs[:, 1:2], cache, np.array([1, 0, 1]))
        out, _ = dec.decode_step(xs[:, 2:3], cache, np.array([2, 1, 2]))
        alone = dec.init_cache(memory[1:2], 8)
        dec.decode_step(xs[1:2, 1:2], alone, 0)
        want, _ = dec.decode_step(xs[1:2, 2:3], alone, 1)
    np.testing.assert_allclose(out[1:2].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


def test_decode_matches_jax_decode_with_per_row_positions():
    jax_dec, dec = _pair('TransformerDecoder', 16, num_layers=2,
                         num_heads=4, num_kv_heads=2, use_rope=True,
                         d_memory=12, seed=7)
    memory = _x((3, 5, 12), seed=12)
    xs = _x((3, 4, 16), seed=13)
    lens = [5, 2, 4]
    j_cache = jax_dec.init_cache(jnp.asarray(memory), 6)
    cache = dec.init_cache(torch.from_numpy(memory), 6)
    for t, pos in enumerate(([0, 0, 0], [1, 0, 1], [2, 1, 2], [3, 2, 3])):
        j_out, j_cache = jax_dec.decode_step(
            jnp.asarray(xs[:, t:t + 1]), j_cache,
            jnp.asarray(pos, jnp.int32), memory_seq_len=jnp.asarray(lens))
        with torch.no_grad():
            out, cache = dec.decode_step(
                torch.from_numpy(xs[:, t:t + 1]), cache, np.asarray(pos),
                memory_seq_len=lens)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   atol=ATOL, rtol=0)


def test_a_write_past_the_cache_raises():
    """``lax.dynamic_update_slice`` clamps a start that runs past the
    cache; the port refuses the write (its callers never reach it)."""
    _, mha = _pair('MultiheadAttention', 16, 4)
    cache = mha.init_cache(batch_size=2, max_len=4)
    x = torch.zeros((2, 2, 16))
    with pytest.raises(ValueError, match='do not fit the cache'):
        mha.decode_step(x, cache, 3)
    with pytest.raises(ValueError, match='do not fit the cache'):
        mha.decode_step(x[:, :1], cache, np.array([0, 4]))


def test_a_row_that_sees_no_key_gives_the_mean_of_the_values():
    """Masked logits are filled with finfo.min, not -inf: an unused slot
    (memory length 0) gives finite outputs, the mean of the values."""
    _, mha = _pair('MultiheadAttention', 16, 4, seed=3)
    mem = torch.from_numpy(_x((2, 6, 16), seed=4))
    q = torch.from_numpy(_x((2, 1, 16), seed=5))
    with torch.no_grad():
        kv = mha.precompute_kv(mem)
        got = mha.attend_cached(q, kv, key_padding_lens=[0, 6])
        mean = mha.out_proj(kv['v'].mean(dim=2).reshape(2, 1, 16))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got[0].numpy(), mean[0].numpy(), atol=1e-6,
                               rtol=0)


def test_bf16_decoder_takes_the_dense_backend_and_decodes():
    """Under 'auto' a bf16 forward on the CPU takes the dense path (on the
    card the bf16 attention kernels, as the measured dispatch table
    decides for float32 and bf16 alike), and the decode loop runs dense in
    bf16 with bf16 caches."""
    _, dec = _pair('TransformerDecoder', d_model=16, num_layers=1,
                   num_heads=4, seed=43)
    dec = dec.to(torch.bfloat16)
    x = torch.from_numpy(_x((2, 5, 16), seed=44)).to(torch.bfloat16)
    memory = torch.from_numpy(_x((2, 3, 16), seed=45)).to(torch.bfloat16)
    with torch.no_grad():
        want = dec(x, memory)
        cache = dec.init_cache(memory, 5, dtype=torch.bfloat16)
        assert cache['self'][0]['k'].dtype == torch.bfloat16
        got = torch.cat([dec.decode_step(x[:, t:t + 1], cache, t)[0]
                         for t in range(5)], 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=0.05, rtol=0)
    assert tf.should_use_flash('cuda')
    assert tf.should_use_flash('cuda', torch.bfloat16)
    assert not tf.should_use_flash('cpu', torch.bfloat16)
