"""bf16 attention: the port's plain versions of the attention kernels and
``MultiheadAttention`` in bf16 against the JAX package's, on the CPU.

The same arrays, made with numpy and cast to bf16 in both packages, go
through ``padertorch_tpu.ops.pallas.attention.flash_attention`` (interpret
mode, its own block sizes: one key block at these lengths) and ``jax.vjp``
of it, and through the port's ``flash_attention_fwd_plain`` and
``flash_attention_bwd_plain``, which follow the Pallas kernel's dtypes step
by step (float32 logits, softmax and sums; the probabilities rounded to
bf16 only for ``P V``; every backward sum float32; each output rounded
once).  Limits: every element within one bf16 unit in the last place of the
larger of the two values plus ``ATOL`` (float32 sums in another order, where
terms cancel, move a small result by more than its own unit: the largest
seen beyond one unit is 1.9e-6), and at most ``SHARE`` of the elements
differ at all (the largest share seen is 1.57%, dq under grouped heads).

Three faults of the port are held here, each failing on the tree before
they were repaired:
- the dense path of ``MultiheadAttention`` rounded bf16 logits to bf16
  (``torch.matmul`` of bf16 operands) where the JAX package sums them into
  float32 (``preferred_element_type=float32``);
- the plain ``flash_attention`` on bf16 tensors took the softmax in bf16;
- ``FlashAttention.backward`` summed ``delta`` in the input dtype.

The bf16 CUDA kernels are held against these plain versions on the card
(``test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 26).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.mk.modules import transformer as jax_tf
from padertorch_tpu.module import combine, partition
from padertorch_tpu.ops.pallas.attention import (
    flash_attention as jax_flash_attention)
from padertorch_tpu.train.precision import Precision as JaxPrecision
from padertorch_tpu_torch.contrib.mk.modules import transformer as tf
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.ops.kernels import attention as attention_kernels
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_fwd_plain)

torch.set_num_threads(2)

ATOL = 1e-5
SHARE = 0.03

# name: (B, H, Hkv, Tq, Tk, D, kwargs)
CASES = {
    'causal_d16': (2, 2, 2, 40, 40, 16, {'causal': True}),
    'window_d64': (1, 2, 2, 48, 48, 64, {'window': (5, 3)}),
    'ragged_d16': (3, 2, 2, 33, 33, 16, {'key_padding_lens': [33, 20, 0]}),
    'gqa_causal_ragged_d64': (2, 4, 2, 24, 24, 64,
                              {'causal': True, 'key_padding_lens': [24, 10]}),
    'tq_ne_tk_d16': (2, 2, 2, 19, 45, 16, {}),
    'full_d64': (2, 2, 2, 100, 100, 64, {}),
}


def ulp_distance(got, want):
    """(largest difference beyond one bf16 unit in the last place of the
    larger of the two values, share of elements that differ)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(big > 0, big, torch.ones_like(big)))) - 7),
        torch.zeros_like(big))
    return (float((diff - ulp).max().detach()),
            float((diff > 0).float().mean()))


def assert_within_one_ulp(got, want, label):
    excess, share = ulp_distance(got, want)
    assert excess <= ATOL and share <= SHARE, (label, excess, share)


def _arrays(name):
    b, h, h_kv, tq, tk, d, kwargs = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return ([rng.randn(*shape).astype('float32')
             for shape in ((b, h, tq, d), (b, h_kv, tk, d), (b, h_kv, tk, d),
                           (b, h, tq, d))], kwargs)


def _to_torch(arrays):
    return [torch.from_numpy(x).bfloat16() for x in arrays]


def _from_jax(x):
    return torch.from_numpy(np.asarray(x).astype('float32'))


@pytest.fixture(scope='module')
def jax_references():
    """{name: (o, (dq, dk, dv))} of the Pallas kernel in interpret mode on
    the bf16 arrays, once per module."""
    out = {}
    for name in CASES:
        arrays, kwargs = _arrays(name)
        q, k, v, d_o = (jnp.asarray(x).astype(jnp.bfloat16) for x in arrays)
        jkw = dict(kwargs, interpret=True)
        if 'key_padding_lens' in jkw:
            jkw['key_padding_lens'] = jnp.asarray(jkw['key_padding_lens'])
        o, vjp = jax.vjp(
            lambda q, k, v: jax_flash_attention(q, k, v, **jkw), q, k, v)
        out[name] = (_from_jax(o), tuple(_from_jax(g) for g in vjp(d_o)))
    return out


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_bf16_forward_matches_the_pallas_kernel(name, jax_references):
    """On the parent tree the plain version took the softmax in bf16:
    most outputs differed by more than a unit."""
    (q, k, v, _), kwargs = _arrays(name)
    o, lse = flash_attention_fwd_plain(*_to_torch((q, k, v)), **kwargs)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert_within_one_ulp(o, jax_references[name][0], 'o')


@pytest.mark.parametrize('name', ['causal_d16', 'full_d64', 'window_d64'])
def test_plain_bf16_forward_in_key_tiles_matches_the_pallas_blocks(name):
    """``key_tile`` takes the keys as the Pallas kernel takes its blocks of
    ``block_k`` (and the bf16 kernel its tiles of 64): P rounded to bf16
    against the running maximum.  Against the Pallas kernel with blocks of
    16 the plain version in tiles of 16 stays within one unit (0 to
    0.004% of the elements differ), where the untiled one differs in 8% to
    28% of them, by up to 2.2e-3 beyond a unit."""
    (q, k, v, _), kwargs = _arrays(name)
    jkw = dict(kwargs, interpret=True, block_q=16, block_k=16)
    want = _from_jax(jax_flash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), **jkw))
    args = _to_torch((q, k, v))
    got, lse = flash_attention_fwd_plain(*args, key_tile=16, **kwargs)
    assert_within_one_ulp(got, want, 'o')
    untiled, untiled_lse = flash_attention_fwd_plain(*args, **kwargs)
    assert ulp_distance(untiled, want)[1] > SHARE
    torch.testing.assert_close(lse, untiled_lse, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_bf16_backward_matches_jax_grad(name, jax_references):
    arrays, kwargs = _arrays(name)
    q, k, v, d_o = _to_torch(arrays)
    o, lse = flash_attention_fwd_plain(q, k, v, **kwargs)
    got = flash_attention_bwd_plain(q, k, v, o, lse, d_o, **kwargs)
    for g, w, x, label in zip(got, jax_references[name][1], (q, k, v),
                              ('dq', 'dk', 'dv')):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape, label
        assert_within_one_ulp(g, w, label)


@pytest.mark.parametrize('name', ['gqa_causal_ragged_d64', 'window_d64'])
def test_the_cpu_wrapper_differentiates_bf16_with_the_plain_backward(name):
    """``flash_attention`` on bf16 CPU tensors with a gradient: the plain
    forward, and as its backward ``flash_attention_bwd_plain`` bit for bit
    (autograd of the bf16 forward would round dP to bf16)."""
    arrays, kwargs = _arrays(name)
    q, k, v, d_o = _to_torch(arrays)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(flash_attention.launches)
    out = flash_attention(*leaves, **kwargs)
    got = torch.autograd.grad(out, leaves, d_o)
    o, lse = flash_attention_fwd_plain(q, k, v, **kwargs)
    assert torch.equal(out.detach(), o)
    want = flash_attention_bwd_plain(q, k, v, o, lse, d_o, **kwargs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert flash_attention.launches == before


def test_a_fully_masked_bf16_row_gives_zero_output_and_gradient():
    arrays, kwargs = _arrays('ragged_d16')
    q, k, v, d_o = _to_torch(arrays)
    o, lse = flash_attention_fwd_plain(q, k, v, **kwargs)
    grads = flash_attention_bwd_plain(q, k, v, o, lse, d_o, **kwargs)
    assert float(o[2].abs().max()) == 0.0
    assert bool((lse[2] == -1e30).all())
    assert all(float(g[2].abs().max()) == 0.0 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_flash_function_backward_sums_delta_in_float32(monkeypatch):
    """``FlashAttention.backward`` hands the kernels ``delta = sum(f32(dO)
    f32(O))`` in float32 (the JAX package's ``_bwd_call``); on the parent
    tree it was a bf16 sum.  The launches are replaced by the plain
    versions, so the Function's own arithmetic runs on the CPU."""
    arrays, kwargs = _arrays('full_d64')
    q, k, v, d_o = _to_torch(arrays)
    seen = {}

    def fake_fwd(q, k, v, lens, causal, left, right, scale, train):
        return flash_attention_fwd_plain(q, k, v)

    def fake_bwd(q, k, v, lens, d_o, lse, delta, *config):
        seen['delta'] = delta
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(attention_kernels, '_launch_fwd', fake_fwd)
    monkeypatch.setattr(attention_kernels, '_launch_bwd', fake_bwd)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_kernels.FlashAttention.apply(*leaves, None, False, None,
                                                 None, 0.125)
    torch.autograd.grad(out, leaves, d_o)
    want = (d_o.float() * out.detach().float()).sum(-1)
    assert seen['delta'].dtype == torch.float32
    assert torch.equal(seen['delta'], want)


def test_the_kernels_take_two_types_alike_and_refuse_a_mix():
    q = torch.zeros((2, 4, 5, 16))
    attention_kernels._check(q, q, q)
    attention_kernels._check(*(x.bfloat16() for x in (q, q, q)))
    for mix in ((q.bfloat16(), q, q), (q, q.bfloat16(), q),
                (q, q, q.bfloat16()), (q.half(), q.half(), q.half())):
        with pytest.raises(TypeError, match='float32 or bfloat16'):
            attention_kernels._check(*mix)


# (num_heads, num_kv_heads, call kwargs)
MHA_CASES = {
    'causal_ragged_gqa': (4, 2, {'causal': True,
                                 'key_padding_lens': np.array([30, 17])}),
    'window': (2, 2, {'attn_window': (4, 6)}),
}


def _bf16_pair(heads, kv_heads, bias=False):
    """``MultiheadAttention(32, heads)`` with RoPE in both packages, the
    JAX module's trainable arrays cast to bf16 as its policy casts them,
    the port cast with ``.to`` (RoPE's frequencies stay float32 in both);
    the projections with or without a bias."""
    ptrandom.seed(0)
    jax_module = jax_tf.MultiheadAttention(
        32, heads, num_kv_heads=kv_heads, use_rope=True, bias=bias).eval()
    port = tf.MultiheadAttention(32, heads, num_kv_heads=kv_heads,
                                 use_rope=True, bias=bias).eval()
    from_jax_state_dict(port, jax_module.state_dict())
    params, static = partition(jax_module)
    return (combine(JaxPrecision('bfloat16').cast_floating(params), static),
            port.to(torch.bfloat16))


@pytest.mark.parametrize('use_flash', [False, True])
@pytest.mark.parametrize('name', sorted(MHA_CASES))
def test_bf16_multihead_attention_matches_jax(name, use_flash):
    """Dense and fused backends in bf16, each against the same backend of
    the JAX module.  On the parent tree the dense backend's bf16 logits were
    rounded to bf16: about half the outputs moved by a unit or more."""
    heads, kv_heads, kwargs = MHA_CASES[name]
    jax_module, port = _bf16_pair(heads, kv_heads)
    jax_tf.set_attention_backend(jax_module, use_flash)
    tf.set_attention_backend(port, use_flash)
    x = np.random.RandomState(1).randn(2, 30, 32).astype('float32')
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    want = _from_jax(jax_module(jnp.asarray(x).astype(jnp.bfloat16), **jkw))
    pkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    got = port(torch.from_numpy(x).bfloat16(), **pkw)
    assert got.dtype == torch.bfloat16
    assert_within_one_ulp(got, want, f'{name} use_flash={use_flash}')


@pytest.mark.parametrize('use_flash', [False, True])
@pytest.mark.parametrize('name', sorted(MHA_CASES))
def test_bf16_multihead_attention_with_bias_matches_jax(name, use_flash):
    """As above with a bias on every projection: the port's bf16 ``Linear``
    rounds the product and then the sum with the bias, as the JAX layer
    does.  torch's fused ``Linear``, which rounds once, moved 28% to 31% of
    a projection's outputs by a unit."""
    heads, kv_heads, kwargs = MHA_CASES[name]
    jax_module, port = _bf16_pair(heads, kv_heads, bias=True)
    jax_tf.set_attention_backend(jax_module, use_flash)
    tf.set_attention_backend(port, use_flash)
    x = np.random.RandomState(1).randn(2, 30, 32).astype('float32')
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    want = _from_jax(jax_module(jnp.asarray(x).astype(jnp.bfloat16), **jkw))
    pkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    got = port(torch.from_numpy(x).bfloat16(), **pkw)
    assert got.dtype == torch.bfloat16
    assert_within_one_ulp(got, want, f'{name} use_flash={use_flash} bias')


def test_dense_logits_are_float32_sums_of_the_bf16_operands(monkeypatch):
    """The dense backend's softmax sees float32 logits equal to the float32
    product of the widened bf16 q and k (exact products, float32 sums)."""
    heads, kv_heads, kwargs = MHA_CASES['window']
    _, port = _bf16_pair(heads, kv_heads)
    tf.set_attention_backend(port, False)
    seen = []
    softmax = torch.softmax

    def spy(logits, dim):
        seen.append(logits)
        return softmax(logits, dim=dim)

    x = torch.from_numpy(
        np.random.RandomState(1).randn(2, 30, 32).astype('float32'))
    x = x.bfloat16()
    q = port._split(port.q_proj(x), heads)
    k = port._split(port.k_proj(x), kv_heads)
    q, k = port.rope(q), port.rope(k)
    monkeypatch.setattr(torch, 'softmax', spy)
    port(x)
    logits, = seen
    assert logits.dtype == torch.float32
    want = torch.matmul(q.float(), k.float().transpose(-1, -2)) / 4.0
    assert torch.equal(logits, want)
