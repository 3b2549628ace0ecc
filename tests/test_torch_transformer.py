"""The port's transformer encoder modules against the JAX package's, on the
CPU.

Every module is built in both packages with the same arguments, the JAX
weights go into the port through ``from_jax_state_dict``, and the same
numpy inputs go through both.  The fused attention backend runs as the JAX
package's own tests run it off a TPU (``use_flash=True`` takes the Pallas
interpreter) and, in the port, as the kernels' plain version.  Forward and
parameter gradients agree to 1e-4 (float32, sums in another order), the
gradients relative to each gradient's largest entry; weights make the round
trip through ``to_jax_state_dict`` exactly.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.mk.modules import transformer as jax_tf
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu_torch.contrib.mk.modules import transformer as tf
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)

torch.set_num_threads(2)

ATOL = 1e-4


def _pair(name, *args, seed=0, **kwargs):
    """The same module in both packages, with the JAX module's weights."""
    ptrandom.seed(seed)
    jax_module = getattr(jax_tf, name)(*args, **kwargs).eval()
    port = getattr(tf, name)(*args, **kwargs).eval()
    from_jax_state_dict(port, jax_module.state_dict())
    return jax_module, port


def _to_jnp(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _to_torch(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _check(jax_module, port, inputs, kwargs=None, grads=True):
    """Forward and parameter gradients of ``sum(out * cot)``."""
    kwargs = kwargs or {}
    j_in = [_to_jnp(x) for x in inputs]
    j_kw = {k: _to_jnp(v) for k, v in kwargs.items()}
    want = np.asarray(jax_module(*j_in, **j_kw))
    out = port(*[_to_torch(x) for x in inputs],
               **{k: _to_torch(v) for k, v in kwargs.items()})
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL, rtol=0)
    if not grads:
        return
    cot = np.random.RandomState(7).randn(*want.shape).astype('float32')
    params, static = partition(jax_module)

    def loss(params):
        return jnp.sum(combine(params, static)(*j_in, **j_kw) * cot)

    want_grads = state_dict(jax.grad(loss)(params))
    port.zero_grad()
    (out * torch.from_numpy(cot)).sum().backward()
    holder = copy.deepcopy(port)
    with torch.no_grad():
        for p, g in zip(port.parameters(), holder.parameters()):
            assert p.grad is not None
            g.copy_(p.grad)
    got_grads = to_jax_state_dict(holder)
    assert set(want_grads) <= set(got_grads)
    want_grads = {name: np.asarray(w) for name, w in want_grads.items()}
    # a gradient that is zero in exact arithmetic (the key bias: a softmax
    # does not see a shift of all its logits) is rounding noise of the
    # module's other gradients, so the floor follows the largest of them
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want_grads.values())
    for name, w in want_grads.items():
        np.testing.assert_allclose(
            got_grads[name], w, rtol=0,
            atol=ATOL * max(float(np.abs(w).max()), floor), err_msg=name)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


@pytest.mark.parametrize('offset', [0, 5, np.array([0, 3, 11])])
def test_rope_matches_jax(offset):
    jax_rope, rope = _pair('RoPE', 8)
    x = _x((3, 2, 7, 8))
    want = np.asarray(jax_rope(jnp.asarray(x), offset=_to_jnp(offset)))
    got = rope(torch.from_numpy(x), offset=_to_torch(offset))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # split-half, not interleaved: position 0 is left as it is
    if isinstance(offset, int) and offset == 0:
        np.testing.assert_array_equal(got[:, :, 0].numpy(), x[:, :, 0])


def test_rope_buffer_is_the_jax_buffer_and_round_trips():
    jax_rope, rope = _pair('RoPE', 16)
    want = np.asarray(jax_rope.state_dict()['inv_freq'])
    np.testing.assert_array_equal(tf.RoPE(16).inv_freq.numpy(), want)
    np.testing.assert_array_equal(to_jax_state_dict(rope)['inv_freq'], want)


def test_dynamic_tanh_matches_jax():
    jax_dyt, dyt = _pair('DynamicTanh', 6, alpha0=0.7)
    _check(jax_dyt, dyt, [_x((2, 5, 6))])


# name: (constructor kwargs, forward kwargs, backends)
MHA_CASES = {
    'rope': (dict(use_rope=True), {}, (False, True)),
    'no_rope_no_bias': (dict(bias=False), {}, (False, True)),
    'padding': (dict(use_rope=True),
                {'key_padding_lens': np.array([9, 4])}, (False, True)),
    'causal': (dict(use_rope=True), {'causal': True}, (False, True)),
    'window': (dict(use_rope=True), {'attn_window': (2, 1)}, (False, True)),
    'causal_window': (dict(), {'causal': True, 'attn_window': (3, None)},
                      (False, True)),
    'gqa': (dict(use_rope=True, num_kv_heads=2),
            {'key_padding_lens': np.array([9, 6])}, (False, True)),
    'mqa': (dict(num_kv_heads=1), {'causal': True}, (False, True)),
    'qk_norm_rms': (dict(use_rope=True, qk_norm='rms'), {}, (False, True)),
    'qk_norm_l2': (dict(use_rope=True, qk_norm='l2'), {}, (False, True)),
    'add_bias_kv': (dict(add_bias_kv=True),
                    {'key_padding_lens': np.array([9, 3])}, (False,)),
    'linear_attention_bias': (dict(linear_attention_bias=True), {},
                              (False,)),
    'attn_bias': (dict(use_rope=True),
                  {'attn_bias': _x((2, 4, 9, 9), seed=3)}, (False,)),
}


@pytest.mark.parametrize('use_flash', [False, True])
@pytest.mark.parametrize('name', sorted(MHA_CASES))
def test_multihead_attention_matches_jax(name, use_flash):
    ctor, kwargs, backends = MHA_CASES[name]
    if use_flash not in backends:
        # an additive bias or the bias token: both packages take the dense
        # path whatever the backend asked for, checked under use_flash=False
        use_flash = 'auto'
    jax_mha, mha = _pair('MultiheadAttention', 16, 4, use_flash=use_flash,
                         **ctor)
    _check(jax_mha, mha, [_x((2, 9, 16))], kwargs)


@pytest.mark.parametrize('use_flash', [False, True])
def test_cross_attention_with_other_key_and_value_sizes(use_flash):
    jax_mha, mha = _pair('MultiheadAttention', 16, 4, d_kv=12, d_v=10,
                         use_flash=use_flash)
    inputs = [_x((2, 7, 16)), _x((2, 11, 12), seed=2), _x((2, 11, 10), seed=3)]
    _check(jax_mha, mha, inputs, {'key_padding_lens': np.array([11, 5])})


def test_backends_agree_on_valid_rows_and_differ_on_fully_masked_ones():
    _, mha = _pair('MultiheadAttention', 16, 4, use_rope=True)
    x = torch.from_numpy(_x((2, 9, 16)))
    lens = [9, 0]
    dense = tf.set_attention_backend(mha, False)(x, key_padding_lens=lens)
    fused = tf.set_attention_backend(mha, True)(x, key_padding_lens=lens)
    np.testing.assert_allclose(fused[0].detach().numpy(),
                               dense[0].detach().numpy(), atol=ATOL, rtol=0)
    # no key at all: the fused backend gives out_proj(0), the dense one the
    # projected mean of the values
    np.testing.assert_allclose(
        fused[1].detach().numpy(),
        np.broadcast_to(mha.out_proj.bias.detach().numpy(), (9, 16)),
        atol=1e-6, rtol=0)
    assert float((fused[1] - dense[1]).abs().max()) > 1e-3


def test_attention_dropout_in_training_takes_the_dense_path():
    mha = tf.MultiheadAttention(16, 4, dropout=0.5, use_flash=True)
    x = torch.from_numpy(_x((2, 9, 16)))
    torch.manual_seed(0)
    a = mha.train()(x)
    torch.manual_seed(1)
    b = mha(x)
    assert float((a - b).abs().max()) > 0     # dropout was active
    assert torch.equal(mha.eval()(x), mha(x))  # and is off in eval


def test_options_that_wait_raise_and_name_the_roadmap():
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        tf.MultiheadAttention(16, 4, magnitude_preserving=True)
    mha = tf.MultiheadAttention(16, 4)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        mha.set_sequence_mesh(None)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        tf.PositionalEncoding(16)
    with pytest.warns(UserWarning, match='dense'):
        tf.MultiheadAttention(16, 4, linear_attention_bias=True,
                              use_flash=True)(torch.zeros((1, 3, 16)))


def test_every_public_name_of_the_jax_module_is_ported_or_says_it_waits():
    for name in jax_tf.__all__:
        if name in tf.__all__:
            assert getattr(tf, name) is not None
        else:
            with pytest.raises(NotImplementedError, match='ROADMAP.md'):
                getattr(tf, name)
    assert not hasattr(tf, 'no_such_name')


@pytest.mark.parametrize('pre_activation', [False, True])
def test_ffn_matches_jax(pre_activation):
    jax_ffn, ffn = _pair('_FFN', 8, 24, pre_activation=pre_activation)
    _check(jax_ffn, ffn, [3 * _x((2, 5, 8))])


def test_ffn_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form, torch to the erf form:
    with the erf form this comparison fails at 1e-4."""
    jax_ffn, ffn = _pair('_FFN', 8, 24)
    x = 3 * _x((4, 16, 8))
    want = np.asarray(jax_ffn(jnp.asarray(x)))
    got = ffn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    t = torch.from_numpy(x)
    erf = ffn.lin2(torch.nn.functional.gelu(ffn.lin1(t))).detach().numpy()
    assert np.abs(erf - want).max() > ATOL
    with pytest.raises(ValueError, match='activation'):
        tf._FFN(8, 24, activation='nope')


@pytest.mark.parametrize('norm,kind', [
    ('layer_norm', torch.nn.LayerNorm), ('rms', tf.nn.RMSNorm),
    ('dyt', tf.DynamicTanh)])
def test_make_norm(norm, kind):
    made = tf._make_norm(norm, 8)
    assert type(made) is kind
    if norm == 'rms':
        assert made.eps == 1e-6          # the JAX package's, not torch's
        ptrandom.seed(0)
        jax_norm = jax_tf._make_norm('rms', 8)
        x = 1e-3 * _x((2, 3, 8))         # small enough that eps shows
        np.testing.assert_allclose(
            made(torch.from_numpy(x)).detach().numpy(),
            np.asarray(jax_norm(jnp.asarray(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize('bias,layer_scale,zero_init', [
    (True, False, False), (True, True, False), (False, True, True),
    (False, False, False)])
def test_cond_layer_norm_matches_jax(bias, layer_scale, zero_init):
    jax_norm, norm = _pair('CondLayerNorm', 8, 5, bias=bias,
                           layer_scale=layer_scale, zero_init=zero_init)
    x, cond = _x((2, 4, 8)), _x((2, 5), seed=2)
    want, want_alpha = jax_norm(jnp.asarray(x), jnp.asarray(cond))
    got, got_alpha = norm(torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    assert (got_alpha is None) == (want_alpha is None) == (not layer_scale)
    if layer_scale:
        np.testing.assert_allclose(got_alpha.detach().numpy(),
                                   np.asarray(want_alpha), atol=ATOL, rtol=0)
        if zero_init:
            assert float(got_alpha.abs().max()) == 0.0
    plain, none = norm(torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(jax_norm(jnp.asarray(x))[0]), atol=ATOL,
        rtol=0)


LAYER_CASES = {
    'pre_norm': dict(),
    'post_norm': dict(pre_norm=False),
    'rms_norm': dict(norm='rms'),
    'dyt_norm': dict(norm='dyt', use_rope=False),
    'cond_pre_norm': dict(cond_dim=5),
    'cond_post_norm': dict(cond_dim=5, pre_norm=False),
    'cond_zero_init': dict(cond_dim=5, zero_init=True),
    'normalize_skip_connections': dict(normalize_skip_connections=True),
    'pre_activation_gqa': dict(pre_activation=True, num_kv_heads=2),
}


@pytest.mark.parametrize('use_flash', [False, True])
@pytest.mark.parametrize('name', sorted(LAYER_CASES))
def test_encoder_layer_matches_jax(name, use_flash):
    ctor = LAYER_CASES[name]
    jax_layer, layer = _pair('TransformerEncoderLayer', 16, 4, d_ff=24,
                             **ctor)
    jax_tf.set_attention_backend(jax_layer, use_flash)
    tf.set_attention_backend(layer, use_flash)
    kwargs = {'seq_len': np.array([9, 5])}
    if 'cond_dim' in ctor:
        kwargs['cond'] = _x((2, 5), seed=4)
    _check(jax_layer, layer, [_x((2, 9, 16))], kwargs)


def test_encoder_layer_is_the_reference_name():
    assert tf.EncoderLayer is tf.TransformerEncoderLayer


@pytest.mark.parametrize('use_flash', [False, True])
@pytest.mark.parametrize('ctor', [
    dict(input_size=10), dict(pre_norm=False), dict(cond_dim=5, norm='rms'),
    dict(num_kv_heads=1, d_ff=20)],
    ids=['input_proj', 'post_norm', 'cond', 'mqa'])
def test_transformer_encoder_with_seq_len_matches_jax(ctor, use_flash):
    jax_enc, enc = _pair('TransformerEncoder', 16, 2, 4, **ctor)
    jax_tf.set_attention_backend(jax_enc, use_flash)
    tf.set_attention_backend(enc, use_flash)
    kwargs = {'seq_len': np.array([9, 4, 7])}
    if 'cond_dim' in ctor:
        kwargs['cond'] = _x((3, 5), seed=4)
    x = _x((3, 9, ctor.get('input_size', 16)))
    _check(jax_enc, enc, [x], kwargs)
    out = enc(torch.from_numpy(x), **{k: torch.from_numpy(v)
                                      for k, v in kwargs.items()})
    assert float(out[1, 4:].abs().max()) == 0.0   # padding is zeroed


def test_set_attention_backend_reaches_every_attention_block():
    enc = tf.TransformerEncoder(16, 3, 4)
    assert {m.use_flash for m in enc.modules()
            if isinstance(m, tf.MultiheadAttention)} == {'auto'}
    assert tf.set_attention_backend(enc, True) is enc
    flags = [m.use_flash for m in enc.modules()
             if isinstance(m, tf.MultiheadAttention)]
    assert flags == [True] * 3
    tf.set_attention_backend(enc, False)
    assert not any(m.use_flash for m in enc.modules()
                   if isinstance(m, tf.MultiheadAttention))


@pytest.mark.parametrize('name,args,kwargs', [
    ('MultiheadAttention', (16, 4), dict(use_rope=True, qk_norm='rms',
                                         add_bias_kv=True, num_kv_heads=2)),
    ('TransformerEncoder', (16, 2, 4), dict(norm='dyt', input_size=8)),
    ('TransformerEncoder', (16, 1, 4), dict(cond_dim=3, norm='rms')),
])
def test_weights_round_trip_exactly(name, args, kwargs):
    jax_module, port = _pair(name, *args, seed=5, **kwargs)
    want = {k: np.asarray(v) for k, v in jax_module.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    again = to_jax_state_dict(from_jax_state_dict(
        getattr(tf, name)(*args, **kwargs), got))
    for key in want:
        np.testing.assert_array_equal(again[key], want[key], err_msg=key)
