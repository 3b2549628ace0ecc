"""The plain versions of the port's attention kernels against the JAX
package's Pallas kernels, on the CPU.

The same arrays, made with numpy, go through
``padertorch_tpu.ops.pallas.attention.flash_attention`` (interpret mode,
16-wide blocks, as the JAX package's own tests run it) and through
``padertorch_tpu_torch.ops.kernels.attention.flash_attention``, which on a
CPU tensor is ``flash_attention_plain``; gradients come from ``jax.grad``
and from autograd.  Tolerance 1e-5 absolute: the same float32 arithmetic,
sums in another order (the Pallas kernel adds block by block).  The CUDA
kernels themselves are held against these plain versions on the card
(``test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 12).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.ops.pallas.attention import (
    flash_attention as jax_flash_attention)
from padertorch_tpu_torch.ops.kernels import attention
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_fwd_plain, flash_attention_plain,
    should_use_flash, visible_mask)

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _pinned_cpu_arithmetic():
    """Every test starts from the same CPU arithmetic, whatever the tests
    that ran before it in this worker's process left: two intra-op threads,
    float32 matmuls at full precision, no flushing of denormals; and
    torch's float32 ``exp`` and ``log`` already called once.  The first
    ``exp`` of a process, on two threads of a loaded machine, can come back
    with errors several times this file's limit (the next call is exact):
    the causal forward case, the first test of this file and so often the
    first ``exp`` of its worker, failed by 5.1e-5 that way in whole runs."""
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision('highest')
    torch.set_flush_denormal(False)
    torch.log(torch.exp(torch.linspace(-30.0, 0.0, 1 << 16)))
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)

# name: (B, H, Hkv, Tq, Tk, D, kwargs)
CASES = {
    'full': (2, 2, 2, 40, 40, 16, {}),
    'causal': (2, 2, 2, 40, 40, 16, {'causal': True}),
    'window': (1, 2, 2, 48, 48, 8, {'window': (5, 3)}),
    'window_left_only': (1, 2, 2, 48, 48, 8, {'window': (7, None)}),
    'key_padding': (3, 2, 2, 33, 33, 16,
                    {'key_padding_lens': [33, 20, 1]}),
    'causal_and_padding': (2, 2, 2, 40, 40, 16,
                           {'causal': True, 'key_padding_lens': [40, 17]}),
    'gqa': (2, 4, 2, 24, 24, 8, {'key_padding_lens': [24, 10]}),
    'mqa_causal': (1, 4, 1, 24, 24, 8, {'causal': True}),
    'tq_ne_tk': (2, 2, 2, 19, 45, 16, {}),
    'zero_length_row': (3, 2, 2, 20, 20, 8,
                        {'key_padding_lens': [20, 0, 7]}),
}


def _arrays(name):
    b, h, h_kv, tq, tk, d, kwargs = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    q = rng.randn(b, h, tq, d).astype('float32')
    k = rng.randn(b, h_kv, tk, d).astype('float32')
    v = rng.randn(b, h_kv, tk, d).astype('float32')
    d_o = rng.randn(b, h, tq, d).astype('float32')
    return q, k, v, d_o, kwargs


def _jax_kwargs(kwargs):
    kwargs = dict(kwargs)
    if 'key_padding_lens' in kwargs:
        kwargs['key_padding_lens'] = jnp.asarray(kwargs['key_padding_lens'])
    return dict(kwargs, interpret=True, block_q=16, block_k=16)


def _dense_reference(q, k, v, causal=False, key_padding_lens=None,
                     window=None):
    """softmax(q k^T / sqrt(D) + mask) v in float64 numpy, written out
    independently of the port; fully masked rows give 0."""
    b, h, tq, d = q.shape
    group = h // k.shape[1]
    k, v = np.repeat(k, group, axis=1), np.repeat(v, group, axis=1)
    tk = k.shape[2]
    logits = np.einsum('bhqd,bhkd->bhqk', q.astype('float64'),
                       k.astype('float64')) / np.sqrt(d)
    rows, cols = np.arange(tq)[:, None], np.arange(tk)[None, :]
    valid = np.ones((b, 1, tq, tk), bool)
    if key_padding_lens is not None:
        valid &= cols[None, None] < np.asarray(key_padding_lens)[
            :, None, None, None]
    if causal:
        valid &= (cols <= rows)[None, None]
    if window is not None:
        left, right = window
        if left is not None:
            valid &= (rows - cols <= left)[None, None]
        if right is not None:
            valid &= (cols - rows <= right)[None, None]
    logits = np.where(valid, logits, -np.inf)
    top = np.max(logits, axis=-1, keepdims=True)
    top = np.where(np.isfinite(top), top, 0.0)
    p = np.exp(logits - top)
    total = p.sum(-1, keepdims=True)
    p = np.where(total > 0, p / np.where(total > 0, total, 1.0), 0.0)
    return np.einsum('bhqk,bhkd->bhqd', p, v.astype('float64'))


@pytest.mark.parametrize('name', sorted(CASES))
def test_forward_matches_the_pallas_kernel(name):
    q, k, v, _, kwargs = _arrays(name)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **_jax_kwargs(kwargs)))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kwargs)
    assert got.shape == want.shape and got.dtype == torch.float32
    # each side against the float64 reference too, so that a failure
    # names the side that moved
    ref = _dense_reference(q, k, v, **kwargs)
    sides = (f'against float64: the Pallas kernel '
             f'{np.abs(want - ref).max():.3e}, the port '
             f'{np.abs(got.numpy() - ref).max():.3e}')
    np.testing.assert_allclose(want, ref, atol=TOL, rtol=0,
                               err_msg='the Pallas kernel; ' + sides)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0,
                               err_msg='the port; ' + sides)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                               err_msg=sides)


@pytest.mark.parametrize('name', sorted(CASES))
def test_gradients_match_jax_grad_of_the_pallas_kernel(name):
    q, k, v, d_o, kwargs = _arrays(name)

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, **_jax_kwargs(kwargs))
                       * d_o)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, **kwargs)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(d_o))
    for g, w, label in zip(got, want, 'qkv'):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=f'd{label}')


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_version_matches_a_dense_float64_reference(name):
    q, k, v, _, kwargs = _arrays(name)
    got, lse = flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **kwargs)
    np.testing.assert_allclose(got.numpy(), _dense_reference(q, k, v, **kwargs),
                               atol=TOL, rtol=0)
    assert lse.shape == q.shape[:3] and bool(torch.isfinite(lse).all())


def test_a_fully_masked_row_gives_zero_output_and_zero_gradient():
    """Keys of length 0, and rows a causal mask with Tq > Tk and a short
    key length leaves nothing: exactly 0, no NaN, lse -1e30."""
    q, k, v, d_o, kwargs = _arrays('zero_length_row')
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention_fwd_plain(*leaves, **kwargs)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(d_o))
    assert float(out[1].abs().max()) == 0.0
    assert bool((lse[1] == -1e30).all())
    for g in grads:
        assert bool(torch.isfinite(g).all())
        assert float(g[1].abs().max()) == 0.0
    assert float(out[0].abs().max()) > 0 and float(grads[0][2].abs().max()) > 0
    # keys beyond the length get no gradient either
    assert float(grads[1][2, :, 7:].abs().max()) == 0.0
    assert float(grads[2][2, :, 7:].abs().max()) == 0.0


def test_two_evaluations_agree_exactly():
    q, k, v, _, kwargs = _arrays('causal_and_padding')
    args = [torch.from_numpy(x) for x in (q, k, v)]
    assert torch.equal(flash_attention(*args, **kwargs),
                       flash_attention(*args, **kwargs))


def test_lengths_may_be_a_tensor_a_list_or_an_array():
    q, k, v, _, _ = _arrays('key_padding')
    args = [torch.from_numpy(x) for x in (q, k, v)]
    want = flash_attention(*args, key_padding_lens=[33, 20, 1])
    for lens in (np.array([33, 20, 1]), torch.tensor([33, 20, 1]),
                 torch.tensor([33, 20, 1], dtype=torch.int32),
                 [40, 20, 1]):  # beyond Tk: clamped
        assert torch.equal(flash_attention(*args, key_padding_lens=lens),
                           want)


def test_visible_mask_is_the_pallas_mask():
    got = visible_mask(5, 6, torch.tensor([6, 2]), True, (2, None), 'cpu')
    assert got.shape == (2, 1, 5, 6)
    rows, cols = np.arange(5)[:, None], np.arange(6)[None, :]
    base = (cols <= rows) & (rows - cols <= 2)
    np.testing.assert_array_equal(got[0, 0].numpy(), base)
    np.testing.assert_array_equal(got[1, 0].numpy(), base & (cols < 2))


@pytest.mark.parametrize('training', [False, True])
@pytest.mark.parametrize('causal,window', [
    (False, None), (True, None), (False, (256, 256))])
def test_should_use_flash_is_false_off_the_card_and_follows_the_table(
        causal, window, training, monkeypatch):
    kwargs = dict(causal=causal, window=window, training=training)
    assert should_use_flash(8192, device='cpu', **kwargs) is False
    mode = 'window' if window else 'causal' if causal else 'full'
    phase = 'training' if training else 'forward'
    other = 'forward' if training else 'training'
    monkeypatch.setitem(attention.FLASH_WINS, mode,
                        {phase: ((1024, None),), other: ()})
    assert should_use_flash(1024, **kwargs) is True
    assert should_use_flash(512, 2048, **kwargs) is True   # max(Tq, Tk)
    assert should_use_flash(1023, **kwargs) is False
    assert should_use_flash(8192, device='cpu', **kwargs) is False
    assert should_use_flash(
        4096, **dict(kwargs, training=not training)) is False
    monkeypatch.setitem(attention.FLASH_WINS[mode], phase,
                        ((None, 100), (512, 600)))
    assert should_use_flash(100, **kwargs) is True
    assert should_use_flash(101, **kwargs) is False
    assert should_use_flash(600, **kwargs) is True
    assert should_use_flash(601, **kwargs) is False
    monkeypatch.setitem(attention.FLASH_WINS[mode], phase, ())
    assert should_use_flash(10 ** 6, **kwargs) is False


def test_the_measured_table_sends_the_sepformer_shapes_to_the_kernels():
    for t in (66, 100):
        for training in (False, True):
            assert should_use_flash(t, training=training)
    assert not should_use_flash(512)
    assert should_use_flash(2048) and should_use_flash(2048, training=True)
    assert should_use_flash(1024, training=True)
    assert not should_use_flash(512, training=True)
    assert should_use_flash(2048, causal=True, training=True)
    assert should_use_flash(4096, window=(256, 256), training=True)


def test_the_wrapper_on_a_cpu_tensor_is_the_plain_version():
    q, k, v, _, kwargs = _arrays('window')
    args = [torch.from_numpy(x) for x in (q, k, v)]
    before = dict(flash_attention.launches)
    assert torch.equal(flash_attention(*args, **kwargs),
                       flash_attention_plain(*args, **kwargs))
    assert flash_attention.launches == before  # no kernel was launched
