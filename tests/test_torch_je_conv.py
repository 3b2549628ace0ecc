"""The port's ``contrib/je/modules/conv.py`` forward stack against the JAX
package's, on the CPU.

``CNN1d``/``CNN2d`` in six configurations (batch and sequence norm, max
and average pooling, strides along one axis, dilation, every pad type,
gated and pre-activation convolutions, projected residual connections,
one into the output), with the weights moved by ``from_jax_state_dict``
and ragged lengths: outputs and sequence lengths in train and in eval mode
(the running statistics after a training call too), and the gradients of
every parameter and of the input, at 1e-4 of their largest entry (the
bias of a convolution that a batch norm follows, whose gradient vanishes
in exact arithmetic, below 1e-4 of the model's largest gradient entry).  Also
``Pad``/``Trim``, the length helpers, the max-pool index helpers and the
shape and receptive-field bookkeeping, against the JAX functions.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.je.modules import conv as jax_conv
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu_torch.contrib.je.modules import conv
from padertorch_tpu_torch.migrate import (
    _jax_to_port, from_jax_state_dict, to_jax_state_dict)

torch.set_num_threads(2)

ATOL = 1e-4

CONFIGS = {
    'walnet': ('CNN2d', dict(in_channels=1, out_channels=[4, 8, 8],
                             kernel_size=3, pool_size=[2, 2, 1],
                             norm='batch'), (3, 1, 16, 21)),
    'strided-residual': ('CNN2d', dict(
        in_channels=2, out_channels=[4, 4, 6], kernel_size=[3, (3, 5), 3],
        stride=[(2, 1), 1, 1], pool_type='avg', pool_size=[1, 2, 1],
        residual_connections=[2, None, None], norm='batch'),
        (2, 2, 12, 18)),
    'valid-2d': ('CNN2d', dict(
        in_channels=3, out_channels=[5, 4], kernel_size=(3, 5),
        pad_type=None, pool_size=[(2, 1), 2],
        output_activation_fn='identity'), (2, 3, 16, 24)),
    'sequence-front': ('CNN1d', dict(
        in_channels=4, out_channels=[8, 8, 6], kernel_size=3,
        dilation=[1, 2, 1], pad_type='front', pool_size=[1, 2, 1],
        norm='sequence'), (3, 4, 25)),
    'gated-pre': ('CNN1d', dict(
        in_channels=4, out_channels=[6, 6], kernel_size=[4, 3],
        pad_type='end', gated=True, pre_activation=True, norm='batch',
        activation_fn='tanh'), (2, 4, 19)),
    'residual-out': ('CNN1d', dict(
        in_channels=3, out_channels=[6, 6, 8], kernel_size=3,
        stride=[2, 1, 1], residual_connections=[3, 2, None]),
        (3, 3, 20)),
}


def _models(name, seed=0):
    cls, kwargs, _ = CONFIGS[name]
    ptrandom.seed(seed)
    jax_model = getattr(jax_conv, cls)(**kwargs)
    port = from_jax_state_dict(getattr(conv, cls)(**kwargs),
                               jax_model.state_dict())
    return jax_model, port


def _inputs(name, seed):
    shape = CONFIGS[name][2]
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    t = shape[-1]
    seq_len = np.array([t, t - 5, t - 9][:shape[0]], np.int64)
    x *= np.arange(t) < seq_len[:, None, None] if len(shape) == 3 else \
        (np.arange(t) < seq_len[:, None, None, None])
    return x, seq_len


@pytest.mark.parametrize('mode', ['train', 'eval'])
@pytest.mark.parametrize('name', list(CONFIGS))
def test_outputs_and_lengths_match_jax(name, mode):
    jax_model, port = _models(name)
    x, seq_len = _inputs(name, 1)
    if mode == 'eval':
        # the running statistics of one training call first
        jax_model.train()(jnp.asarray(x), seq_len)
        port.train()(torch.from_numpy(x), seq_len)
    getattr(jax_model, mode)()
    getattr(port, mode)()
    x, seq_len = _inputs(name, 2)
    want, want_len = jax_model(jnp.asarray(x), seq_len)
    with torch.no_grad():
        got, got_len = port(torch.from_numpy(x), seq_len)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(np.asarray(got_len), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))
    assert port.get_shapes(x.shape)[-1] == tuple(want.shape)
    for g, w in zip(port.get_seq_lens(seq_len),
                    jax_model.get_seq_lens(seq_len)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port.get_receptive_field(),
                                  jax_model.get_receptive_field())
    stats = to_jax_state_dict(port)
    for key, value in jax_model.state_dict().items():
        np.testing.assert_allclose(stats[key], np.asarray(value), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_gradients_match_jax(name):
    jax_model, port = _models(name, seed=1)
    x, seq_len = _inputs(name, 3)
    cls, kwargs, shape = CONFIGS[name]
    out_shape = port.get_shapes(shape)[-1]
    w = np.random.RandomState(4).randn(*out_shape).astype(np.float32)
    params, static = partition(jax_model)

    def jax_loss(params, x):
        y, _ = combine(params, static)(x, seq_len)
        return jnp.sum(y * w)

    grads, grad_x = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in state_dict(grads).items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = port(xt, seq_len)
    (y * torch.from_numpy(w)).sum().backward()
    names = {id(p) for p in port.parameters()}
    got = {}
    for jax_name, targets in _jax_to_port(port).items():
        param, convert = targets[0][:2]
        if id(param) in names:
            got[jax_name] = convert(param.grad.numpy())
    assert set(got) == set(want)
    largest = max(float(np.abs(v).max()) for v in want.values())
    for key, g in got.items():
        scale = float(np.abs(want[key]).max())
        if scale < 1e-5 * largest:
            # the bias of a convolution that a batch norm follows: its
            # gradient vanishes in exact arithmetic, both sides hold
            # rounding noise only
            assert float(np.abs(g).max()) < ATOL * largest, key
            continue
        np.testing.assert_allclose(g, want[key], rtol=0, atol=ATOL * scale,
                                   err_msg=key)
    np.testing.assert_allclose(
        xt.grad.numpy(), np.asarray(grad_x), rtol=0,
        atol=ATOL * float(np.abs(np.asarray(grad_x)).max()))


@pytest.mark.parametrize('side', ['both', 'front', 'end', ['front', None]])
@pytest.mark.parametrize('size', [3, 4, (2, 0)])
def test_pad_and_trim_match_jax(side, size):
    if isinstance(side, list) and not isinstance(size, tuple):
        size = (size, 0)
    x = np.random.RandomState(5).randn(2, 3, 6, 7).astype(np.float32)
    padded = conv.Pad(side=side)(torch.from_numpy(x), size)
    np.testing.assert_array_equal(
        padded.numpy(),
        np.asarray(jax_conv.Pad(side=side)(jnp.asarray(x), size)))
    np.testing.assert_array_equal(
        conv.Trim(side=side)(padded, size).numpy(), x)


@pytest.mark.parametrize('n', [1, 2])
def test_max_pool_indices_match_jax(n):
    rng = np.random.RandomState(6)
    if n == 1:
        x = rng.randn(2, 3, 11).astype(np.float32)
        args = (3, 2)
        got = conv._max_pool_indices_1d(torch.from_numpy(x), *args)
        want = jax_conv._max_pool_indices_1d(jnp.asarray(x), *args)
    else:
        x = rng.randn(2, 3, 9, 11).astype(np.float32)
        x[..., :2, :2] = 1.5       # ties: the first maximum is taken
        args = ((2, 3), (2, 2))
        got = conv._max_pool_indices_2d(torch.from_numpy(x), *args)
        want = jax_conv._max_pool_indices_2d(jnp.asarray(x), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pool = (conv.Pool1d if n == 1 else conv.Pool2d)(pool_size=args[0],
                                                    pool_stride=args[1])
    y, seq_len, indices = pool(torch.from_numpy(x), [x.shape[-1]] * 2,
                               return_indices=True)
    y_plain, _ = pool(torch.from_numpy(x), [x.shape[-1]] * 2)
    np.testing.assert_array_equal(y.numpy(), y_plain.numpy())


@pytest.mark.parametrize('pad_type', ['both', 'front', 'end', None])
@pytest.mark.parametrize('kernel,dilation,stride', [(3, 1, 1), (4, 2, 2),
                                                    (5, 1, 3)])
def test_length_helpers_match_jax(pad_type, kernel, dilation, stride):
    lengths = np.arange(9, 30)
    for transpose in (False, True):
        np.testing.assert_array_equal(
            conv.compute_conv_output_sequence_lengths(
                lengths, kernel, dilation, pad_type, stride, transpose),
            jax_conv.compute_conv_output_sequence_lengths(
                lengths, kernel, dilation, pad_type, stride, transpose))
        np.testing.assert_array_equal(
            conv.compute_conv_output_shape(
                (2, 3, 17, 29), 4, kernel, dilation, stride, pad_type,
                transpose),
            jax_conv.compute_conv_output_shape(
                (2, 3, 17, 29), 4, kernel, dilation, stride, pad_type,
                transpose))
    layer = conv.Conv1d(2, 2, kernel, dilation=dilation, stride=stride,
                        pad_type=pad_type)
    got = layer.get_out_lengths(torch.as_tensor(lengths))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(
        got.numpy(), conv.compute_conv_output_sequence_lengths(
            lengths, kernel, dilation, pad_type, stride))


def test_conv_layers_and_stacks_as_the_jax_tests_use_them():
    """The shape checks of ``tests/test_modules/test_je_conv.py``."""
    y, lens = conv.Conv1d(4, 8, 3, norm='sequence').eval()(
        torch.ones(2, 4, 20), seq_len=[20, 15])
    assert tuple(y.shape) == (2, 8, 20) and list(lens) == [20, 15]
    y, lens = conv.Conv1d(4, 8, 3, stride=2).eval()(
        torch.ones(2, 4, 20), seq_len=[20, 15])
    assert y.shape[-1] == conv.compute_conv_out_size(20, 3, 1, 2, 'both')
    assert list(lens) == [10, 8]
    y, _ = conv.Conv1d(4, 8, 3, gated=True).eval()(torch.ones(2, 4, 20))
    assert tuple(y.shape) == (2, 8, 20)
    cnn = conv.CNN1d(4, [8, 16, 16], 3, norm='batch', pool_size=[1, 2, 1])
    y, lens = cnn.eval()(torch.ones(2, 4, 32), seq_len=[32, 24])
    assert tuple(y.shape) == (2, 16, 16) and list(lens) == [16, 12]
    cnn = conv.CNN1d(4, [8, 16, 16], 3, residual_connections=[2, None, None])
    assert '0->2' in cnn.residual_skip_convs
    assert cnn.get_receptive_field()[0] == 7
    cnn = conv.CNN2d(1, [8, 8, 8], 3, residual_connections=[2, None, None])
    y, _ = cnn.eval()(torch.ones(2, 1, 16, 32), seq_len=[32, 20])
    assert tuple(y.shape) == (2, 8, 16, 32)
    assert list(cnn.residual_skip_convs) == ["0->2"]   # 1 -> 8 channels
