"""The port's Conv-TasNet (``modules/convnet.py`` and ``TasNet`` with a
``ConvNet`` separator) against the JAX package's, on the CPU.

The same weights (through ``from_jax_state_dict``; the norms' ``gamma`` and
``beta`` made random first, so that they count) and the same inputs, made
with numpy from a seed, go through both packages.  Sizes are cut (2 blocks
x 2 repeats of 32 hidden channels on 16 features; 32 filters) and the
batch is ragged, so gLN's statistics take in the padding, as the
reference's do.

- both norms, the pad split for odd and even totals, ``Conv1d`` with and
  without a norm, ``_Conv1DBlock``, ``ConvNet``: 1e-4 (sums in another
  order);
- ``TasNet`` with a ``ConvNet`` separator: forward, the three losses (1e-4
  relative) and every gradient (1e-4 of each one's largest entry);
- ``PReLU``'s derivative at 0 is 1, as ``jnp.where(x >= 0, ...)``'s;
- one bf16 policy step of the recipe's ``convnet`` variant against the JAX
  step's loss, 1e-2 relative (``tests/test_torch_precision.py``);
- the weights' round trip through both layouts, exact;
- the recipe's ``--variant convnet``: ``get_trainer_config`` and a small
  ``test_run`` on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models import tasnet as jax_tasnet
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules import convnet as jax_convnet
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.models import tasnet
from padertorch_tpu_torch.modules import convnet
from tests.test_torch_precision import (
    _assert_masters_float32, _jax_step_loss, _port_step_loss,
    _tasnet_pair)

torch.set_num_threads(2)

ATOL = 1e-4
SEPARATOR = dict(input_size=16, num_blocks=2, num_repeats=2,
                 hidden_channels=32)


def _randomize_norms(jax_module, seed):
    """The JAX module with every norm's gamma and beta drawn at random."""
    rng = np.random.RandomState(seed)
    sd = {k: np.asarray(v) for k, v in jax_module.state_dict().items()}
    for key in sd:
        if key.endswith(('.gamma', '.beta')) or key in ('gamma', 'beta'):
            sd[key] = (1 + 0.3 * rng.randn(*sd[key].shape)).astype(
                'float32')
    return jax_module.load_state_dict(
        {k: jnp.asarray(v) for k, v in sd.items()})


def _pair(make_jax, make_port, seed=0):
    ptrandom.seed(seed)
    jax_module = _randomize_norms(make_jax(), seed)
    return jax_module, from_jax_state_dict(make_port(),
                                           jax_module.state_dict())


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


@pytest.mark.parametrize('name', ['GlobalLayerNorm', 'ChannelwiseLayerNorm'])
def test_norms_match_jax(name):
    jax_norm, norm = _pair(lambda: getattr(jax_convnet, name)(6),
                           lambda: getattr(convnet, name)(6))
    x = _x(0, (3, 6, 11)) * 2 + 0.5
    _close(norm(torch.from_numpy(x)), jax_norm(jnp.asarray(x)))
    assert norm.gamma.shape == (1, 6, 1) and norm.beta.shape == (1, 6, 1)


@pytest.mark.parametrize('kernel_size, dilation', [
    (3, 1), (3, 4), (2, 1), (4, 3), (5, 2)])
@pytest.mark.parametrize('pad_type', ['both', 'front', 'end', None])
def test_pad_split_for_odd_and_even_totals(kernel_size, dilation, pad_type):
    """``total // 2`` in front and ``ceil(total / 2)`` at the end, and the
    conv's output with that padding equal to the JAX one."""
    want = jax_convnet.compute_pad_size(kernel_size, dilation, 1, pad_type)
    assert convnet.compute_pad_size(
        kernel_size, dilation, 1, pad_type) == want
    if pad_type == 'both':
        total = dilation * (kernel_size - 1)
        assert want == (total // 2, total - total // 2)
    jax_conv, conv = _pair(
        lambda: jax_convnet.Conv1d(4, 5, kernel_size, dilation=dilation,
                                   pad_type=pad_type),
        lambda: convnet.Conv1d(4, 5, kernel_size, dilation=dilation,
                               pad_type=pad_type), seed=kernel_size)
    x = _x(1, (2, 4, 17))
    got, ref = conv(torch.from_numpy(x)), jax_conv(jnp.asarray(x))
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize('norm', [None, 'gLN', 'cLN'])
def test_conv1d_with_and_without_a_norm(norm):
    def make(package):
        return lambda: package.Conv1d(
            6, 8, 3, dilation=2, norm=package.build_norm(norm, 6),
            activation_fn='prelu')
    jax_conv, conv = _pair(make(jax_convnet), make(convnet), seed=2)
    x = _x(2, (3, 6, 13))
    _close(conv(torch.from_numpy(x)), jax_conv(jnp.asarray(x)))


def test_build_norm_refuses_an_unknown_norm():
    with pytest.raises(ValueError, match='BN'):
        convnet.build_norm('BN', 4)


@pytest.mark.parametrize('norm', ['gLN', 'cLN'])
def test_conv1d_block(norm):
    def make(package):
        return lambda: package._Conv1DBlock(8, 12, 3, dilation=2, norm=norm)
    jax_block, block = _pair(make(jax_convnet), make(convnet), seed=3)
    x = _x(3, (2, 8, 15))
    _close(block(torch.from_numpy(x)), jax_block(jnp.asarray(x)))


def test_convnet_matches_jax():
    jax_net, net = _pair(lambda: jax_convnet.ConvNet(**SEPARATOR),
                         lambda: convnet.ConvNet(**SEPARATOR), seed=4)
    x = _x(4, (3, 21, 16))
    _close(net(torch.from_numpy(x), [21, 15, 9]),
           jax_net(jnp.asarray(x), jnp.asarray([21, 15, 9])))
    assert net.hidden_size == net.input_size == 16


def test_prelu_derivative_at_zero_is_jax_s():
    from padertorch_tpu import nn as jax_nn
    x = np.asarray([-1.5, 0.0, 0.0, 2.0], 'float32')
    want = jax.grad(lambda v: jnp.sum(jax_nn.PReLU()(v)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    convnet.nn.PReLU()(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad.tolist() == [0.25, 1.0, 1.0, 1.0]


def _build(package, conv_package):
    return package.TasNet(
        encoder=package.TasEncoder(20, feature_size=32),
        separator=conv_package.ConvNet(**SEPARATOR),
        decoder=package.TasDecoder(20, feature_size=32))


def _models(seed):
    return _pair(lambda: _build(jax_tasnet, jax_convnet),
                 lambda: _build(tasnet, convnet), seed=seed)


def _batch(seed, samples=403):
    rng = np.random.RandomState(seed)
    lens = np.array([samples, samples - 70, samples - 151], dtype='int32')
    valid = (np.arange(samples)[None, :] < lens[:, None]).astype('float32')
    s = (rng.randn(3, 2, samples) * 0.3).astype('float32') * valid[:, None]
    return {'y': s.sum(1).astype('float32'), 's': s, 'num_samples': lens}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: v if k == 'num_samples' else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope='module')
def tasnet_pair():
    return _models(5)


def test_tasnet_forward_and_losses_match_jax(tasnet_pair):
    jax_model, port = tasnet_pair
    batch = _batch(0)
    want = jax_model(_jnp(batch))
    want_losses = jax_model.loss(_jnp(batch), want)
    with torch.no_grad():
        got = port.eval()(_torch(batch))
        got_losses = port.loss(_torch(batch), got)
    np.testing.assert_array_equal(got.pop('encoded_sequence_lengths'),
                                  np.asarray(want.pop(
                                      'encoded_sequence_lengths')))
    assert got.keys() == want.keys()
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        _close(got[key], want[key])
    assert got_losses.keys() == want_losses.keys() == {
        'si-sdr', 'log-mse', 'log1p-mse'}
    for key in got_losses:
        np.testing.assert_allclose(float(got_losses[key]),
                                   float(want_losses[key]), rtol=ATOL,
                                   err_msg=key)


def test_tasnet_gradients_match_jax(tasnet_pair):
    """The gradient of the weighted loss for every parameter, 1e-4 of each
    gradient's largest entry."""
    jax_model, port = tasnet_pair
    batch = _batch(2)
    weights = {'si-sdr': 1.0, 'log-mse': 0.3, 'log1p-mse': 0.2}
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        losses = model.loss(_jnp(batch), model(_jnp(batch)))
        return sum(weights[k] * v for k, v in losses.items())

    want = state_dict(jax.grad(jax_loss)(params))
    port.zero_grad()
    losses = port.train().loss(_torch(batch), port(_torch(batch)))
    sum(weights[k] * v for k, v in losses.items()).backward()
    grads = _build(tasnet, convnet)
    with torch.no_grad():
        for (name, p), g in zip(port.named_parameters(),
                                grads.parameters()):
            assert p.grad is not None, name
            g.copy_(p.grad)
    got = to_jax_state_dict(grads)
    assert got.keys() == want.keys()
    for name in got:
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=ATOL * np.abs(w).max(), err_msg=name)


def test_weights_round_trip_exactly(tasnet_pair):
    jax_model, port = tasnet_pair
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    assert 'separator.conv_blocks.layers.1.layers.0.conv.conv.weight' in got
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    again = to_jax_state_dict(from_jax_state_dict(
        _build(tasnet, convnet), got))
    for name in want:
        np.testing.assert_array_equal(again[name], want[name], err_msg=name)
    # the depthwise conv is OIH, (hidden, 1, kernel), in both
    assert got['separator.conv_blocks.layers.0.layers.1.conv.conv.weight'] \
        .shape == (32, 1, 3)


def test_one_bf16_policy_step_matches_the_jax_step(tmp_path):
    jax_trainer, port, batch = _tasnet_pair(tmp_path, 'convnet', SEPARATOR)
    got = _port_step_loss(port, batch)
    want = _jax_step_loss(jax_trainer, batch)
    np.testing.assert_allclose(got, want, rtol=1e-2)
    _assert_masters_float32(port)


def test_recipe_variant_config_and_a_small_test_run(tmp_path):
    from padertorch_tpu.contrib.examples.source_separation.tasnet import (
        train as jax_train)
    from padertorch_tpu_torch.contrib.examples.source_separation.tasnet \
        import data, train
    from padertorch_tpu_torch.io import dumps_config
    from padertorch_tpu.io import dumps_config as jax_dumps
    import json
    full = json.loads(dumps_config(train.get_trainer_config(
        tmp_path, variant='convnet')))
    want = json.loads(jax_dumps(jax_train.get_trainer_config(
        tmp_path, variant='convnet')))
    assert full['model'] == want['model']
    assert full['model']['separator'] == {
        'factory': 'padertorch_tpu.modules.convnet.ConvNet',
        'input_size': 256, 'num_blocks': 8, 'num_repeats': 4,
        'hidden_channels': 512, 'kernel_size': 3, 'norm': 'gLN'}
    from padertorch_tpu_torch.train.trainer import Trainer
    torch.manual_seed(0)
    trainer = Trainer.from_config(train.get_trainer_config(
        tmp_path / 'small', variant='convnet', updates={
            'model': {'encoder': {'feature_size': 16},
                      'separator': dict(SEPARATOR, hidden_channels=8)},
            'stop_trigger': (1, 'epoch')}))
    assert type(trainer.model.separator).__name__ == 'ConvNet'
    examples = data.synthetic_database(num_examples=4, num_samples=1200)
    trainer.test_run(
        data.prepare_dataset(examples, batch_size=2, segment_length=800,
                             shuffle=False, prefetch=False),
        data.prepare_dataset(examples, batch_size=2, segment_length=800,
                             shuffle=False, prefetch=False))
