"""The port's SepFormer-TasNet against the JAX package's, on the CPU.

The same weights (through ``from_jax_state_dict``) and the same ragged
batches, made with numpy, go through both packages, on the dense attention
backend and on the fused one (the JAX side runs the Pallas attention kernel
in its interpreter, the port the kernels' plain version).  Sizes are cut (32
filters, one block of one intra- and one inter-chunk layer on 16 features,
2 heads, chunks of 10).

- ``forward``: every key of the output dict, 1e-4;
- the three losses, 1e-4 relative;
- the gradient of a weighted sum of the losses for every parameter, 1e-4
  of each gradient's largest entry;
- three optimizer steps with ``Adam(gradient_clipping=5)`` (the recipe's)
  against the JAX ``Trainer``'s train step: losses and pre-clip gradient
  norms 1e-3 relative, every parameter after each step 1e-4;
- the weights' round trip through both layouts, exact.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.mk.modules.transformer import (
    set_attention_backend as jax_set_attention_backend)
from padertorch_tpu.models import tasnet as jax_tasnet
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules.dual_path_transformer import (
    DualPathTransformer as JaxDualPathTransformer)
from padertorch_tpu.train.optimizer import Adam as JaxAdam
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    set_attention_backend)
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.models import tasnet
from padertorch_tpu_torch.modules.dual_path_transformer import (
    DualPathTransformer)
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

ATOL = 1e-4
LOSS_WEIGHTS = {'si-sdr': 1.0, 'log-mse': 0.0, 'log1p-mse': 0.0}
SEPARATOR = dict(input_size=16, window_length=10, hop_size=5, num_blocks=1,
                 num_layers_intra=1, num_layers_inter=1, num_heads=2)


def _build(package, separator):
    return package.TasNet(
        encoder=package.TasEncoder(20, feature_size=32),
        separator=separator(**SEPARATOR),
        decoder=package.TasDecoder(20, feature_size=32))


def _models(use_flash, seed=0):
    ptrandom.seed(seed)
    jax_model = _build(jax_tasnet, JaxDualPathTransformer)
    port = from_jax_state_dict(_build(tasnet, DualPathTransformer),
                               jax_model.state_dict())
    jax_set_attention_backend(jax_model, use_flash)
    set_attention_backend(port, use_flash)
    return jax_model, port


def _batch(seed, samples=403):
    rng = np.random.RandomState(seed)
    lens = np.array([samples, samples - 70, samples - 151], dtype='int32')
    valid = (np.arange(samples)[None, :] < lens[:, None]).astype('float32')
    s = (rng.randn(3, 2, samples) * 0.3).astype('float32') * valid[:, None]
    return {'y': s.sum(1).astype('float32'), 's': s, 'num_samples': lens}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    """As ``TasNet.example_to_device`` leaves it: lengths on the host."""
    return {k: v if k == 'num_samples' else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize('use_flash', [False, True])
def test_forward_and_losses_match_jax(use_flash):
    jax_model, port = _models(use_flash)
    batch = _batch(0)
    want = jax_model.eval()(_jnp(batch))
    want_losses = jax_model.loss(_jnp(batch), want)
    with torch.no_grad():
        got = port.eval()(_torch(batch))
        got_losses = port.loss(_torch(batch), got)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(
        got.pop('encoded_sequence_lengths'),
        np.asarray(want.pop('encoded_sequence_lengths')))
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert got['out'].shape == (3, 2, 403)
    assert got_losses.keys() == want_losses.keys() == set(LOSS_WEIGHTS)
    for key in got_losses:
        np.testing.assert_allclose(
            float(got_losses[key]), float(want_losses[key]), rtol=ATOL,
            err_msg=key)


@pytest.mark.parametrize('use_flash', [False, True])
def test_gradients_match_jax(use_flash):
    jax_model, port = _models(use_flash, seed=2)
    batch = _batch(2)
    weights = {'si-sdr': 1.0, 'log-mse': 0.3, 'log1p-mse': 0.2}
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        losses = model.loss(_jnp(batch), model(_jnp(batch)))
        return sum(weights[k] * v for k, v in losses.items())

    want = {k: np.asarray(v)
            for k, v in state_dict(jax.grad(jax_loss)(params)).items()}
    losses = port.loss(_torch(batch), port(_torch(batch)))
    sum(weights[k] * v for k, v in losses.items()).backward()
    grads = _build(tasnet, DualPathTransformer)
    with torch.no_grad():
        for (name, p), g in zip(port.named_parameters(),
                                grads.parameters()):
            assert p.grad is not None, name
            g.copy_(p.grad)
    got = to_jax_state_dict(grads)
    assert set(want) <= set(got)
    # a key bias has a zero gradient in exact arithmetic (a softmax does
    # not see a shift of all its logits): the floor follows the others
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name], w, rtol=0,
            atol=ATOL * max(float(np.abs(w).max()), floor), err_msg=name)


def _jax_train_steps(jax_model, clip, batches, tmp_path):
    """Losses, pre-clip norms and parameters after each step of the JAX
    Trainer's own (jitted) train step."""
    trainer = JaxTrainer(
        jax_model, tmp_path / 'jax', JaxAdam(gradient_clipping=clip),
        loss_weights=LOSS_WEIGHTS)
    step = trainer._get_fn('train', trainer._make_train_step)
    params, static = partition(trainer.model)
    out = []
    for i, batch in enumerate(batches):
        key = jax.random.fold_in(trainer._base_key, i)
        params, static, states, loss, _, _, norms = step(
            params, static, trainer._opt_states, _jnp(batch), key,
            trainer._loss_weight_arrays())
        trainer._set_opt_states(states)
        out.append((float(loss), float(norms['']),
                    {k: np.asarray(v) for k, v in state_dict(
                        combine(params, static)).items()}))
    return out


@pytest.mark.parametrize('use_flash', [False, True])
def test_three_adam_steps_match_the_jax_trainer(use_flash, tmp_path):
    jax_model, port = _models(use_flash, seed=3)
    batches = [_batch(10 + i) for i in range(3)]
    want = _jax_train_steps(jax_model, 5.0, batches, tmp_path)
    trainer = Trainer(port.train(), tmp_path / 'port',
                      Adam(gradient_clipping=5.0),
                      loss_weights=LOSS_WEIGHTS)
    for batch, (want_loss, want_norm, want_params) in zip(batches, want):
        loss, _, _, _ = trainer.train_step(trainer.model, batch)
        loss.backward()
        norm = trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        np.testing.assert_allclose(float(loss.detach()), want_loss,
                                   rtol=1e-3)
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-3)
        got_params = to_jax_state_dict(port)
        for name in want_params:
            np.testing.assert_allclose(
                got_params[name], want_params[name], atol=ATOL, rtol=0,
                err_msg=name)


def test_weights_round_trip_exactly():
    jax_model, port = _models('auto', seed=4)
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    again = to_jax_state_dict(
        from_jax_state_dict(_build(tasnet, DualPathTransformer), got))
    for name in want:
        np.testing.assert_array_equal(again[name], want[name], err_msg=name)


def test_two_evaluations_give_the_same_bits():
    """What the trainer's ``test_run`` demands of a model in eval mode."""
    _, port = _models(True, seed=5)
    batch = _torch(_batch(5))
    with torch.no_grad():
        a = port.eval()(batch)['out']
        b = port(batch)['out']
    assert torch.equal(a, b)


def test_dogmatic_config_with_a_sepformer_separator_is_the_jax_models():
    """As written to ``config.json``, where classes carry their
    ``padertorch_tpu.`` path in both packages."""
    from padertorch_tpu.io import dumps_config as jax_dumps
    from padertorch_tpu_torch.io import dumps_config
    path = ('padertorch_tpu.modules.dual_path_transformer'
            '.DualPathTransformer')
    want = json.loads(jax_dumps(jax_tasnet.TasNet.get_config(
        {'separator': {'factory': path}})))
    got = json.loads(dumps_config(tasnet.TasNet.get_config(
        {'separator': {'factory': DualPathTransformer}})))
    assert got == want
    assert got['separator']['factory'] == path
    assert got['separator']['input_size'] == 128
    assert got['separator']['num_blocks'] == 4
    assert got['separator']['num_heads'] == 8
    model = tasnet.TasNet.from_config(tasnet.TasNet.get_config({
        'encoder': {'feature_size': 32},
        'separator': {'factory': path, **SEPARATOR}}))
    assert isinstance(model.separator, DualPathTransformer)
