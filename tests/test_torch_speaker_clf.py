"""The port's speaker classifier against the JAX package's, on the CPU,
with both front ends: host STFTs through ``NormalizedLogMelExtractor`` and
raw audio through ``FusedAudioLogMelExtractor`` (on the CPU its composed
path, and its fused route's plain version with ``backend='pallas'``).

The same weights and running statistics (through ``from_jax_state_dict``)
and the same ragged batches, made with numpy, go through both packages at a
cut size (CNN channels (4, 8), 16 GRU units, 5 speakers).

- ``forward`` logits in training and eval mode, 1e-4;
- loss 1e-4 relative, accuracy equal, buffers equal;
- the gradient of every parameter, 1e-4 of its largest entry;
- three optimizer steps with ``Adam(lr=3e-4, gradient_clipping=10)`` (the
  recipe's) against the JAX ``Trainer``'s train step: losses and pre-clip
  norms 1e-3 relative, parameters and running statistics 1e-4;
- the weights' and statistics' round trip through both layouts, exact.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.examples.speaker_classification.supervised \
    .model import SpeakerClf as JaxSpeakerClf
from padertorch_tpu.contrib.je.modules import features as jax_features
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.train.optimizer import Adam as JaxAdam
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch.contrib.examples.speaker_classification \
    .supervised.model import SpeakerClf
from padertorch_tpu_torch.contrib.examples.speaker_classification \
    .supervised import train as clf_train
from padertorch_tpu_torch.contrib.je.modules import features
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.modules.recurrent import GRU
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

ATOL = 1e-4
SMALL = dict(num_speakers=5, cnn_channels=(4, 8), hidden_size=16)
FRONT_ENDS = ['stft', 'audio', 'audio-fused-route']


def _extractor(package, front_end):
    if front_end == 'stft':
        return package.NormalizedLogMelExtractor(16000, 512, 64)
    backend = 'auto'
    if front_end == 'audio-fused-route':
        # the port runs the fused route (its plain version on the CPU), the
        # JAX side its composed path
        backend = 'pallas' if package is features else 'jnp'
    return package.FusedAudioLogMelExtractor(16000, 512, 128, 64,
                                             backend=backend)


def _models(front_end, seed=0):
    ptrandom.seed(seed)
    jax_model = JaxSpeakerClf(_extractor(jax_features, front_end), **SMALL)
    port = from_jax_state_dict(
        SpeakerClf(_extractor(features, front_end), **SMALL),
        jax_model.state_dict())
    return jax_model, port


def _batch(front_end, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 5, 4).astype('int32')
    if front_end == 'stft':
        lens = np.array([19, 19, 12, 7], 'int32')
        x = rng.randn(4, 1, 19, 257, 2).astype('float32')
        x *= (np.arange(19)[None, :] < lens[:, None])[:, None, :, None, None]
        return {'stft': x, 'seq_len': lens, 'speaker_id': labels}
    lens = np.array([2500, 2500, 1800, 900], 'int32')
    x = (rng.randn(4, 2500) * 0.1).astype('float32')
    x *= np.arange(2500)[None, :] < lens[:, None]
    return {'audio_data': x, 'seq_len': lens, 'speaker_id': labels}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize('front_end', FRONT_ENDS)
def test_forward_and_review_match_jax(front_end):
    jax_model, port = _models(front_end)
    assert isinstance(port.gru, GRU) and not port.gru.bidirectional
    for mode in ('train', 'eval'):           # train first: statistics move
        getattr(jax_model, mode)()
        getattr(port, mode)()
        batch = _batch(front_end, 0)
        want = jax_model(_jnp(batch))
        want_review = jax_model.review(_jnp(batch), want)
        with torch.no_grad():
            got = port(_torch(batch))
            review = port.review(_torch(batch), got)
        assert tuple(got.shape) == want.shape == (4, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=mode)
        np.testing.assert_allclose(float(review['loss']),
                                   float(want_review['loss']), rtol=ATOL)
        assert float(review['scalars']['accuracy']) == \
            float(want_review['scalars']['accuracy'])
        for key in ('predictions', 'labels'):
            np.testing.assert_array_equal(
                review['buffers'][key].numpy(),
                np.asarray(want_review['buffers'][key]))
    stats = to_jax_state_dict(port)
    for name, value in jax_model.state_dict().items():
        np.testing.assert_allclose(stats[name], np.asarray(value), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_modify_summary_computes_the_overall_accuracy():
    _, port = _models('audio')
    summary = {
        'scalars': {'accuracy': [0.5, 1.0]},
        'buffers': {'predictions': [np.array([1, 2]), np.array([3])],
                    'labels': [np.array([1, 0]), np.array([3])]},
        'snapshots': {},
    }
    out = port.modify_summary(summary)
    assert out['scalars']['overall_accuracy'] == pytest.approx(2 / 3)
    assert out['scalars']['accuracy'] == pytest.approx(0.75)
    assert not out['buffers']


@pytest.mark.parametrize('front_end', FRONT_ENDS)
def test_gradients_match_jax(front_end):
    jax_model, port = _models(front_end, seed=2)
    batch = _batch(front_end, 2)
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        return model.review(_jnp(batch), model(_jnp(batch)))['loss']

    want = {k: np.asarray(v)
            for k, v in state_dict(jax.grad(jax_loss)(params)).items()}
    port.review(_torch(batch), port(_torch(batch)))['loss'].backward()
    got = {}
    names = {id(p): n for n, p in port.named_parameters()}
    from padertorch_tpu_torch.migrate import _jax_to_port
    for jax_name, targets in _jax_to_port(port).items():
        param, convert = targets[0]
        if id(param) in names and param.requires_grad:
            got[jax_name] = convert(param.grad.numpy())
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name], w, rtol=0, atol=ATOL * float(np.abs(w).max()),
            err_msg=name)


@pytest.mark.parametrize('front_end', FRONT_ENDS)
def test_three_adam_steps_match_the_jax_trainer(front_end, tmp_path):
    jax_model, port = _models(front_end, seed=3)
    batches = [_batch(front_end, 10 + i) for i in range(3)]
    jax_trainer = JaxTrainer(
        jax_model, tmp_path / 'jax',
        JaxAdam(lr=3e-4, gradient_clipping=10.0))
    step = jax_trainer._get_fn('train', jax_trainer._make_train_step)
    params, static = partition(jax_trainer.model)
    trainer = Trainer(port.train(), tmp_path / 'port',
                      Adam(lr=3e-4, gradient_clipping=10.0))
    for i, batch in enumerate(batches):
        key = jax.random.fold_in(jax_trainer._base_key, i)
        params, static, states, want_loss, _, _, norms = step(
            params, static, jax_trainer._opt_states, _jnp(batch), key,
            jax_trainer._loss_weight_arrays())
        jax_trainer._set_opt_states(states)
        want_params = {k: np.asarray(v) for k, v in state_dict(
            combine(params, static)).items()}
        loss, _, _, _ = trainer.train_step(trainer.model, batch)
        loss.backward()
        norm = trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(norm), float(norms['']), rtol=1e-3)
        got_params = to_jax_state_dict(port)
        assert set(got_params) == set(want_params)
        for name in want_params:
            np.testing.assert_allclose(
                got_params[name], want_params[name], atol=ATOL, rtol=1e-5,
                err_msg=f'step {i} {name}')
    assert float(got_params['feature_extractor.norm.num_tracked_values']
                 .max()) > 0


@pytest.mark.parametrize('front_end', ['stft', 'audio'])
def test_weights_and_statistics_round_trip_exactly(front_end):
    jax_model, port = _models(front_end, seed=4)
    port.train()(_torch(_batch(front_end, 4)))      # move the statistics
    got = to_jax_state_dict(port)
    assert 'cnn.layers.0.weight' in got and 'cnn.layers.2.bias' in got
    assert got['cnn.layers.0.weight'].shape == (4, 1, 3, 3)
    assert got['gru.w_ih.0'].shape == (8 * 16, 3 * 16)
    assert got['head.weight'].shape == (16, 5)
    assert set(got) == set(jax_model.state_dict())
    again = SpeakerClf(_extractor(features, front_end), **SMALL)
    again = to_jax_state_dict(from_jax_state_dict(again, got))
    for name in got:
        np.testing.assert_array_equal(again[name], got[name], err_msg=name)
    loaded = jax_model.load_state_dict(got)     # and the JAX model takes it
    batch = _batch(front_end, 5)
    with torch.no_grad():
        want = port.eval()(_torch(batch)).numpy()
    np.testing.assert_allclose(np.asarray(loaded.eval()(_jnp(batch))), want,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize('on_device', [False, True])
def test_recipe_config_is_the_jax_recipes(on_device, tmp_path):
    """As written to ``config.json``: class paths ``padertorch_tpu.``, the
    recipe's sizes, the fused extractor with ``--on_device_features``."""
    config = clf_train.get_trainer_config(tmp_path, 8, on_device)
    from padertorch_tpu_torch.io import dumps_config
    dumped = json.loads(dumps_config(config))
    model = dumped['model']
    assert model['factory'] == (
        'padertorch_tpu.contrib.examples.speaker_classification.supervised'
        '.model.SpeakerClf')
    assert (model['num_speakers'], model['cnn_channels'],
            model['hidden_size']) == (8, [16, 32], 64)
    extractor = model['feature_extractor']
    want = ('FusedAudioLogMelExtractor' if on_device
            else 'NormalizedLogMelExtractor')
    assert extractor['factory'] == \
        f'padertorch_tpu.contrib.je.modules.features.{want}'
    assert extractor['number_of_filters'] == 64
    if on_device:
        assert (extractor['shift'], extractor['backend'],
                extractor['fading']) == (128, 'auto', 'full')
    # the JAX package builds its model from the same dict
    from padertorch_tpu.configurable import Configurable as JaxConfigurable
    jax_model = JaxConfigurable.from_config(model)
    assert type(jax_model).__name__ == 'SpeakerClf'
    assert dumped['optimizer']['lr'] == 3e-4
    # the class defaults are the full width
    full = SpeakerClf.get_config()
    assert (full['num_speakers'], list(full['cnn_channels']),
            full['hidden_size']) == (251, [32, 64], 256)
