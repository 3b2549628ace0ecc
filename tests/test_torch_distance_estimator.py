"""The distance-estimation recipe of the port against the JAX package's,
on the CPU.

- the features (``stft``, ``mag``, ``phase``, ``ild``, ``ipd``,
  ``diffuseness`` and a combination), coherence and the labelled batches
  of ``prepare``, at 1e-5 (numpy and scipy in both packages);
- the recipe's ``DistanceEstimator`` (``CNN2d``, a one-direction GRU of 64
  units, a masked mean) and the reference family of ``model.py``
  (``HybridCNN``, ``CRNN``, the class-quantized ``DistanceEstimator``, with
  post- and pre-activation batch norm and with the GLU branch; the head's
  dropout off), the
  weights moved by ``from_jax_state_dict``: outputs in train and eval mode
  and the review's numbers at 1e-4, the gradient of every parameter at
  1e-4 of its largest entry (a bias that a batch norm follows, whose
  gradient vanishes in exact arithmetic, below 1e-4 of the largest
  gradient entry);
- ``create_jsons`` on a tree of WAV files: the same JSON as the JAX
  script's;
- ``train.py`` then ``evaluate.py`` through their ``main`` on the CPU:
  ``config.json``, ``feature.json``, checkpoints, a ``Makefile``, the
  evaluation's numbers; the JAX model loads the storage dir and gives the
  port's estimates.
"""
import copy
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.examples.source_localization.distance_estimator \
    import (create_jsons as jax_create_jsons, data as jax_data,
            model as jax_family, train as jax_train)
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu_torch.contrib.examples.source_localization \
    .distance_estimator import create_jsons, data, evaluate, model, train
from padertorch_tpu_torch.migrate import (
    _jax_to_port, from_jax_state_dict, to_jax_state_dict)

torch.set_num_threads(2)

ATOL = 1e-4
FEATURES = ['stft', 'mag', 'phase', 'ild', 'ipd', 'diffuseness',
            'mag ild ipd diffuseness']


def _observation(seed, n=4000):
    return next(iter(data.synthetic_database(1, n, seed=seed)))


@pytest.mark.parametrize('feature', FEATURES)
def test_features_match_jax(feature):
    example = _observation(0)
    got = data.FeatureExtraction(feature=feature, low_freq_bin=2)(
        dict(example))
    want = jax_data.FeatureExtraction(feature=feature, low_freq_bin=2)(
        dict(example))
    assert got['features'].shape == want['features'].shape
    assert got['features'].shape[0] == data.FeatureExtraction(
        feature=feature).num_channels
    assert got['num_frames'] == want['num_frames']
    np.testing.assert_allclose(got['features'], want['features'], rtol=0,
                               atol=1e-5)
    x = np.asarray(data._stft(example['observation']))
    np.testing.assert_allclose(data.coherence(x), jax_data.coherence(x),
                               rtol=0, atol=1e-5)


def test_prepared_batches_match_jax():
    def batches(package):
        return list(package.prepare(
            package.synthetic_database(6, 3000, seed=1), batch_size=4,
            shuffle=False))
    for got, want in zip(batches(data), batches(jax_data)):
        assert got['example_id'] == want['example_id']
        for key in ('features', 'num_frames', 'distance', 'label'):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-5, err_msg=key)


def _recipe_models(seed):
    ptrandom.seed(seed)
    config = {'cnn': {'in_channels': 4, 'out_channels': [4, 8]},
              'num_freq_bins': 33, 'hidden_size': 16}
    jax_model = jax_train.DistanceEstimator.from_config(
        jax_train.DistanceEstimator.get_config(copy.deepcopy(config)))
    port = train.DistanceEstimator.from_config(
        train.DistanceEstimator.get_config(copy.deepcopy(config)))
    return jax_model, from_jax_state_dict(port, jax_model.state_dict())


# the head's dropout off: its masks come from different generators
NO_DROPOUT = {'fcn': {'dropout': 0.0}}
FAMILY = {
    'crnn': {'net': {'cnn': {'n_freq_bins': 32}, **NO_DROPOUT}},
    'crnn-post-bn': {'net': {'cnn': {
        'n_freq_bins': 32, 'cnn_2d': {'pre_activation': False},
        'cnn_1d': {'pre_activation': False}}, **NO_DROPOUT}},
    'crnn-glu': {'net': {'cnn': {
        'n_freq_bins': 32, 'cnn_2d': {'activation_fn': 'glu'}},
        **NO_DROPOUT}},
}


def _family_models(name, seed):
    ptrandom.seed(seed)
    config = FAMILY[name]
    jax_model = jax_family.DistanceEstimator.from_config(
        jax_family.DistanceEstimator.get_config(copy.deepcopy(config)))
    port = model.DistanceEstimator.from_config(
        model.DistanceEstimator.get_config(copy.deepcopy(config)))
    return jax_model, from_jax_state_dict(port, jax_model.state_dict())


def _batch(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == 'recipe':
        frames = np.array([30, 30, 22, 14], 'int32')
        x = rng.randn(4, 4, 33, 30).astype('float32')
        x *= (np.arange(30) < frames[:, None])[:, None, None, :]
        distance = rng.uniform(0.5, 3.0, 4).astype('float32')
        return {'features': x, 'num_frames': frames, 'distance': distance}
    distance = rng.uniform(0.0, 3.0, 4).astype('float32')
    return {'features': rng.randn(4, 1, 32, 20).astype('float32'),
            'distance': distance,
            'label': np.round(distance / 0.1).astype('int64')}


def _models(name, seed):
    if name == 'recipe':
        return _recipe_models(seed)
    return _family_models(name, seed)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


MODELS = ['recipe', *FAMILY]


@pytest.mark.parametrize('mode', ['train', 'eval'])
@pytest.mark.parametrize('name', MODELS)
def test_forward_and_review_match_jax(name, mode):
    kind = 'recipe' if name == 'recipe' else 'family'
    jax_model, port = _models(name, 0)
    if mode == 'eval':
        jax_model.train()(_jnp(_batch(kind, 0)))
        port.train()(_torch(_batch(kind, 0)))
    getattr(jax_model, mode)()
    getattr(port, mode)()
    batch = _batch(kind, 1)
    want = jax_model(_jnp(batch))
    with torch.no_grad():
        got = port(_torch(batch))
        review = port.review(_torch(batch), got)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    want_review = jax_model.review(_jnp(batch), want)
    np.testing.assert_allclose(float(review['loss']),
                               float(want_review['loss']), rtol=ATOL)
    for key, value in want_review['scalars'].items():
        np.testing.assert_allclose(review['scalars'][key].numpy(),
                                   np.asarray(value), rtol=ATOL, atol=ATOL,
                                   err_msg=key)
    stats = to_jax_state_dict(port)
    assert set(stats) == set(jax_model.state_dict())
    for key, value in jax_model.state_dict().items():
        np.testing.assert_allclose(stats[key], np.asarray(value), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize('name', MODELS)
def test_gradients_match_jax(name):
    kind = 'recipe' if name == 'recipe' else 'family'
    jax_model, port = _models(name, 1)
    batch = _batch(kind, 2)
    params, static = partition(jax_model)

    def jax_loss(params):
        net = combine(params, static)
        return net.review(_jnp(batch), net(_jnp(batch)))['loss']

    want = {k: np.asarray(v)
            for k, v in state_dict(jax.grad(jax_loss)(params)).items()}
    port.review(_torch(batch), port(_torch(batch)))['loss'].backward()
    trainable = {id(p) for p in port.parameters()}
    got = {key: targets[0][1](targets[0][0].grad.numpy())
           for key, targets in _jax_to_port(port).items()
           if id(targets[0][0]) in trainable}
    assert set(got) == set(want)
    largest = max(float(np.abs(v).max()) for v in want.values())
    for key, w in want.items():
        scale = float(np.abs(w).max())
        if scale < 1e-5 * largest:
            assert float(np.abs(got[key]).max()) < ATOL * largest, key
            continue
        np.testing.assert_allclose(got[key], w, rtol=0, atol=ATOL * scale,
                                   err_msg=key)


def test_family_summary_matches_jax():
    jax_model, port = _family_models('crnn', 0)

    def summary():
        return {'scalars': {'target': [3, 4, 7, 2], 'est_cls': [3, 5, 1, 2],
                            'rmse': [1.0, 4.0, 0.25, 0.0],
                            'mae': [1.0, 2.0, 0.5, 0.0]},
                'buffers': {}, 'snapshots': {}}
    got = port.modify_summary(summary())['scalars']
    want = jax_model.modify_summary(summary())['scalars']
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_create_jsons_indexes_a_wav_tree_as_jax(tmp_path):
    rir_path, signal_path = create_jsons.make_synthetic_tree(tmp_path / 'a')
    jax_rir, jax_signal = jax_create_jsons.make_synthetic_tree(
        tmp_path / 'b')
    for got, want in ((rir_path, jax_rir), (signal_path, jax_signal)):
        for path in sorted(got.rglob('*')):
            twin = want / path.relative_to(got)
            assert path.is_dir() or path.read_bytes() == twin.read_bytes()
    assert create_jsons.index_rir_database(rir_path) == \
        jax_create_jsons.index_rir_database(rir_path)
    assert create_jsons.index_signal_database(signal_path) == \
        jax_create_jsons.index_signal_database(signal_path)
    argv = sys.argv
    sys.argv = ['create_jsons', '--synthetic', str(tmp_path / 'c'),
                '--out', str(tmp_path / 'db.json')]
    try:
        create_jsons.main()
    finally:
        sys.argv = argv
    from padertorch_tpu_torch.data.database import JsonDatabase
    db = JsonDatabase(tmp_path / 'db.json')
    assert db.dataset_names == ('rirs', 'source_signals')
    scenes = list(db.get_dataset('rirs'))
    assert len(scenes) == 3 and all(len(s['audio_path']['rir']) == 2
                                    and s['distance'] > 0 for s in scenes)
    assert len(db.get_dataset('source_signals')) == 4


def test_train_then_evaluate_and_the_jax_model_loads_it(tmp_path):
    argv = sys.argv
    try:
        sys.argv = ['train', '--storage_root', str(tmp_path), '--synthetic',
                    '--epochs', '1', '--device', 'cpu']
        train.main()
        storage_dir = tmp_path / 'distance' / '1'
        sys.argv = ['evaluate', '--model_path', str(storage_dir),
                    '--synthetic', '--device', 'cpu']
        evaluate.main()
    finally:
        sys.argv = argv
    for name in ('config.json', 'feature.json', 'Makefile',
                 'checkpoints/ckpt_latest.ptt', 'checkpoints/ckpt_best_mae.ptt'):
        assert (storage_dir / name).exists(), name
    makefile = (storage_dir / 'Makefile').read_text()
    assert (f'distance_estimator.evaluate --model_path {storage_dir} '
            '--synthetic --device cpu') in makefile
    result = json.loads(
        (storage_dir / 'eval' / 'evaluation_result.json').read_text())
    summary = result['summary']
    assert summary['num_examples'] == 32
    assert summary['pseudo_accuracy'] >= summary['accuracy']
    assert np.isfinite(summary['mae'])
    port = train.DistanceEstimator.from_storage_dir(
        storage_dir, checkpoint_name='ckpt_best_mae.ptt').eval()
    jax_model = jax_train.DistanceEstimator.from_storage_dir(
        storage_dir, checkpoint_name='ckpt_best_mae.ptt').eval()
    batch = next(iter(data.prepare(data.synthetic_database(4, seed=7),
                                   batch_size=4, shuffle=False)))
    with torch.no_grad():
        got = port(port.example_to_device(batch)).numpy()
    want = np.asarray(jax_model({k: batch[k] for k in
                                 ('features', 'num_frames')}))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    estimates = [v['estimate'] for v in result['examples'].values()]
    assert len(estimates) == 32 and np.isfinite(estimates).all()
