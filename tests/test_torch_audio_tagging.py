"""The audio-tagging recipe of the port against the JAX package's, on the
CPU.

- ``WALNet`` (cut to a CNN of (4, 8, 8) channels) with the weights and
  batch-norm statistics moved by ``from_jax_state_dict``: logits, loss and
  buffers in train and eval mode at 1e-4, the gradient of every parameter
  at 1e-4 of its largest entry (the biases that a batch norm follows,
  whose gradients vanish in exact arithmetic, below 1e-4 of the largest
  gradient entry), and the round trip of weights and statistics;
- the multilabel metrics (mAP, mAUC, lwlrap, F1) at 1e-6, a class without
  positives among the targets;
- ``get_datasets`` on an AudioSet-style WAV tree (stereo, int32 and 8 kHz
  files among int16 ones; buckets up to half padding, so that batches are
  ragged): the training batches under the same numpy seed (shuffle,
  random gain, mixup), the validation and evaluation batches, bit for bit,
  and the ``eventss.json`` the encoder stores;
- mixup: ``_superpose``, ``_MixUpDataset`` and ``log_truncated_normal``
  with the same generators;
- a storage dir that the port's ``train.py`` wrote loads into the JAX
  ``WALNet``, which gives the port's logits.
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
from padertorch_tpu.contrib.examples.sound_recognition.audio_tagging import (
    data as jax_data, train as jax_train)
from padertorch_tpu.evaluation import multilabel as jax_multilabel
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu_torch.contrib.examples import _wav_databases as wav_dbs
from padertorch_tpu_torch.contrib.examples.sound_recognition.audio_tagging \
    import data, train
from padertorch_tpu_torch.evaluation import multilabel
from padertorch_tpu_torch.migrate import (
    _jax_to_port, from_jax_state_dict, to_jax_state_dict)

torch.set_num_threads(2)

ATOL = 1e-4
SMALL = {'cnn': {'out_channels': [4, 8, 8]}, 'num_events': 5}
STFT = dict(shift=160, size=512, window_length=400, pad=True, fading=None)


def _models(seed=0):
    ptrandom.seed(seed)
    jax_model = jax_train.WALNet.from_config(jax_train.WALNet.get_config(
        copy.deepcopy(SMALL)))
    port = train.WALNet.from_config(train.WALNet.get_config(
        copy.deepcopy(SMALL)))
    return jax_model, from_jax_state_dict(port, jax_model.state_dict())


def _batch(seed):
    rng = np.random.RandomState(seed)
    seq_len = np.array([23, 17, 9], 'int32')
    stft = rng.randn(3, 1, 23, 257, 2).astype('float32')
    stft *= (np.arange(23) < seq_len[:, None])[:, None, :, None, None]
    events = (rng.rand(3, 5) < 0.4).astype('float32')
    return {'stft': stft, 'seq_len': seq_len, 'events': events}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_forward_and_review_match_jax(mode):
    jax_model, port = _models()
    if mode == 'eval':
        jax_model.train()(_jnp(_batch(0)))
        port.train()(_torch(_batch(0)))
    getattr(jax_model, mode)()
    getattr(port, mode)()
    batch = _batch(1)
    want = jax_model(_jnp(batch))
    want_review = jax_model.review(_jnp(batch), want)
    with torch.no_grad():
        got = port(_torch(batch))
        review = port.review(_torch(batch), got)
    assert tuple(got.shape) == want.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(review['loss']),
                               float(want_review['loss']), rtol=ATOL)
    for key in ('scores', 'targets'):
        np.testing.assert_allclose(
            review['buffers'][key].numpy(),
            np.asarray(want_review['buffers'][key]), rtol=0, atol=ATOL)
    stats = to_jax_state_dict(port)
    assert set(stats) == set(jax_model.state_dict())
    for name, value in jax_model.state_dict().items():
        np.testing.assert_allclose(stats[name], np.asarray(value), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_gradients_match_jax():
    jax_model, port = _models(seed=1)
    batch = _batch(2)
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        return model.review(_jnp(batch), model(_jnp(batch)))['loss']

    want = {k: np.asarray(v)
            for k, v in state_dict(jax.grad(jax_loss)(params)).items()}
    port.review(_torch(batch), port(_torch(batch)))['loss'].backward()
    trainable = {id(p) for p in port.parameters()}
    got = {name: targets[0][1](targets[0][0].grad.numpy())
           for name, targets in _jax_to_port(port).items()
           if id(targets[0][0]) in trainable}
    assert set(got) == set(want)
    largest = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        scale = float(np.abs(w).max())
        if scale < 1e-5 * largest:
            assert float(np.abs(got[name]).max()) < ATOL * largest, name
            continue
        np.testing.assert_allclose(got[name], w, rtol=0, atol=ATOL * scale,
                                   err_msg=name)


def test_modify_summary_computes_the_metrics_as_jax():
    jax_model, port = _models()
    rng = np.random.RandomState(3)
    scores = [rng.rand(4, 5).astype('float32') for _ in range(2)]
    targets = [(rng.rand(4, 5) < 0.5).astype('float32') for _ in range(2)]

    def summary():
        return {'scalars': {}, 'buffers': {'scores': list(scores),
                                           'targets': list(targets)},
                'snapshots': {}}
    got = port.modify_summary(summary())['scalars']
    want = jax_model.modify_summary(summary())['scalars']
    assert set(got) == set(want) == {'mAP', 'mAUC', 'lwlrap', 'mF1'}
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


@pytest.mark.parametrize('metric', ['mean_average_precision', 'mean_auc',
                                    'lwlrap', 'fscore', 'average_precision',
                                    'auc'])
def test_multilabel_metrics_match_jax(metric):
    rng = np.random.RandomState(4)
    scores = rng.rand(40, 6)
    targets = (rng.rand(40, 6) < 0.3).astype(int)
    targets[:, 2] = 0                  # a class without positives
    targets[0] = 0                     # and an example without labels
    scores[5, 1] = scores[6, 1]        # a tie
    if metric in ('average_precision', 'auc'):
        args = (scores[:, 0], targets[:, 0])
    else:
        args = (scores, targets)
    got = getattr(multilabel, metric)(*args)
    want = getattr(jax_multilabel, metric)(*args)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope='module')
def audioset(tmp_path_factory):
    return wav_dbs.write_audioset(tmp_path_factory.mktemp('audioset'),
                                  min_samples=4000)


@pytest.mark.parametrize('mixup', [(1,), (0.5, 0.5)])
def test_get_datasets_on_wav_files_equal_the_jax_pipeline(
        audioset, mixup, tmp_path):
    outs = {}
    for name, package in (('port', data), ('jax', jax_data)):
        splits = package.get_datasets(
            audioset, audio_reader={'target_sample_rate': 16000},
            stft=dict(STFT), batch_size=2, storage_dir=tmp_path / name,
            num_workers=0, mixup_probs=mixup, min_mixup_overlap=0.5,
            max_padding_rate=0.5)
        np.random.seed(5)
        outs[name] = [list(split) for split in splits]
        outs[name + '_labels'] = (tmp_path / name / 'eventss.json'
                                  ).read_text()
    assert outs['port_labels'] == outs['jax_labels']
    assert json.loads(outs['port_labels']) == sorted(wav_dbs.EVENTS)
    for got_split, want_split in zip(outs['port'], outs['jax']):
        assert len(got_split) == len(want_split) > 0
        for got, want in zip(got_split, want_split):
            assert set(got) == set(want)
            for key in want:
                if isinstance(want[key], np.ndarray):
                    assert got[key].dtype == want[key].dtype, key
                    np.testing.assert_array_equal(got[key], want[key],
                                                  err_msg=key)
                else:
                    assert got[key] == want[key], key
    ids = [i for b in outs['port'][0] for i in b['example_id']]
    assert any('+' in i for i in ids) == (len(mixup) > 1)
    # ragged: the evaluation batches pad their shorter clips
    assert all(len(set(b['seq_len'].tolist())) > 1 for b in outs['port'][2])


def test_mixup_draws_as_the_jax_package():
    rng = np.random.RandomState(6)
    examples = [{'dataset': '', 'example_id': f'e{i}',
                 'stft': rng.randn(1, 5 + i, 4).astype(np.float32),
                 'seq_len': 5 + i,
                 'events': (rng.rand(3) > 0.5).astype(np.float32)}
                for i in range(10)]
    for seed in range(3):
        got = data._superpose(examples[0], examples[seed + 4], 0.3, 7,
                              np.random.RandomState(seed))
        want = jax_data._superpose(examples[0], examples[seed + 4], 0.3, 7,
                                   np.random.RandomState(seed))
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]))
    np.testing.assert_array_equal(
        data.log_truncated_normal(50, rng=np.random.RandomState(7)),
        jax_data.log_truncated_normal(50, rng=np.random.RandomState(7)))
    from padertorch_tpu.data import dataset as jax_lazy
    from padertorch_tpu_torch.data import dataset as lazy
    got = data._MixUpDataset(lazy.from_list(examples), (0.3, 0.7), 0.5,
                             None, buffer_size=4, seed=1)
    want = jax_data._MixUpDataset(jax_lazy.from_list(examples), (0.3, 0.7),
                                  0.5, None, buffer_size=4, seed=1)
    for _ in range(2):                  # two epochs: re-drawn alike
        epoch_got, epoch_want = list(got), list(want)
        assert [e['example_id'] for e in epoch_got] == \
            [e['example_id'] for e in epoch_want]
        for g, w in zip(epoch_got, epoch_want):
            np.testing.assert_array_equal(g['stft'], w['stft'])
            np.testing.assert_array_equal(g['events'], w['events'])


def test_a_port_storage_dir_loads_into_the_jax_model(tmp_path):
    argv = sys.argv
    sys.argv = ['train', '--storage_root', str(tmp_path), '--synthetic',
                '--epochs', '1', '--device', 'cpu']
    try:
        train.main()
    finally:
        sys.argv = argv
    storage_dir = tmp_path / 'tagging' / '1'
    config = json.loads((storage_dir / 'config.json').read_text())
    assert config['trainer']['model']['factory'] == (
        'padertorch_tpu.contrib.examples.sound_recognition.audio_tagging'
        '.train.WALNet')
    assert config['trainer']['model']['cnn']['factory'] == \
        'padertorch_tpu.contrib.je.modules.conv.CNN2d'
    port = train.WALNet.from_storage_dir(
        storage_dir, checkpoint_name='ckpt_latest.ptt').eval()
    jax_model = jax_train.WALNet.from_storage_dir(
        storage_dir, checkpoint_name='ckpt_latest.ptt').eval()
    batch = next(iter(train.prepare(train.synthetic_database(4, seed=3),
                                    batch_size=4, shuffle=False)))
    with torch.no_grad():
        got = port(port.example_to_device(batch)).numpy()
    want = np.asarray(jax_model({k: batch[k] for k in
                                 ('stft', 'seq_len', 'events')}))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
