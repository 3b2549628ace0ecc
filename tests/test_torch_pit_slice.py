"""The port's uPIT separation slice against the JAX package: model masks,
loading a JAX training's storage dir, ``evaluate_example``, the recipe's
evaluate entry point, and the recipe's train entry point, whose storage
dir both packages' evaluate entry points load (same SI-SDR, 1e-3 dB).

Sizes are cut (2 BLSTM layers of 16 units) at the recipe's F=257, K=2.
Masks 1e-4 (f32, two recurrent layers); estimates 1e-4 of their peak;
SI-SDR 1e-3 dB.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.examples.source_separation.pit import (
    evaluate as jax_evaluate)
from padertorch_tpu.io import dump_config
from padertorch_tpu.models.bss import (
    PermutationInvariantTrainingModel as JaxPIT)
from padertorch_tpu.modules.recurrent import set_rnn_backend
from padertorch_tpu.ops._stft import HostSTFT as JaxHostSTFT
from padertorch_tpu.serialize import dump_state
from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data, evaluate)
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.ops._stft import HostSTFT

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SIZE = dict(F=257, recurrent_layers=2, units=16, K=2)


def _jax_model(seed=0):
    ptrandom.seed(seed)
    return JaxPIT(**SIZE)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    lens = np.array([20, 13, 7], dtype='int32')
    y = np.abs(rng.randn(3, 20, 257)).astype('float32')
    y *= np.arange(20)[None, :, None] < lens[:, None, None]
    return y, lens


def _port_masks(model, y, lens):
    with torch.no_grad():
        return model({'Y_abs': torch.from_numpy(y),
                      'num_frames': torch.from_numpy(lens)}).numpy()


@pytest.mark.parametrize('backend', ['scan', 'pallas'])
def test_masks_match_jax(backend):
    jax_model = set_rnn_backend(_jax_model(), backend)
    port = from_jax_state_dict(
        PermutationInvariantTrainingModel(**SIZE).eval(),
        jax_model.state_dict())
    y, lens = _batch()
    want = np.asarray(jax_model(
        {'Y_abs': jnp.asarray(y), 'num_frames': jnp.asarray(lens)}))
    got = _port_masks(port, y, lens)
    assert got.shape == want.shape == (3, 20, 2, 257)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _jax_storage_dir(path, jax_model):
    config = JaxPIT.get_config(dict(SIZE))
    dump_config({'trainer': {'model': config}}, path / 'config.json')
    dump_state({'model': jax_model.state_dict(), 'iteration': 1,
                'epoch': 1, 'hooks': {}},
               path / 'checkpoints' / 'ckpt_best_loss.ptt')
    return path


def test_from_storage_dir_loads_a_jax_training(tmp_path):
    jax_model = _jax_model(1)
    storage_dir = _jax_storage_dir(tmp_path, jax_model)
    assert json.loads((storage_dir / 'config.json').read_text())[
        'trainer']['model']['factory'].startswith('padertorch_tpu.models')
    port = PermutationInvariantTrainingModel.from_storage_dir(
        storage_dir).eval()
    assert isinstance(port, PermutationInvariantTrainingModel)
    assert port.blstm.num_layers == 2 and port.blstm.hidden_size == 16
    y, lens = _batch(1)
    want = np.asarray(jax_model(
        {'Y_abs': jnp.asarray(y), 'num_frames': jnp.asarray(lens)}))
    np.testing.assert_allclose(_port_masks(port, y, lens), want,
                               atol=1e-4, rtol=0)


def _capture_estimates(monkeypatch, module):
    """Record what ``evaluate_example`` hands to ``OutputMetrics``."""
    captured = []
    original = module.OutputMetrics

    def spy(speech_prediction, speech_source, **kwargs):
        captured.append(np.asarray(speech_prediction))
        return original(speech_prediction, speech_source, **kwargs)

    monkeypatch.setattr(module, 'OutputMetrics', spy)
    return captured


def test_evaluate_example_matches_jax(monkeypatch):
    jax_model = _jax_model(2)
    port = from_jax_state_dict(
        PermutationInvariantTrainingModel(**SIZE).eval(),
        jax_model.state_dict())
    kwargs = dict(fading='full', complex_representation='complex')
    port_stft = HostSTFT(data.STFT_SIZE, data.STFT_SHIFT, **kwargs)
    jax_stft = JaxHostSTFT(data.STFT_SIZE, data.STFT_SHIFT,
                           dtype='float32', **kwargs)
    got_est = _capture_estimates(monkeypatch, evaluate)
    want_est = _capture_estimates(monkeypatch, jax_evaluate)
    examples = list(data.synthetic_database(num_examples=2,
                                            num_samples=4000))
    for example in examples:
        got_id, got = evaluate.evaluate_example(port, port_stft, example)
        want_id, want = jax_evaluate.evaluate_example(
            jax_model, jax_stft, example)
        assert got_id == want_id == example['example_id']
        assert got.keys() == want.keys()
        for key in ('input_si_sdr', 'output_si_sdr', 'improvement_si_sdr'):
            np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                       rtol=0, err_msg=key)
    assert len(got_est) == len(want_est) == 2
    for g, w in zip(got_est, want_est):
        assert g.shape == w.shape and g.shape[0] == 2
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   rtol=0)


def test_evaluate_entry_point(tmp_path):
    storage_dir = _jax_storage_dir(tmp_path, _jax_model(3))
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run(
        [sys.executable, '-m',
         'padertorch_tpu_torch.contrib.examples.source_separation.pit'
         '.evaluate', '--model_path', str(storage_dir), '--synthetic',
         '--device', 'cpu'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    means = json.loads((storage_dir / 'eval' / 'means.json').read_text())
    results = json.loads((storage_dir / 'eval' / 'result.json').read_text())
    assert len(results) == 8
    assert np.isfinite(means['improvement_si_sdr'])


def _run_module(module, *args):
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2',
           'JAX_PLATFORMS': 'cpu'}
    return subprocess.run(
        [sys.executable, '-m', module, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)


def test_train_entry_point_and_both_evaluates(tmp_path):
    recipe = 'contrib.examples.source_separation.pit'
    proc = _run_module(
        f'padertorch_tpu_torch.{recipe}.train', '--storage_root',
        str(tmp_path), '--synthetic', '--epochs', '1', '--units', '16',
        '--layers', '1', '--device', 'cpu')
    assert proc.returncode == 0, proc.stderr
    assert 'Successfully finished test run' in proc.stdout
    storage_dir = tmp_path / 'pit' / '1'
    assert f'Finished. storage_dir={storage_dir}' in proc.stdout
    names = {p.name for p in storage_dir.iterdir()}
    assert 'config.json' in names and 'checkpoints' in names
    assert any(n.startswith('events.out.tfevents.') for n in names)
    assert {p.name for p in (storage_dir / 'checkpoints').iterdir()} == {
        'ckpt_0.ptt', 'ckpt_8.ptt', 'ckpt_latest.ptt', 'ckpt_best_loss.ptt',
        'ckpt_ranking.json'}

    results = {}
    for package, extra in (('padertorch_tpu_torch', ['--device', 'cpu']),
                           ('padertorch_tpu', [])):
        proc = _run_module(f'{package}.{recipe}.evaluate', '--model_path',
                           str(storage_dir), '--synthetic', *extra)
        assert proc.returncode == 0, proc.stderr
        results[package] = json.loads(
            (storage_dir / 'eval' / 'result.json').read_text())
    port, jax_ = results['padertorch_tpu_torch'], results['padertorch_tpu']
    assert port.keys() == jax_.keys() and len(port) == 8
    for example_id in port:
        for key in ('input_si_sdr', 'output_si_sdr'):
            np.testing.assert_allclose(
                port[example_id][key], jax_[example_id][key], atol=1e-3,
                rtol=0, err_msg=f'{example_id} {key}')


@pytest.mark.parametrize('entry', ['train', 'evaluate'])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Without ``--device cpu`` the entry points take the card; where
    there is none they fail with torch's own error."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    storage_dir = _jax_storage_dir(tmp_path / 'run', _jax_model(4))
    args = {'train': ['--storage_root', str(tmp_path), '--synthetic',
                      '--epochs', '1', '--units', '8', '--layers', '1'],
            'evaluate': ['--model_path', str(storage_dir), '--synthetic']}
    proc = _run_module(
        'padertorch_tpu_torch.contrib.examples.source_separation.pit.'
        + entry, *args[entry])
    assert proc.returncode != 0
    assert 'cuda' in proc.stderr.lower()
    assert not (storage_dir / 'eval').exists()
