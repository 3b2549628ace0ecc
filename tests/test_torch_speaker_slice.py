"""The port's speaker-classification recipe end to end on the CPU, against
the JAX package.

``speaker_classification.supervised.train --synthetic --epochs 1 --device
cpu`` with the host STFT front end and with ``--on_device_features``, then
both packages' ``evaluate.py``: the same accuracy and the same
misclassified examples, confidences within 1e-4.
"""
import json

import numpy as np
import pytest

from tests.test_torch_pit_slice import _run_module
from tests.test_torch_wavenet_slice import SPEAKER


@pytest.mark.parametrize('on_device', [False, True],
                         ids=['host_stft', 'on_device_features'])
def test_speaker_clf_train_entry_point_and_both_evaluates(on_device,
                                                          tmp_path):
    proc = _run_module(
        f'padertorch_tpu_torch.{SPEAKER}.train', '--storage_root',
        str(tmp_path), '--synthetic', '--epochs', '1', '--device', 'cpu',
        *(['--on_device_features'] if on_device else []))
    assert proc.returncode == 0, proc.stderr
    assert 'Successfully finished test run' in proc.stdout
    storage_dir = tmp_path / 'speaker_clf' / '1'
    assert f'Finished. storage_dir={storage_dir}' in proc.stdout
    config = json.loads((storage_dir / 'config.json').read_text())
    model = config['trainer']['model']
    assert model['factory'] == (
        'padertorch_tpu.contrib.examples.speaker_classification.supervised'
        '.model.SpeakerClf')
    assert model['feature_extractor']['factory'] == (
        'padertorch_tpu.contrib.je.modules.features.'
        + ('FusedAudioLogMelExtractor' if on_device
           else 'NormalizedLogMelExtractor'))
    assert (model['num_speakers'], model['cnn_channels'],
            model['hidden_size']) == (8, [16, 32], 64)
    names = {p.name for p in (storage_dir / 'checkpoints').iterdir()}
    assert {'ckpt_0.ptt', 'ckpt_latest.ptt', 'ckpt_best_accuracy.ptt',
            'ckpt_ranking.json'} <= names
    labels = json.loads((storage_dir / 'speaker_ids.json').read_text())
    assert labels == [f'speaker_{i}' for i in range(8)]

    means, missed = {}, {}
    for package, extra in (('padertorch_tpu_torch', ['--device', 'cpu']),
                           ('padertorch_tpu', [])):
        proc = _run_module(f'{package}.{SPEAKER}.evaluate', '--model_path',
                           str(storage_dir), '--synthetic', *extra)
        assert proc.returncode == 0, proc.stderr
        means[package] = json.loads(
            (storage_dir / 'eval' / 'means.json').read_text())
        missed[package] = json.loads(
            (storage_dir / 'eval' / 'misclassified.json').read_text())
    port, jax_ = means['padertorch_tpu_torch'], means['padertorch_tpu']
    assert port['num_examples'] == 20
    assert port == jax_
    assert missed['padertorch_tpu_torch'].keys() == \
        missed['padertorch_tpu'].keys()
    for example_id, entry in missed['padertorch_tpu_torch'].items():
        other = missed['padertorch_tpu'][example_id]
        assert entry['predicted_label'] == other['predicted_label']
        assert entry['true_label'] == other['true_label']
        np.testing.assert_allclose(entry['confidence'], other['confidence'],
                                   atol=1e-4, rtol=0, err_msg=example_id)
