"""Each ``--database`` recipe of the port trains and evaluates on the CPU
from a WAV tree and JSON written by ``_wav_databases`` (int16 mono of
lengths up to two times apart, stereo, int32 and 8 kHz files), through its
``main`` as a user calls it (``--device cpu``, tiny models): the storage
dir holds ``config.json``, checkpoints and a ``Makefile`` whose
``evaluate`` target names the database and the device, and the evaluation
writes finite metrics.  The mask estimator's ``evaluate.py --database``
runs on a model trained on its synthetic set."""
import json
import sys

import numpy as np
import pytest
import torch

from padertorch_tpu_torch.contrib.examples import _wav_databases as wav_dbs

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def dbs(tmp_path_factory):
    root = tmp_path_factory.mktemp('wav_dbs')
    return {
        'wsj0_2mix': wav_dbs.write_wsj0_2mix(root, min_samples=4000),
        'librispeech': wav_dbs.write_librispeech(root, min_samples=4000),
        'chime': wav_dbs.write_chime(root),
        'audioset': wav_dbs.write_audioset(root, min_samples=4000),
    }


def run_main(module, *args):
    argv = sys.argv
    sys.argv = [module.__name__, *map(str, args)]
    try:
        module.main()
    finally:
        sys.argv = argv


def check_storage_dir(storage_dir, train_module, database=None):
    assert (storage_dir / 'config.json').exists()
    checkpoints = {p.name for p in (storage_dir / 'checkpoints').iterdir()}
    assert 'ckpt_latest.ptt' in checkpoints, checkpoints
    makefile = (storage_dir / 'Makefile').read_text()
    assert f'python -m padertorch_tpu_torch.contrib.examples.' \
           f'{train_module}.train' in makefile
    evaluate = next(line for line in makefile.splitlines()
                    if '.evaluate --model_path' in line)
    assert f'--model_path {storage_dir}' in evaluate
    assert evaluate.endswith('--device cpu'), evaluate
    if database is not None:
        assert f'--database {database}' in evaluate, evaluate
    else:
        assert '--synthetic' in evaluate, evaluate


def finite(values):
    return bool(np.isfinite(np.asarray(values, float)).all())


@pytest.mark.parametrize('recipe', ['pit', 'tasnet', 'or_pit'])
def test_separation_recipes_train_and_evaluate_on_wav_files(
        recipe, dbs, tmp_path):
    import importlib
    base = f'padertorch_tpu_torch.contrib.examples.source_separation.{recipe}'
    train = importlib.import_module(f'{base}.train')
    evaluate = importlib.import_module(f'{base}.evaluate')
    db = dbs['wsj0_2mix']
    size = {'pit': ['--units', 16, '--layers', 1],
            'tasnet': ['--small', '--segment_length', 4000],
            'or_pit': ['--small', '--segment_length', 4000]}[recipe]
    run_main(train, '--storage_root', tmp_path, '--database', db,
             '--epochs', 1, '--batch_size', 2, '--device', 'cpu', *size)
    storage_dir = tmp_path / recipe / '1'
    check_storage_dir(storage_dir, f'source_separation.{recipe}', db)
    run_main(evaluate, '--model_path', storage_dir, '--database', db,
             '--dataset', 'mix_2_spk_min_tt', '--device', 'cpu')
    result = json.loads((storage_dir / 'eval' / 'result.json').read_text())
    assert sorted(result) == [f'mix_2_spk_min_tt_{i}' for i in range(3)]
    for metrics in result.values():
        assert finite(metrics['output_si_sdr'])
        # each request is scored on its own file's samples
        assert len(metrics['output_si_sdr']) == 2


def test_wavenet_trains_and_synthesizes_a_wav_file(dbs, tmp_path):
    from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet \
        import evaluate, train
    db = dbs['librispeech']
    run_main(train, '--storage_root', tmp_path, '--database', db,
             '--epochs', 1, '--batch_size', 2, '--small', '--device', 'cpu')
    storage_dir = tmp_path / 'wavenet' / '1'
    check_storage_dir(storage_dir, 'audio_synthesis.wavenet', db)
    run_main(evaluate, '--model_path', storage_dir, '--database', db,
             '--dataset', 'test_clean', '--max_examples', 1,
             '--chunk_length', 2000, '--chunk_overlap', 500,
             '--parallel', '--device', 'cpu')
    means = json.loads((storage_dir / 'eval' / 'means.json').read_text())
    assert means['num_examples'] == 1 and finite(means['rmse'])
    # the stereo, first utterance of test_clean, averaged over channels
    first = json.loads(db.read_text())['datasets']['test_clean']
    assert means['num_samples'] == next(iter(first.values()))['num_samples']


@pytest.mark.parametrize('on_device_features', [True, False])
def test_speaker_classifier_trains_and_evaluates_on_wav_files(
        on_device_features, dbs, tmp_path):
    from padertorch_tpu_torch.contrib.examples.speaker_classification \
        .supervised import evaluate, train
    db = dbs['librispeech']
    run_main(train, '--storage_root', tmp_path, '--database', db,
             '--epochs', 1, '--batch_size', 4, '--device', 'cpu',
             *(['--on_device_features'] if on_device_features else []))
    storage_dir = tmp_path / 'speaker_clf' / '1'
    check_storage_dir(storage_dir, 'speaker_classification.supervised', db)
    assert json.loads((storage_dir / 'speaker_ids.json').read_text()) == [
        f'speaker_{i}' for i in range(4)]
    run_main(evaluate, '--model_path', storage_dir, '--database', db,
             '--dataset', 'test_clean', '--device', 'cpu')
    means = json.loads((storage_dir / 'eval' / 'means.json').read_text())
    assert means['num_examples'] == 12 and 0 <= means['accuracy'] <= 1


def test_mask_estimator_evaluates_multichannel_wav_files(dbs, tmp_path):
    from padertorch_tpu_torch.contrib.examples.speech_enhancement \
        .mask_estimator import evaluate, train
    run_main(train, '--storage_root', tmp_path, '--synthetic', '--epochs', 1,
             '--num_units', 16, '--device', 'cpu')
    storage_dir = tmp_path / 'mask_estimator' / '1'
    check_storage_dir(storage_dir, 'speech_enhancement.mask_estimator')
    run_main(evaluate, '--model_path', storage_dir, '--database',
             dbs['chime'], '--device', 'cpu', '--beamformer', 'gev')
    result = json.loads((storage_dir / 'eval' / 'result.json').read_text())
    assert sorted(result) == [f'et05_simu_{i}' for i in range(3)]
    for metrics in result.values():
        assert finite([v for kind in metrics.values()
                       for v in kind.values()])


def test_audio_tagger_trains_and_evaluates_on_wav_files(dbs, tmp_path):
    from padertorch_tpu_torch.contrib.examples.sound_recognition \
        .audio_tagging import evaluate, train
    db = dbs['audioset']
    run_main(train, '--storage_root', tmp_path, '--database', db,
             '--epochs', 1, '--batch_size', 2, '--device', 'cpu')
    storage_dir = tmp_path / 'tagging' / '1'
    check_storage_dir(storage_dir, 'sound_recognition.audio_tagging', db)
    assert json.loads((storage_dir / 'eventss.json').read_text()) == \
        sorted(wav_dbs.EVENTS)
    run_main(evaluate, '--model_path', storage_dir, '--database', db,
             '--dataset', 'eval', '--device', 'cpu')
    means = json.loads((storage_dir / 'eval' / 'means.json').read_text())
    assert means['num_examples'] == 4
    assert all(finite(means[k]) for k in ('mAP', 'mAUC', 'lwlrap', 'mF1'))
