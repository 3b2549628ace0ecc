"""The speech-recognition recipe of the port end to end on the CPU, in this
process: ``train.py --device cpu`` for one epoch at a tiny width (d_model
16, one layer, 2 heads, 12 synthetic utterances in batches of 2) for each
head, then ``evaluate.py`` on 4 held-out requests, greedy and with a beam;
the CTC head with ``--markov 0.8`` and ``--beam_width 4 --lm_order 2``;
and the ``--database`` branch on a JSON database that the test writes.
Each evaluation leaves ``eval/transcriptions.json`` and ``eval/means.json``
with ``wer`` and ``ser``.
"""
import json

import numpy as np
import pytest
import torch

from padertorch_tpu_torch.contrib.examples.speech_recognition.ctc import (
    data)
from padertorch_tpu_torch.contrib.examples.speech_recognition.ctc.model \
    import AttentionASR, ConformerCTC, TransducerASR
from tests.test_torch_pit_slice import _run_main

torch.set_num_threads(2)

RECIPE = 'padertorch_tpu_torch.contrib.examples.speech_recognition.ctc'
TINY = ['--device', 'cpu', '--epochs', '1', '--d_model', '16',
        '--num_layers', '1', '--num_heads', '2', '--kernel_size', '5',
        '--batch_size', '2']
CASES = {
    'ctc': (['--model', 'ctc'], [[], ['--beam_width', '2']], ConformerCTC),
    'transducer': (['--model', 'transducer', '--causal'],
                   [[], ['--beam_width', '2']], TransducerASR),
    'aed': (['--model', 'aed'], [[], ['--beam_width', '2']], AttentionASR),
    'ctc-lm': (['--model', 'ctc', '--markov', '0.8'],
               [['--beam_width', '4', '--lm_order', '2', '--markov', '0.8']],
               ConformerCTC),
}


def _check_eval(storage_dir, num_examples):
    means = json.loads((storage_dir / 'eval' / 'means.json').read_text())
    assert 0.0 <= means['wer'] and 0.0 <= means['ser'] <= 1.0
    assert means['num_examples'] == num_examples
    transcriptions = json.loads(
        (storage_dir / 'eval' / 'transcriptions.json').read_text())
    assert len(transcriptions) == num_examples
    errors = sum(r['num_errors'] for r in transcriptions.values())
    assert means['wer'] == pytest.approx(errors / means['num_tokens'])
    for r in transcriptions.values():
        assert all(1 <= t <= data.VOCAB_SIZE for t in r['reference'])
    return means


@pytest.mark.parametrize('case', list(CASES))
def test_recipe_trains_and_evaluates_on_the_cpu(monkeypatch, tmp_path,
                                                case):
    train_args, evals, head = CASES[case]
    _run_main(monkeypatch, f'{RECIPE}.train', '--storage_root',
              str(tmp_path), '--synthetic', '--num_examples', '12',
              *TINY, *train_args)
    storage_dir = tmp_path / 'ctc_asr' / '1'
    config = json.loads((storage_dir / 'config.json').read_text())
    assert config['trainer']['model']['factory'].endswith(head.__name__)
    assert config['trainer']['model']['causal'] == ('--causal' in train_args)
    assert (storage_dir / 'checkpoints' / 'ckpt_best_loss.ptt').exists()
    for eval_args in evals:
        _run_main(monkeypatch, f'{RECIPE}.evaluate', '--model_path',
                  str(storage_dir), '--synthetic', '--num_examples', '4',
                  '--device', 'cpu', *eval_args)
        _check_eval(storage_dir, 4)


def test_lm_order_needs_the_ctc_head_and_a_beam(monkeypatch, tmp_path):
    for head, extra, message in (('aed', ['--beam_width', '2'],
                                  'CTC head only'),
                                 ('ctc', [], 'requires --beam_width')):
        root = tmp_path / head
        _run_main(monkeypatch, f'{RECIPE}.train', '--storage_root',
                  str(root), '--synthetic', '--num_examples', '12',
                  *TINY, '--model', head)
        with pytest.raises(SystemExit, match=message):
            _run_main(monkeypatch, f'{RECIPE}.evaluate', '--model_path',
                      str(root / 'ctc_asr' / '1'), '--synthetic',
                      '--num_examples', '2', '--device', 'cpu',
                      '--lm_order', '2', *extra)


def _write_database(path):
    """A JSON database of the synthetic utterances, audio inline, with
    ``train``, ``dev`` and ``test`` splits."""
    def split(num_examples, seed):
        return {ex['example_id']: {
                    'audio_data': np.round(ex['audio_data'], 6).tolist(),
                    'seq_len': int(ex['seq_len']),
                    'labels': [int(t) for t in ex['labels']]}
                for ex in data.synthetic_database(num_examples=num_examples,
                                                  seed=seed)}

    path.write_text(json.dumps({'datasets': {
        'train': split(8, 0), 'dev': split(4, 1), 'test': split(3, 2)}}))


def test_database_branch(monkeypatch, tmp_path):
    database = tmp_path / 'db.json'
    _write_database(database)
    _run_main(monkeypatch, f'{RECIPE}.train', '--storage_root',
              str(tmp_path), '--database', str(database), *TINY)
    storage_dir = tmp_path / 'ctc_asr' / '1'
    assert (storage_dir / 'checkpoints' / 'ckpt_best_loss.ptt').exists()
    _run_main(monkeypatch, f'{RECIPE}.evaluate', '--model_path',
              str(storage_dir), '--database', str(database), '--device',
              'cpu', '--beam_width', '2', '--lm_order', '2')
    transcriptions = json.loads(
        (storage_dir / 'eval' / 'transcriptions.json').read_text())
    want = json.loads(database.read_text())['datasets']['test']
    assert set(transcriptions) == set(want)
    for example_id, r in transcriptions.items():
        assert r['reference'] == want[example_id]['labels']
    _check_eval(storage_dir, 3)
