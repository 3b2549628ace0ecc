"""The port's tasnet recipe end to end on the CPU, against the JAX package.

``train.py --synthetic --small --device cpu`` for one epoch of a short run
(with ``test_run``, validation on ``si-sdr``, checkpoints and audio
summaries), with LSTM and with GRU chunk RNNs; then the port's
``evaluate.py`` and, for the GRU run, the JAX package's load that storage
dir and give the same SI-SDR per example (1e-3 dB) and the same means
(1e-3 dB) on the first requests of the recipe's synthetic set (that an
LSTM checkpoint of the port loads in the JAX package is held by
``test_torch_pit_slice.py``); the audio events the summary hook wrote
decode as WAV.  Variants whose separators are not ported raise.  The
``--variant sepformer`` run is ``test_torch_sepformer_slice.py``.
"""
import io
import json
import wave

import numpy as np
import pytest
import torch

from padertorch_tpu.summary import tfevents as jax_tfevents
from padertorch_tpu_torch.contrib.examples.source_separation.tasnet import (
    train)
from padertorch_tpu_torch.summary import tfevents
from padertorch_tpu_torch.summary.writer import SummaryWriter
from tests.test_torch_pit_slice import EVAL_EXAMPLES, _run_main, _run_module

RECIPE = 'contrib.examples.source_separation.tasnet'
BGRU = ['with', 'model.separator.inter_chunk_type=bgru',
        'model.separator.intra_chunk_type=bgru']


# A shorter run of the same entry points: training on 8 examples (2
# iterations of 4 segments; the recipe's default is 32), the evaluates on
# the first EVAL_EXAMPLES of the recipe's 8 synthetic requests.
SHORT_TRAINING = ['--num_examples', '8']


@pytest.mark.parametrize('rnn_type', ['blstm', 'bgru'])
def test_train_entry_point_and_both_evaluates(rnn_type, tmp_path):
    proc = _run_module(
        f'padertorch_tpu_torch.{RECIPE}.train', '--storage_root',
        str(tmp_path), '--synthetic', '--small', '--epochs', '1',
        '--device', 'cpu', *SHORT_TRAINING,
        *(BGRU if rnn_type == 'bgru' else []))
    assert proc.returncode == 0, proc.stderr
    assert 'Successfully finished test run' in proc.stdout
    storage_dir = tmp_path / 'tasnet' / '1'
    assert f'Finished. storage_dir={storage_dir}' in proc.stdout
    config = json.loads((storage_dir / 'config.json').read_text())
    separator = config['trainer']['model']['separator']
    assert separator['factory'] == \
        'padertorch_tpu.modules.dual_path_rnn.DPRNN'
    assert separator['intra_chunk_type'] == rnn_type
    assert {p.name for p in (storage_dir / 'checkpoints').iterdir()} == {
        'ckpt_0.ptt', 'ckpt_2.ptt', 'ckpt_latest.ptt',
        'ckpt_best_si-sdr.ptt', 'ckpt_ranking.json'}

    # the snapshots of TasNet.review came through add_audio
    event_file, = [p for p in storage_dir.iterdir()
                   if p.name.startswith('events.out.tfevents.')]
    audios = {}
    for event in tfevents.load_events_as_dict(event_file):
        for value in event.get('summary', {}).get('value', []):
            if 'audio' in value:
                audios[value['tag']] = value['audio']
    assert {'validation/observation', 'validation/estimate/0',
            'validation/estimate/1', 'validation/target/0',
            'validation/target/1'} <= set(audios)
    audio = audios['validation/estimate/1']
    assert audio['sample_rate'] == 8000 and audio['num_channels'] == 1
    with wave.open(io.BytesIO(audio['encoded_audio_string'])) as wav:
        assert wav.getframerate() == 8000 and wav.getsampwidth() == 2
        assert wav.getnframes() == audio['length_frames'] > 0
    # the JAX package's reader walks the same file
    assert len(jax_tfevents.load_events_as_dict(event_file)) == len(
        tfevents.load_events_as_dict(event_file))

    results, means = {}, {}
    packages = [('padertorch_tpu_torch', ['--device', 'cpu'])]
    if rnn_type == 'bgru':
        packages.append(('padertorch_tpu', []))
    for package, extra in packages:
        proc = _run_module(f'{package}.{RECIPE}.evaluate', '--model_path',
                           str(storage_dir), '--synthetic', *extra,
                           num_examples=EVAL_EXAMPLES)
        assert proc.returncode == 0, proc.stderr
        results[package] = json.loads(
            (storage_dir / 'eval' / 'result.json').read_text())
        means[package] = json.loads(
            (storage_dir / 'eval' / 'means.json').read_text())
    port = results['padertorch_tpu_torch']
    assert len(port) == EVAL_EXAMPLES
    assert np.isfinite(means['padertorch_tpu_torch']['improvement_si_sdr'])
    if rnn_type != 'bgru':
        return
    jax_ = results['padertorch_tpu']
    assert port.keys() == jax_.keys()
    for example_id in port:
        for key in ('input_si_sdr', 'output_si_sdr'):
            np.testing.assert_allclose(
                port[example_id][key], jax_[example_id][key], atol=1e-3,
                rtol=0, err_msg=f'{example_id} {key}')
    assert means['padertorch_tpu_torch'].keys() == \
        means['padertorch_tpu'].keys()
    for key, value in means['padertorch_tpu_torch'].items():
        np.testing.assert_allclose(value, means['padertorch_tpu'][key],
                                   atol=1e-3, rtol=0, err_msg=key)


def test_add_audio_events_decode(tmp_path):
    writer = SummaryWriter(tmp_path)
    signal = np.sin(np.arange(800) / 10) * 1.5  # clipped to [-1, 1]
    writer.add_audio('a/b', signal, 3, sample_rate=8000)
    writer.add_audio('t', torch.zeros(5).numpy(), 4)
    writer.close()
    events = tfevents.load_events_as_dict(writer.path)
    (first,), (second,) = (e['summary']['value'] for e in events[1:])
    assert events[1]['step'] == 3 and first['tag'] == 'a/b'
    audio = first['audio']
    assert audio['content_type'] == 'audio/wav'
    assert audio['length_frames'] == 800 and audio['sample_rate'] == 8000
    with wave.open(io.BytesIO(audio['encoded_audio_string'])) as wav:
        pcm = np.frombuffer(wav.readframes(800), '<i2')
    np.testing.assert_allclose(pcm / 32767, np.clip(signal, -1, 1),
                               atol=1e-4)
    assert second['audio']['sample_rate'] == 44100


@pytest.mark.parametrize('variant', ['convnet', 'sepformer'])
def test_variants_that_are_not_ported_raise(variant, tmp_path):
    """``convnet`` still waits and raises; ``sepformer`` is ported and gives
    the JAX recipe's full-width separator."""
    if variant == 'sepformer':
        separator = train.get_trainer_config(
            tmp_path, variant=variant)['model']['separator']
        assert {k: v for k, v in separator.items() if k != 'factory'} == {
            'input_size': 128, 'window_length': 100, 'hop_size': 50,
            'num_blocks': 4, 'num_layers_intra': 2, 'num_layers_inter': 2,
            'num_heads': 8, 'd_ff': None, 'dropout': 0.0, 'use_rope': True}
        return
    with pytest.raises(NotImplementedError, match='modules/convnet.py'):
        train.get_trainer_config(tmp_path, variant=variant)


@pytest.mark.parametrize('variant', ['dprnn', 'win2', 'stft'])
def test_variant_configs_name_jax_classes(variant, tmp_path):
    from padertorch_tpu_torch.io import dumps_config
    config = json.loads(dumps_config(
        train.get_trainer_config(tmp_path, variant=variant, loss='log-mse')))
    assert config['loss_weights'] == {
        'si-sdr': 0.0, 'log-mse': 1.0, 'log1p-mse': 0.0}
    assert config['optimizer']['gradient_clipping'] == 5.0
    model = config['model']
    assert model['factory'] == 'padertorch_tpu.models.tasnet.TasNet'
    assert model['encoder']['factory'].startswith(
        'padertorch_tpu.models.tasnet.')
    assert model['encoder']['window_length'] == (
        2 if variant == 'win2' else 20)
    assert model['separator']['num_blocks'] == 6


def test_database_path_raises(monkeypatch):
    with pytest.raises(NotImplementedError, match='--database'):
        _run_main(monkeypatch, f'padertorch_tpu_torch.{RECIPE}.train',
                  '--database', 'x.json', '--device', 'cpu')


@pytest.mark.parametrize('entry', ['train', 'evaluate'])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Without ``--device cpu`` the entry points take the card; where
    there is none they fail with torch's own error."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    args = {'train': ['--storage_root', str(tmp_path), '--synthetic',
                      '--small', '--epochs', '1'],
            'evaluate': ['--model_path', str(tmp_path), '--synthetic']}
    if entry == 'evaluate':
        # a storage dir to load: config and one checkpoint of a tiny model
        from padertorch_tpu_torch.io import dump_config
        from padertorch_tpu_torch.migrate import to_jax_state_dict
        from padertorch_tpu_torch.serialize import dump_state
        from padertorch_tpu_torch.train.trainer import Trainer
        config = train.get_trainer_config(
            tmp_path, updates={'model': train.SMALL})
        dump_config({'trainer': config}, tmp_path / 'config.json')
        model = Trainer.from_config(config).model
        dump_state({'model': to_jax_state_dict(model)},
                   tmp_path / 'checkpoints' / 'ckpt_best_si-sdr.ptt')
    with pytest.raises((AssertionError, RuntimeError), match='(?i)cuda'):
        _run_main(monkeypatch, f'padertorch_tpu_torch.{RECIPE}.{entry}',
                  *args[entry])
    assert not (tmp_path / 'eval').exists()
