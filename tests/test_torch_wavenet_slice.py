"""The port's wavenet and speaker-classification recipes end to end on the
CPU, against the JAX package.

``audio_synthesis.wavenet.train --synthetic --small --device cpu`` for one
epoch (``test_run``, validation, checkpoints, an audio snapshot), then both
packages' ``evaluate.py`` on that storage dir: the same examples and sample
counts, and RMSEs that agree as far as sampled output can (the two packages
draw from different generators, so the synthesized audio agrees in
distribution only: 10 % relative on the global RMSE of 4 x 4000 samples);
the weights both loaded are held exactly, through the teacher-forced logits
of the two loaded models (1e-4).  Training runs on 4 synthetic utterances
(the recipe's default is 12): the test is of the plumbing, not of learning.
The speaker-classification recipe's run is ``test_torch_speaker_slice.py``;
both recipes' entry points raise for a ``--database`` that does not exist
(``test_torch_real_audio_recipes.py`` runs them on WAV files) and default
to the card.
"""
import json

import numpy as np
import pytest
import torch

from tests.test_torch_pit_slice import _run_main, _run_module

WAVENET = 'contrib.examples.audio_synthesis.wavenet'
SPEAKER = 'contrib.examples.speaker_classification.supervised'


def test_wavenet_train_entry_point_and_both_evaluates(tmp_path):
    proc = _run_module(
        f'padertorch_tpu_torch.{WAVENET}.train', '--storage_root',
        str(tmp_path), '--synthetic', '--small', '--epochs', '1',
        '--num_examples', '4', '--device', 'cpu')
    assert proc.returncode == 0, proc.stderr
    assert 'Successfully finished test run' in proc.stdout
    storage_dir = tmp_path / 'wavenet' / '1'
    assert f'Finished. storage_dir={storage_dir}' in proc.stdout
    config = json.loads((storage_dir / 'config.json').read_text())
    model = config['trainer']['model']
    assert model['factory'] == ('padertorch_tpu.contrib.examples.'
                                'audio_synthesis.wavenet.model.WaveNetVocoder')
    assert model['wavenet'] == {
        'factory': 'padertorch_tpu.modules.wavenet.wavenet.WaveNet',
        'n_cond_channels': 80, 'upsamp_window': 800, 'upsamp_stride': 200,
        'n_in_channels': 256, 'n_layers': 2, 'max_dilation': 2,
        'n_residual_channels': 8, 'n_skip_channels': 16,
        'n_out_channels': 256, 'fading': 'full'}
    names = {p.name for p in (storage_dir / 'checkpoints').iterdir()}
    assert {'ckpt_0.ptt', 'ckpt_latest.ptt', 'ckpt_best_loss.ptt',
            'ckpt_ranking.json'} <= names

    from padertorch_tpu_torch.summary import tfevents
    event_file, = [p for p in storage_dir.iterdir()
                   if p.name.startswith('events.out.tfevents.')]
    tags = {value['tag']
            for event in tfevents.load_events_as_dict(event_file)
            for value in event.get('summary', {}).get('value', [])}
    assert {'training/loss', 'validation/loss', 'validation/accuracy',
            'validation/target_audio'} <= tags

    means, rmse = {}, {}
    for package, extra in (('padertorch_tpu_torch', ['--device', 'cpu']),
                           ('padertorch_tpu', [])):
        proc = _run_module(f'{package}.{WAVENET}.evaluate', '--model_path',
                           str(storage_dir), '--synthetic', *extra)
        assert proc.returncode == 0, proc.stderr
        means[package] = json.loads(
            (storage_dir / 'eval' / 'means.json').read_text())
        rmse[package] = dict(json.loads(
            (storage_dir / 'eval' / 'rmse.json').read_text()))
        wavs = sorted(p.name for p in
                      (storage_dir / 'eval' / 'audio').iterdir())
        assert wavs == [f'utt_{i}.wav' for i in range(4)]
    port, jax_ = means['padertorch_tpu_torch'], means['padertorch_tpu']
    assert port['num_examples'] == jax_['num_examples'] == 4
    assert port['num_samples'] == jax_['num_samples'] == 16000
    assert rmse['padertorch_tpu_torch'].keys() == rmse['padertorch_tpu'].keys()
    assert np.isfinite(port['rmse']) and 0 < port['rmse'] < 2
    # sampled audio: the packages agree in distribution only
    np.testing.assert_allclose(port['rmse'], jax_['rmse'], rtol=0.1)

    # what both packages loaded is the same model: teacher-forced logits
    import jax.numpy as jnp
    from padertorch_tpu.contrib.examples.audio_synthesis.wavenet.model \
        import WaveNetVocoder as JaxVocoder
    from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet \
        import data
    from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet.model \
        import WaveNetVocoder
    loaded = WaveNetVocoder.from_storage_dir(
        storage_dir, checkpoint_name='ckpt_best_loss.ptt').eval()
    loaded_jax = JaxVocoder.from_storage_dir(
        storage_dir, checkpoint_name='ckpt_best_loss.ptt').eval()
    batch = data.post_batch([data.extract_features(e) for e in list(
        data.synthetic_database(num_examples=2, num_samples=2000, seed=3))])
    with torch.no_grad():
        out = loaded({k: torch.from_numpy(v) for k, v in batch.items()
                      if k in ('features', 'audio_data')})
    out_jax = loaded_jax({k: jnp.asarray(batch[k])
                          for k in ('features', 'audio_data')})
    np.testing.assert_array_equal(out['quantized'].numpy(),
                                  np.asarray(out_jax['quantized']))
    np.testing.assert_allclose(out['logits'].numpy(),
                               np.asarray(out_jax['logits']), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize('recipe,entry', [
    (WAVENET, 'train'), (WAVENET, 'evaluate'),
    (SPEAKER, 'train'), (SPEAKER, 'evaluate')])
def test_database_path_raises(recipe, entry, tmp_path, monkeypatch):
    """``--database`` reads the JSON it names: a path that does not exist
    raises, the entry point does not fall back to the synthetic set (for
    ``evaluate.py`` behind a storage dir of a tiny model that loads)."""
    args = ['--database', str(tmp_path / 'missing.json'), '--device', 'cpu']
    if entry == 'evaluate':
        _tiny_storage_dir(recipe, tmp_path)
        args += ['--model_path', str(tmp_path)]
    else:
        args += ['--storage_root', str(tmp_path)]
    with pytest.raises(FileNotFoundError, match='missing.json'):
        _run_main(monkeypatch, f'padertorch_tpu_torch.{recipe}.{entry}',
                  *args)
    assert not (tmp_path / 'eval').exists()


def _tiny_storage_dir(recipe, storage_dir):
    """A config and one checkpoint of an untrained tiny model."""
    from padertorch_tpu_torch.io import dump_config
    from padertorch_tpu_torch.migrate import to_jax_state_dict
    from padertorch_tpu_torch.serialize import dump_state
    from padertorch_tpu_torch.train.trainer import Trainer
    if recipe == WAVENET:
        from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet \
            import train
        config = train.get_trainer_config(storage_dir, {'model': train.SMALL})
        name = 'ckpt_best_loss.ptt'
    else:
        from padertorch_tpu_torch.contrib.examples.speaker_classification \
            .supervised import train
        config = train.get_trainer_config(storage_dir, 4)
        name = 'ckpt_best_accuracy.ptt'
    dump_config({'trainer': config}, storage_dir / 'config.json')
    model = Trainer.from_config(config).model
    dump_state({'model': to_jax_state_dict(model)},
               storage_dir / 'checkpoints' / name)


@pytest.mark.parametrize('recipe', [WAVENET, SPEAKER])
def test_train_entry_points_default_to_the_card(recipe, tmp_path,
                                                monkeypatch):
    """Without ``--device cpu`` the entry points take the card; where there
    is none they fail with torch's own error."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    with pytest.raises((AssertionError, RuntimeError), match='(?i)cuda'):
        _run_main(monkeypatch, f'padertorch_tpu_torch.{recipe}.train',
                  '--storage_root', str(tmp_path), '--synthetic',
                  '--epochs', '1',
                  *(['--small'] if recipe == WAVENET else []))
