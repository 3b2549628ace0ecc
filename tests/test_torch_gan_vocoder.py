"""The port's GAN vocoder recipe and STFT losses against the JAX package.

- ``ops/losses/stft.py``: the multi-resolution STFT loss and its two
  terms at 1e-5, its gradient within 1e-4 of the gradient's largest entry;
- the recipe's model at its ``--small`` widths (weights carried over by
  ``migrate.py``, the generator's transposed convolutions among them): the
  generator's waveform, every review loss and scalar at 1e-4;
- one adversarial step of both Trainers from the same weights and batch
  (SGD: Adam's first step, ``lr * g / (|g| + eps)``, turns the rounding of
  a gradient entry near zero into a step of either sign): every updated
  parameter of both submodules at 1e-4; with the recipe's Adam, a zero
  discriminator loss weight leaves the generator's update as it was, bit
  for bit, and the discriminator where it was;
- ``train.py --synthetic --small`` with asynchronous checkpoints, then the
  ``evaluate.py`` of both packages on its storage dir: the same metrics at
  1e-4 and the WAV dumps;
- the modules this slice adds import neither JAX nor ``padertorch_tpu``
  nor optax.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.examples.audio_synthesis.gan_vocoder import (
    model as jax_model_mod)
from padertorch_tpu.data import dataset as jax_lazy
from padertorch_tpu.ops.losses import stft as jax_stft
from padertorch_tpu.train import optimizer as jax_optim
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch.contrib.examples.audio_synthesis.gan_vocoder \
    import data, model as model_mod, train as gan_train
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.ops.losses import stft
from padertorch_tpu_torch.train import optimizer as optim
from padertorch_tpu_torch.train.trainer import Trainer

from tests.test_torch_pit_slice import _run_module

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
GAN = 'contrib.examples.audio_synthesis.gan_vocoder'
TOL = 1e-4
ADAM = dict(lr=2e-4, betas=(0.8, 0.99), gradient_clipping=10.0)
SGD = dict(lr=0.05, gradient_clipping=10.0)


def _signals(seed=0, shape=(2, 4000)):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype('float32')
    return x, (x + 0.3 * rng.randn(*shape)).astype('float32')


def test_stft_losses_match_jax():
    x, y = _signals()
    want = jax_stft.multi_resolution_stft_loss(jnp.asarray(x),
                                               jnp.asarray(y))
    got = stft.multi_resolution_stft_loss(torch.from_numpy(x),
                                          torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    sc, mag = stft.stft_magnitude_loss(
        torch.from_numpy(x), torch.from_numpy(y), size=512, shift=50,
        window_length=240)
    want_sc, want_mag = jax_stft.stft_magnitude_loss(
        jnp.asarray(x), jnp.asarray(y), size=512, shift=50,
        window_length=240)
    np.testing.assert_allclose([float(sc), float(mag)],
                               [float(want_sc), float(want_mag)], rtol=1e-5)
    # the gradient that trains the generator
    want_grad = jax.grad(lambda e: jax_stft.multi_resolution_stft_loss(
        e, jnp.asarray(y)))(jnp.asarray(x))
    estimate = torch.from_numpy(x).requires_grad_()
    stft.multi_resolution_stft_loss(estimate, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(estimate.grad.numpy(), np.asarray(want_grad),
                               atol=1e-4 * np.abs(want_grad).max(), rtol=0)


def _models(seed=0):
    """The recipe's ``--small`` model in both packages, the same weights."""
    ptrandom.seed(seed)
    jax_model = jax_model_mod.GANVocoder(
        generator=jax_model_mod.Generator(base_channels=16),
        discriminator=jax_model_mod.MultiScaleDiscriminator(
            base_channels=4, n_layers=3, n_scales=2))
    port = model_mod.GANVocoder(
        generator=model_mod.Generator(base_channels=16),
        discriminator=model_mod.MultiScaleDiscriminator(
            base_channels=4, n_layers=3, n_scales=2))
    return jax_model, from_jax_state_dict(port, jax_model.state_dict())


def _batch():
    batches = data.prepare_dataset(
        data.synthetic_database(num_examples=2), batch_size=2,
        segment_length=4000, shuffle=False, prefetch=False)
    return next(iter(batches))


def _inputs(batch, to):
    return {k: to(batch[k]) for k in ('features', 'audio_data')}


def test_forward_and_review_match_jax():
    jax_model, port = _models()
    batch = _batch()
    assert batch['features'].shape == (2, 80, 23)
    jax_in = _inputs(batch, jnp.asarray)
    port_in = _inputs(batch, torch.from_numpy)
    want_out = jax_model(jax_in)
    want = jax_model.review(jax_in, want_out)
    with torch.no_grad():
        got_out = port(port_in)
        got = port.review(port_in, got_out)
    # 23 frames of 200 samples, cropped to the target's 4000
    assert got_out['fake'].shape == (2, 4000)
    np.testing.assert_allclose(got_out['fake'].numpy(),
                               np.asarray(want_out['fake']),
                               atol=TOL, rtol=0)
    for kind in ('losses', 'scalars'):
        assert got[kind].keys() == want[kind].keys()
        for key in want[kind]:
            np.testing.assert_allclose(float(got[kind][key]),
                                       float(want[kind][key]), rtol=TOL,
                                       err_msg=key)


def _port_step(port, batch, tmp_path, loss_weights=None, name='Adam',
               kwargs=ADAM):
    opt = getattr(optim, name)
    trainer = Trainer(port, tmp_path, {'generator': opt(**kwargs),
                                       'discriminator': opt(**kwargs)},
                      adversarial=True, loss_weights=loss_weights,
                      stop_trigger=(1, 'iteration'))
    trainer.train([batch])
    return {k: v.copy() for k, v in to_jax_state_dict(trainer.model).items()}


def test_one_adversarial_step_matches_jax(tmp_path):
    jax_model, port = _models(1)
    batch = _batch()
    start = to_jax_state_dict(port)
    start = {k: v.copy() for k, v in start.items()}
    got = _port_step(port, batch, tmp_path / 'port', name='SGD', kwargs=SGD)
    theirs = JaxTrainer(
        jax_model, tmp_path / 'jax',
        {'generator': jax_optim.SGD(**SGD),
         'discriminator': jax_optim.SGD(**SGD)},
        adversarial=True, stop_trigger=(1, 'iteration'))
    theirs.train(jax_lazy.from_list([{
        k: batch[k] for k in ('features', 'audio_data')}]))
    want = {k: np.asarray(v) for k, v in theirs.model.state_dict().items()}
    assert got.keys() == want.keys()
    assert {k.split('.')[0] for k in got} == {'generator', 'discriminator'}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=k)
        assert not np.array_equal(got[k], start[k]), k   # every one moved


def test_a_zero_discriminator_weight_leaves_the_generator_update(tmp_path):
    batch = _batch()
    _, port = _models(2)
    start = {k: v.copy() for k, v in to_jax_state_dict(port).items()}
    both = _port_step(port, batch, tmp_path / 'a')
    _, port = _models(2)
    generator_only = _port_step(
        port, batch, tmp_path / 'b',
        loss_weights={'generator': 1.0, 'discriminator': 0.0})
    for k in both:
        if k.startswith('generator.'):
            np.testing.assert_array_equal(generator_only[k], both[k])
        else:
            np.testing.assert_array_equal(generator_only[k], start[k])


def test_train_then_both_evaluates(tmp_path):
    proc = _run_module(
        f'padertorch_tpu_torch.{GAN}.train', '--storage_root', str(tmp_path),
        '--synthetic', '--small', '--epochs', '1', '--num_examples', '4',
        '--batch_size', '2', '--async_checkpointing', '--device', 'cpu')
    assert proc.returncode == 0, proc.stderr
    assert 'Successfully finished test run' in proc.stdout
    storage_dir = tmp_path / 'gan_vocoder' / '1'
    config = json.loads((storage_dir / 'config.json').read_text())['trainer']
    assert config['model']['factory'] == (
        f'padertorch_tpu.{GAN}.model.GANVocoder')
    assert config['adversarial'] and config['async_checkpointing']
    assert set(config['optimizer']) == {'generator', 'discriminator'}
    names = {p.name for p in (storage_dir / 'checkpoints').iterdir()}
    assert {'ckpt_0.ptt', 'ckpt_latest.ptt', 'ckpt_best_loss.ptt',
            'ckpt_ranking.json'} <= names
    assert not [n for n in names if '.tmp' in n]
    assert 'evaluate:' in (storage_dir / 'Makefile').read_text()

    means = {}
    for package in ('padertorch_tpu_torch', 'padertorch_tpu'):
        args = ['--model_path', str(storage_dir), '--synthetic']
        if package == 'padertorch_tpu_torch':
            args += ['--device', 'cpu']
        proc = _run_module(f'{package}.{GAN}.evaluate', *args)
        assert proc.returncode == 0, proc.stderr
        means[package] = json.loads(
            (storage_dir / 'eval' / 'means.json').read_text())
        wavs = sorted(p.name for p in
                      (storage_dir / 'eval' / 'audio').iterdir())
        assert wavs == [f'utt_{i}.wav' for i in range(4)]
    mine, theirs = means.values()
    assert mine['num_samples'] == theirs['num_samples'] == 16000
    for key in ('rmse', 'stft_loss'):
        np.testing.assert_allclose(mine[key], theirs[key], rtol=TOL)


IMPORTS = '''
import json, sys
from padertorch_tpu_torch.contrib.examples.audio_synthesis.gan_vocoder \\
    import evaluate, train
from padertorch_tpu_torch.train import hooks, optimizer, trainer
print(json.dumps(sorted(sys.modules)))
'''


def test_the_slice_imports_no_jax():
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run([sys.executable, '-c', IMPORTS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = ('jax', 'jaxlib', 'padertorch_tpu', 'optax', 'tensorboardX')
    assert [m for m in modules if m.split('.')[0] in banned] == []
    assert 'padertorch_tpu_torch.ops.losses.stft' in modules


@pytest.mark.parametrize('rates', [(5, 5, 4, 2), (3, 2)])
def test_generator_multiplies_the_frame_rate(rates):
    generator = model_mod.Generator(n_mels=4, base_channels=8,
                                    upsample_rates=rates)
    with torch.no_grad():
        wave = generator(torch.zeros(1, 4, 7))
    assert wave.shape == (1, 7 * generator.hop_length)
    assert gan_train.SMALL['generator'] == {'base_channels': 16}
