"""A dict of optimizers, the adversarial step and asynchronous checkpoints
in the port's Trainer, against the JAX Trainer and closed forms.

- ``adversarial=True``: on a linear toy GAN the one-step updates are known
  in closed form; each submodule gets the gradient of its own loss only
  (the discriminator never the generator's), with loss weights; the same
  errors as the JAX package's for a missing dict or unmatched loss keys;
  one forward a step (the JAX package differentiates a replayed forward per
  key); Adam trajectories, validation and resume equal to the JAX
  Trainer's (1e-6).
- A dict of optimizers without ``adversarial``: one joint loss, each
  submodule's own optimizer, clip and summary (1e-6 against JAX).
- ``async_checkpointing=True``: the written file holds the parameters of
  the step at which it was taken, though the next step changed the live
  tensors in place before the thread wrote it; it equals a synchronous
  save; training writes resumable checkpoints; a failed write raises once
  at the next wait.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import padertorch_tpu as jpt
from padertorch_tpu import random as ptrandom
from padertorch_tpu.data import dataset as jax_lazy
from padertorch_tpu.train import optimizer as jax_optim
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch import Model
from padertorch_tpu_torch.serialize import load_state
from padertorch_tpu_torch.train import optimizer as optim
from padertorch_tpu_torch.train import trainer as trainer_mod
from padertorch_tpu_torch.train.hooks import Hook
from padertorch_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

TOL = 1e-6
A0, W0 = 0.5, 2.0


class _Scalar(torch.nn.Module):
    """x -> value * x, the value a 1 x 1 ``Linear`` weight (a layout that
    the checkpoints' ``migrate.py`` knows)."""

    def __init__(self, value):
        super().__init__()
        self.scale = torch.nn.Linear(1, 1, bias=False)
        with torch.no_grad():
            self.scale.weight.fill_(value)

    @property
    def value(self):
        return self.scale.weight[0, 0]

    def forward(self, x):
        return self.scale(x[..., None])[..., 0]


class LinearGAN(Model):
    """fake = a*z, D(x) = w*x, Wasserstein-style linear losses:
    g_loss = -w a mean(z), d_loss = w (a mean(z) - mean(x)).  Each
    forward is counted."""

    def __init__(self):
        super().__init__()
        self.generator = _Scalar(A0)
        self.discriminator = _Scalar(W0)
        self.forwards = 0

    def forward(self, inputs):
        self.forwards += 1
        return self.generator(inputs['z'])

    def review(self, inputs, outputs):
        d_fake = self.discriminator(outputs)
        d_real = self.discriminator(inputs['x'])
        return {'losses': {
            'generator': -torch.mean(d_fake),
            'discriminator': torch.mean(d_fake) - torch.mean(d_real)}}


class _JaxScalar(jpt.Module):
    def __init__(self, value):
        self.scale = jpt.nn.Linear(1, 1, bias=False)
        self.scale.weight = jnp.full((1, 1), value, 'float32')

    def forward(self, x):
        return self.scale(x[..., None])[..., 0]


class JaxLinearGAN(jpt.Model):
    def __init__(self):
        self.generator = _JaxScalar(A0)
        self.discriminator = _JaxScalar(W0)

    def forward(self, inputs):
        return self.generator(inputs['z'])

    def review(self, inputs, outputs):
        d_fake = self.discriminator(outputs)
        d_real = self.discriminator(inputs['x'])
        return {'losses': {
            'generator': -jnp.mean(d_fake),
            'discriminator': jnp.mean(d_fake) - jnp.mean(d_real)}}


def _examples(n=4, batch=4):
    rng = np.random.RandomState(0)
    return [{'z': rng.randn(batch).astype('float32'),
             'x': rng.randn(batch).astype('float32') + 3.0}
            for _ in range(n)]


def _gan_trainer(path, optimizer=('SGD', {'lr': 0.1}), model=None,
                 **kwargs):
    name, opt_kwargs = optimizer
    kwargs.setdefault('stop_trigger', (1, 'iteration'))
    return Trainer(
        model or LinearGAN(), path,
        {'generator': getattr(optim, name)(**opt_kwargs),
         'discriminator': getattr(optim, name)(**opt_kwargs)},
        adversarial=True, **kwargs)


def _values(trainer):
    model = trainer.model
    if isinstance(model, JaxLinearGAN):
        return tuple(float(getattr(model, k).scale.weight[0, 0])
                     for k in ('generator', 'discriminator'))
    return (float(model.generator.value), float(model.discriminator.value))


@pytest.mark.parametrize('weights', [None, (0.5, 2.0)])
def test_adversarial_grads_are_isolated(tmp_path, weights):
    """One SGD step against the closed form of each key's own gradient
    (a leak of the generator's loss into the discriminator would add
    ``-lr * gw * a mean(z)``), with and without loss weights."""
    lr = 0.1
    gw, dw = weights or (1.0, 1.0)
    kwargs = ({} if weights is None else
              {'loss_weights': {'generator': gw, 'discriminator': dw}})
    trainer = _gan_trainer(tmp_path, **kwargs)
    ex = _examples(n=1)
    trainer.train(ex)
    mz, mx = ex[0]['z'].mean(), ex[0]['x'].mean()
    want_a = A0 - lr * gw * (-W0 * mz)
    want_w = W0 - lr * dw * (A0 * mz - mx)
    got_a, got_w = _values(trainer)
    np.testing.assert_allclose(got_a, want_a, rtol=1e-5)
    np.testing.assert_allclose(got_w, want_w, rtol=1e-5)
    assert abs(got_w - (want_w + lr * gw * A0 * mz)) > 1e-3
    # one forward for the step (none in this run's other phases)
    assert trainer.model.forwards == 1


def test_adversarial_requires_a_dict_and_matching_keys(tmp_path):
    with pytest.raises(TypeError, match='adversarial'):
        Trainer(LinearGAN(), tmp_path, optim.SGD(lr=0.1), adversarial=True)

    class BadModel(LinearGAN):
        def review(self, inputs, outputs):
            review = super().review(inputs, outputs)
            review['losses'] = {'g': review['losses']['generator']}
            return review

    trainer = _gan_trainer(tmp_path, model=BadModel())
    with pytest.raises(Exception, match='keyed exactly'):
        trainer.train(_examples(n=1))


def _jax_gan_trainer(path, optimizer, **kwargs):
    name, opt_kwargs = optimizer
    ptrandom.seed(0)
    return JaxTrainer(
        JaxLinearGAN(), path,
        {'generator': getattr(jax_optim, name)(**opt_kwargs),
         'discriminator': getattr(jax_optim, name)(**opt_kwargs)},
        adversarial=True, **kwargs)


def test_adam_trajectory_validation_and_resume_match_jax(tmp_path):
    """Two epochs of 4 steps with validation, then a resume to three:
    both submodules' values, the optimizers' states round trip per key,
    the per-key summary (``generator_grad_norm``,
    ``lr/generator/param_group_0``)."""
    settings = dict(stop_trigger=(2, 'epoch'), checkpoint_trigger=(1, 'epoch'),
                    summary_trigger=(1, 'epoch'))
    opt = ('Adam', {'lr': 1e-2})
    data = _examples(n=4)
    results = []
    for make, sub in ((_gan_trainer, 'port'), (_jax_gan_trainer, 'jax')):
        trainer = make(tmp_path / sub, optimizer=opt, **settings)
        trainer.register_validation_hook(jax_lazy.from_list(data)
                                         if sub == 'jax' else data)
        trainer.train(jax_lazy.from_list(data) if sub == 'jax' else data)
        first = _values(trainer)
        resumed = make(tmp_path / sub, optimizer=opt,
                       **{**settings, 'stop_trigger': (3, 'epoch')})
        resumed.register_validation_hook(jax_lazy.from_list(data)
                                         if sub == 'jax' else data)
        resumed.train(jax_lazy.from_list(data) if sub == 'jax' else data,
                      resume=True)
        results.append((first, _values(resumed), resumed.iteration))
    (first, last, iteration), (want_first, want_last, want_iteration) = \
        results
    np.testing.assert_allclose(first, want_first, atol=TOL, rtol=0)
    np.testing.assert_allclose(last, want_last, atol=TOL, rtol=0)
    assert iteration == want_iteration == 12
    assert first != (A0, W0) and last != first
    state = load_state(tmp_path / 'port' / 'checkpoints' / 'ckpt_latest.ptt')
    assert set(state['optimizer']) == {'generator', 'discriminator'}
    assert list(state['optimizer']['generator']['state']) == [
        'scale.weight']


class TwoLayers(Model):
    """A joint loss over two submodules, each with its own optimizer."""

    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(3, 4)
        self.decoder = torch.nn.Linear(4, 2)

    def forward(self, batch):
        return self.decoder(torch.tanh(self.encoder(batch['x'])))

    def review(self, batch, out):
        return {'loss': ((out - batch['y']) ** 2).mean()}


class JaxTwoLayers(jpt.Model):
    def __init__(self):
        self.encoder = jpt.nn.Linear(3, 4)
        self.decoder = jpt.nn.Linear(4, 2)

    def forward(self, batch):
        return self.decoder(jnp.tanh(self.encoder(batch['x'])))

    def review(self, batch, out):
        return {'loss': jnp.mean((out - batch['y']) ** 2)}


def test_dict_of_optimizers_matches_jax(tmp_path):
    from padertorch_tpu_torch.migrate import (
        from_jax_state_dict, to_jax_state_dict)
    rng = np.random.RandomState(1)
    data = [{'x': rng.randn(5, 3).astype('float32'),
             'y': rng.randn(5, 2).astype('float32')} for _ in range(3)]
    ptrandom.seed(0)
    jax_model = JaxTwoLayers()
    port = from_jax_state_dict(TwoLayers(), jax_model.state_dict())
    seen = []

    class Summaries(Hook):
        def post_optimize(self, trainer, summary):
            seen.append(summary)

    kwargs = dict(stop_trigger=(2, 'epoch'))
    trainer = Trainer(port, tmp_path / 'port', {
        'encoder': optim.SGD(lr=0.1, momentum=0.9),
        'decoder': optim.Adam(lr=0.01, gradient_clipping=0.1)}, **kwargs)
    trainer.register_hook(Summaries())
    trainer.train(data)
    theirs = JaxTrainer(jax_model, tmp_path / 'jax', {
        'encoder': jax_optim.SGD(lr=0.1, momentum=0.9),
        'decoder': jax_optim.Adam(lr=0.01, gradient_clipping=0.1)},
        **kwargs)
    theirs.train(jax_lazy.from_list(data))
    got = to_jax_state_dict(trainer.model)
    for k, v in theirs.model.state_dict().items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=TOL, rtol=0,
                                   err_msg=k)
    assert set(seen[0]['scalars']) == {
        'encoder_grad_norm', 'decoder_grad_norm',
        'lr/encoder/param_group_0', 'lr/decoder/param_group_0'}
    assert set(seen[0]['histograms']) == {'encoder_grad_norm_',
                                          'decoder_grad_norm_'}


def _regression_trainer(path, **kwargs):
    torch.manual_seed(0)
    return Trainer(TwoLayers(), path, optim.Adam(lr=0.05),
                   stop_trigger=(2, 'epoch'), **kwargs)


def _data(n=3):
    rng = np.random.RandomState(2)
    return [{'x': rng.randn(5, 3).astype('float32'),
             'y': rng.randn(5, 2).astype('float32')} for _ in range(n)]


def test_async_checkpoint_holds_the_step_it_was_taken_at(tmp_path,
                                                        monkeypatch):
    """The writer is held until another optimizer step has changed the
    live parameters and Adam's moments in place: the file still holds the
    ones of the save (the aliasing a snapshot by reference would show)."""
    trainer = _regression_trainer(tmp_path / 'exp', async_checkpointing=True)
    trainer.train(_data())
    want = {k: v.copy() for k, v in trainer.state_dict()['model'].items()}
    want_moment = trainer.optimizer.optimizer.state[
        trainer.model.decoder.bias]['exp_avg'].clone()
    release = threading.Event()
    write = trainer_mod.dump_state

    def held(state, path):
        assert release.wait(60)
        write(state, path)

    monkeypatch.setattr(trainer_mod, 'dump_state', held)
    trainer.save_checkpoint(tmp_path / 'snap.ptt')
    loss, _, _, _ = trainer.train_step(trainer.model, _data()[0])
    loss.backward()
    trainer.optimizer.step()
    assert not np.allclose(
        trainer.model.decoder.bias.detach().numpy(), want['decoder.bias'])
    release.set()
    trainer.wait_for_checkpoint_writes()
    state = load_state(tmp_path / 'snap.ptt')
    for k, v in want.items():
        np.testing.assert_array_equal(state['model'][k], v, err_msg=k)
    np.testing.assert_array_equal(
        state['optimizer']['state']['decoder.bias']['exp_avg'],
        want_moment.numpy())


def test_async_save_equals_sync_save(tmp_path):
    trainer = _regression_trainer(tmp_path / 'exp')
    trainer.train(_data())
    trainer.save_checkpoint(tmp_path / 'sync.ptt')
    trainer.async_checkpointing = True
    trainer.save_checkpoint(tmp_path / 'async.ptt')
    trainer.wait_for_checkpoint_writes()
    a, b = (load_state(tmp_path / f'{n}.ptt') for n in ('sync', 'async'))
    from padertorch_tpu_torch.utils.nested import flatten
    flat_a, flat_b = flatten(a), flatten(b)
    assert flat_a.keys() == flat_b.keys()
    for key, value in flat_a.items():
        np.testing.assert_array_equal(np.asarray(value),
                                      np.asarray(flat_b[key]), err_msg=key)


def test_async_training_writes_resumable_checkpoints(tmp_path):
    trainer = _regression_trainer(tmp_path / 'exp', async_checkpointing=True)
    trainer.register_validation_hook(_data(2))
    trainer.train(_data())
    assert trainer._ckpt_writer is None   # committed before train returned
    ckpt_dir = trainer.checkpoint_dir
    latest = ckpt_dir / 'ckpt_latest.ptt'
    assert latest.is_symlink() and latest.resolve().name == 'ckpt_6.ptt'
    assert (ckpt_dir / 'ckpt_ranking.json').exists()
    resumed = _regression_trainer(tmp_path / 'exp', async_checkpointing=True)
    resumed.register_validation_hook(_data(2))
    resumed.load_checkpoint()
    assert resumed.iteration == trainer.iteration == 6
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_writer_errors_surface_once_on_wait(tmp_path, monkeypatch):
    trainer = _regression_trainer(tmp_path / 'exp', async_checkpointing=True)
    trainer.train(_data())

    def boom(state, path):
        raise OSError('disk full')

    monkeypatch.setattr(trainer_mod, 'dump_state', boom)
    trainer.save_checkpoint(tmp_path / 'fail.ptt')
    with pytest.raises(RuntimeError, match='checkpoint write failed'):
        trainer.wait_for_checkpoint_writes()
    trainer.wait_for_checkpoint_writes()
