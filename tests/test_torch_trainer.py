"""The port's Trainer, hooks, triggers, ``test_run`` and event writer on
tiny models trained for a few iterations on the CPU.

What is held against the JAX package: the triggers fire at the same
(iteration, epoch) pairs; the event file reads the same through the JAX
package's ``load_events_as_dict`` (tensorboardX's protobuf classes) and
the port's hand decoder; a storage dir written here loads in the JAX
package's model (masks 1e-4).  The rest is the trainer's own contract:
storage dir layout, exact resume, gradient accumulation (1e-6: one sum
taken in two parts), loss weights read at every step, a non-finite loss
on the last step raising, and ``test_run``'s verdicts.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models.bss import (
    PermutationInvariantTrainingModel as JaxPIT)
from padertorch_tpu.serialize import load_state as jax_load_state
from padertorch_tpu.summary import tfevents as jax_tfevents
from padertorch_tpu.train import trigger as jax_trigger
from padertorch_tpu.train.optimizer import Adam as JaxAdam
from padertorch_tpu_torch import Model
from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data, train as pit_train)
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.summary import tfevents
from padertorch_tpu_torch.summary.writer import SummaryWriter
from padertorch_tpu_torch.train import trigger
from padertorch_tpu_torch.train.hooks import ValidationHook
from padertorch_tpu_torch.train.optimizer import SGD, Adam
from padertorch_tpu_torch.train.trainer import (
    InteractiveTrainer, MultiDeviceTrainer, Trainer)

torch.set_num_threads(2)


class Regression(Model):
    """y = W x + b with two losses, each summed over the batch."""

    def __init__(self, noisy_eval=False):
        super().__init__()
        self.linear = torch.nn.Linear(4, 3)
        self.noisy_eval = noisy_eval

    def forward(self, batch):
        out = self.linear(batch['x'])
        if self.noisy_eval and not self.training:
            out = out + torch.rand_like(out)
        return out

    def review(self, batch, out):
        err = out - batch['y']
        return {'losses': {'l2': (err ** 2).sum(), 'l1': err.abs().sum()},
                'scalars': {'batch_size': len(batch['x'])}}


def _batches(n, size=2, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 3)
    out = []
    for _ in range(n):
        x = rng.randn(size, 4).astype('float32')
        out.append({'x': x, 'y': (scale * x @ w).astype('float32'),
                    'example_id': [f'e{i}' for i in range(size)]})
    return out


def _trainer(path, model=None, seed=0, **kwargs):
    torch.manual_seed(seed)
    kwargs.setdefault('loss_weights', {'l2': 1.0, 'l1': 0.0})
    kwargs.setdefault('summary_trigger', (2, 'iteration'))
    kwargs.setdefault('checkpoint_trigger', (1, 'epoch'))
    kwargs.setdefault('stop_trigger', (2, 'epoch'))
    return Trainer(model or Regression(), path,
                   kwargs.pop('optimizer', None) or SGD(lr=0.01), **kwargs)


def _params(trainer):
    return {k: v.detach().clone()
            for k, v in trainer.model.state_dict().items()}


def test_storage_dir_contract(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.register_validation_hook(_batches(2, seed=1))
    trainer.train(_batches(3))
    assert (trainer.iteration, trainer.epoch) == (6, 2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names[0] == 'checkpoints' and len(names) == 2
    assert names[1].startswith('events.out.tfevents.')
    ckpt_dir = tmp_path / 'checkpoints'
    # max_checkpoints=1: the best survives, and the one that ckpt_latest
    # pointed to while the last was being written (ckpt_0 is gone)
    assert sorted(p.name for p in ckpt_dir.iterdir()) == [
        'ckpt_3.ptt', 'ckpt_6.ptt', 'ckpt_best_loss.ptt',
        'ckpt_latest.ptt', 'ckpt_ranking.json']
    assert (ckpt_dir / 'ckpt_latest.ptt').resolve().name == 'ckpt_6.ptt'
    assert (ckpt_dir / 'ckpt_best_loss.ptt').resolve().name == 'ckpt_6.ptt'
    ranking = json.loads((ckpt_dir / 'ckpt_ranking.json').read_text())
    assert ranking['metric'] == 'loss' and not ranking['maximize']
    assert [name for name, _ in ranking['ranking']] == [
        'ckpt_6.ptt', 'ckpt_3.ptt']
    # the JAX package's loader reads the file: same format, same entries
    state = jax_load_state(ckpt_dir / 'ckpt_6.ptt')
    assert set(state) == {'model', 'iteration', 'epoch', 'optimizer',
                          'hooks'}
    assert (state['iteration'], state['epoch']) == (6, 2)
    assert set(state['model']) == {'linear.weight', 'linear.bias'}
    assert state['model']['linear.weight'].shape == (4, 3)  # (in, out)
    assert set(state['hooks']) == {'ValidationHook'}


def test_validation_ranks_and_keeps_the_best(tmp_path):
    """A learning rate that diverges: the first checkpoint stays best."""
    trainer = _trainer(tmp_path, optimizer=SGD(lr=0.5),
                       stop_trigger=(4, 'epoch'))
    trainer.register_validation_hook(_batches(2, seed=1), max_checkpoints=2)
    trainer.train(_batches(3, scale=3.0))
    ckpt_dir = tmp_path / 'checkpoints'
    hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
    scores = [s for _, s in hook.ckpt_ranking]
    assert scores == sorted(scores)
    assert (ckpt_dir / 'ckpt_best_loss.ptt').resolve().name == \
        hook.ckpt_ranking[0][0] == 'ckpt_0.ptt'
    assert hook.n_degradations == 4
    # the two best, the last, and the one ckpt_latest pointed to meanwhile
    kept = {p.name for p in ckpt_dir.glob('ckpt_[0-9]*.ptt')}
    assert kept == {'ckpt_0.ptt', 'ckpt_3.ptt', 'ckpt_9.ptt', 'ckpt_12.ptt'}


def test_resume_continues_exactly(tmp_path):
    batches = _batches(3)
    straight = _trainer(tmp_path / 'a', optimizer=Adam(lr=0.01),
                        stop_trigger=(4, 'epoch'))
    straight.register_validation_hook(_batches(2, seed=1))
    straight.train(batches)

    first = _trainer(tmp_path / 'b', optimizer=Adam(lr=0.01))
    first.register_validation_hook(_batches(2, seed=1))
    first.train(batches)
    assert first.iteration == 6
    resumed = _trainer(tmp_path / 'b', seed=5, optimizer=Adam(lr=0.01),
                       stop_trigger=(4, 'epoch'))
    resumed.register_validation_hook(_batches(2, seed=1))
    resumed.train(batches, resume=True)
    assert (resumed.iteration, resumed.epoch) == (12, 4)
    for key, value in _params(straight).items():
        assert torch.equal(value, _params(resumed)[key]), key
    assert sorted(p.name for p in (tmp_path / 'b/checkpoints').iterdir()) \
        == sorted(p.name for p in (tmp_path / 'a/checkpoints').iterdir())
    with pytest.raises(AssertionError, match='resume'):
        _trainer(tmp_path / 'b').train(batches)


def test_virtual_minibatch_is_one_step_on_the_doubled_batch(tmp_path):
    halves = _batches(4, size=2)
    doubled = [{k: (np.concatenate([a[k], b[k]]) if k != 'example_id'
                    else a[k] + b[k]) for k in a}
               for a, b in zip(halves[::2], halves[1::2])]
    accumulated = _trainer(tmp_path / 'a', virtual_minibatch_size=2,
                           stop_trigger=(1, 'epoch'))
    accumulated.train(halves)
    whole = _trainer(tmp_path / 'b', stop_trigger=(1, 'epoch'))
    whole.train(doubled)
    assert accumulated.iteration == whole.iteration == 2
    for key, value in _params(whole).items():
        torch.testing.assert_close(_params(accumulated)[key], value,
                                   atol=1e-6, rtol=0)


def test_loss_weights_are_read_at_every_step(tmp_path):
    from padertorch_tpu_torch.train.hooks import Hook

    class SwitchLoss(Hook):
        def pre_step(self, trainer):
            if trainer.iteration == 1:
                trainer.loss_weights = {'l2': 0.0, 'l1': 1.0}

    trainer = _trainer(tmp_path, summary_trigger=(1, 'iteration'),
                       stop_trigger=(2, 'iteration'))
    trainer.register_hook(SwitchLoss())
    trainer.train(_batches(2))
    event_file, = [p for p in tmp_path.iterdir() if 'tfevents' in p.name]
    scalars = tfevents.scalars_from_events(event_file)
    assert scalars['training/l2_loss_weight'] == [(1, 1.0), (2, 0.0)]
    assert scalars['training/l1_loss_weight'] == [(1, 0.0), (2, 1.0)]
    for step, loss in scalars['training/loss']:
        used = 'training/l2' if step == 1 else 'training/l1'
        assert loss == dict(scalars[used])[step]


@pytest.mark.parametrize('bad_step', [0, 2])
def test_non_finite_loss_raises_also_on_the_last_step(tmp_path, bad_step):
    batches = _batches(3)
    batches[bad_step]['y'][0, 0] = np.nan
    trainer = _trainer(tmp_path, stop_trigger=(3, 'iteration'))
    with pytest.raises(RuntimeError, match='not finite'):
        trainer.train(batches)
    # the check runs one step late (after the next step's backward, before
    # its optimizer step), and when training ends for the last step
    assert trainer.iteration == bad_step + 1
    assert trainer.writer is None
    assert (tmp_path / 'log' / 'error_state_model_state.ptt').exists()


def test_test_run_passes_on_a_sound_model_and_restores_it(tmp_path):
    trainer = _trainer(tmp_path)
    before = _params(trainer)
    trainer.test_run(_batches(3), _batches(2, seed=1))
    for key, value in before.items():
        assert torch.equal(value, _params(trainer)[key]), key
    assert (trainer.iteration, trainer.epoch) == (-1, -1)
    assert list(tmp_path.iterdir()) == []
    trainer.test_run(_batches(4), _batches(2, seed=1),
                     virtual_minibatch_size=2,
                     test_with_known_iterator_length=True)


def test_test_run_fails_when_eval_is_not_deterministic(tmp_path):
    trainer = _trainer(tmp_path, model=Regression(noisy_eval=True))
    with pytest.raises(AssertionError, match='Not equal to tolerance'):
        trainer.test_run(_batches(3), _batches(2, seed=1))


def test_test_run_fails_when_the_loss_does_not_depend_on_the_model(tmp_path):
    trainer = _trainer(tmp_path, optimizer=SGD(lr=0.0))
    with pytest.raises(AssertionError, match='did not change'):
        trainer.test_run(_batches(3), _batches(2, seed=1))
    with pytest.raises(AssertionError, match='needs 2 validation batches'):
        trainer.test_run(_batches(3), _batches(1, seed=1))


@pytest.mark.parametrize('spec', [
    (1, 'epoch'), (2, 'epoch'), (1, 'iteration'), (3, 'iteration')])
def test_triggers_fire_as_the_jax_ones(spec):
    schedule = [(it, it // 4) for it in range(14)]
    for cls in ('IntervalTrigger', 'EndTrigger'):
        mine = getattr(trigger, cls).new(spec)
        theirs = getattr(jax_trigger, cls).new(spec)
        assert [mine(it, ep) for it, ep in schedule] == \
            [theirs(it, ep) for it, ep in schedule]
        mine.set_last(6, 1)
        theirs.set_last(6, 1)
        assert [mine(it, ep) for it, ep in schedule[6:]] == \
            [theirs(it, ep) for it, ep in schedule[6:]]
    combos = [(trigger, jax_trigger)]
    for mod in combos[0]:
        any_t = mod.AnyTrigger((3, 'iteration'), (1, 'epoch'))
        all_t = mod.AllTrigger((2, 'iteration'), (1, 'epoch'))
        not_t = mod.NotTrigger(mod.IntervalTrigger.new(spec))
        fired = [(any_t(it, ep), all_t(it, ep), not_t(it, ep))
                 for it, ep in schedule]
        combos.append(fired)
    assert combos[1] == combos[2]


def _normalised(events):
    out = []
    for event in events:
        for value in event.get('summary', {}).get('value', []):
            kind, = set(value) - {'tag'}
            payload = value[kind]
            if kind == 'simple_value':
                # protobuf's dict form prints a float32's shortest decimal
                payload = float(np.float32(payload))
            elif kind == 'image':
                payload = (int(payload['height']), int(payload['width']),
                           int(payload['colorspace']))
            elif kind == 'histo':
                payload = {k: np.asarray(v, dtype=float).tolist()
                           for k, v in payload.items()}
            out.append((value['tag'], int(event.get('step', 0)), kind,
                        payload))
    return out


def test_event_file_reads_the_same_in_both_packages(tmp_path):
    config = pit_train.get_trainer_config(tmp_path, {
        'model': {'units': 8, 'recurrent_layers': 1},
        'summary_trigger': (2, 'iteration'),
        'stop_trigger': (1, 'epoch')})
    trainer = Trainer.from_config(config)
    batches = data.prepare_dataset(
        data.synthetic_database(num_examples=6, num_samples=3000),
        batch_size=2, shuffle=False, prefetch=False)
    trainer.register_validation_hook(batches)
    trainer.train(batches)
    event_file, = [p for p in tmp_path.iterdir() if 'tfevents' in p.name]
    mine = tfevents.load_events_as_dict(event_file)
    theirs = jax_tfevents.load_events_as_dict(event_file)
    assert len(mine) == len(theirs) > 20
    assert mine[0]['file_version'] == theirs[0]['file_version'] \
        == 'brain.Event:2'
    got, want = _normalised(mine), _normalised(theirs)
    assert got == want
    tags = {(tag, kind) for tag, _, kind, _ in got}
    assert {('training/loss', 'simple_value'),
            ('training/grad_norm', 'simple_value'),
            ('training/grad_norm_', 'histo'),
            ('training/lr/param_group_0', 'simple_value'),
            ('training/pit_mse_loss', 'simple_value'),
            ('training_timings/time_per_iteration', 'simple_value'),
            ('training_timings/time_rel_backward', 'simple_value'),
            ('training/mask_0', 'image'),
            ('training/observation', 'image'),
            ('validation/loss', 'simple_value'),
            ('validation/estimation_1', 'image')} <= tags
    assert sorted({step for tag, step, _, _ in got
                   if tag == 'training/loss'}) == [2, 3]
    mine = tfevents.scalars_from_events(event_file)
    theirs = jax_tfevents.scalars_from_events(event_file)
    assert mine.keys() == theirs.keys()
    for tag in mine:
        assert mine[tag] == [(step, float(np.float32(value)))
                             for step, value in theirs[tag]], tag


def test_writer_refuses_what_it_does_not_write(tmp_path):
    writer = SummaryWriter(tmp_path)
    try:
        for name in ('add_figure', 'add_text'):
            with pytest.raises(NotImplementedError,
                               match='summary/writer.py'):
                getattr(writer, name)('tag', None, 0)
        with pytest.raises(ValueError):
            writer.add_image('tag', np.zeros((5, 6)), 0)
    finally:
        writer.close()


def test_storage_dir_loads_in_the_jax_package(tmp_path):
    """The checkpoint contract: ``model`` is in the JAX layout, so the JAX
    model loads a training of the port; the ``optimizer`` entry is the
    port's own and shares no key with the JAX optimizer's state."""
    size = {'units': 8, 'recurrent_layers': 2}
    config = pit_train.get_trainer_config(tmp_path, {
        'model': size, 'stop_trigger': (2, 'iteration')})
    from padertorch_tpu_torch.io import dump_config
    dump_config({'trainer': config}, tmp_path / 'config.json')
    trainer = Trainer.from_config(config)
    batches = data.prepare_dataset(
        data.synthetic_database(num_examples=4, num_samples=3000),
        batch_size=2, shuffle=False, prefetch=False)
    trainer.register_validation_hook(batches)
    trainer.train(batches)

    stored = json.loads((tmp_path / 'config.json').read_text())
    assert stored['trainer']['model']['factory'] == \
        'padertorch_tpu.models.bss.PermutationInvariantTrainingModel'
    ptrandom.seed(0)
    jax_model = JaxPIT.from_storage_dir(tmp_path)
    port = PermutationInvariantTrainingModel.from_storage_dir(
        tmp_path).eval()
    batch = next(iter(batches))
    want = np.asarray(jax_model({
        'Y_abs': jnp.asarray(batch['Y_abs']),
        'num_frames': jnp.asarray(batch['num_frames'])}))
    with torch.no_grad():
        got = port({'Y_abs': torch.from_numpy(batch['Y_abs']),
                    'num_frames': torch.from_numpy(batch['num_frames'])})
        live = trainer.model.eval()(
            {'Y_abs': torch.from_numpy(batch['Y_abs']),
             'num_frames': torch.from_numpy(batch['num_frames'])})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert torch.equal(got, live)

    state = jax_load_state(tmp_path / 'checkpoints' / 'ckpt_latest.ptt')
    assert set(state['optimizer']) == {'state', 'hyperparams'}
    names = [n for n, p in port.named_parameters() if p.requires_grad]
    assert list(state['optimizer']['state']) == names
    assert set(state['optimizer']['state'][names[0]]) == {
        'step', 'exp_avg', 'exp_avg_sq'}
    jax_opt = JaxAdam().set_parameters(
        {k: jnp.asarray(v) for k, v in state['model'].items()})
    assert not set(jax_opt.state_dict()) & (
        set(state['optimizer']) | set(state['optimizer']['state']))


@pytest.mark.parametrize('kwargs', [
    {'adversarial': True}, {'sharding': 'data'}, {'precision': 'bfloat16'},
    {'async_checkpointing': True}, {'checkpoint_format': 'orbax'}])
def test_options_that_are_not_ported_raise(tmp_path, kwargs):
    with pytest.raises(NotImplementedError, match='not ported'):
        _trainer(tmp_path, **kwargs)


def test_trainers_that_are_not_ported_raise(tmp_path):
    for cls in (MultiDeviceTrainer, InteractiveTrainer):
        with pytest.raises(NotImplementedError, match='not ported'):
            cls(Regression(), tmp_path, SGD())
    trainer = _trainer(tmp_path)
    with pytest.raises(NotImplementedError, match='BackOff'):
        trainer.register_validation_hook(_batches(2), n_back_off=1,
                                         back_off_patience=1)
    with pytest.raises(NotImplementedError, match='ProgressBar'):
        trainer.train(_batches(2), progress_bar=True)
