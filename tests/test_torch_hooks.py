"""The port's hooks against the JAX package's, each through both Trainers.

The same model (``y = gain * (W x + b)``, two losses; the port's weights
from the JAX model's through ``migrate.py``), the same batches made with
numpy, the same hook settings: after each optimizer step the learning
rate, the loss weights and the annealed attribute are equal (1e-6
relative: the JAX package keeps the learning rate in float32), the
parameters agree within 1e-5, and so do the checkpoint directories, the
rankings and the back-off's iteration.  The EMA of the weights within
1e-6.  Each hook with state resumes to the trajectory of the JAX resume.
"""
import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import padertorch_tpu as jpt
from padertorch_tpu import nn as jnn
from padertorch_tpu import random as ptrandom
from padertorch_tpu.module import state_dict as jax_state_dict
from padertorch_tpu.train import hooks as jax_hooks
from padertorch_tpu.train import optimizer as jax_optim
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch import Model
from padertorch_tpu_torch.migrate import (
    from_jax_arrays, from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.summary import tfevents
from padertorch_tpu_torch.train import hooks
from padertorch_tpu_torch.train import optimizer as optim
from padertorch_tpu_torch.train.trainer import InteractiveTrainer, Trainer

torch.set_num_threads(2)

ATOL = 1e-5
LOSS_WEIGHTS = {'l2': 1.0, 'l1': 0.5}


class Regression(Model):
    def __init__(self):
        super().__init__()
        self.linear = torch.nn.Linear(4, 3)
        self.gain = 1.0

    def forward(self, batch):
        return self.linear(batch['x']) * self.gain

    def review(self, batch, out):
        err = out - batch['y']
        return {'losses': {'l2': (err ** 2).sum(), 'l1': err.abs().sum()}}


class JaxRegression(jpt.Model):
    def __init__(self):
        self.linear = jnn.Linear(4, 3)
        self.gain = 1.0

    def forward(self, batch):
        return self.linear(batch['x']) * self.gain

    def review(self, batch, out):
        err = out - batch['y']
        return {'losses': {'l2': jnp.sum(err ** 2),
                           'l1': jnp.sum(jnp.abs(err))}}


def _batches(n, seed=0, size=2):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 3)
    out = []
    for _ in range(n):
        x = rng.randn(size, 4).astype('float32')
        out.append({'x': x, 'y': (x @ w).astype('float32')})
    return out


def _schedule(count):
    return 0.05 * 0.7 ** count


def _jax_layout(model):
    # copies: on the CPU the arrays of ``to_jax_state_dict`` may be views
    # of the live parameters
    return {k: v.copy() for k, v in to_jax_state_dict(model).items()}


def _read_port(trainer):
    return {'iteration': trainer.iteration, 'lr': trainer.optimizer.lr,
            'weights': dict(trainer.loss_weights),
            'gain': float(trainer.model.gain),
            'params': _jax_layout(trainer.model)}


def _read_jax(trainer):
    return {'iteration': trainer.iteration, 'lr': trainer.optimizer.lr,
            'weights': {k: float(v) for k, v in trainer.loss_weights.items()},
            'gain': float(trainer.model.gain),
            'params': {k: np.asarray(v)
                       for k, v in trainer.model.state_dict().items()}}


def _recorder(base, read):
    class Recorder(base):
        def __init__(self):
            self.rows = []

        def post_optimize(self, trainer, summary):
            self.rows.append(read(trainer))

    return Recorder()


def _trainers(tmp_path, make_hooks, optimizer=('SGD', {'lr': 0.05}),
              stop=(3, 'epoch'), validation=None):
    """The two trainers on the same weights with the same hooks
    (``make_hooks(module)`` builds them from ``hooks`` or ``jax_hooks``),
    each with a recorder; returns [(trainer, recorder, hooks)] port
    first."""
    ptrandom.seed(0)
    jax_model = JaxRegression()
    port = from_jax_state_dict(Regression(), jax_model.state_dict())
    name, kwargs = optimizer
    out = []
    for cls, model, opt_module, hook_module, read, sub in (
            (Trainer, port, optim, hooks, _read_port, 'port'),
            (JaxTrainer, jax_model, jax_optim, jax_hooks, _read_jax, 'jax')):
        trainer = cls(model, tmp_path / sub,
                      getattr(opt_module, name)(**kwargs),
                      loss_weights=dict(LOSS_WEIGHTS),
                      summary_trigger=(1, 'epoch'),
                      checkpoint_trigger=(1, 'epoch'), stop_trigger=stop)
        recorder = _recorder(hook_module.Hook, read)
        made = make_hooks(hook_module)
        trainer.register_hook([*made, recorder])
        if validation is not None:
            trainer.register_validation_hook(_batches(2, seed=9),
                                             **validation)
        out.append((trainer, recorder, made))
    return out


def _assert_rows_equal(got, want):
    assert len(got) == len(want) > 0
    for mine, theirs in zip(got, want):
        assert mine['iteration'] == theirs['iteration']
        np.testing.assert_allclose(mine['lr'], theirs['lr'], rtol=1e-6)
        assert mine['weights'].keys() == theirs['weights'].keys()
        for k in mine['weights']:
            np.testing.assert_allclose(mine['weights'][k],
                                       theirs['weights'][k], rtol=1e-6)
        np.testing.assert_allclose(mine['gain'], theirs['gain'], rtol=1e-6)
        assert mine['params'].keys() == theirs['params'].keys()
        for k in mine['params']:
            np.testing.assert_allclose(mine['params'][k], theirs['params'][k],
                                       atol=ATOL, rtol=0, err_msg=k)


HOOK_SETS = {
    'lr_schedule': lambda h: [h.LRSchedulerHook(
        _schedule, trigger=(1, 'iteration'))],
    'lr_schedule_by_epoch': lambda h: [h.LRSchedulerHook(
        _schedule, trigger=(1, 'epoch'))],
    'lr_annealing': lambda h: [h.LRAnnealingHook(
        (1, 'iteration'), [(2, 1.0), (7, 0.2)], 'iteration')],
    'loss_weight_annealing': lambda h: [h.LossWeightAnnealingHook(
        (1, 'iteration'), [(3, 0.25), (6, 2.0)], 'iteration', 'l1')],
    'model_attribute_annealing': lambda h: [h.ModelAttributeAnnealingHook(
        (1, 'epoch'), [(1, 0.5), (3, 1.5)], 'epoch', 'gain')],
}


@pytest.mark.parametrize('hook_set', sorted(HOOK_SETS))
def test_hook_and_its_resume_match_jax(tmp_path, hook_set):
    """Three epochs of 3 steps; then both packages resume their storage
    dir to five epochs, with the hook's state from the checkpoint."""
    make = HOOK_SETS[hook_set]
    (port, port_rec, port_hooks), (theirs, jax_rec, jax_hooks_) = \
        _trainers(tmp_path, make)
    batches = _batches(3)
    port.train(batches)
    theirs.train(batches)
    _assert_rows_equal(port_rec.rows, jax_rec.rows)
    for mine, theirs_ in zip(port_hooks, jax_hooks_):
        assert mine.uid == theirs_.uid
        mine, theirs_ = mine.state_dict(), theirs_.state_dict()
        assert mine.keys() == theirs_.keys()
        for key in mine:   # an annealed learning rate's scale: float32
            np.testing.assert_allclose(mine[key], theirs_[key], rtol=1e-7)

    (port, port_rec, port_hooks), (theirs, jax_rec, jax_hooks_) = \
        _trainers(tmp_path, make, stop=(5, 'epoch'))
    port.train(batches, resume=True)
    theirs.train(batches, resume=True)
    assert port_rec.rows[0]['iteration'] == 9
    _assert_rows_equal(port_rec.rows, jax_rec.rows)


def test_back_off_matches_jax(tmp_path):
    """The validation set's loss rises as the model fits the training
    set's: the first degradation backs off to ``ckpt_0``, halves the
    learning rate and trains on from iteration 0."""
    validation = dict(metric='loss', maximize=False, n_back_off=1,
                      back_off_patience=0, lr_update_factor=0.5,
                      max_checkpoints=2)
    (port, port_rec, _), (theirs, jax_rec, _) = _trainers(
        tmp_path, lambda h: [], optimizer=('Adam', {'lr': 0.05}),
        validation=validation)
    batches = _batches(3)
    port.train(batches)
    theirs.train(batches)
    _assert_rows_equal(port_rec.rows, jax_rec.rows)
    iterations = [row['iteration'] for row in port_rec.rows]
    back_off = iterations.index(0, 1)   # iteration 0 a second time
    assert [row['lr'] for row in port_rec.rows[back_off - 1:back_off + 1]] \
        == [0.05, 0.025]
    port_dir, jax_dir = (t.checkpoint_dir for t in (port, theirs))
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(
        p.name for p in jax_dir.iterdir())
    mine, want = (json.loads((d / 'ckpt_ranking.json').read_text())
                  for d in (port_dir, jax_dir))
    assert [n for n, _ in mine['ranking']] == [n for n, _ in want['ranking']]
    np.testing.assert_allclose([s for _, s in mine['ranking']],
                               [s for _, s in want['ranking']], rtol=ATOL)
    for d in (port_dir, jax_dir):
        assert (d / 'ckpt_best_loss.ptt').resolve().name == \
            mine['ranking'][0][0]
    hook, = [h for h in port.hooks
             if isinstance(h, hooks.BackOffValidationHook)]
    assert hook.remaining_back_offs == 0


def test_ema_matches_jax_and_resumes(tmp_path):
    (port, _, (ema,)), (theirs, _, (jax_ema,)) = _trainers(
        tmp_path, lambda h: [h.EMAHook(decay=0.6)])
    batches = _batches(3)
    port.train(batches)
    theirs.train(batches)
    want = {k: np.asarray(v)
            for k, v in jax_state_dict(jax_ema.ema_params).items()}
    live = _jax_layout(port.model)
    with ema.average_parameters(port.model):
        got = _jax_layout(port.model)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
        assert np.abs(got[k] - live[k]).max() > 1e-3, k
    for k, v in _jax_layout(port.model).items():
        np.testing.assert_array_equal(v, live[k])   # swapped back
    # the JAX average in the port's names and layouts (migrate.py)
    theirs_here = from_jax_arrays(port.model, want)
    assert theirs_here.keys() == ema.ema_params.keys()
    for name, value in ema.ema_params.items():
        np.testing.assert_allclose(theirs_here[name].numpy(), value.numpy(),
                                   atol=1e-6, rtol=0)

    # the average is checkpointed by name and restored at the first step
    state = port.state_dict()['hooks']['EMAHook']
    assert set(state['average']) == {'linear.weight', 'linear.bias'}
    resumed = Trainer(Regression(), tmp_path / 'port', optim.SGD(lr=0.05),
                      loss_weights=dict(LOSS_WEIGHTS))
    restored = hooks.EMAHook(decay=0.9)
    resumed.register_hook(restored)
    resumed.load_checkpoint()
    restored.pre_step(resumed)
    assert restored.decay == 0.6
    for name, value in ema.ema_params.items():
        assert torch.equal(restored.ema_params[name], value), name


def test_ema_is_the_host_recomputation(tmp_path):
    """``ema = d * ema + (1 - d) * p`` after every step, the first a copy,
    against the same expression in numpy from the recorded parameters."""
    (port, recorder, (ema,)), _ = _trainers(
        tmp_path, lambda h: [h.EMAHook(decay=0.75)])
    port.train(_batches(3))
    seen = [row['params'] for row in recorder.rows]
    expect = dict(seen[0])
    for params in seen[1:]:
        expect = {k: np.float32(0.75) * expect[k]
                  + np.float32(0.25) * params[k] for k in expect}
    with ema.average_parameters(port.model):
        got = _jax_layout(port.model)
    for k in expect:
        np.testing.assert_allclose(got[k], expect[k], atol=1e-6, rtol=0)


def _fake_trainer(iteration=0, epoch=0):
    class Writer:
        def __init__(self):
            self.scalars = {}

        def add_scalar(self, tag, value, step):
            self.scalars[tag] = (value, step)

    class Fake:
        device = torch.device('cpu')
        writer = Writer()
    fake = Fake()
    fake.iteration, fake.epoch = iteration, epoch
    return fake


def test_energy_hook_as_the_jax_one():
    trainer = _fake_trainer()
    hook = hooks.EnergyEstimateHook((1, 'epoch'), chip_watts=200.0,
                                    host_watts=100.0)
    theirs = jax_hooks.EnergyEstimateHook((1, 'epoch'), chip_watts=200.0,
                                          host_watts=100.0)
    assert hook.uid == theirs.uid and hook.priority == theirs.priority
    hook.pre_step(trainer)
    assert trainer.writer.scalars['x_emissions/avg_power_watts'][0] == 300.0
    energy0 = trainer.writer.scalars['x_emissions/energy_kwh'][0]
    state = hook.state_dict()
    assert set(state) == set(theirs.state_dict()) == {'consumed_kwh_before'}
    again = hooks.EnergyEstimateHook((1, 'epoch'))
    again.load_state_dict(state)
    theirs.load_state_dict(state)
    assert again._consumed_kwh() == theirs._consumed_kwh() >= energy0
    trainer.iteration = 10
    hook.close(trainer)
    energy1 = trainer.writer.scalars['x_emissions/energy_kwh'][0]
    assert trainer.writer.scalars['x_emissions/co2_kg'][0] == \
        pytest.approx(energy1 * 0.475)
    # the default on a CPU model: the host alone, no TPU budget
    cpu = hooks.EnergyEstimateHook()
    cpu.pre_step(trainer)
    assert cpu.watts == 100.0


def test_energy_hook_reads_the_cards_power_limit(monkeypatch):
    calls = []

    class Done:
        stdout = '700.00\n'

    def run(command, **kwargs):
        calls.append(command)
        return Done()

    monkeypatch.setattr(hooks.subprocess, 'run', run)
    assert hooks.card_power_limit_watts('cuda:1') == 700.0
    assert calls == [['nvidia-smi', '--query-gpu=power.limit',
                      '--format=csv,noheader,nounits', '-i', '1']]


def test_resume_with_track_emissions(tmp_path):
    batches = _batches(3)
    for epochs, resume in ((1, False), (2, True)):
        (port, _, _), _ = _trainers(tmp_path, lambda h: [],
                                    stop=(epochs, 'epoch'))
        port.train(batches, resume=resume, track_emissions=True)
    assert port.epoch == 2
    state = port.state_dict()['hooks']['EnergyEstimateHook']
    assert state['consumed_kwh_before'] > 0
    event_file = sorted(p for p in (tmp_path / 'port').iterdir()
                        if 'tfevents' in p.name)[-1]
    assert 'x_emissions/energy_kwh' in tfevents.scalars_from_events(
        event_file)


def test_progress_bar_and_its_missing_dependency(tmp_path, monkeypatch,
                                                  capsys):
    (port, _, _), _ = _trainers(tmp_path, lambda h: [], stop=(1, 'epoch'))
    port.train(_batches(3), progress_bar=True)
    assert port.iteration == 3
    monkeypatch.setitem(sys.modules, 'tqdm', None)
    (port, _, _), _ = _trainers(tmp_path / 'b', lambda h: [])
    with pytest.raises(ImportError, match='tqdm'):
        port.train(_batches(3), progress_bar=True)


def test_profiler_hook_writes_a_trace(tmp_path):
    (port, _, (profiler,)), _ = _trainers(
        tmp_path, lambda h: [h.TorchProfilerHook((100, 'iteration'),
                                                 num_steps=2)]
        if h is hooks else [])
    port.train(_batches(3))
    assert profiler.trace_path == tmp_path / 'port' / 'profile' / \
        'trace_2.json'
    events = json.loads(profiler.trace_path.read_text())['traceEvents']
    names = {event.get('name', '') for event in events}
    assert any(name.startswith('aten::') for name in names)


def test_interactive_trainer_prints_instead_of_writing(tmp_path, capsys):
    trainer = InteractiveTrainer(Regression(), tmp_path, optim.SGD(lr=0.05),
                                 loss_weights=dict(LOSS_WEIGHTS),
                                 summary_trigger=(1, 'iteration'),
                                 stop_trigger=(2, 'iteration'))
    trainer.train(_batches(3))
    out = capsys.readouterr().out
    assert '[1] training/loss: ' in out and '[2] training/l1: ' in out
    assert not [p for p in tmp_path.iterdir() if 'tfevents' in p.name]
    assert (tmp_path / 'checkpoints' / 'ckpt_latest.ptt').exists()


def test_annealing_is_piecewise_linear_as_in_jax():
    values = {}
    for module in (hooks, jax_hooks):
        class Probe(module.AnnealingHook):
            def get_value(self, trainer):
                return 2.0

            def set_value(self, trainer, value):
                values.setdefault(module.__name__, []).append(value)

        hook = Probe((1, 'iteration'), [(2, 1.0), (4, 0.5)], 'iteration',
                     'x')
        for it in range(6):
            trainer = _fake_trainer(iteration=it)
            hook.pre_step(trainer)
    mine, theirs = values.values()
    assert mine == theirs == [2.0, 2.0, 2.0, 1.5, 1.0, 1.0]
