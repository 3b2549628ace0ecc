"""One uPIT training step, and three, against the JAX package.

The same weights (through ``from_jax_state_dict``) and the same batches,
made with numpy, go through both packages on the CPU; the JAX side runs
its Pallas LSTM kernels in interpret mode (and the ``scan`` backend for
the gradients).  Sizes are cut (2 BLSTM layers of 16 units, F=33).

- review losses and the gradient of every parameter: 1e-4 (f32, two
  recurrent layers and their adjoints, sums in another order);
- three optimizer steps with ``Adam(gradient_clipping=10)``, and with a
  clip small enough to bind, against the JAX ``Trainer``'s train step:
  losses, pre-clip gradient norms (1e-4 relative) and every parameter
  after each step (1e-4);
- the bias rule that makes this hold: the port trains ``bias_ih`` alone.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models.bss import (
    PermutationInvariantTrainingModel as JaxPIT)
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules.recurrent import set_rnn_backend
from padertorch_tpu.train.optimizer import Adam as JaxAdam
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.models.bss import (
    PermutationInvariantTrainingModel, _masked_pit_mse)
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

SIZE = dict(F=33, recurrent_layers=2, units=16, K=2)
ATOL = 1e-4
LOSS_WEIGHTS = {'pit_mse_loss': 1.0, 'pit_ips_loss': 0.5}


def _batch(seed):
    rng = np.random.RandomState(seed)
    b, t, k, f = 3, 14, 2, 33
    lens = np.array([14, 9, 5], dtype='int32')
    valid = (np.arange(t)[None, :] < lens[:, None]).astype('float32')
    x = np.abs(rng.randn(b, t, k, f)).astype('float32') * valid[
        :, :, None, None]
    return {
        'Y_abs': (x.sum(2) * rng.uniform(0.8, 1.2, (b, t, f))).astype(
            'float32'),
        'X_abs': x,
        'cos_phase_difference': rng.uniform(-1, 1, (b, t, k, f)).astype(
            'float32'),
        'num_frames': lens,
    }


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _models(seed, backend='pallas'):
    ptrandom.seed(seed)
    jax_model = set_rnn_backend(JaxPIT(**SIZE), backend)
    port = from_jax_state_dict(
        PermutationInvariantTrainingModel(**SIZE), jax_model.state_dict())
    return jax_model, port.train()


def test_masked_pit_mse_matches_jax():
    from padertorch_tpu.models.bss import _masked_pit_mse as jax_fn
    rng = np.random.RandomState(0)
    est, tgt = (rng.randn(3, 14, 3, 5).astype('float32') for _ in range(2))
    lens = np.array([14, 9, 5], dtype='int32')
    want = jax_fn(jnp.asarray(est), jnp.asarray(tgt), jnp.asarray(lens))
    got = _masked_pit_mse(torch.from_numpy(est), torch.from_numpy(tgt),
                          torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('backend', ['scan', 'pallas'])
def test_review_losses_and_gradients_match_jax(backend):
    jax_model, port = _models(0, backend)
    batch = _batch(0)
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        review = model.review(_jnp(batch), model(_jnp(batch)))
        return sum(LOSS_WEIGHTS[k] * v for k, v in review['losses'].items()
                   ), review['losses']

    (_, want_losses), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    want_grads = state_dict(want_grads)

    review = port.review(_torch(batch), port(_torch(batch)))
    assert review.keys() == {'losses'}
    for key, value in review['losses'].items():
        np.testing.assert_allclose(
            value.detach().numpy(), np.asarray(want_losses[key]),
            atol=ATOL, rtol=0, err_msg=key)
    sum(LOSS_WEIGHTS[k] * v for k, v in review['losses'].items()).backward()

    # the port's gradients in the JAX layout: as weights move, so do they
    grads = PermutationInvariantTrainingModel(**SIZE)
    with torch.no_grad():
        for (name, p), g in zip(port.named_parameters(),
                                grads.parameters()):
            if p.requires_grad:
                g.copy_(p.grad)
            else:
                assert p.grad is None and 'bias_hh' in name
                g.zero_()
    got_grads = to_jax_state_dict(grads)
    assert got_grads.keys() == want_grads.keys()
    for name in got_grads:
        np.testing.assert_allclose(
            got_grads[name], np.asarray(want_grads[name]), atol=ATOL,
            rtol=0, err_msg=name)


def test_snapshots_only_when_asked_for():
    _, port = _models(1)
    batch = _torch(_batch(1))
    port.create_snapshot = True
    review = port.review(batch, port(batch))
    assert set(review['snapshots']) == {
        'observation', 'mask_0', 'mask_1', 'estimation_0', 'estimation_1'}
    assert tuple(review['snapshots']['mask_1'].shape) == (14, 33)


def _jax_train_steps(jax_model, clip, batches, tmp_path):
    """Losses, pre-clip norms and parameters after each step of the JAX
    Trainer's own (jitted) train step."""
    trainer = JaxTrainer(
        jax_model, tmp_path / 'jax', JaxAdam(gradient_clipping=clip),
        loss_weights=LOSS_WEIGHTS)
    step = trainer._get_fn('train', trainer._make_train_step)
    params, static = partition(trainer.model)
    out = []
    for i, batch in enumerate(batches):
        key = jax.random.fold_in(trainer._base_key, i)
        params, static, states, loss, _, _, norms = step(
            params, static, trainer._opt_states, _jnp(batch), key,
            trainer._loss_weight_arrays())
        trainer._set_opt_states(states)
        out.append((float(loss), float(norms['']),
                    {k: np.asarray(v) for k, v in state_dict(
                        combine(params, static)).items()}))
    return out


@pytest.mark.parametrize('clip', [10.0, 0.05])
def test_three_adam_steps_match_the_jax_trainer(clip, tmp_path):
    jax_model, port = _models(2)
    batches = [_batch(10 + i) for i in range(3)]
    want = _jax_train_steps(jax_model, clip, batches, tmp_path)

    trainer = Trainer(port, tmp_path / 'port',
                      Adam(gradient_clipping=clip),
                      loss_weights=LOSS_WEIGHTS)
    norms = []
    for batch, (want_loss, want_norm, want_params) in zip(batches, want):
        loss, _, _, review = trainer.train_step(trainer.model, batch)
        loss.backward()
        norm = trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=ATOL)
        np.testing.assert_allclose(float(norm), want_norm, rtol=ATOL)
        np.testing.assert_allclose(
            float(review['scalars']['pit_ips_loss_loss_weight']), 0.5)
        got_params = to_jax_state_dict(port)
        for name in want_params:
            np.testing.assert_allclose(
                got_params[name], want_params[name], atol=ATOL, rtol=0,
                err_msg=name)
        norms.append(float(norm))
    # the small clip binds at every step, the recipe's never does
    assert all(n > clip for n in norms) == (clip < 1)


def test_training_both_biases_would_leave_the_jax_trajectory(tmp_path):
    """The trap the bias rule avoids: with ``bias_hh`` trained too, both
    biases get the fused bias's gradient, the norm that the clip sees
    grows and the bias moves twice as far."""
    jax_model, port = _models(3)
    batch = _batch(20)
    # (the JAX step donates its parameters: read them before it runs)
    start = np.asarray(state_dict(jax_model)['blstm.b.0']).copy()
    (_, want_norm, want_params), = _jax_train_steps(
        jax_model, 10.0, [batch], tmp_path)
    for name, p in port.named_parameters():
        if 'bias_hh' in name:
            p.requires_grad_(True)
    trainer = Trainer(port, tmp_path / 'port', Adam(gradient_clipping=10.0),
                      loss_weights=LOSS_WEIGHTS)
    loss, _, _, _ = trainer.train_step(trainer.model, batch)
    loss.backward()
    norm = float(trainer.optimizer.step())
    assert norm > want_norm * (1 + 1e-3)
    moved = np.abs(to_jax_state_dict(port)['blstm.b.0'] - start).max()
    moved_jax = np.abs(want_params['blstm.b.0'] - start).max()
    np.testing.assert_allclose(moved, 2 * moved_jax, rtol=1e-2)
