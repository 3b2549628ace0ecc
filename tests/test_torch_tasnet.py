"""The port's ``TasNet`` against the JAX package's, on the CPU.

The same weights (through ``from_jax_state_dict``) and the same batches,
made with numpy, go through both packages; the JAX side runs its Pallas
recurrence kernels in interpret mode.  Sizes are cut (32 filters, 2 DPRNN
blocks of 8 units on 16 features, chunks of 10) and the batch is ragged.

- ``forward``: every key of the output dict, 1e-4 (f32, four recurrences
  in a row and two layer norms, sums in another order);
- the three losses, 1e-4 relative;
- three optimizer steps with ``Adam(gradient_clipping=5)`` (the recipe's)
  against the JAX ``Trainer``'s train step: losses and pre-clip gradient
  norms 1e-3 relative, every parameter after each step 1e-4 (Adam's first
  steps move every weight by the learning rate, 1e-3, whatever its
  gradient: a parameter off by 1e-4 is a tenth of one step);
- the weights' round trip through both layouts, exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models import tasnet as jax_tasnet
from padertorch_tpu.modules.dual_path_rnn import DPRNN as JaxDPRNN
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules.recurrent import set_rnn_backend
from padertorch_tpu.train.optimizer import Adam as JaxAdam
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.models import tasnet
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

ATOL = 1e-4
LOSS_WEIGHTS = {'si-sdr': 1.0, 'log-mse': 0.0, 'log1p-mse': 0.0}
VARIANTS = ['blstm', 'bgru', 'win2', 'stft']


def _build(package, dprnn, variant):
    """The small model of one package: ``variant`` is a chunk RNN type of
    the ``dprnn`` configuration, or the ``win2`` / ``stft`` coders."""
    rnn_type = variant if variant in ('blstm', 'bgru') else 'blstm'
    separator = dprnn(16, 8, window_length=10, hop_size=5, num_blocks=2,
                      inter_chunk_type=rnn_type, intra_chunk_type=rnn_type)
    if variant == 'stft':
        coders = dict(encoder=package.StftEncoder(feature_size=32),
                      decoder=package.IstftDecoder(feature_size=32))
    else:
        window = 2 if variant == 'win2' else 20
        coders = dict(
            encoder=package.TasEncoder(window, feature_size=32),
            decoder=package.TasDecoder(window, feature_size=32))
    return package.TasNet(separator=separator, **coders)


def _models(variant, seed=0, backend='pallas'):
    ptrandom.seed(seed)
    jax_model = set_rnn_backend(_build(jax_tasnet, JaxDPRNN, variant),
                                backend)
    port = from_jax_state_dict(_build(tasnet, DPRNN, variant),
                               jax_model.state_dict())
    return jax_model, port


def _batch(seed, samples=403):
    rng = np.random.RandomState(seed)
    lens = np.array([samples, samples - 70, samples - 151], dtype='int32')
    valid = (np.arange(samples)[None, :] < lens[:, None]).astype('float32')
    s = (rng.randn(3, 2, samples) * 0.3).astype('float32') * valid[:, None]
    return {'y': s.sum(1).astype('float32'), 's': s, 'num_samples': lens}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    """As ``TasNet.example_to_device`` leaves it: lengths on the host."""
    return {k: v if k == 'num_samples' else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize('variant', VARIANTS)
def test_forward_and_losses_match_jax(variant):
    jax_model, port = _models(variant)
    batch = _batch(0)
    want = jax_model(_jnp(batch))
    want_losses = jax_model.loss(_jnp(batch), want)
    with torch.no_grad():
        got = port.eval()(_torch(batch))
        got_losses = port.loss(_torch(batch), got)
    assert got.keys() == want.keys() == {
        'out', 'encoded', 'encoded_out', 'encoded_sequence_lengths'}
    lengths = got.pop('encoded_sequence_lengths')
    assert isinstance(lengths, np.ndarray)  # host integers
    np.testing.assert_array_equal(
        lengths, np.asarray(want.pop('encoded_sequence_lengths')))
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert got['out'].shape == (3, 2, 403)
    assert got_losses.keys() == want_losses.keys() == set(LOSS_WEIGHTS)
    for key in got_losses:
        np.testing.assert_allclose(
            float(got_losses[key]), float(want_losses[key]), rtol=ATOL,
            err_msg=key)


def test_losses_without_num_samples_take_the_whole_signal():
    jax_model, port = _models('bgru', seed=1, backend='scan')
    batch = _batch(1)
    del batch['num_samples']
    want = jax_model.loss(_jnp(batch), jax_model(_jnp(batch)))
    with torch.no_grad():
        got = port.loss(_torch(batch), port(_torch(batch)))
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=ATOL, err_msg=key)


@pytest.mark.parametrize('variant', ['blstm', 'bgru'])
def test_gradients_match_jax(variant):
    """The gradient of the weighted loss for every trained parameter,
    1e-4 of each gradient's largest entry."""
    jax_model, port = _models(variant, seed=2)
    batch = _batch(2)
    weights = {'si-sdr': 1.0, 'log-mse': 0.3, 'log1p-mse': 0.2}
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        losses = model.loss(_jnp(batch), model(_jnp(batch)))
        return sum(weights[k] * v for k, v in losses.items())

    want = state_dict(jax.grad(jax_loss)(params))
    losses = port.loss(_torch(batch), port(_torch(batch)))
    sum(weights[k] * v for k, v in losses.items()).backward()
    grads = _build(tasnet, DPRNN, variant)
    with torch.no_grad():
        for (name, p), g in zip(port.named_parameters(),
                                grads.parameters()):
            if p.requires_grad:
                assert p.grad is not None, name
                g.copy_(p.grad)
            else:
                assert p.grad is None and 'bias_hh' in name
                g.zero_()
    got = to_jax_state_dict(grads)
    assert got.keys() == want.keys()
    for name in got:
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=ATOL * np.abs(w).max(), err_msg=name)


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


@pytest.mark.parametrize('variant', ['blstm', 'bgru'])
def test_three_adam_steps_match_the_jax_trainer(variant, tmp_path):
    jax_model, port = _models(variant, seed=3)
    batches = [_batch(10 + i) for i in range(3)]
    want = _jax_train_steps(jax_model, 5.0, batches, tmp_path)
    trainer = Trainer(port.train(), tmp_path / 'port',
                      Adam(gradient_clipping=5.0),
                      loss_weights=LOSS_WEIGHTS)
    for batch, (want_loss, want_norm, want_params) in zip(batches, want):
        loss, example, _, review = trainer.train_step(trainer.model, batch)
        assert isinstance(example['num_samples'], np.ndarray)
        loss.backward()
        norm = trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        np.testing.assert_allclose(float(loss.detach()), want_loss,
                                   rtol=1e-3)
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-3)
        got_params = to_jax_state_dict(port)
        for name in want_params:
            np.testing.assert_allclose(
                got_params[name], want_params[name], atol=ATOL, rtol=0,
                err_msg=name)


@pytest.mark.parametrize('variant', VARIANTS)
def test_weights_round_trip_exactly(variant):
    jax_model, port = _models(variant, seed=4)
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    again = to_jax_state_dict(
        from_jax_state_dict(_build(tasnet, DPRNN, variant), got))
    for name in want:
        np.testing.assert_array_equal(again[name], want[name], err_msg=name)
    # the transposed convolution's axes are swapped, nothing else
    if variant != 'stft':
        np.testing.assert_array_equal(
            port.decoder.decoder_1d.weight.detach().numpy(),
            np.swapaxes(want['decoder.decoder_1d.weight'], 0, 1))


def test_snapshots_become_audio_in_the_summary():
    _, port = _models('bgru', seed=5, backend='scan')
    batch = _torch(_batch(5))
    port.create_snapshot = True
    review = port.review(batch, port(batch))
    assert set(review['snapshots']) == {
        'observation', 'estimate/0', 'estimate/1', 'target/0', 'target/1'}
    summary = {'scalars': {}, 'snapshots': review['snapshots'],
               'audios': {}, 'buffers': {}}
    summary = port.modify_summary(summary)
    assert not summary['snapshots']
    signal, rate = summary['audios']['estimate/1']
    assert rate == 8000 and signal.shape == (403,)
    np.testing.assert_allclose(np.abs(signal).max(), 0.95, rtol=1e-6)


def test_a_separator_that_is_not_ported_raises():
    with pytest.raises(NotImplementedError, match='modules/convnet.py'):
        tasnet.TasNet(encoder=tasnet.TasEncoder(20, 32),
                      separator=torch.nn.Identity(),
                      decoder=tasnet.TasDecoder(20, 32))


def test_dogmatic_config_is_the_jax_models():
    """As written to ``config.json``, where classes carry their
    ``padertorch_tpu.`` path in both packages."""
    import json
    from padertorch_tpu.io import dumps_config as jax_dumps
    from padertorch_tpu_torch.io import dumps_config
    want = json.loads(jax_dumps(jax_tasnet.TasNet.get_config()))
    got = json.loads(dumps_config(tasnet.TasNet.get_config()))
    assert got == want
    assert got['separator']['factory'] == \
        'padertorch_tpu.modules.dual_path_rnn.DPRNN'
    assert got['separator']['rnn_size'] == 128
