"""The port's One-and-Rest PIT (``models/or_pit.py``) and its recipe
against the JAX package's, on the CPU.

- ``one_and_rest_permutation_invariant_loss``: the loss and the index,
  including a tie (both pick the first of equal candidates);
- ``OneAndRestPIT`` on a small ``blstm`` DPRNN TasNet (the same weights
  through ``from_jax_state_dict``; the JAX side on its ``scan`` backend,
  the plain time loop): ``forward`` 1e-4, ``review`` with a ragged batch
  and 2 or 3 targets 1e-4 relative, every gradient 1e-4 of its largest
  entry; ``separate`` with and without ``num_speakers``, 1e-4;
- the weights' round trip (the ``separator.`` prefix), exact;
- the recipe's ``train.py --small --device cpu`` for one epoch on a few
  synthetic mixtures, then its ``evaluate.py`` on 4 requests, in this
  process.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models import or_pit as jax_or_pit
from padertorch_tpu.models import tasnet as jax_tasnet
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules.dual_path_rnn import DPRNN as JaxDPRNN
from padertorch_tpu.modules.recurrent import set_rnn_backend
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.models import or_pit, tasnet
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
from tests.test_torch_pit_slice import _run_main

torch.set_num_threads(2)

ATOL = 1e-4


def _mse(e, t, lib):
    return lib.mean((e - t) ** 2)


@pytest.mark.parametrize('case', ['distinct', 'tie'])
def test_loss_and_index_match_jax_including_a_tie(case):
    rng = np.random.RandomState(0)
    targets = rng.randn(3, 16).astype('float32')
    if case == 'tie':
        targets[2] = targets[0]         # candidates 0 and 2 are equal
        inputs = np.stack([targets[0], targets.sum(0) - targets[0]])
    else:
        inputs = rng.randn(2, 16).astype('float32')
    want_loss, want_idx = jax_or_pit.one_and_rest_permutation_invariant_loss(
        jnp.asarray(inputs), jnp.asarray(targets),
        lambda e, t: _mse(e, t, jnp))
    got_loss, got_idx = or_pit.one_and_rest_permutation_invariant_loss(
        torch.from_numpy(inputs), torch.from_numpy(targets),
        lambda e, t: _mse(e, t, torch))
    assert int(got_idx) == int(want_idx)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=ATOL,
                               atol=1e-7)
    if case == 'tie':
        assert int(got_idx) == 0


def _build(package, dprnn, tasnet_module):
    separator = tasnet_module.TasNet(
        encoder=tasnet_module.TasEncoder(20, feature_size=32),
        separator=dprnn(16, 8, window_length=10, hop_size=5, num_blocks=2),
        decoder=tasnet_module.TasDecoder(20, feature_size=32))
    return package.OneAndRestPIT(separator, max_iterations=3)


@pytest.fixture(scope='module')
def models():
    ptrandom.seed(0)
    jax_model = set_rnn_backend(
        _build(jax_or_pit, JaxDPRNN, jax_tasnet), 'scan')
    port = from_jax_state_dict(_build(or_pit, DPRNN, tasnet),
                               jax_model.state_dict())
    return jax_model, port


def _batch(seed, speakers=2, samples=403):
    rng = np.random.RandomState(seed)
    lens = np.array([samples, samples - 70, samples - 151], dtype='int32')
    valid = (np.arange(samples)[None, :] < lens[:, None]).astype('float32')
    s = (rng.randn(3, speakers, samples) * 0.3).astype('float32') \
        * valid[:, None]
    return {'y': s.sum(1).astype('float32'), 's': s, 'num_samples': lens}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: v if k == 'num_samples' else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize('speakers', [2, 3])
def test_forward_and_review_match_jax(models, speakers):
    jax_model, port = models
    batch = _batch(speakers, speakers)
    want = jax_model(_jnp(batch))
    want_review = jax_model.review(_jnp(batch), want)
    with torch.no_grad():
        got = port.eval()(_torch(batch))
        got_review = port.review(_torch(batch), got)
    assert got.keys() == want.keys() == {'one', 'rest'}
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert got_review.keys() == want_review.keys() == {'loss'}
    np.testing.assert_allclose(float(got_review['loss']),
                               float(want_review['loss']), rtol=ATOL)


def test_review_without_num_samples_takes_the_whole_signal(models):
    jax_model, port = models
    batch = _batch(4)
    del batch['num_samples']
    want = jax_model.review(_jnp(batch), jax_model(_jnp(batch)))
    with torch.no_grad():
        got = port.review(_torch(batch), port(_torch(batch)))
    np.testing.assert_allclose(float(got['loss']), float(want['loss']),
                               rtol=ATOL)


def test_gradients_match_jax(models):
    jax_model, port = models
    batch = _batch(5, speakers=3)
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        return model.review(_jnp(batch), model(_jnp(batch)))['loss']

    want = state_dict(jax.grad(jax_loss)(params))
    port.zero_grad()
    port.train()
    port.review(_torch(batch), port(_torch(batch)))['loss'].backward()
    grads = _build(or_pit, DPRNN, tasnet)
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


@pytest.mark.parametrize('num_speakers', [None, 2, 3])
def test_separate_matches_jax(models, num_speakers):
    """``max_iterations`` (3) splits without ``num_speakers``, else
    ``num_speakers - 1``."""
    jax_model, port = models
    batch = _batch(6)
    want = np.asarray(jax_model.separate(_jnp(batch),
                                         num_speakers=num_speakers))
    with torch.no_grad():
        got = port.eval().separate(_torch(batch),
                                   num_speakers=num_speakers).numpy()
    assert got.shape == want.shape == (3, num_speakers or 4, 403)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_weights_round_trip_exactly(models):
    jax_model, port = models
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    assert all(k.startswith('separator.') for k in got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_recipe_trains_and_evaluates_on_the_cpu(monkeypatch, tmp_path,
                                                capsys):
    from padertorch_tpu_torch.contrib.examples.source_separation.tasnet \
        import data
    make = data.synthetic_database
    monkeypatch.setattr(
        data, 'synthetic_database',
        lambda *a, num_examples=8, **k: make(
            *a, num_examples=min(num_examples, 4), **k))
    recipe = 'padertorch_tpu_torch.contrib.examples.source_separation.or_pit'
    _run_main(monkeypatch, f'{recipe}.train', '--storage_root',
              str(tmp_path), '--synthetic', '--small', '--epochs', '1',
              '--batch_size', '2', '--device', 'cpu')
    storage_dir = tmp_path / 'or_pit' / '1'
    out = capsys.readouterr().out
    assert 'Successfully finished test run' in out
    assert f'Finished. storage_dir={storage_dir}' in out
    config = json.loads((storage_dir / 'config.json').read_text())
    model = config['trainer']['model']
    assert model['factory'] == 'padertorch_tpu.models.or_pit.OneAndRestPIT'
    assert model['separator']['factory'] == \
        'padertorch_tpu.models.tasnet.TasNet'
    assert 'ckpt_best_loss.ptt' in {
        p.name for p in (storage_dir / 'checkpoints').iterdir()}
    _run_main(monkeypatch, f'{recipe}.evaluate', '--model_path',
              str(storage_dir), '--synthetic', '--device', 'cpu')
    results = json.loads((storage_dir / 'eval' / 'result.json').read_text())
    assert len(results) == 4
    for metrics in results.values():
        assert len(metrics['output_si_sdr']) == 2
        assert np.isfinite(metrics['output_si_sdr']).all()
    means = json.loads((storage_dir / 'eval' / 'means.json').read_text())
    assert np.isfinite(means['improvement_si_sdr'])
