"""The port's mask estimator, beamformers and STOI, and the
``speech_enhancement/mask_estimator`` recipe, against the JAX package's,
on the CPU.

- ``fully_connected_stack`` (dropout off): 1e-4;
- ``binary_cross_entropy``, predictions at 0, 1 and at the clip's bounds
  among them: values and gradients 1e-6 relative; ``F.binary_cross_entropy``
  is another function;
- ``SimpleMaskEstimator`` (dropout 0, small widths, a ragged batch; the
  JAX side on its ``scan`` backend, the plain time loop): forward and
  review 1e-4, every gradient 1e-4 of its largest entry; its snapshots
  become images; the weights' round trip, exact;
- every beamforming function and ``stoi`` on the same numpy inputs: 1e-6
  relative (both are numpy);
- the recipe's ``evaluate_example`` on the synthetic 4-channel database
  with both beamformers, metric by metric against the JAX recipe's: given
  the same masks (a model that returns the JAX model's), 1e-6 relative;
  with each package's own model, whose masks differ by float32 rounding
  (1e-6), stoi 1e-3 and the dB metrics 1e-3 dB through MVDR; through GEV
  0.1 dB, since an untrained model's speech and noise masks are both near
  0.5, so the two PSD matrices nearly coincide and the principal
  generalized eigenvector moves with the last bits of the masks;
- the recipe's ``train.py`` (``test_run``, training) and ``evaluate.py`` on
  the CPU at ``--num_units 16``, in this process.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.evaluation import beamforming as jax_beamforming
from padertorch_tpu.evaluation.stoi import stoi as jax_stoi
from padertorch_tpu.models import mask_estimator as jax_mask_estimator
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules import fully_connected as jax_fully_connected
from padertorch_tpu.modules.recurrent import set_rnn_backend
from padertorch_tpu_torch.evaluation import beamforming
from padertorch_tpu_torch.evaluation.stoi import stoi
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.models import mask_estimator
from padertorch_tpu_torch.modules import fully_connected
from tests.test_torch_pit_slice import _run_main

torch.set_num_threads(2)

ATOL = 1e-4
F = 257


@pytest.mark.parametrize('hidden, output_activation', [
    (None, None), (12, 'sigmoid'), ([12, 10], 'identity'), ([9], 'relu')])
def test_fully_connected_stack(hidden, output_activation):
    ptrandom.seed(0)
    jax_stack = jax_fully_connected.fully_connected_stack(
        7, hidden, 5, activation='elu',
        output_activation=output_activation).eval()
    stack = fully_connected.fully_connected_stack(
        7, hidden, 5, activation='elu', output_activation=output_activation)
    from_jax_state_dict(stack, jax_stack.state_dict()).eval()
    assert len(stack) == len(jax_stack)
    x = np.random.RandomState(0).randn(3, 7).astype('float32')
    np.testing.assert_allclose(
        stack(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jax_stack(jnp.asarray(x))), atol=ATOL, rtol=0)


def test_binary_cross_entropy_with_predictions_at_0_and_1():
    rng = np.random.RandomState(1)
    p = rng.uniform(size=(4, 9)).astype('float32')
    p[0, :4] = [0.0, 1.0, 1e-7, np.float32(1 - 1e-7)]
    p[1, :2] = [1.0, 0.0]
    t = (rng.uniform(size=(4, 9)) > 0.5).astype('float32')
    t[0, :4] = [0.0, 1.0, 1.0, 0.0]
    t[1, :2] = [0.0, 1.0]
    want, want_grad = jax.value_and_grad(
        jax_mask_estimator.binary_cross_entropy)(jnp.asarray(p),
                                                 jnp.asarray(t))
    pt = torch.from_numpy(p).requires_grad_()
    got = mask_estimator.binary_cross_entropy(pt, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=0)
    torch_bce = torch.nn.functional.binary_cross_entropy(
        torch.from_numpy(p), torch.from_numpy(t))
    assert abs(float(torch_bce) - float(want)) > 1e-3


def _build(package, units=16):
    return package.SimpleMaskEstimator(F, num_units=units, dropout=0.0)


@pytest.fixture(scope='module')
def models():
    ptrandom.seed(0)
    jax_model = set_rnn_backend(_build(jax_mask_estimator), 'scan')
    sd = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    rng = np.random.RandomState(3)
    for key in ('norm.gamma', 'norm.beta'):
        sd[key] = (1 + 0.3 * rng.randn(*sd[key].shape)).astype('float32')
    jax_model = jax_model.load_state_dict(
        {k: jnp.asarray(v) for k, v in sd.items()})
    port = from_jax_state_dict(_build(mask_estimator), sd)
    return jax_model, port


def _batch(seed, frames=23):
    rng = np.random.RandomState(seed)
    lens = np.array([frames, frames - 5, frames - 11], dtype='int32')
    valid = (np.arange(frames)[None, :, None] < lens[:, None, None])
    obs = (np.abs(rng.randn(3, frames, F)) * valid).astype('float32')
    speech = ((rng.uniform(size=obs.shape) > 0.5) * valid).astype('float32')
    return {'observation_abs': obs, 'speech_mask_target': speech,
            'noise_mask_target': (1 - speech) * valid.astype('float32'),
            'num_frames': lens}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_and_review_match_jax(models):
    jax_model, port = models
    batch = _batch(0)
    want = jax_model(_jnp(batch))
    want_review = jax_model.review(_jnp(batch), want)
    with torch.no_grad():
        got = port.eval()(_torch(batch))
        got_review = port.review(_torch(batch), got)
    assert got.keys() == want.keys() == {
        'speech_mask_prediction', 'noise_mask_prediction'}
    for key in got:
        assert tuple(got[key].shape) == (3, 23, F)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(float(got_review['loss']),
                               float(want_review['loss']), rtol=ATOL)


def test_gradients_match_jax(models):
    jax_model, port = models
    batch = _batch(1)
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        return model.review(_jnp(batch), model(_jnp(batch)))['loss']

    want = state_dict(jax.grad(jax_loss)(params))
    port.zero_grad()
    port.train().review(_torch(batch), port(_torch(batch)))['loss'].backward()
    grads = _build(mask_estimator)
    with torch.no_grad():
        for (name, p), g in zip(port.named_parameters(),
                                grads.parameters()):
            if p.requires_grad:
                g.copy_(p.grad)
            else:
                assert 'bias_hh' in name
                g.zero_()
    got = to_jax_state_dict(grads)
    assert got.keys() == want.keys()
    for name in got:
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=ATOL * np.abs(w).max(), err_msg=name)


def test_weights_round_trip_and_snapshots(models):
    jax_model, port = models
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    batch = _torch(_batch(2))
    port.create_snapshot = True
    try:
        with torch.no_grad():
            review = port.review(batch, port(batch))
    finally:
        port.create_snapshot = False
    summary = port.modify_summary({
        'scalars': {}, 'snapshots': review['snapshots'], 'images': {},
        'buffers': {}})
    assert set(summary['images']) == {
        'speech_mask', 'noise_mask', 'observed_stft', 'speech_mask_target',
        'noise_mask_target'}
    assert summary['images']['speech_mask'].shape == (1, F, 23)


def _stft_inputs(seed, channels=4, frames=40, bins=9):
    rng = np.random.RandomState(seed)
    y = rng.randn(channels, frames, bins) + 1j * rng.randn(
        channels, frames, bins)
    speech = rng.uniform(size=(frames, bins))
    return y, speech, 1 - speech


BEAMFORMING = ['psd', 'psd_no_mask', 'gev', 'phase_correction', 'mvdr',
               'ban', 'apply', 'gev_beamforming', 'gev_beamforming_no_ban']


def _beamform(lib, name, y, speech, noise):
    target = lib.get_power_spectral_density_matrix(y, speech)
    noise_psd = lib.get_power_spectral_density_matrix(y, noise)
    if name == 'psd':
        return target
    if name == 'psd_no_mask':
        return lib.get_power_spectral_density_matrix(y)
    if name == 'gev':
        return lib.get_gev_vector(target, noise_psd)
    if name == 'phase_correction':
        return lib.phase_correction(y[:, 0, :].T)
    if name == 'mvdr':
        return lib.get_mvdr_vector_souden(target, noise_psd, ref_channel=1)
    if name == 'ban':
        return lib.blind_analytic_normalization(
            lib.get_mvdr_vector_souden(target, noise_psd), noise_psd)
    if name == 'apply':
        return lib.apply_beamforming_vector(
            lib.get_mvdr_vector_souden(target, noise_psd), y)
    return lib.gev_beamforming(y, speech, noise,
                               ban=name == 'gev_beamforming')


@pytest.mark.parametrize('name', BEAMFORMING)
def test_beamforming_matches_jax_package(name):
    y, speech, noise = _stft_inputs(4)
    want = _beamform(jax_beamforming, name, y, speech, noise)
    got = _beamform(beamforming, name, y, speech, noise)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize('sample_rate', [8000, 10000, 16000])
def test_stoi_matches_jax_package(sample_rate):
    rng = np.random.RandomState(sample_rate)
    n = 3 * sample_rate // 2
    t = np.arange(n) / sample_rate
    clean = np.sin(2 * np.pi * 300 * t) * (1 + np.sin(2 * np.pi * 2 * t))
    noisy = clean + 0.5 * rng.randn(n)
    for estimate in (noisy, clean, 0.1 * noisy):
        want = jax_stoi(clean, estimate, sample_rate=sample_rate)
        got = stoi(clean, estimate, sample_rate=sample_rate)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match='too short'):
        stoi(clean[:2000], noisy[:2000], sample_rate=sample_rate)
    from padertorch_tpu_torch import evaluation
    assert evaluation.stoi is stoi


class _FixedMasks(torch.nn.Module):
    """A model that returns given masks (the JAX model's)."""

    def __init__(self, outputs):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.outputs = outputs

    def forward(self, batch):
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.outputs.items()}


@pytest.mark.parametrize('beamformer', ['mvdr_souden', 'gev'])
def test_evaluate_example_matches_the_jax_recipe(models, beamformer):
    from padertorch_tpu.contrib.examples.speech_enhancement.mask_estimator \
        import evaluate as jax_evaluate
    from padertorch_tpu_torch.contrib.examples.speech_enhancement \
        .mask_estimator import evaluate, train
    jax_model, port = models
    port.eval()
    jax_model = jax_model.eval()
    examples = list(evaluate.synthetic_multichannel_database(num_examples=2))
    jax_examples = list(jax_evaluate.synthetic_multichannel_database(
        num_examples=2))
    own_tolerance = 1e-3 if beamformer == 'mvdr_souden' else 0.1
    for example, jax_example in zip(examples, jax_examples):
        np.testing.assert_array_equal(example['observation'],
                                      jax_example['observation'])
        masks = {}

        def recorded(batch):
            masks.update(jax_model(batch))
            return masks

        jax_id, want = jax_evaluate.evaluate_example(
            recorded, jax_evaluate.train_mod._stft, jax_example,
            beamformer=beamformer)
        for model, atol, rtol in (
                (_FixedMasks(masks), 0, 1e-6),
                (port, own_tolerance, 0)):
            example_id, got = evaluate.evaluate_example(
                model, train._stft, example, beamformer=beamformer)
            assert example_id == jax_id
            assert got.keys() == want.keys() == {
                'observed', 'masked', 'beamformed'}
            for kind in got:
                assert got[kind].keys() == {'stoi', 'si_sdr', 'sdr'}
                for metric, value in got[kind].items():
                    assert np.isfinite(value)
                    np.testing.assert_allclose(
                        value, want[kind][metric],
                        atol=min(atol, 1e-3) if metric == 'stoi' else atol,
                        rtol=rtol, err_msg=f'{example_id} {kind} {metric}')


def test_recipe_trains_and_evaluates_on_the_cpu(monkeypatch, tmp_path,
                                                capsys):
    """The recipe's own data: 16 training mixtures, 4 requests."""
    recipe = ('padertorch_tpu_torch.contrib.examples.speech_enhancement'
              '.mask_estimator')
    _run_main(monkeypatch, f'{recipe}.train', '--storage_root',
              str(tmp_path), '--synthetic', '--epochs', '1',
              '--batch_size', '2', '--num_units', '16', '--device', 'cpu')
    storage_dir = tmp_path / 'mask_estimator' / '1'
    out = capsys.readouterr().out
    assert 'Successfully finished test run' in out
    config = json.loads((storage_dir / 'config.json').read_text())
    assert config['trainer']['model']['factory'] == \
        'padertorch_tpu.models.mask_estimator.SimpleMaskEstimator'
    for beamformer in ('mvdr_souden', 'gev'):
        _run_main(monkeypatch, f'{recipe}.evaluate', '--model_path',
                  str(storage_dir), '--synthetic', '--device', 'cpu',
                  '--beamformer', beamformer)
        results = json.loads(
            (storage_dir / 'eval' / 'result.json').read_text())
        assert len(results) == 4
        for metrics in results.values():
            for kind in ('observed', 'masked', 'beamformed'):
                assert all(np.isfinite(v) for v in metrics[kind].values())
