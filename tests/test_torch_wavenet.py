"""The port's ``WaveNet`` and ``WaveNetVocoder`` against the JAX package's,
on the CPU.

The same weights (through ``from_jax_state_dict``) and the same inputs,
made with numpy, go through both packages at a cut size (4 layers of 8
residual and 16 skip channels, 8 conditioning channels, upsampling 8/4).

- ``forward``: logits 1e-4, quantized targets equal; ``get_cond_input``
  for every fading, also window == stride (no fading region);
- the sampler, through ``sample`` (seeded by a generator) and through
  ``sample_kernel`` (seeded by an integer), its plain version here, against
  the JAX ``lax.scan`` sampler: greedy indices equal and teacher-forced
  logits 2e-5; one generator state gives one sequence of draws whichever
  of the two is called;
- ``infer``: sequential chunks equal the ``parallel`` batch under greedy,
  and both equal the JAX package's;
- the vocoder's loss 1e-4 relative, the gradient of every parameter 1e-4 of
  its largest entry, three optimizer steps with ``Adam(lr=1e-3,
  gradient_clipping=10)`` (the recipe's) against the JAX ``Trainer``'s
  train step: losses and pre-clip norms 1e-3 relative, parameters 1e-4;
- ``mu_law_encode`` truncates as the JAX package's; ``softmax_cross_entropy``
  ignores -1; the weights' round trip through both layouts is exact.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.examples.audio_synthesis.wavenet.model import (
    WaveNetVocoder as JaxWaveNetVocoder)
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules.wavenet import WaveNet as JaxWaveNet
from padertorch_tpu.ops.losses.classification import (
    softmax_cross_entropy as jax_softmax_cross_entropy)
from padertorch_tpu.ops.mu_law import (
    mu_law_decode as jax_mu_law_decode, mu_law_encode as jax_mu_law_encode)
from padertorch_tpu.train.optimizer import Adam as JaxAdam
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet.model \
    import WaveNetVocoder
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.modules.wavenet import Conv, WaveNet
from padertorch_tpu_torch.ops.kernels.wavenet import wavenet_sample
from padertorch_tpu_torch.ops.losses.classification import (
    softmax_cross_entropy)
from padertorch_tpu_torch.ops.mu_law import mu_law_decode, mu_law_encode
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

ATOL = 1e-4
LOGIT_TOL = 2e-5
SMALL = dict(n_cond_channels=8, upsamp_window=8, upsamp_stride=4,
             n_layers=4, max_dilation=4, n_residual_channels=8,
             n_skip_channels=16)


def _models(seed=0, **updates):
    ptrandom.seed(seed)
    kwargs = {**SMALL, **updates}
    jax_model = JaxWaveNetVocoder(JaxWaveNet(**kwargs))
    port = from_jax_state_dict(WaveNetVocoder(WaveNet(**kwargs)),
                               jax_model.state_dict())
    return jax_model, port


def _batch(seed, frames=12, batch=2, window=8, stride=4):
    rng = np.random.RandomState(seed)
    samples = (frames - 1) * stride + window - 2 * (window - stride)
    return {
        'features': rng.randn(batch, 8, frames).astype('float32'),
        # a few more samples than the features cover: the model crops
        'audio_data': rng.uniform(-1, 1, (batch, samples + 3)).astype(
            'float32'),
    }


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_logits_and_targets_match_jax():
    jax_model, port = _models()
    batch = _batch(0)
    want = jax_model(_jnp(batch))
    with torch.no_grad():
        got = port(_torch(batch))
    assert tuple(got['logits'].shape) == want['logits'].shape == (2, 256, 44)
    np.testing.assert_allclose(got['logits'].numpy(),
                               np.asarray(want['logits']), atol=ATOL, rtol=0)
    assert got['quantized'].dtype == torch.int32
    np.testing.assert_array_equal(got['quantized'].numpy(),
                                  np.asarray(want['quantized']))
    # position 0 sees nothing
    assert float(got['logits'][:, :, 0].abs().max()) == 0.0
    with pytest.raises(ValueError, match='upsample'):
        port.wavenet(torch.from_numpy(batch['features']),
                     torch.from_numpy(batch['audio_data'][:, :30]))


@pytest.mark.parametrize('window,stride,fading', [
    (8, 4, 'full'), (8, 4, 'half'), (7, 4, 'half'), (8, 4, None),
    (4, 4, 'full'), (4, 4, 'half')])
def test_get_cond_input_matches_jax(window, stride, fading):
    jax_model, port = _models(1, upsamp_window=window, upsamp_stride=stride,
                              fading=fading)
    features = np.random.RandomState(1).randn(2, 8, 9).astype('float32')
    want = np.asarray(jax_model.wavenet.get_cond_input(jnp.asarray(features)))
    with torch.no_grad():
        got = port.wavenet.get_cond_input(torch.from_numpy(features)).numpy()
    assert got.shape == want.shape and got.shape[-1] > 0
    assert got.shape[1] == 2 * 8 * 4
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _cond(port, seed=2, frames=10):
    features = np.random.RandomState(seed).randn(2, 8, frames).astype(
        'float32')
    with torch.no_grad():
        cond = port.wavenet.get_cond_input(torch.from_numpy(features))
    return cond.reshape(2, 4, 16, -1)


@pytest.mark.parametrize('route', ['sample', 'sample_kernel'])
def test_samplers_match_the_jax_scan_sampler(route):
    jax_model, port = _models(2)
    cond = _cond(port)
    forced = np.random.RandomState(3).randint(
        0, 256, (2, cond.shape[-1])).astype('int32')
    sampler = getattr(port.wavenet, route)
    want = jax_model.wavenet.sample(jnp.asarray(cond.numpy()), sample=False)
    got = sampler(cond, sample=False)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, want_logits = jax_model.wavenet.sample(
        jnp.asarray(cond.numpy()), sample=False,
        forced_input=jnp.asarray(forced), return_logits=True)
    _, got_logits = sampler(cond, sample=False,
                            forced_input=torch.from_numpy(forced),
                            return_logits=True)
    assert tuple(got_logits.shape) == want_logits.shape
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=LOGIT_TOL, rtol=0)


def test_teacher_forced_sampler_logits_are_the_training_logits():
    """What ties the sampler to the training graph: fed the true sample
    t - 1 at step t, step t's logits are ``forward``'s at position t."""
    _, port = _models(4)
    batch = _torch(_batch(4))
    with torch.no_grad():
        out = port(batch)
        cond = port.wavenet.get_cond_input(batch['features'])
    t = out['quantized'].shape[1]
    cond = cond[..., :t].reshape(2, 4, 16, t)
    forced = torch.cat([torch.full((2, 1), 128, dtype=torch.int32),
                        out['quantized'][:, :-1]], dim=1)
    _, logits = port.wavenet.sample_kernel(
        cond, sample=False, forced_input=forced, return_logits=True)
    # step 0 is the phantom position before the shift (training zeroes it)
    np.testing.assert_allclose(logits[:, :, 1:].numpy(),
                               out['logits'][:, :, 1:].numpy(), atol=ATOL,
                               rtol=0)


def test_infer_sequential_equals_parallel_and_jax_under_greedy():
    jax_model, port = _models(5)
    features = np.random.RandomState(5).randn(2, 8, 21).astype('float32')
    kwargs = dict(chunk_length=30, chunk_overlap=6, sample=False)
    sequential = port.wavenet.infer(torch.from_numpy(features), **kwargs)
    parallel = port.wavenet.infer(torch.from_numpy(features), parallel=True,
                                  **kwargs)
    whole = port.wavenet.infer(torch.from_numpy(features), sample=False)
    assert tuple(sequential.shape) == tuple(whole.shape) == (2, 80)
    assert float(sequential.abs().max()) <= 1.0
    # the same indices; the decode's float32 power differs in the last bit
    # between tensor shapes
    np.testing.assert_allclose(sequential.numpy(), parallel.numpy(),
                               atol=1e-7, rtol=0)
    assert len(np.unique(sequential.numpy())) > 10
    # the first chunk is the whole signal's head
    np.testing.assert_allclose(sequential[:, :20].numpy(),
                               whole[:, :20].numpy(), atol=1e-7, rtol=0)
    for mode in (False, True):
        want = jax_model.wavenet.infer(jnp.asarray(features), parallel=mode,
                                       **kwargs)
        np.testing.assert_allclose(sequential.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=0)


def test_infer_draws_from_its_generator():
    _, port = _models(6)
    features = torch.from_numpy(
        np.random.RandomState(6).randn(1, 8, 6).astype('float32'))
    a = port.wavenet.infer(features, generator=torch.Generator().manual_seed(1))
    b = port.wavenet.infer(features, generator=torch.Generator().manual_seed(1))
    c = port.wavenet.infer(features, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert port.synthesize(features, generator=torch.Generator()
                           .manual_seed(1)).equal(a)
    assert wavenet_sample.launches == 0      # CPU tensors launch nothing


def test_sample_draws_what_sample_kernel_draws_for_its_seed():
    """One sampler per contract: ``sample`` takes its seed from the
    generator and is ``sample_kernel`` from there on, so the CPU's draws
    are the counter-based generator's, which the card's kernel repeats."""
    _, port = _models(8)
    cond = _cond(port, seed=8)
    generator = torch.Generator().manual_seed(5)
    seed = int(torch.randint(0, 2 ** 30, (), generator=generator))
    got = port.wavenet.sample(cond, torch.Generator().manual_seed(5))
    want = port.wavenet.sample_kernel(cond, seed=seed)
    other = port.wavenet.sample_kernel(cond, seed=seed + 1)
    assert torch.equal(got, want) and not torch.equal(got, other)
    with pytest.raises(ValueError, match='conditioning channels'):
        port.wavenet.sample(cond[:, :, :8])


def test_loss_and_gradients_match_jax():
    jax_model, port = _models(7)
    batch = _batch(7)
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        return model.review(_jnp(batch), model(_jnp(batch)))['loss']

    want_loss, want = jax.value_and_grad(jax_loss)(params)
    want = {k: np.asarray(v) for k, v in state_dict(want).items()}
    review = port.review(_torch(batch), port(_torch(batch)))
    np.testing.assert_allclose(float(review['loss'].detach()), float(want_loss),
                               rtol=ATOL)
    want_review = jax_model.review(_jnp(batch), jax_model(_jnp(batch)))
    np.testing.assert_allclose(
        float(review['scalars']['accuracy']),
        float(want_review['scalars']['accuracy']), atol=1e-6)
    review['loss'].backward()
    grads = WaveNetVocoder(WaveNet(**SMALL))
    with torch.no_grad():
        for (name, p), g in zip(port.named_parameters(), grads.parameters()):
            assert p.grad is not None, name
            g.copy_(p.grad)
    got = to_jax_state_dict(grads)
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name], w, rtol=0, atol=ATOL * float(np.abs(w).max()),
            err_msg=name)


def test_three_adam_steps_match_the_jax_trainer(tmp_path):
    jax_model, port = _models(8)
    batches = [_batch(20 + i) for i in range(3)]
    jax_trainer = JaxTrainer(
        jax_model, tmp_path / 'jax',
        JaxAdam(lr=1e-3, gradient_clipping=10.0))
    step = jax_trainer._get_fn('train', jax_trainer._make_train_step)
    params, static = partition(jax_trainer.model)
    trainer = Trainer(port.train(), tmp_path / 'port',
                      Adam(lr=1e-3, gradient_clipping=10.0))
    for i, batch in enumerate(batches):
        key = jax.random.fold_in(jax_trainer._base_key, i)
        params, static, states, want_loss, _, _, norms = step(
            params, static, jax_trainer._opt_states, _jnp(batch), key,
            jax_trainer._loss_weight_arrays())
        jax_trainer._set_opt_states(states)
        want_params = {k: np.asarray(v) for k, v in state_dict(
            combine(params, static)).items()}
        loss, _, _, _ = trainer.train_step(trainer.model, batch)
        loss.backward()
        norm = trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(norm), float(norms['']), rtol=1e-3)
        got_params = to_jax_state_dict(port)
        for name in want_params:
            np.testing.assert_allclose(
                got_params[name], want_params[name], atol=ATOL, rtol=0,
                err_msg=name)


def test_weights_round_trip_exactly_and_export():
    jax_model, port = _models(9)
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    assert 'wavenet.dilate_layers.3.conv.weight' in got
    assert got['wavenet.upsample.weight'].shape == (8, 8, 8)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    again = to_jax_state_dict(from_jax_state_dict(
        WaveNetVocoder(WaveNet(**SMALL)), got))
    for name in want:
        np.testing.assert_array_equal(again[name], want[name], err_msg=name)
    exported = port.wavenet.export_weights()
    want_exported = jax_model.wavenet.export_weights()
    assert exported.keys() == want_exported.keys()
    for key, value in want_exported.items():
        if isinstance(value, list):
            for a, b in zip(exported[key], value):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(exported[key], value)


def test_conv_init_is_xavier_uniform_with_torch_gains():
    torch.manual_seed(0)
    for gain_name, gain in (('linear', 1.0), ('tanh', 5 / 3),
                            ('relu', 2 ** 0.5), ('sigmoid', 1.0)):
        conv = Conv(64, 128, kernel_size=2, w_init_gain=gain_name)
        bound = gain * (6.0 / (64 * 2 + 128 * 2)) ** 0.5
        w = conv.conv.weight.detach()
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.97 * bound
        np.testing.assert_allclose(float(w.std()), bound / 3 ** 0.5,
                                   rtol=0.05)
    # an explicit generator decides the draw, whatever the global one holds
    first, second = (Conv(8, 8, generator=torch.Generator().manual_seed(3))
                     for _ in range(2))
    assert torch.equal(first.conv.weight, second.conv.weight)
    assert not torch.equal(first.conv.weight, Conv(8, 8).conv.weight)


def test_dogmatic_config_is_the_jax_models():
    """As written to ``config.json``, where classes carry their
    ``padertorch_tpu.`` path in both packages."""
    from padertorch_tpu.io import dumps_config as jax_dumps
    from padertorch_tpu_torch.io import dumps_config
    want = json.loads(jax_dumps(JaxWaveNetVocoder.get_config()))
    got = json.loads(dumps_config(WaveNetVocoder.get_config()))
    assert got == want
    assert got['wavenet']['factory'] == \
        'padertorch_tpu.modules.wavenet.wavenet.WaveNet'
    assert (got['wavenet']['n_layers'], got['wavenet']['max_dilation'],
            got['wavenet']['n_residual_channels']) == (16, 128, 64)
    model = WaveNetVocoder.from_config(WaveNetVocoder.get_config(
        {'wavenet': SMALL}))
    assert model.wavenet.dilations == [1, 2, 4, 1]


def test_mu_law_truncates_like_jax_and_decodes():
    x = np.random.RandomState(0).uniform(-1, 1, 5000).astype('float32')
    x[:3] = [-1.0, 0.0, 1.0]
    got = mu_law_encode(torch.from_numpy(x))
    assert got.dtype == torch.int32
    want = np.asarray(jax_mu_law_encode(jnp.asarray(x)))
    # float32 log1p differs in the last bit between the packages: a value
    # that lands within 1e-4 of an integer may truncate to its neighbour
    mu = 255.0
    exact = (np.sign(x.astype('float64'))
             * np.log1p(mu * np.abs(x.astype('float64'))) / np.log1p(mu)
             + 1) / 2 * mu + 0.5
    clear = np.abs(exact - np.round(exact)) > 1e-4
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    assert clear.mean() > 0.99
    assert got[:3].tolist() == [0, 128, 255]
    # truncation, not rounding: 0.3 encodes to 207.23 + 0.5 -> 207
    assert int(mu_law_encode(torch.tensor(0.3))) == int(exact_index(0.3))
    idx = np.arange(256).astype('int32')
    np.testing.assert_allclose(
        mu_law_decode(torch.from_numpy(idx)).numpy(),
        np.asarray(jax_mu_law_decode(jnp.asarray(idx))), atol=1e-6)


def exact_index(value, mu=255.0):
    x_mu = np.sign(value) * np.log1p(mu * abs(value)) / np.log1p(mu)
    return np.floor((x_mu + 1) / 2 * mu + 0.5)


def test_softmax_cross_entropy_matches_jax_and_ignores_minus_one():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 11).astype('float32')
    t = rng.randint(0, 11, (3, 7)).astype('int32')
    t[0, :3] = -1
    want = float(jax_softmax_cross_entropy(jnp.asarray(x), jnp.asarray(t)))
    got = softmax_cross_entropy(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # the mean is over the non-ignored: not the mean over all 21
    keep = t != -1
    logp = torch.log_softmax(torch.from_numpy(x), -1).numpy()
    picked = np.take_along_axis(logp, np.where(keep, t, 0)[..., None], -1)
    np.testing.assert_allclose(float(got), -picked[..., 0][keep].mean(),
                               rtol=1e-6)
    all_ignored = softmax_cross_entropy(
        torch.from_numpy(x), torch.full((3, 7), -1, dtype=torch.int64))
    assert float(all_ignored) == 0.0
    with pytest.raises(ValueError, match='do not fit'):
        softmax_cross_entropy(torch.from_numpy(x), torch.zeros(3, 6))
