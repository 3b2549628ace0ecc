"""The port's feature extractors, normalization and reductions against the
JAX package's, on the CPU, on the same numpy-seeded inputs (1e-4 on
normalized features of size up to 6, 1e-5 relative on filterbanks and
running statistics).

- ``get_fbanks``/``hz2mel``/``mel2hz`` (copies), ``MelTransform`` and its
  ``inverse``, ``DeltaExtractor``;
- ``NormalizedLogMelExtractor`` (deltas, batch norm or input norm, SpecAugment
  masks from an explicit generator) and ``FusedAudioLogMelExtractor`` on its
  three backends, in training (running statistics over several calls) and in
  eval mode;
- ``Normalization``/``InputNormalization``: running statistics with a
  momentum and with the cumulative average, ``inverse``, freeze; the two
  quirks of ``running_var`` (Bessel correction on the power term only, eps
  added twice) pinned by tests that fail for the textbook form;
- ``Sum``/``Mean``/``Max``/``TakeLast``/``AutoPool`` with lengths.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.contrib.je.modules import features as jax_features
from padertorch_tpu.contrib.je.modules import reduce as jax_reduce
from padertorch_tpu.modules import normalization as jax_normalization
from padertorch_tpu_torch.contrib.je.modules import features, reduce
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.modules import normalization
from padertorch_tpu_torch.ops.kernels.logmel import fused_logmel

ATOL = 1e-4


def _sync(port, jax_module):
    return from_jax_state_dict(port, jax_module.state_dict())


@pytest.mark.parametrize('htk_mel', [True, False])
@pytest.mark.parametrize('highest', [None, 7000, -500])
def test_get_fbanks_and_mel_scales_are_the_jax_ones(htk_mel, highest):
    want = jax_features.get_fbanks(16000, 512, 40, 60.0, highest, htk_mel)
    got = features.get_fbanks(16000, 512, 40, 60.0, highest, htk_mel)
    assert got.shape == (40, 257) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    hz = np.linspace(0, 8000, 50)
    np.testing.assert_array_equal(features.hz2mel(hz, htk_mel),
                                  jax_features.hz2mel(hz, htk_mel))
    np.testing.assert_allclose(
        features.mel2hz(features.hz2mel(hz, htk_mel), htk_mel), hz,
        atol=1e-6)


@pytest.mark.parametrize('log', [True, False])
def test_mel_transform_and_inverse_match_jax(log):
    x = np.abs(np.random.RandomState(0).randn(2, 1, 9, 257)).astype(
        'float32')
    jax_mel = jax_features.MelTransform(16000, 512, 40, log=log)
    mel = _sync(features.MelTransform(16000, 512, 40, log=log), jax_mel)
    want = np.asarray(jax_mel(jnp.asarray(x)))
    got = mel(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        mel.inverse(got).numpy(),
        np.asarray(jax_mel.inverse(jnp.asarray(want))), atol=1e-5,
        rtol=1e-4)
    assert list(mel.state_dict()) == ['fbanks']
    assert not list(mel.parameters())


@pytest.mark.parametrize('order', [1, 2])
def test_delta_extractor_matches_jax(order):
    x = np.random.RandomState(1).randn(2, 3, 5, 11).astype('float32')
    want = np.asarray(jax_features.DeltaExtractor(order=order)(
        jnp.asarray(x)))
    got = features.DeltaExtractor(order=order)(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, 5, 11)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _stft_batch(seed, frames=23):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 1, frames, 257, 2).astype('float32'),
            np.array([frames, frames - 5, frames - 11], 'int32'))


@pytest.mark.parametrize('kwargs', [
    {}, {'add_deltas': True, 'add_delta_deltas': True},
    {'batch_norm': True}, {'norm_statistics_axis': 'bft', 'clamp': None}])
def test_normalized_logmel_extractor_matches_jax_over_training_calls(kwargs):
    jax_ex = jax_features.NormalizedLogMelExtractor(16000, 512, 40, **kwargs)
    ex = _sync(features.NormalizedLogMelExtractor(16000, 512, 40, **kwargs),
               jax_ex)
    for step in range(3):                    # training: statistics move
        x, seq_len = _stft_batch(step)
        want, want_len = jax_ex(jnp.asarray(x), jnp.asarray(seq_len))
        got, got_len = ex(torch.from_numpy(x), torch.from_numpy(seq_len))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f'step {step}')
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    stats = to_jax_state_dict(ex)
    for name, value in jax_ex.state_dict().items():
        np.testing.assert_allclose(stats[name], np.asarray(value),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(ex.norm.num_tracked_values.max()) > 0
    jax_ex.eval()
    ex.eval()
    x, seq_len = _stft_batch(9)
    want, _ = jax_ex(jnp.asarray(x), jnp.asarray(seq_len))
    got, _ = ex(torch.from_numpy(x), torch.from_numpy(seq_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # eval leaves the statistics alone
    np.testing.assert_array_equal(
        to_jax_state_dict(ex)['norm.num_tracked_values'],
        stats['norm.num_tracked_values'])
    if not kwargs.get('batch_norm'):
        back = ex.inverse(got)
        want_back = jax_ex.inverse(want)
        assert tuple(back.shape)[-1] == 257
        if kwargs.get('clamp', 6) is None:
            np.testing.assert_allclose(back.numpy(), np.asarray(want_back),
                                       rtol=1e-3, atol=1e-4)


def test_spec_augment_draws_from_an_explicit_generator():
    ex = features.NormalizedLogMelExtractor(
        16000, 512, 40, n_time_masks=2, max_masked_time_steps=5,
        n_frequency_masks=1, max_masked_frequency_bands=8)
    x, seq_len = _stft_batch(0, frames=40)
    x = torch.from_numpy(x)
    plain = features.NormalizedLogMelExtractor(16000, 512, 40)
    ex.generator = torch.Generator().manual_seed(3)
    a, _ = ex(x)
    ex.norm.reset_running_stats()
    ex.generator = torch.Generator().manual_seed(3)
    b, _ = ex(x)
    ex.norm.reset_running_stats()
    ex.generator = torch.Generator().manual_seed(4)
    c, _ = ex(x)
    unmasked, _ = plain(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    masked = (a == 0) & (unmasked != 0)
    assert bool(masked.any())
    # masked entries form whole time columns or whole mel rows, at most 5
    # (twice) of 40 frames and 8 of 40 bands per example
    for i in range(3):
        cols = masked[i, 0].all(dim=0).sum()
        rows = masked[i, 0].all(dim=1).sum()
        assert int(cols) <= 10 and int(rows) <= 8
        rest = masked[i, 0][~masked[i, 0].all(dim=1)][
            :, ~masked[i, 0].all(dim=0)]
        assert not bool(rest.any())
    assert torch.equal(a[~masked], unmasked[~masked])
    ex.eval()
    plain.eval()
    ex.norm.load_state_dict(plain.norm.state_dict())
    assert torch.equal(ex(x)[0], plain(x)[0])   # eval mode masks nothing


def _audio_batch(seed, samples=3000):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, samples).astype('float32') * 0.1,
            np.array([samples, samples - 700, samples - 1501], 'int32'))


@pytest.mark.parametrize('backend', ['auto', 'pallas', 'jnp'])
def test_fused_audio_extractor_matches_jax_over_training_calls(backend):
    """On the CPU 'auto' and 'jnp' are the composed path and 'pallas' the
    fused route's plain version; the JAX side runs 'jnp' (its Pallas
    front end is held by ``test_torch_logmel_kernel.py``)."""
    jax_ex = jax_features.FusedAudioLogMelExtractor(
        16000, 512, 128, 64, backend='jnp')
    ex = _sync(features.FusedAudioLogMelExtractor(
        16000, 512, 128, 64, backend=backend), jax_ex)
    for step in range(3):
        x, seq_len = _audio_batch(step)
        want, want_len = jax_ex(jnp.asarray(x), jnp.asarray(seq_len))
        got, got_len = ex(torch.from_numpy(x), torch.from_numpy(seq_len))
        assert tuple(got.shape) == (3, 1, 64, 27)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f'step {step}')
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
        assert got_len.tolist() == [27, 21, 15]
    stats = to_jax_state_dict(ex)
    assert set(stats) == set(jax_ex.state_dict())
    for name, value in jax_ex.state_dict().items():
        np.testing.assert_allclose(stats[name], np.asarray(value),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    jax_ex.eval()
    ex.eval()
    x, seq_len = _audio_batch(9)
    want, _ = jax_ex(jnp.asarray(x[:, None]), jnp.asarray(seq_len))
    got, _ = ex(torch.from_numpy(x[:, None]), seq_len)   # (B, 1, T) audio
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert fused_logmel.launches == 0        # CPU tensors launch nothing


def test_fused_audio_extractor_backends_and_hops():
    with pytest.raises(ValueError, match='backend'):
        features.FusedAudioLogMelExtractor(16000, 512, 128, 40,
                                           backend='cuda')
    x = torch.from_numpy(_audio_batch(0)[0])
    # a hop that does not divide the window: 'pallas' keeps the JAX rule,
    # 'auto' and 'jnp' take it
    odd = dict(window_length=400)
    with pytest.raises(ValueError, match='shift'):
        features.FusedAudioLogMelExtractor(
            16000, 512, 160, 40, backend='pallas', **odd)(x)
    a = features.FusedAudioLogMelExtractor(16000, 512, 160, 40, **odd)(x)[0]
    b = features.FusedAudioLogMelExtractor(
        16000, 512, 160, 40, backend='jnp', **odd)(x)[0]
    assert torch.equal(a, b) and tuple(a.shape) == (3, 1, 40, 21)
    ex = features.FusedAudioLogMelExtractor(16000, 512, 128, 40)
    assert [n for n, _ in ex.named_buffers()] == [
        'fbanks', 'norm.num_tracked_values', 'norm.running_mean',
        'norm.running_power']
    assert not list(ex.parameters())         # the filterbank is not trained


# --------------------------------------------------------------------- #
# normalization                                                          #
# --------------------------------------------------------------------- #
NORMS = [
    dict(data_format='bct', shape=(None, 5, None), statistics_axis='bt',
         momentum=0.5),
    dict(data_format='bct', shape=(None, 5, None), statistics_axis='bt',
         momentum=None, independent_axis=None),
    dict(data_format='bcft', shape=(None, 2, 5, None), statistics_axis='bft',
         independent_axis='c'),
    dict(data_format='bct', shape=(None, 5, None), statistics_axis='t',
         independent_axis='c'),
    dict(data_format='bct', shape=(None, 5, None), statistics_axis='bt',
         shift=False),
    dict(data_format='bct', shape=(None, 5, None), statistics_axis='bt',
         scale=False),
]


def _norm_input(seed, kwargs):
    rng = np.random.RandomState(seed)
    shape = [4 if d is None else d for d in kwargs['shape']]
    shape[-1] = 9
    return ((rng.randn(*shape) * 2 + 1).astype('float32'),
            np.array([9, 7, 4, 2], 'int32'))


@pytest.mark.parametrize('cls', ['Normalization', 'InputNormalization'])
@pytest.mark.parametrize('kwargs', NORMS)
def test_normalization_matches_jax_in_training_and_eval(cls, kwargs):
    jax_norm = getattr(jax_normalization, cls)(**kwargs)
    norm = _sync(getattr(normalization, cls)(**kwargs), jax_norm)
    assert set(to_jax_state_dict(norm)) == set(jax_norm.state_dict())
    for step in range(3):
        x, seq_len = _norm_input(step, kwargs)
        want = jax_norm(jnp.asarray(x), jnp.asarray(seq_len))
        got = norm(torch.from_numpy(x), torch.from_numpy(seq_len))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=f'step {step}')
        stats = to_jax_state_dict(norm)
        for name, value in jax_norm.state_dict().items():
            np.testing.assert_allclose(stats[name], np.asarray(value),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    jax_norm.eval()
    norm.eval()
    x, seq_len = _norm_input(7, kwargs)
    want = jax_norm(jnp.asarray(x), jnp.asarray(seq_len))
    got = norm(torch.from_numpy(x), torch.from_numpy(seq_len))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    if norm.track_running_stats:
        np.testing.assert_allclose(
            norm.inverse(got, seq_len).detach().numpy(),
            np.asarray(jax_norm.inverse(want, jnp.asarray(seq_len))),
            atol=ATOL, rtol=0)
    else:
        with pytest.raises(NotImplementedError):
            norm.inverse(got)


def test_running_var_keeps_the_reference_quirks():
    """``running_var`` = clamp(n / (n - 1) * power - mean**2, 0) + eps: the
    Bessel factor on the power term only, and eps added here *and* again by
    ``_running_norm``/``inverse``.  Both differ measurably from the textbook
    n / (n - 1) * (power - mean**2) + eps used once."""
    eps = 0.05
    norm = normalization.Normalization(
        data_format='bc', shape=(None, 1), statistics_axis='b',
        sequence_axis=None, independent_axis=None, eps=eps, momentum=None)
    x = torch.tensor([[3.0], [5.0], [4.0]])
    norm(x)                                   # training: mean 4, power 50/3
    n, mean, power = 3.0, 4.0, 50.0 / 3
    assert float(norm.num_tracked_values) == n
    np.testing.assert_allclose(float(norm.running_mean), mean, rtol=1e-6)
    np.testing.assert_allclose(float(norm.running_power), power, rtol=1e-6)
    quirk = n / (n - 1) * power - mean ** 2 + eps          # 9.05
    textbook = n / (n - 1) * (power - mean ** 2) + eps     # 1.05
    np.testing.assert_allclose(float(norm.running_var), quirk, rtol=1e-6)
    assert abs(quirk - textbook) > 7
    norm.eval()
    y = norm(torch.tensor([[6.0]]))
    np.testing.assert_allclose(float(y), 2.0 / np.sqrt(quirk + eps),
                               rtol=1e-6)
    # eps once would give 2 / sqrt(9.05) = 0.66482, twice 0.66299
    assert abs(float(y) - 2.0 / np.sqrt(quirk)) > 1e-3
    np.testing.assert_allclose(float(norm.inverse(y)), 6.0, rtol=1e-6)
    # one tracked value: n is clipped to 2, no division by zero
    norm.reset_running_stats()
    norm.train()
    norm(torch.tensor([[2.0]]))
    np.testing.assert_allclose(float(norm.running_var), 2 * 4.0 - 4.0 + eps,
                               rtol=1e-6)


def test_cumulative_average_and_freeze():
    kwargs = dict(data_format='bct', shape=(None, 2, None),
                  statistics_axis='bt', momentum=None)
    norm = normalization.InputNormalization(**kwargs)
    rng = np.random.RandomState(0)
    chunks = [rng.randn(b, 2, 6).astype('float32') + 3 for b in (2, 5, 1)]
    for chunk in chunks:
        norm(torch.from_numpy(chunk))
    everything = np.concatenate(chunks)
    np.testing.assert_allclose(
        norm.running_mean.numpy()[0, :, 0], everything.mean((0, 2)),
        rtol=1e-5)
    np.testing.assert_allclose(
        norm.running_power.numpy()[0, :, 0], (everything ** 2).mean((0, 2)),
        rtol=1e-5)
    assert float(norm.num_tracked_values[0, 0, 0]) == 8 * 6
    # gradients do not flow into the statistics, and freezing stops them
    x = torch.from_numpy(chunks[0]).requires_grad_(True)
    norm(x).sum().backward()
    assert x.grad is not None and not norm.running_mean.requires_grad
    norm.freeze()
    before = norm.running_mean.clone()
    norm(torch.from_numpy(chunks[1]))
    assert torch.equal(norm.running_mean, before)
    assert not norm.gamma.requires_grad
    norm.unfreeze()
    norm(torch.from_numpy(chunks[1]))
    assert not torch.equal(norm.running_mean, before)
    assert norm.gamma.requires_grad
    with pytest.raises(ValueError, match='shape'):
        normalization.Normalization(data_format='bct',
                                    shape=(None, None, None),
                                    statistics_axis='bt')


# --------------------------------------------------------------------- #
# reductions                                                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize('name', ['Sum', 'Mean', 'Max', 'TakeLast'])
@pytest.mark.parametrize('axis,with_lengths', [(1, True), (-1, True),
                                               (1, False)])
def test_reductions_match_jax(name, axis, with_lengths):
    x = np.random.RandomState(0).randn(3, 6, 6).astype('float32')
    seq_len = np.array([6, 3, 1], 'int32') if with_lengths else None
    want = getattr(jax_reduce, name)(axis=axis)(
        jnp.asarray(x), None if seq_len is None else jnp.asarray(seq_len))
    got = getattr(reduce, name)(axis=axis)(torch.from_numpy(x), seq_len)
    assert tuple(got.shape) == (3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_take_last_takes_the_last_valid_step():
    x = torch.arange(24.).reshape(2, 4, 3)
    got = reduce.TakeLast(axis=1)(x, torch.tensor([2, 4]))
    assert got.tolist() == [[3.0, 4.0, 5.0], [21.0, 22.0, 23.0]]
    assert reduce.TakeLast(axis=1)(x).tolist() == x[:, -1].tolist()
    grad_in = x.clone().requires_grad_(True)
    reduce.TakeLast(axis=1)(grad_in, [2, 4]).sum().backward()
    assert grad_in.grad[0, 1].tolist() == [1.0, 1.0, 1.0]
    assert float(grad_in.grad.sum()) == 6.0


def test_autopool_weighs_by_a_softmax_per_class():
    """alpha = 0 is the mean, a large alpha the max, each class its own
    alpha; lengths mask the padding.  (The JAX module broadcasts alpha over
    the axis before the classes, so it takes a (B, n_classes, T) input only
    where B == n_classes: there, with one alpha for all classes, both
    agree.)"""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 7).astype('float32')
    seq_len = np.array([7, 4, 2])
    pool = reduce.AutoPool(5)
    with torch.no_grad():
        pool.alpha.copy_(torch.tensor([0.0, 0.5, 1.0, 2.0, 50.0]))
    got = pool(torch.from_numpy(x), seq_len).detach().numpy()
    for b in range(3):
        valid = x[b, :, :seq_len[b]]
        for c, alpha in enumerate([0.0, 0.5, 1.0, 2.0, 50.0]):
            w = np.exp(alpha * valid[c] - (alpha * valid[c]).max())
            np.testing.assert_allclose(
                got[b, c], (valid[c] * w / w.sum()).sum(), rtol=1e-5,
                atol=1e-6)
    np.testing.assert_allclose(got[0, 0], x[0, 0].mean(), rtol=1e-5)
    np.testing.assert_allclose(got[1, 4], x[1, 4, :4].max(), rtol=1e-4)
    square = rng.randn(5, 5, 7).astype('float32')
    lens = np.array([7, 4, 2, 3, 1])
    jax_pool = jax_reduce.AutoPool(5, alpha0=1.5)
    port = _sync(reduce.AutoPool(5), jax_pool)
    np.testing.assert_allclose(
        port(torch.from_numpy(square), lens).detach().numpy(),
        np.asarray(jax_pool(jnp.asarray(square), jnp.asarray(lens))),
        atol=1e-6)
    frozen = reduce.AutoPool(5, trainable=False)
    assert not frozen.alpha.requires_grad and 'alpha' in frozen.state_dict()
