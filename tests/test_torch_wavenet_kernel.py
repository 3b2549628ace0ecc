"""The port's ``wavenet_sample`` (its plain version: these tensors lie on
the CPU) against the JAX package's Pallas kernel in interpret mode and
against ``WaveNet.sample``, on the same numpy-seeded weights and
conditioning: greedy indices equal, teacher-forced logits within 2e-5 (the
limit of ``tests/test_ops/test_pallas_wavenet.py``: f32 sums in another
order through 4 gated layers).  Stochastic sampling: the counter-based
generator's mapping to [0, 1) is the JAX package's ``_uniform_from_bits``
on signed bit patterns, its draws are uniform and differ by seed, step, row
and class, and the sampled indices' histogram follows the softmax (the TPU
kernel draws other bits: sampled output is held to its distribution only).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.modules.wavenet.wavenet import WaveNet as JaxWaveNet
from padertorch_tpu.ops.pallas.wavenet import (
    _uniform_from_bits, wavenet_sample as jax_wavenet_sample)
from padertorch_tpu_torch.ops.kernels import wavenet as kernels
from padertorch_tpu_torch.ops.kernels.wavenet import (
    ring_bytes, wavenet_sample, wavenet_sample_plain, wavenet_uniform)

LOGIT_TOL = 2e-5
DILATIONS = (1, 2, 4, 1)
L, R, S, O, C = 4, 16, 32, 256, 256


def make_weights(seed=0, n_layers=L):
    rng = np.random.RandomState(seed)

    def u(*shape):
        return rng.uniform(-0.3, 0.3, shape).astype('float32')

    return {
        'w_prev': u(n_layers, R, 2 * R), 'w_curr': u(n_layers, R, 2 * R),
        'b_dil': u(n_layers, 2 * R), 'w_res': u(n_layers - 1, R, R),
        'b_res': u(n_layers - 1, R), 'w_skip': u(n_layers, R, S),
        'b_skip': u(n_layers, S), 'w_out': u(S, O), 'w_end': u(O, O),
        'embed': rng.randn(C, R).astype('float32'),
    }


def make_cond(t=24, b=2, seed=1, n_layers=L):
    rng = np.random.RandomState(seed)
    return rng.randn(t, b, n_layers, 2 * R).astype('float32')


def to_torch(w):
    return {k: torch.from_numpy(v) for k, v in w.items()}


def to_jax(w):
    return {k: jnp.asarray(v) for k, v in w.items()}


def test_greedy_matches_pallas_kernel_exactly():
    w, cond = make_weights(), make_cond()
    want = jax_wavenet_sample(jnp.asarray(cond), to_jax(w), DILATIONS,
                              interpret=True)
    got = wavenet_sample(torch.from_numpy(cond), to_torch(w), DILATIONS)
    assert got.dtype == torch.int32 and tuple(got.shape) == (24, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 4   # not stuck on one index


@pytest.mark.parametrize('n_layers,dilations', [(4, DILATIONS), (2, (2, 3))])
def test_teacher_forced_logits_match_pallas_kernel(n_layers, dilations):
    w = make_weights(n_layers=n_layers)
    cond = make_cond(n_layers=n_layers)
    forced = np.random.RandomState(2).randint(0, 256, (24, 2)).astype('int32')
    idx_j, logits_j = jax_wavenet_sample(
        jnp.asarray(cond), to_jax(w), dilations,
        forced_input=jnp.asarray(forced), return_logits=True, interpret=True)
    idx_t, logits_t = wavenet_sample(
        torch.from_numpy(cond), to_torch(w), dilations,
        forced_input=torch.from_numpy(forced), return_logits=True)
    assert tuple(logits_t.shape) == (24, 2, O)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_matches_the_scan_sampler_of_the_jax_module():
    """Through the module's layouts: the JAX ``WaveNet.sample`` (a
    ``lax.scan``) against the plain version on the weights the module
    exports, free-running greedy and teacher-forced."""
    ptrandom.seed(0)
    net = JaxWaveNet(
        n_cond_channels=20, upsamp_window=4, upsamp_stride=2, n_layers=4,
        max_dilation=4, n_residual_channels=R, n_skip_channels=S,
        n_out_channels=256)
    rng = np.random.RandomState(0)
    cond = rng.randn(2, 4, 2 * R, 24).astype('float32')     # (B, L, 2R, T)
    forced = rng.randint(0, 256, (2, 24)).astype('int32')

    def mat(layer, tap=0):
        return np.asarray(layer.conv.weight)[:, :, tap].T

    w = {
        'w_prev': np.stack([mat(l, 0) for l in net.dilate_layers]),
        'w_curr': np.stack([mat(l, 1) for l in net.dilate_layers]),
        'b_dil': np.stack([np.asarray(l.conv.bias)
                           for l in net.dilate_layers]),
        'w_res': np.stack([mat(l) for l in net.res_layers]),
        'b_res': np.stack([np.asarray(l.conv.bias) for l in net.res_layers]),
        'w_skip': np.stack([mat(l) for l in net.skip_layers]),
        'b_skip': np.stack([np.asarray(l.conv.bias)
                            for l in net.skip_layers]),
        'w_out': mat(net.conv_out), 'w_end': mat(net.conv_end),
        'embed': np.asarray(net.embed.weight),
    }
    w = {k: torch.from_numpy(np.array(v)) for k, v in w.items()}
    cond_t = np.transpose(cond, (3, 0, 1, 2))
    cond_t = np.concatenate([np.zeros_like(cond_t[:1]), cond_t[:-1]])
    idx_scan = net.sample(jnp.asarray(cond), key=jax.random.PRNGKey(0),
                          sample=False)
    got = wavenet_sample_plain(torch.from_numpy(cond_t), w, net.dilations)
    np.testing.assert_array_equal(got.numpy().T, np.asarray(idx_scan))
    _, logits_scan = net.sample(
        jnp.asarray(cond), key=jax.random.PRNGKey(0), sample=False,
        forced_input=jnp.asarray(forced), return_logits=True)
    _, logits = wavenet_sample_plain(
        torch.from_numpy(cond_t), w, net.dilations,
        forced_input=torch.from_numpy(forced.T.copy()), return_logits=True)
    np.testing.assert_allclose(
        logits.numpy().transpose(1, 2, 0), np.asarray(logits_scan),
        atol=LOGIT_TOL, rtol=0)


def test_uniform_mapping_is_the_jax_one_on_signed_bit_patterns():
    """``wavenet_uniform`` maps its 32 mixed bits through the upper 24, as
    ``_uniform_from_bits`` maps the TPU's signed int32 bits: the same
    float for the same bit pattern, in [0, 1), also for patterns with the
    sign bit set."""
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2 ** 32, size=100_000, dtype=np.int64)
    bits[:4] = [2 ** 31, 2 ** 32 - 1, 0, 2 ** 31 - 1]
    ours = ((torch.from_numpy(bits) >> 8) & 0xFFFFFF).to(
        torch.float32) / float(1 << 24)
    signed = bits.astype(np.uint32).view(np.int32)
    theirs = np.asarray(_uniform_from_bits(jnp.asarray(signed)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert ours.min() >= 0.0 and ours.max() < 1.0


def test_uniform_draws_are_uniform_and_keyed():
    u = wavenet_uniform(3, torch.arange(50), 4, 256)
    assert tuple(u.shape) == (50, 4, 256) and u.dtype == torch.float32
    flat = u.numpy().ravel()
    assert flat.min() >= 0.0 and flat.max() < 1.0
    assert abs(flat.mean() - 0.5) < 0.01
    hist, _ = np.histogram(flat, bins=10, range=(0, 1))
    assert hist.min() > 0.9 * flat.size / 10, hist
    assert len(np.unique(flat)) > 0.99 * flat.size
    # one step alone gives the same numbers as that step within a range
    np.testing.assert_array_equal(
        wavenet_uniform(3, [17], 4, 256)[0].numpy(), u[17].numpy())
    assert not np.array_equal(wavenet_uniform(4, [17], 4, 256)[0].numpy(),
                              u[17].numpy())
    # the 32-bit products do not overflow int64: python integers agree
    def mix(x):
        x ^= x >> 16
        x = x * 0x7feb352d & 0xFFFFFFFF
        x ^= x >> 15
        x = x * 0x846ca68b & 0xFFFFFFFF
        return x ^ x >> 16
    key = mix(3 ^ (49 * 0x9E3779B1 & 0xFFFFFFFF))
    key = mix(key ^ (3 * 0x85EBCA77 & 0xFFFFFFFF))
    bits = mix(key ^ (255 * 0xC2B2AE3D & 0xFFFFFFFF))
    assert float(u[49, 3, 255]) == ((bits >> 8) & 0xFFFFFF) / (1 << 24)


def test_sampled_indices_follow_the_softmax():
    """Teacher-forced, every step's choice is an independent draw from that
    step's softmax.  With the same conditioning at every row and step the
    logits are the same everywhere, and the histogram of 3936 draws is held
    against the softmax: total variation below 0.1 (a fair sample of that size
    over the about 40 classes that carry mass gives 0.03 to 0.06)."""
    w = make_weights()
    w['w_end'] = w['w_end'] * 4.0            # a peaked distribution
    t, b = 500, 8
    cond = np.broadcast_to(make_cond(1, 1)[0, 0], (t, b, L, 2 * R)).copy()
    forced = np.full((t, b), 77, 'int32')
    idx, logits = wavenet_sample(
        torch.from_numpy(cond), to_torch(w), (1, 1, 1, 1), sample=True,
        seed=11, forced_input=torch.from_numpy(forced), return_logits=True)
    # dilation 1 everywhere: layer i sees the settled input one step after
    # layer i - 1, so from step 8 on every step computes the same logits
    idx, logits = idx[8:], logits[8:]
    assert float((logits - logits[0, 0]).abs().max()) < 1e-5
    probs = torch.softmax(logits[0, 0], -1).numpy()
    hist = np.bincount(idx.numpy().ravel(), minlength=O) / idx.numel()
    assert 0.5 * np.abs(hist - probs).sum() < 0.1
    assert hist.argmax() == probs.argmax()
    greedy = wavenet_sample(torch.from_numpy(cond), to_torch(w),
                            (1, 1, 1, 1),
                            forced_input=torch.from_numpy(forced))
    assert (greedy[8:].numpy() == probs.argmax()).all()
    again = wavenet_sample(
        torch.from_numpy(cond), to_torch(w), (1, 1, 1, 1), sample=True,
        seed=11, forced_input=torch.from_numpy(forced))
    np.testing.assert_array_equal(again[8:].numpy(), idx.numpy())
    other = wavenet_sample(
        torch.from_numpy(cond), to_torch(w), (1, 1, 1, 1), sample=True,
        seed=12, forced_input=torch.from_numpy(forced))
    assert (other[8:].numpy() != idx.numpy()).mean() > 0.5


def test_argmax_ties_go_to_the_lowest_index():
    w = make_weights()
    w['w_end'][:] = 0.0                      # all logits equal (zero)
    idx = wavenet_sample(torch.from_numpy(make_cond(5, 2)), to_torch(w),
                         DILATIONS)
    assert (idx.numpy() == 0).all()


def test_wrapper_checks_its_inputs_and_counts_no_launch_on_cpu():
    w, cond = to_torch(make_weights()), torch.from_numpy(make_cond())
    before = wavenet_sample.launches
    wavenet_sample(cond, w, DILATIONS)
    assert wavenet_sample.launches == before
    with pytest.raises(ValueError, match='dilations'):
        wavenet_sample(cond, w, (1, 2, 4))
    with pytest.raises(ValueError, match='w_out'):
        wavenet_sample(cond, {**w, 'w_out': w['w_out'][:-1]}, DILATIONS)
    with pytest.raises(KeyError, match='embed'):
        wavenet_sample(cond, {k: v for k, v in w.items() if k != 'embed'},
                       DILATIONS)
    with pytest.raises(ValueError, match='forced_input'):
        wavenet_sample(cond, w, DILATIONS,
                       forced_input=torch.zeros(3, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match='backward'):
        wavenet_sample(cond.clone().requires_grad_(True), w, DILATIONS)
    with pytest.raises(ValueError, match='index 128'):
        wavenet_sample(cond, {**w, 'embed': w['embed'][:100]}, DILATIONS)
    # the full-width rings: 510 slots of 64 floats
    assert ring_bytes([2 ** (i % 8) for i in range(16)], 64) == 130_560
    assert kernels.START_INDEX == 128
