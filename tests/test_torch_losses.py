"""The port's source-separation losses and ``compute_mask`` against the JAX
package's, on the same numpy inputs; 1e-5 (f32 sums in another order over
at most a few hundred terms)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops.losses import source_separation as jax_losses
from padertorch_tpu.ops.sequence.mask import compute_mask as jax_mask
from padertorch_tpu_torch.ops.losses import source_separation as losses
from padertorch_tpu_torch.ops.sequence.mask import compute_mask

torch.set_num_threads(2)

ATOL = 1e-5
T, F = 6, 5


def _pair(k, seed):
    rng = np.random.RandomState(seed)
    est = rng.randn(T, k, F).astype('float32')
    tgt = est[:, np.roll(np.arange(k), -1)] + 0.1 * rng.randn(
        T, k, F).astype('float32')
    return est, tgt.astype('float32')


@pytest.mark.parametrize('k', [2, 3])
def test_pit_loss_mse(k):
    est, tgt = _pair(k, seed=k)
    want, want_perm = jax_losses.pit_loss(
        jnp.asarray(est), jnp.asarray(tgt), 1, return_permutation=True)
    got, got_perm = losses.pit_loss(
        torch.from_numpy(est), torch.from_numpy(tgt), 1,
        return_permutation=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got_perm.tolist() == np.asarray(want_perm).tolist()
    assert got_perm.tolist() == np.roll(np.arange(k), -1).tolist()
    plain = losses.pit_loss(torch.from_numpy(est), torch.from_numpy(tgt), 1)
    assert torch.equal(plain, got)


def test_pit_loss_gradient():
    est, tgt = _pair(3, seed=7)
    import jax
    want = jax.grad(lambda e: jax_losses.pit_loss(e, jnp.asarray(tgt), 1))(
        jnp.asarray(est))
    e = torch.from_numpy(est).requires_grad_()
    losses.pit_loss(e, torch.from_numpy(tgt), 1).backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize('k', [2, 3])
def test_pit_loss_cross_entropy(k):
    rng = np.random.RandomState(10 + k)
    logits = rng.randn(T, k, F).astype('float32')
    labels = rng.randint(0, k, size=(T, F))
    want, want_perm = jax_losses.pit_loss(
        jnp.asarray(logits), jnp.asarray(labels), 1,
        loss_fn='cross_entropy', return_permutation=True)
    got, got_perm = losses.pit_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), 1,
        loss_fn='cross_entropy', return_permutation=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got_perm.tolist() == np.asarray(want_perm).tolist()


@pytest.mark.parametrize('loss_fn', ['mse', 'cross_entropy'])
def test_compute_pairwise_losses(loss_fn):
    rng = np.random.RandomState(20)
    k = 3
    if loss_fn == 'mse':
        est, tgt = _pair(k, seed=20)
        kwargs = {}
    else:
        est = rng.randn(T, k, F).astype('float32')
        tgt = rng.randint(0, k, size=(T, F))
        kwargs = {'loss_fn': 'cross_entropy'}
    want = jax_losses.compute_pairwise_losses(
        jnp.asarray(est), jnp.asarray(tgt), 1, **kwargs)
    got = losses.compute_pairwise_losses(
        torch.from_numpy(est), torch.from_numpy(tgt), 1, **kwargs)
    assert tuple(got.shape) == (k, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize('algorithm', ['optimal', 'greedy', 'brute_force'])
@pytest.mark.parametrize('reduction', ['mean', 'sum', None])
def test_pit_loss_from_loss_matrix(algorithm, reduction):
    matrix = np.random.RandomState(30).randn(4, 4).astype('float32')
    want, want_perm = jax_losses.pit_loss_from_loss_matrix(
        jnp.asarray(matrix), reduction=reduction, algorithm=algorithm,
        return_permutation=True)
    got, got_perm = losses.pit_loss_from_loss_matrix(
        torch.from_numpy(matrix), reduction=reduction, algorithm=algorithm,
        return_permutation=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got_perm.tolist() == np.asarray(want_perm).tolist()


def test_pairwise_matrix_and_brute_force_agree_with_pit_loss():
    est, tgt = _pair(3, seed=40)
    est, tgt = torch.from_numpy(est), torch.from_numpy(tgt)
    matrix = losses.compute_pairwise_losses(est, tgt, 1)
    np.testing.assert_allclose(
        losses.pit_loss_from_loss_matrix(
            matrix, algorithm='brute_force').numpy(),
        losses.pit_loss(est, tgt, 1).numpy(), atol=ATOL)


def test_deep_clustering_loss():
    rng = np.random.RandomState(50)
    x = rng.randn(40, 6).astype('float32')
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    t = np.eye(3, dtype='float32')[rng.randint(0, 3, size=40)]
    want = jax_losses.deep_clustering_loss(jnp.asarray(x), jnp.asarray(t))
    got = losses.deep_clustering_loss(torch.from_numpy(x),
                                      torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize('batch_axis,sequence_axis', [(0, 1), (0, -1),
                                                      (1, 0)])
def test_compute_mask(batch_axis, sequence_axis):
    x = np.ones((3, 3, 7, 4), dtype='float32')
    lengths = [1, 3, 2]
    want = jax_mask(jnp.asarray(x), lengths, batch_axis, sequence_axis)
    got = compute_mask(torch.from_numpy(x), lengths, batch_axis,
                       sequence_axis)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(compute_mask(torch.from_numpy(x), None),
                       torch.ones(3, 3, 7, 4))
