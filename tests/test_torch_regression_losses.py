"""The port's regression losses (``ops/losses/regression.py``) against the
JAX package's, on the CPU: the six losses over ``reduction`` None, 'sum'
and 'mean' and with ``soft_sdr_max`` where a loss takes it, values and
gradients with respect to the estimate (and the target), 1e-4 relative
(float32 sums in another order), on (B, K, T) signals made with numpy from
a seed; ``si_sdr_loss``'s ``offset_invariant`` and ``grad_stop``; the
exports of ``ops/losses``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.ops.losses import regression as jax_regression
from padertorch_tpu_torch.ops.losses import regression

torch.set_num_threads(2)

RTOL = 1e-4

# (name, reductions it takes, options)
CASES = [
    *[('mse_loss', r, {}) for r in (None, 'sum', 'mean')],
    *[('log_mse_loss', r, o) for r in (None, 'sum', 'mean')
      for o in ({}, {'soft_sdr_max': 20})],
    *[('sdr_loss', r, o) for r in (None, 'sum', 'mean')
      for o in ({}, {'soft_sdr_max': 30})],
    *[('si_sdr_loss', r, o) for r in (None, 'sum', 'mean')
      for o in ({}, {'soft_sdr_max': 30}, {'offset_invariant': True},
                {'grad_stop': True})],
    *[('log1p_mse_loss', r, {}) for r in (None, 'sum', 'mean')],
    ('source_aggregated_sdr_loss', 'n/a', {}),
    ('source_aggregated_sdr_loss', 'n/a', {'soft_sdr_max': 20}),
]


def _signals(seed, shape=(3, 2, 257)):
    rng = np.random.RandomState(seed)
    target = rng.randn(*shape).astype('float32')
    estimate = (target + 0.4 * rng.randn(*shape) + 0.1).astype('float32')
    return estimate, target


def _kwargs(reduction, options):
    return options if reduction == 'n/a' else {**options,
                                               'reduction': reduction}


@pytest.mark.parametrize('name, reduction, options', CASES)
def test_values_and_gradients_match_jax(name, reduction, options):
    estimate, target = _signals(len(name) + len(options))
    kwargs = _kwargs(reduction, options)
    jax_fn = getattr(jax_regression, name)
    port_fn = getattr(regression, name)

    def jax_sum(e, t):
        return jnp.sum(jax_fn(e, t, **kwargs))

    want = np.asarray(jax_fn(jnp.asarray(estimate), jnp.asarray(target),
                             **kwargs))
    want_de, want_dt = jax.grad(jax_sum, argnums=(0, 1))(
        jnp.asarray(estimate), jnp.asarray(target))
    e = torch.from_numpy(estimate).requires_grad_()
    t = torch.from_numpy(target).requires_grad_()
    got = port_fn(e, t, **kwargs)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
    got.sum().backward()
    for grad, ref in ((e.grad, want_de), (t.grad, want_dt)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(grad.numpy(), ref, rtol=0,
                                   atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize('name', ['mse_loss', 'sdr_loss', 'log1p_mse_loss'])
def test_an_unknown_reduction_raises(name):
    estimate, target = map(torch.from_numpy, _signals(0))
    with pytest.raises(ValueError, match='Unknown reduction'):
        getattr(regression, name)(estimate, target, reduction='max')


@pytest.mark.parametrize('soft_sdr_max', [1, 50, 0.5])
def test_uncommon_soft_sdr_max_asserts(soft_sdr_max):
    estimate, target = map(torch.from_numpy, _signals(0))
    with pytest.raises(AssertionError, match='soft_sdr_max'):
        regression.sdr_loss(estimate, target, soft_sdr_max=soft_sdr_max)


def test_one_dimensional_signals_and_the_exports():
    estimate, target = _signals(1, shape=(301,))
    want = float(jax_regression.si_sdr_loss(jnp.asarray(estimate),
                                            jnp.asarray(target)))
    got = float(regression.si_sdr_loss(torch.from_numpy(estimate),
                                       torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    from padertorch_tpu_torch.ops import losses
    for name in jax_regression.__all__:
        assert getattr(losses, name) is getattr(regression, name)
