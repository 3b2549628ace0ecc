"""The port's ``DeepClusteringModel`` (``models/bss.py``) against the JAX
package's, on the CPU.

The same weights (through ``from_jax_state_dict``; the JAX side on its
``scan`` backend, the plain time loop) and the same inputs, made with numpy
from a seed, at small widths (F = 17, 2 BLSTM layers of 8 units, E = 5):

- ``forward`` with each ``input_feature_transform``: 1e-4, and unit norm
  over E;
- ``review`` with ragged ``num_frames`` (the loss renormalized by the valid
  frames squared) and without them: 1e-4 relative; every gradient 1e-4 of
  its largest entry;
- the weights' round trip and the ``contrib/tcl/dc.py`` re-export.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models import bss as jax_bss
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules.recurrent import set_rnn_backend
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.models import bss

torch.set_num_threads(2)

ATOL = 1e-4
SIZE = dict(F=17, recurrent_layers=2, units=8, E=5)


def _models(transform, seed=0):
    ptrandom.seed(seed)
    jax_model = set_rnn_backend(jax_bss.DeepClusteringModel(
        **SIZE, input_feature_transform=transform), 'scan')
    port = from_jax_state_dict(bss.DeepClusteringModel(
        **SIZE, input_feature_transform=transform), jax_model.state_dict())
    return jax_model, port


def _batch(seed, frames=19):
    rng = np.random.RandomState(seed)
    lens = np.array([frames, frames - 6, frames - 13], dtype='int32')
    valid = np.arange(frames)[None, :, None] < lens[:, None, None]
    y = (np.abs(rng.randn(3, frames, 17)) * valid).astype('float32')
    speaker = rng.randint(0, 2, size=(3, frames, 17))
    mask = np.stack([speaker == 0, speaker == 1], axis=2).astype('float32')
    return {'Y_abs': y, 'num_frames': lens, 'target_mask': mask}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize('transform', ['identity', 'log1p', 'log'])
def test_forward_and_review_match_jax(transform):
    jax_model, port = _models(transform)
    batch = _batch(0)
    want = jax_model(_jnp(batch))
    want_review = jax_model.review(_jnp(batch), want)
    with torch.no_grad():
        got = port.eval()(_torch(batch))
        got_review = port.review(_torch(batch), got)
    assert tuple(got.shape) == want.shape == (3, 19, 5, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(got, dim=2).numpy(), 1, atol=1e-5)
    assert got_review.keys() == want_review.keys() == {'losses'}
    np.testing.assert_allclose(float(got_review['losses']['dc_loss']),
                               float(want_review['losses']['dc_loss']),
                               rtol=ATOL)


def test_an_unknown_transform_raises():
    _, port = _models('identity')
    port.input_feature_transform = 'sqrt'
    with pytest.raises(NotImplementedError, match='sqrt'):
        port(_torch(_batch(0)))


def test_review_without_num_frames_takes_every_frame():
    jax_model, port = _models('log1p', seed=1)
    batch = _batch(1)
    del batch['num_frames']
    want = jax_model.review(_jnp(batch), jax_model(_jnp(batch)))
    with torch.no_grad():
        got = port.review(_torch(batch), port(_torch(batch)))
    np.testing.assert_allclose(float(got['losses']['dc_loss']),
                               float(want['losses']['dc_loss']), rtol=ATOL)


def test_gradients_match_jax():
    jax_model, port = _models('log1p', seed=2)
    batch = _batch(2)
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        return model.review(_jnp(batch), model(_jnp(batch)))[
            'losses']['dc_loss']

    want = state_dict(jax.grad(jax_loss)(params))
    port.review(_torch(batch), port(_torch(batch)))[
        'losses']['dc_loss'].backward()
    grads = bss.DeepClusteringModel(**SIZE)
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


def test_weights_round_trip_and_the_tcl_re_export():
    jax_model, port = _models('identity', seed=3)
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    from padertorch_tpu_torch.contrib.tcl.dc import DeepClusteringModel
    from padertorch_tpu_torch.models import DeepClusteringModel as exported
    assert DeepClusteringModel is exported is bss.DeepClusteringModel
