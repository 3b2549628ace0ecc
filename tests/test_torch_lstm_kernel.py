"""The port's LSTM cell-scan (``padertorch_tpu_torch.ops.kernels.lstm``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On a CPU tensor the port runs its plain version; the same f32 ops as the
Pallas kernel in another framework, so 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops.pallas.lstm import lstm_cell_scan as jax_cell_scan
from padertorch_tpu_torch.ops.kernels import lstm as kernels_lstm
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_plain)

torch.set_num_threads(2)

T, B, H = 12, 3, 8


def _mask(kind, rows, rng):
    """None, suffix padding, or the prefix padding the backward
    direction sees after the flip."""
    if kind is None:
        return None
    lens = rng.randint(1, T + 1, size=rows)
    lens[0] = T
    mask = (np.arange(T)[:, None] < lens[None, :]).astype('float32')
    return mask if kind == 'suffix' else mask[::-1].copy()


def _inputs(n_dir, mask_kind, seed):
    rng = np.random.RandomState(seed)
    rows = n_dir * B
    w_shape = (H, 4 * H) if n_dir == 1 else (n_dir, H, 4 * H)
    return [
        (rng.randn(T, rows, 4 * H) * 0.5).astype('float32'),
        (rng.randn(*w_shape) * 0.3).astype('float32'),
        _mask(mask_kind, rows, rng),
        (rng.randn(rows, H) * 0.1).astype('float32'),
        (rng.randn(rows, H) * 0.1).astype('float32'),
    ]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('mask_kind', [None, 'suffix', 'prefix'])
@pytest.mark.parametrize('n_dir', [1, 2])
def test_matches_jax_kernel(n_dir, mask_kind):
    arrays = _inputs(n_dir, mask_kind, seed=n_dir)
    want = jax_cell_scan(
        *[None if a is None else jnp.asarray(a) for a in arrays], True)
    got = lstm_cell_scan(*_torch(arrays))
    for name, g, w in zip(('out', 'h_T', 'c_T'), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_cpu_takes_the_plain_version_without_a_launch():
    before = dict(lstm_cell_scan.launches)
    arrays = _torch(_inputs(2, 'suffix', seed=3))
    got = lstm_cell_scan(*arrays)
    want = lstm_cell_scan_plain(*arrays)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert lstm_cell_scan.launches == before


@pytest.mark.parametrize('bad', ['dtype', 'w_shape', 'mask_shape',
                                 'contiguity'])
def test_kernel_argument_checks(bad):
    gx, w, mask, h0, c0 = _torch(_inputs(2, 'suffix', seed=4))
    error = ValueError
    if bad == 'dtype':
        gx, error = gx.double(), TypeError
    elif bad == 'w_shape':
        w = w[:, :, :-4]
    elif bad == 'mask_shape':
        mask = mask[1:]
    else:
        h0 = torch.cat([h0, h0], dim=1)[:, ::2]
    w3, n_dir = kernels_lstm._norm_w(w)
    with pytest.raises(error):
        kernels_lstm._check(gx, w3, n_dir, mask, h0, c0)
