"""Gradients of the port's LSTM cell-scan against the JAX package's custom
VJP (``padertorch_tpu.ops.pallas.lstm``, Pallas kernels in interpret mode).

``jax.vjp`` of ``lstm_cell_scan(..., interpret=True)`` is held against

(a) autograd through the port's plain forward (what a CPU tensor takes),
(b) the step-by-step plain versions of the two training kernels,
    ``lstm_cell_scan_train_plain`` + ``lstm_cell_scan_bwd_plain``, plus the
    ``dW_hh`` product ``recurrent_weight_grad``,

for one and two directions, no mask, suffix padding and prefix padding,
with cotangents on ``out``, ``h_T`` and ``c_T``.  The residuals that (b)
stores are held against ``_fwd_call``'s.  All 1e-5: the same f32
operations in another framework, over 12 steps of width 8.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.ops.pallas import lstm as jax_lstm
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_train_plain, lstm_cell_scan_bwd_plain,
    recurrent_weight_grad)

torch.set_num_threads(2)

T, B, H = 12, 3, 8
ATOL = 1e-5
CASES = [(n_dir, kind) for n_dir in (1, 2)
         for kind in (None, 'suffix', 'prefix')]


def _inputs(n_dir, mask_kind, seed, h0_scale=0.1):
    rng = np.random.RandomState(seed)
    rows = n_dir * B
    mask = None
    if mask_kind is not None:
        lens = rng.randint(1, T, size=rows)
        lens[0] = T
        mask = (np.arange(T)[:, None] < lens[None, :]).astype('float32')
        if mask_kind == 'prefix':
            mask = mask[::-1].copy()
    w_shape = (H, 4 * H) if n_dir == 1 else (n_dir, H, 4 * H)
    arrays = [
        (rng.randn(T, rows, 4 * H) * 0.5).astype('float32'),
        (rng.randn(*w_shape) * 0.3).astype('float32'),
        mask,
        (rng.randn(rows, H) * h0_scale).astype('float32'),
        (rng.randn(rows, H) * h0_scale).astype('float32'),
    ]
    cotangents = [rng.randn(T, rows, H).astype('float32'),
                  rng.randn(rows, H).astype('float32'),
                  rng.randn(rows, H).astype('float32')]
    return arrays, cotangents


def _jnp(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax_grads(arrays, cotangents):
    """(dgates_x, dW_hh, dh0, dc0) through the JAX custom VJP."""
    gx, w, mask, h0, c0 = _jnp(arrays)
    _, vjp = jax.vjp(
        lambda gx, w, h0, c0: jax_lstm.lstm_cell_scan(
            gx, w, mask, h0, c0, True), gx, w, h0, c0)
    return [np.asarray(g) for g in vjp(tuple(_jnp(cotangents)))]


def _assert_all_close(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


GRAD_NAMES = ('dgates_x', 'dW_hh', 'dh0', 'dc0')


@pytest.mark.parametrize('n_dir,mask_kind', CASES)
def test_autograd_through_plain_matches_jax_vjp(n_dir, mask_kind):
    arrays, cotangents = _inputs(n_dir, mask_kind, seed=n_dir)
    want = _jax_grads(arrays, cotangents)
    gx, w, mask, h0, c0 = _torch(arrays)
    leaves = [a.requires_grad_() for a in (gx, w, h0, c0)]
    outs = lstm_cell_scan(leaves[0], leaves[1], mask, leaves[2], leaves[3])
    got = torch.autograd.grad(outs, leaves, _torch(cotangents))
    _assert_all_close(got, want, GRAD_NAMES)


@pytest.mark.parametrize('n_dir,mask_kind', CASES)
def test_plain_training_kernels_match_jax_vjp(n_dir, mask_kind):
    arrays, cotangents = _inputs(n_dir, mask_kind, seed=10 + n_dir)
    want = _jax_grads(arrays, cotangents)
    gx, w, mask, h0, c0 = _torch(arrays)
    out, c_seq, gates, _, _ = lstm_cell_scan_train_plain(
        gx, w, mask, h0, c0)
    dgx, dh0, dc0 = lstm_cell_scan_bwd_plain(
        gates, c_seq, w, mask, *_torch(cotangents))
    dw = recurrent_weight_grad(dgx, out, h0, mask, n_dir)
    if n_dir == 1:
        dw = dw[0]
    _assert_all_close((dgx, dw, dh0, dc0), want, GRAD_NAMES)


@pytest.mark.parametrize('n_dir,mask_kind', CASES)
def test_plain_training_forward_stores_the_jax_residuals(n_dir, mask_kind):
    arrays, _ = _inputs(n_dir, mask_kind, seed=20 + n_dir)
    want = jax_lstm._fwd_call(*_jnp(arrays), True)  # interpret mode
    got = lstm_cell_scan_train_plain(*_torch(arrays))
    _assert_all_close(got, [np.asarray(a) for a in want],
                      ('out', 'c_seq', 'gates', 'h_T', 'c_T'))


@pytest.mark.parametrize('n_dir', [1, 2])
def test_segment_start_term_of_the_weight_gradient(n_dir):
    """Prefix padding with a large h0: the first valid step of a row reads
    the frozen h0, not the zero that ``out`` holds in the padding; without
    the segment-start term ``dW_hh`` misses ``h0^T dz`` of that step."""
    arrays, cotangents = _inputs(n_dir, 'prefix', seed=30 + n_dir,
                                 h0_scale=1.0)
    want = _jax_grads(arrays, cotangents)
    gx, w, mask, h0, c0 = _torch(arrays)
    out, c_seq, gates, _, _ = lstm_cell_scan_train_plain(
        gx, w, mask, h0, c0)
    dgx, _, _ = lstm_cell_scan_bwd_plain(
        gates, c_seq, w, mask, *_torch(cotangents))
    dw = recurrent_weight_grad(dgx, out, h0, mask, n_dir)
    np.testing.assert_allclose(dw.numpy().reshape(want[1].shape), want[1],
                               atol=ATOL, rtol=0)
    without = recurrent_weight_grad(dgx, out, h0, None, n_dir)
    assert np.abs(without.numpy().reshape(want[1].shape)
                  - want[1]).max() > 1e-2
