"""The port's GRU cell-scan plain versions against the JAX package's
Pallas kernel (``padertorch_tpu.ops.pallas.gru``, interpret mode) and
against a ``lax.scan`` reference.

- ``gru_cell_scan_plain`` (what a CPU tensor takes): outputs and ``h_T``,
  1e-5, for one and two directions, no mask, suffix and prefix padding,
  nonzero ``h0``.
- ``gru_cell_scan_train_plain``: the residuals ``acts`` and ``gh_n``
  against ``_fwd_call``'s, 1e-5; ``h_prev``, which the port stores and the
  JAX package rebuilds, against the shifted outputs plus the segment-start
  term.
- Gradients, 2e-5 (the JAX test's own limit): autograd through the plain
  forward, and ``gru_cell_scan_bwd_plain`` + ``recurrent_weight_grad``,
  against ``jax.vjp`` through the Pallas kernel and ``jax.grad`` through
  ``lax.scan``, including the leading-masked case with a large ``h0``
  where a wrong ``h_prev`` corrupts ``dgates_x`` itself.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.ops.pallas import gru as jax_gru
from padertorch_tpu_torch.ops.kernels.gru import (
    gru_cell_scan, gru_cell_scan_plain, gru_cell_scan_train_plain,
    gru_cell_scan_bwd_plain, recurrent_weight_grad)

torch.set_num_threads(2)

T, B, H = 12, 3, 8
ATOL = 1e-5
GRAD_ATOL = 2e-5
CASES = [(n_dir, kind) for n_dir in (1, 2)
         for kind in (None, 'suffix', 'prefix')]


def _inputs(n_dir, mask_kind, seed, h0_scale=0.1, b=B, h=H):
    rng = np.random.RandomState(seed)
    rows = n_dir * b
    mask = None
    if mask_kind is not None:
        lens = rng.randint(1, T, size=rows)
        lens[0] = T
        mask = (np.arange(T)[:, None] < lens[None, :]).astype('float32')
        if mask_kind == 'prefix':
            mask = mask[::-1].copy()
    w_shape = (h, 3 * h) if n_dir == 1 else (n_dir, h, 3 * h)
    arrays = [
        (rng.randn(T, rows, 3 * h) * 0.5).astype('float32'),
        (rng.randn(*w_shape) * (0.3 * np.sqrt(H / h))).astype('float32'),
        mask,
        (rng.randn(rows, h) * h0_scale).astype('float32'),
    ]
    cotangents = [rng.randn(T, rows, h).astype('float32'),
                  rng.randn(rows, h).astype('float32')]
    return arrays, cotangents


def _jnp(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _ref_scan(gx, w, mask, h0):
    """The recurrence as a ``lax.scan`` (one or two directions)."""
    w3 = w if w.ndim == 3 else w[None]
    n_dir = w3.shape[0]
    hdim = h0.shape[-1]
    if mask is None:
        mask = jnp.ones(gx.shape[:2], gx.dtype)

    def step(hh, inp):
        g, m = inp
        gh = jnp.einsum('dbh,dhg->dbg', hh.reshape(n_dir, -1, hdim),
                        w3).reshape(hh.shape[0], -1)
        r = jax.nn.sigmoid(g[:, :hdim] + gh[:, :hdim])
        z = jax.nn.sigmoid(g[:, hdim:2 * hdim] + gh[:, hdim:2 * hdim])
        n = jnp.tanh(g[:, 2 * hdim:] + r * gh[:, 2 * hdim:])
        h_new = jnp.where(m[:, None] > 0, (1 - z) * n + z * hh, hh)
        return h_new, h_new * m[:, None]

    h_t, out = jax.lax.scan(step, h0, (gx, mask))
    return out, h_t


def _jax_grads(arrays, cotangents, fn):
    """(dgates_x, dW_hh, dh0) through ``fn`` on the JAX side."""
    gx, w, mask, h0 = _jnp(arrays)
    _, vjp = jax.vjp(lambda gx, w, h0: fn(gx, w, mask, h0), gx, w, h0)
    return [np.asarray(g) for g in vjp(tuple(_jnp(cotangents)))]


def _pallas(gx, w, mask, h0):
    return jax_gru.gru_cell_scan(gx, w, mask, h0, True)  # interpret mode


def _assert_all_close(got, want, names, atol):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


GRAD_NAMES = ('dgates_x', 'dW_hh', 'dh0')


@pytest.mark.parametrize('h0_scale', [0.1, 1.0])
@pytest.mark.parametrize('n_dir,mask_kind', CASES)
def test_plain_forward_matches_the_pallas_kernel(n_dir, mask_kind, h0_scale):
    arrays, _ = _inputs(n_dir, mask_kind, seed=n_dir, h0_scale=h0_scale)
    want = [np.asarray(a) for a in _pallas(*_jnp(arrays))]
    got = gru_cell_scan_plain(*_torch(arrays))
    _assert_all_close(got, want, ('out', 'h_T'), ATOL)
    # a CPU tensor takes the plain version
    again = gru_cell_scan(*_torch(arrays))
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    if mask_kind is not None:
        assert np.all(got[0].numpy()[arrays[2] == 0] == 0)


@pytest.mark.parametrize('n_dir,mask_kind', CASES)
def test_plain_training_forward_stores_the_jax_residuals(n_dir, mask_kind):
    arrays, _ = _inputs(n_dir, mask_kind, seed=20 + n_dir, h0_scale=1.0)
    out, acts, ghn, h_t = [
        np.asarray(a) for a in jax_gru._fwd_call(*_jnp(arrays), True)]
    got = gru_cell_scan_train_plain(*_torch(arrays))
    got_out, got_acts, got_ghn, got_hprev, got_ht = got
    _assert_all_close((got_out, got_acts, got_ghn, got_ht),
                      (out, acts, ghn, h_t),
                      ('out', 'acts', 'gh_n', 'h_T'), ATOL)
    # h_prev as the JAX backward rebuilds it: h0, the shifted outputs, and
    # h0 again where a valid step follows padding; compared on the valid
    # steps (on a masked step the port stores the frozen state, the JAX
    # package reads the zero of the padded output: both are multiplied
    # by a zero mask)
    mask, h0 = arrays[2], arrays[3]
    want = np.concatenate([h0[None], out[:-1]])
    valid = np.ones((T, h0.shape[0]), bool)
    if mask is not None:
        starts = mask[1:] * (1 - mask[:-1])
        want[1:] += starts[..., None] * h0[None]
        valid = mask > 0
    np.testing.assert_allclose(got_hprev.numpy()[valid], want[valid],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize('reference', ['pallas', 'scan'])
@pytest.mark.parametrize('n_dir,mask_kind', CASES)
def test_autograd_through_plain_matches_jax(n_dir, mask_kind, reference):
    arrays, cotangents = _inputs(n_dir, mask_kind, seed=n_dir)
    want = _jax_grads(arrays, cotangents,
                      _pallas if reference == 'pallas' else _ref_scan)
    gx, w, mask, h0 = _torch(arrays)
    leaves = [a.requires_grad_() for a in (gx, w, h0)]
    outs = gru_cell_scan(leaves[0], leaves[1], mask, leaves[2])
    got = torch.autograd.grad(outs, leaves, _torch(cotangents))
    _assert_all_close(got, want, GRAD_NAMES, GRAD_ATOL)


def _plain_kernel_grads(arrays, cotangents, n_dir):
    gx, w, mask, h0 = _torch(arrays)
    _, acts, gh_n, h_prev, _ = gru_cell_scan_train_plain(gx, w, mask, h0)
    dgx, dgh, dh0 = gru_cell_scan_bwd_plain(
        acts, gh_n, h_prev, w, mask, *_torch(cotangents))
    dw = recurrent_weight_grad(dgh, h_prev, n_dir)
    return dgx, (dw[0] if n_dir == 1 else dw), dh0, dgh


# beside CASES, the narrow shapes at which tests/test_torch_gru_bwd_resident.py
# replays the resident backward kernel's split against the plain version
# (contiguous-valid masks): (n_dir, mask kind, rows per direction, H)
RESIDENT_REPLAY_SHAPES = [(2, 'suffix', 5, 37), (1, 'suffix', 8, 64)]


@pytest.mark.parametrize('reference', ['pallas', 'scan'])
@pytest.mark.parametrize(
    'n_dir,mask_kind,b,h',
    [(*case, B, H) for case in CASES] + RESIDENT_REPLAY_SHAPES,
    ids=[f'{n_dir}-{kind}' for n_dir, kind in CASES]
    + [f'{n_dir}-{kind}-{b}x{h}'
       for n_dir, kind, b, h in RESIDENT_REPLAY_SHAPES])
def test_plain_training_kernels_match_jax(n_dir, mask_kind, b, h,
                                          reference):
    arrays, cotangents = _inputs(n_dir, mask_kind, seed=10 + n_dir, b=b,
                                 h=h)
    want = _jax_grads(arrays, cotangents,
                      _pallas if reference == 'pallas' else _ref_scan)
    got = _plain_kernel_grads(arrays, cotangents, n_dir)[:3]
    _assert_all_close(got, want, GRAD_NAMES, GRAD_ATOL)


def test_backward_emits_the_two_streams_of_the_jax_kernel():
    """``dgx`` and ``dgh`` differ in the n block only, by the factor r,
    and are zero on masked steps."""
    arrays, cotangents = _inputs(2, 'prefix', seed=5)
    dgx, _, _, dgh = _plain_kernel_grads(arrays, cotangents, 2)
    acts = gru_cell_scan_train_plain(*_torch(arrays))[1]
    assert torch.equal(dgx[..., :2 * H], dgh[..., :2 * H])
    torch.testing.assert_close(dgx[..., 2 * H:] * acts[..., :H],
                               dgh[..., 2 * H:], atol=1e-7, rtol=0)
    masked = torch.from_numpy(arrays[2]) == 0
    assert float(dgx[masked].abs().max()) == 0
    assert float(dgh[masked].abs().max()) == 0


@pytest.mark.parametrize('n_dir', [1, 2])
def test_leading_masked_steps_with_a_nonzero_initial_state(n_dir):
    """A leading-masked prefix (the flipped direction of a bidirectional
    layer) with a large ``h0``: the first valid step starts from the
    frozen ``h0``, not from the zero that ``out`` holds in the padding.
    ``h_prev`` enters ``dz_pre`` itself, so a wrong one corrupts
    ``dgates_x``, not only ``dW_hh``."""
    t, b, h = 8, 4, 16
    rng = np.random.RandomState(0)
    rows = n_dir * b
    mask = np.ones((t, rows), np.float32)
    mask[:3] = 0.0
    w_shape = (h, 3 * h) if n_dir == 1 else (n_dir, h, 3 * h)
    arrays = [(rng.randn(t, rows, 3 * h) * 0.3).astype('float32'),
              (rng.randn(*w_shape) * 0.1).astype('float32'), mask,
              (rng.randn(rows, h) * 0.5).astype('float32')]
    cotangents = [rng.randn(t, rows, h).astype('float32'),
                  rng.randn(rows, h).astype('float32')]
    for fn in (_pallas, _ref_scan):
        want = _jax_grads(arrays, cotangents, fn)
        got = _plain_kernel_grads(arrays, cotangents, n_dir)[:3]
        _assert_all_close(got, want, GRAD_NAMES, GRAD_ATOL)
    # with h_prev read from the shifted outputs alone, dgates_x is wrong
    gx, w, mask_t, h0 = _torch(arrays)
    out, acts, gh_n, _, _ = gru_cell_scan_train_plain(gx, w, mask_t, h0)
    shifted = torch.cat([h0[None], out[:-1]])
    wrong = gru_cell_scan_bwd_plain(acts, gh_n, shifted, w, mask_t,
                                    *_torch(cotangents))[0]
    assert np.abs(wrong.numpy() - want[0]).max() > 1e-2
