"""bf16 in the port's GRU against the JAX package, along the two axes of
its contract (``padertorch_tpu_torch/ops/kernels/gru.py``), as
``test_torch_lstm_bf16.py`` holds the LSTM's.

- **streams**: bf16 ``gates_x`` with float32 products.  The port's plain
  versions (the training forward's ``out``, ``acts``, ``gh_n`` and
  ``h_prev``; the backward's ``dgx``; ``dW_hh`` and ``dh0``) against
  ``padertorch_tpu.ops.pallas.gru`` in interpret mode with
  ``compute_dtype='bfloat16'`` (whose interpret mode keeps the products
  float32 and the streams bf16) and ``jax.vjp`` of it.  Limit: one bf16
  unit in the last place of each value plus 1e-5.  The JAX backward
  rebuilds ``h_prev`` from its bf16 ``out``; the port's bf16 ``h_prev`` is
  ``bf16(h_{t-1})``, the same on every valid step (a masked step's
  ``h_prev`` enters no gradient).
- **products**: float32 streams with ``compute_dtype='bfloat16'``.  The
  plain forward against a ``lax.scan`` of the JAX ``GRU._cell_step`` with
  bf16 ``W_hh``, within 1e-5; the port with float32 products lies further
  than 2e-4 from it.
- **modules**: ``set_rnn_backend`` against the JAX function on a DPRNN and
  on the speaker classifier (which RNNs it reaches, and their outputs
  against the JAX scan backend), and a ``bgru`` ``TasNet`` with every GRU
  at ``compute_dtype='bfloat16'`` under the policy's casts (bf16 weights
  and input) against the JAX model with the same weights: outputs within
  5e-2, input gradients within atol 0.35, rtol 0.05 (the JAX package's
  limits for its two backends, as in ``test_torch_lstm_bf16.py``).

Sizes are small: T=12, three rows a direction, H of 8 and 12.  The bf16
kernels are held against these plain versions on the card
(``test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 28).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models import tasnet as jax_tasnet
from padertorch_tpu.module import combine, partition
from padertorch_tpu.modules.dual_path_rnn import DPRNN as JaxDPRNN
from padertorch_tpu.modules.recurrent import (
    GRU as JaxGRU, LSTM as JaxLSTM, set_rnn_backend as jax_set_rnn_backend)
from padertorch_tpu.ops.pallas import gru as jax_gru
from padertorch_tpu.train.precision import Precision as JaxPrecision
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.models import tasnet
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
from padertorch_tpu_torch.modules.recurrent import (
    GRU, LSTM, set_rnn_backend)
from padertorch_tpu_torch.ops.kernels.gru import (
    gru_cell_scan, gru_cell_scan_bwd_plain, gru_cell_scan_plain,
    gru_cell_scan_train_plain, recurrent_weight_grad)

torch.set_num_threads(2)

T, B = 12, 3
STREAM_ATOL = 1e-5
PRODUCT_ATOL = 1e-5
PRODUCT_F32_MIN = 2e-4
MODULE_ATOL = 5e-2
GRAD_ATOL, GRAD_RTOL = 0.35, 0.05

STREAM_CASES = [(2, 'suffix', 8), (2, 'prefix', 12), (1, None, 12)]


def bf16_ulp(x):
    """A bf16 unit in the last place of each value of ``x`` (float64)."""
    x = np.abs(np.asarray(x, 'float64'))
    exponent = np.floor(np.log2(np.where(x > 0, x, 1.0)))
    return np.where(x > 0, 2.0 ** (exponent - 7), 0.0)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype('float64')
    return np.asarray(jnp.asarray(x, jnp.float32), 'float64')


def assert_within_an_ulp(got, want, name, where=None):
    got, want = _numpy(got), _numpy(want)
    assert got.shape == want.shape, name
    excess = np.abs(got - want) - bf16_ulp(want) - STREAM_ATOL
    if where is not None:
        excess = excess[where]
    assert excess.max() <= 0, (name, float(excess.max()))


def _stream_case(n_dir, kind, hdim):
    rng = np.random.RandomState(hdim + n_dir)
    rows = n_dir * B
    mask = None
    if kind is not None:
        lens = rng.randint(1, T, size=rows)
        lens[0] = T
        mask = (np.arange(T)[:, None] < lens[None, :]).astype('float32')
        if kind == 'prefix':
            mask = mask[::-1].copy()
    gates_x = (rng.randn(T, rows, 3 * hdim) * 0.5).astype('float32')
    w = (rng.randn(n_dir, hdim, 3 * hdim) * 0.3).astype('float32')
    h0 = (rng.randn(rows, hdim) * 0.3).astype('float32')
    cot = [rng.randn(T, rows, hdim).astype('float32'),
           rng.randn(rows, hdim).astype('float32')]
    return gates_x, w, mask, h0, cot


@pytest.fixture(scope='module', params=STREAM_CASES,
                ids=[f'{n}dir-{k}-H{h}' for n, k, h in STREAM_CASES])
def streams(request):
    """The case's inputs, and the JAX interpret kernel's forward with its
    residuals, its rebuilt ``h_prev`` and its gradients on bf16
    ``gates_x`` (float32 products)."""
    n_dir, kind, hdim = request.param
    gates_x, w, mask, h0, (d_out, dh) = _stream_case(*request.param)
    gx16 = jnp.asarray(gates_x).astype(jnp.bfloat16)
    m = None if mask is None else jnp.asarray(mask)
    out, acts, ghn, h_t = jax_gru._fwd_call(
        gx16, jnp.asarray(w), m, jnp.asarray(h0), True, 'bfloat16')
    # the JAX backward's h_prev: h0 then out shifted, plus h0 where a
    # valid step follows a masked one
    h0s = jnp.asarray(h0).astype(out.dtype)
    h_prev = jnp.concatenate([h0s[None], out[:-1]], axis=0)
    if m is not None:
        starts = (m[1:] * (1.0 - m[:-1]))[..., None]
        h_prev = h_prev.at[1:].add((starts * h0s[None]).astype(out.dtype))
    _, vjp = jax.vjp(
        lambda g, w_, h: jax_gru.gru_cell_scan(g, w_, m, h, True,
                                               'bfloat16'),
        gx16, jnp.asarray(w), jnp.asarray(h0))
    grads = vjp((jnp.asarray(d_out).astype(jnp.bfloat16), jnp.asarray(dh)))
    port = dict(
        gates_x=torch.from_numpy(np.array(gx16.astype(jnp.float32))).to(
            torch.bfloat16),
        w=torch.from_numpy(w),
        mask=None if mask is None else torch.from_numpy(mask),
        h0=torch.from_numpy(h0),
        d_out=torch.from_numpy(d_out).to(torch.bfloat16),
        dh=torch.from_numpy(dh), n_dir=n_dir, valid=mask)
    return port, (out, acts, ghn, h_prev, h_t), grads


def test_stream_axis_forward_and_residuals_match_the_interpret_kernel(
        streams):
    p, want, _ = streams
    got = gru_cell_scan_train_plain(p['gates_x'], p['w'], p['mask'],
                                    p['h0'])
    out, acts, gh_n, h_prev, h_t = got
    assert {out.dtype, acts.dtype, gh_n.dtype, h_prev.dtype} == {
        torch.bfloat16}
    assert h_t.dtype == torch.float32
    valid = None if p['valid'] is None else p['valid'] > 0
    for name, g, w in zip(('out', 'acts', 'gh_n', 'h_prev', 'h_T'), got,
                          want):
        assert_within_an_ulp(g, w, name,
                             where=valid if name == 'h_prev' else None)
    # the lean forward (what a CPU tensor runs) is the same arithmetic
    lean = gru_cell_scan(p['gates_x'], p['w'], p['mask'], p['h0'])
    for g, w in zip(lean, (out, h_t)):
        assert torch.equal(g, w)


def test_stream_axis_gradients_match_the_interpret_kernel(streams):
    p, _, want = streams
    _, acts, gh_n, h_prev, _ = gru_cell_scan_train_plain(
        p['gates_x'], p['w'], p['mask'], p['h0'])
    dgx, dgh, dh0 = gru_cell_scan_bwd_plain(
        acts, gh_n, h_prev, p['w'], p['mask'], p['d_out'], p['dh'])
    dw = recurrent_weight_grad(dgh, h_prev, p['n_dir'])
    assert dgx.dtype == dgh.dtype == torch.bfloat16
    assert dw.dtype == dh0.dtype == torch.float32
    for name, g, w in zip(('dgates_x', 'dW_hh', 'dh0'), (dgx, dw, dh0),
                          want):
        assert_within_an_ulp(g, w, name)


def test_the_cpu_wrapper_differentiates_bf16_streams(streams):
    """Autograd through the plain forward on a CPU tensor gives bf16
    ``dgates_x`` and float32 ``dW_hh`` and ``dh0`` near the kernel's
    backward (the same contract; autograd rounds in other places)."""
    p, _, want = streams
    gx = p['gates_x'].clone().requires_grad_()
    w = p['w'].clone().requires_grad_()
    h0 = p['h0'].clone().requires_grad_()
    out, h_t = gru_cell_scan(gx, w, p['mask'], h0)
    torch.autograd.backward([out, h_t], [p['d_out'], p['dh']])
    assert gx.grad.dtype == torch.bfloat16
    assert w.grad.dtype == h0.grad.dtype == torch.float32
    for g, w_ in zip((gx.grad, w.grad, h0.grad), want):
        np.testing.assert_allclose(_numpy(g), _numpy(w_), atol=5e-2)


@pytest.mark.parametrize('hdim', [8, 12])
def test_product_axis_matches_the_jax_cell_step(hdim):
    rng = np.random.RandomState(hdim)
    w = (rng.randn(hdim, 3 * hdim) * 0.3).astype('float32')
    gates_x = (rng.randn(T, B, 3 * hdim) * 0.5).astype('float32')
    h0 = (rng.randn(B, hdim) * 0.3).astype('float32')
    cell = JaxGRU(hdim, hdim, compute_dtype='bfloat16')
    w16 = jnp.asarray(w).astype(jnp.bfloat16)

    @jax.jit
    def scan(gx, h):
        return jax.lax.scan(lambda carry, g: cell._cell_step(carry, g, w16),
                            h, gx)

    h_t, out = scan(jnp.asarray(gates_x), jnp.asarray(h0))
    want = [np.asarray(a) for a in (out, h_t)]
    args = [torch.from_numpy(a) for a in (gates_x, w)]

    def distance(compute_dtype):
        got = gru_cell_scan_plain(*args, None, torch.from_numpy(h0),
                                  compute_dtype)
        assert all(g.dtype == torch.float32 for g in got)
        return max(float(np.abs(g.numpy() - w_).max())
                   for g, w_ in zip(got, want))

    assert distance('bfloat16') <= PRODUCT_ATOL
    # the limit tells bf16 products from float32 ones
    assert distance(None) > PRODUCT_F32_MIN


@pytest.mark.parametrize('masked', [False, True])
def test_backward_product_axis_rounds_dgh_and_w_hh(masked):
    """With float32 streams and bf16 products the backward's dh_{t-1} is
    bf16(dgh) @ bf16(W_hh)^T summed in float32: one step against that
    product in float64, and it moves dh0 beyond what float32 sums do."""
    n_dir, kind, hdim = 2, 'suffix' if masked else None, 12
    gates_x, w, mask, h0, (d_out, dh) = _stream_case(n_dir, kind, hdim)
    args = [torch.from_numpy(a) for a in (gates_x, w)]
    mask = None if mask is None else torch.from_numpy(mask)
    _, acts, gh_n, h_prev, _ = gru_cell_scan_train_plain(
        *args, mask, torch.from_numpy(h0))
    bwd_in = (acts[-1:], gh_n[-1:], h_prev[-1:], args[1],
              None if mask is None else mask[-1:],
              torch.from_numpy(d_out[-1:]), torch.from_numpy(dh))
    _, dgh, dh0 = gru_cell_scan_bwd_plain(*bwd_in, 'bfloat16')
    rows = dgh.shape[1]
    g16 = dgh[0].to(torch.bfloat16).double().reshape(n_dir, rows // n_dir,
                                                     -1)
    w16 = args[1].to(torch.bfloat16).double().transpose(1, 2)
    z = acts[-1, :, hdim:2 * hdim].double()
    dh_in = torch.from_numpy(dh).double() + bwd_in[5][0].double()
    want = torch.bmm(g16, w16).reshape(rows, hdim) + dh_in * z
    if mask is not None:
        want = torch.where(mask[-1][:, None] > 0, want,
                           torch.from_numpy(dh).double())
    assert float((dh0.double() - want).abs().max()) <= 1e-5
    _, _, dh0_f32 = gru_cell_scan_bwd_plain(*bwd_in)
    assert float((dh0_f32 - dh0).abs().max()) > PRODUCT_F32_MIN


def _dprnn_pair(rnn_type='bgru'):
    ptrandom.seed(4)
    size = dict(window_length=6, hop_size=3, num_blocks=1,
                inter_chunk_type=rnn_type, intra_chunk_type=rnn_type)
    jax_model = JaxDPRNN(16, 8, **size)
    port = from_jax_state_dict(DPRNN(16, 8, **size),
                               jax_model.state_dict())
    return jax_model, port


def _rnns(module, cls):
    return {name: sub.compute_dtype for name, sub in module.named_modules()
            if isinstance(sub, cls)}


def test_set_rnn_backend_reaches_every_rnn_as_the_jax_function_does():
    """On a DPRNN with a GRU and an LSTM chunk RNN: every RNN gets the
    compute dtype, 'keep' leaves it, the backend and remat raise only on
    the card, a tree without an RNN raises AssertionError in both
    packages, and the forward agrees with the JAX scan backend."""
    ptrandom.seed(4)
    size = dict(window_length=6, hop_size=3, num_blocks=1,
                inter_chunk_type='bgru', intra_chunk_type='blstm')
    jax_model = jax_set_rnn_backend(JaxDPRNN(16, 8, **size), 'scan',
                                    compute_dtype='bfloat16')
    port = from_jax_state_dict(DPRNN(16, 8, **size), jax_model.state_dict())
    assert set_rnn_backend(port, 'pallas', compute_dtype='bfloat16') is port
    jax_dtypes = {name: sub.compute_dtype for name, sub in jax_model.modules()
                  if isinstance(sub, (JaxGRU, JaxLSTM))}
    assert len(jax_dtypes) == 2 and set(jax_dtypes.values()) == {'bfloat16'}
    got = {**_rnns(port, GRU), **_rnns(port, LSTM)}
    assert len(got) == 2 and set(got.values()) == {torch.bfloat16}
    set_rnn_backend(port, 'scan')           # a CPU module: the plain loop
    assert {**_rnns(port, GRU), **_rnns(port, LSTM)} == got
    with pytest.raises(AssertionError):
        set_rnn_backend(torch.nn.Linear(2, 2), 'pallas')
    with pytest.raises(AssertionError):
        jax_set_rnn_backend(jax_tasnet.TasEncoder(2, feature_size=4),
                            'pallas')
    with pytest.raises(ValueError):
        set_rnn_backend(port, 'cudnn')
    x = np.random.RandomState(5).randn(2, 20, 16).astype('float32')
    want = np.asarray(jax_model(jnp.asarray(x), sequence_lengths=[20, 14]))
    with torch.no_grad():
        out = port(torch.from_numpy(x), sequence_lengths=[20, 14])
    np.testing.assert_allclose(out.numpy(), want, atol=MODULE_ATOL, rtol=0)
    set_rnn_backend(port, 'pallas', compute_dtype=None)
    assert set({**_rnns(port, GRU), **_rnns(port, LSTM)}.values()) == {None}


def test_set_rnn_backend_on_the_speaker_classifier():
    """The classifier's GRU takes the compute dtype from
    ``set_rnn_backend`` in both packages; its logits agree with the JAX
    scan backend's."""
    from padertorch_tpu.contrib.examples.speaker_classification.supervised \
        .model import SpeakerClf as JaxSpeakerClf
    from padertorch_tpu_torch.contrib.examples.speaker_classification \
        .supervised.model import SpeakerClf
    config = {'num_speakers': 5, 'cnn_channels': (4, 8), 'hidden_size': 12}
    ptrandom.seed(6)
    jax_model = jax_set_rnn_backend(
        JaxSpeakerClf.from_config(JaxSpeakerClf.get_config(config)), 'scan',
        compute_dtype='bfloat16').eval()
    port = from_jax_state_dict(
        SpeakerClf.from_config(SpeakerClf.get_config(config)),
        jax_model.state_dict()).eval()
    set_rnn_backend(port, 'pallas', compute_dtype='bfloat16')
    assert jax_model.gru.compute_dtype == 'bfloat16'
    assert port.gru.compute_dtype == torch.bfloat16
    rng = np.random.RandomState(7)
    batch = {'stft': rng.randn(2, 1, 30, 257, 2).astype('float32'),
             'seq_len': np.array([30, 21])}
    want = np.asarray(jax_model({k: jnp.asarray(v)
                                 for k, v in batch.items()}))
    with torch.no_grad():
        got = port({'stft': torch.from_numpy(batch['stft']),
                    'seq_len': batch['seq_len']})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=MODULE_ATOL, rtol=0)


def _tasnet_pair():
    """A small ``bgru`` DPRNN-TasNet in both packages, every GRU at
    ``compute_dtype='bfloat16'`` (the JAX model on its scan backend),
    under the policy's casts: the JAX model's floating arrays and the
    port's parameters bf16."""
    def build(package, dprnn):
        separator = dprnn(16, 8, window_length=10, hop_size=5, num_blocks=2,
                          inter_chunk_type='bgru', intra_chunk_type='bgru')
        return package.TasNet(
            separator=separator,
            encoder=package.TasEncoder(20, feature_size=32),
            decoder=package.TasDecoder(20, feature_size=32))

    ptrandom.seed(8)
    jax_model = jax_set_rnn_backend(build(jax_tasnet, JaxDPRNN), 'scan',
                                    compute_dtype='bfloat16')
    port = from_jax_state_dict(build(tasnet, DPRNN), jax_model.state_dict())
    set_rnn_backend(port, 'pallas', compute_dtype='bfloat16')
    params, static = partition(jax_model)
    jax_model = combine(JaxPrecision('bfloat16').cast_floating(params),
                        static)
    return jax_model, port.to(torch.bfloat16)


def test_bgru_tasnet_with_bf16_grus_under_the_policy_matches_jax():
    jax_model, port = _tasnet_pair()
    rng = np.random.RandomState(9)
    lens = np.array([403, 333, 252], dtype='int32')
    valid = (np.arange(403)[None, :] < lens[:, None]).astype('float32')
    y = (rng.randn(3, 403) * 0.3 * valid).astype('float32')

    def jax_out(y16):
        return jax_model({'y': y16, 'num_samples': jnp.asarray(lens)})['out']

    y16 = jnp.asarray(y).astype(jnp.bfloat16)
    want = np.asarray(jax_out(y16).astype(jnp.float32))
    want_grad = np.asarray(jax.grad(
        lambda a: jnp.sum(jax_out(a).astype(jnp.float32) ** 2))(y16).astype(
            jnp.float32))
    ty = torch.from_numpy(y).to(torch.bfloat16).requires_grad_(True)
    out = port({'y': ty, 'num_samples': lens})['out']
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), want,
                               atol=MODULE_ATOL, rtol=0)
    (out.float() ** 2).sum().backward()
    assert ty.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.grad.float().numpy(), want_grad,
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    for name, p in port.named_parameters():
        if p.requires_grad:
            assert p.grad is not None and torch.isfinite(
                p.grad.float()).all(), name
