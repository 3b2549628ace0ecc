"""bf16 in the port's LSTM against the JAX package, along the two axes of
its contract (``padertorch_tpu_torch/ops/kernels/lstm.py``).

XLA:CPU cannot run every bf16 product the card runs, so the comparison
splits as the JAX package's own tests split it:

- **streams**: bf16 ``gates_x`` with float32 products.  The port's plain
  versions (forward, the training forward's residuals, the backward and
  ``dW_hh``) against ``padertorch_tpu.ops.pallas.lstm`` in interpret mode
  with ``compute_dtype='bfloat16'`` (whose interpret mode keeps the
  products float32 and the streams bf16), and ``jax.vjp`` of it.  Limit:
  one bf16 unit in the last place of each value plus 1e-5 (the same
  float32 arithmetic; a value near a rounding boundary may round the other
  way).  ``out``, the residuals and ``dgates_x`` are bf16; the states,
  ``dW_hh``, ``dh0`` and ``dc0`` float32.
- **products**: float32 streams with ``compute_dtype='bfloat16'``.  The
  plain forward against a ``lax.scan`` of the JAX ``LSTM._cell_step``
  (``bf16(h) @ bf16(W_hh)``, float32 sums).  Limit 1e-5 (what differs is
  the order of float32 sums); the port with float32 products lies further
  than 2e-4 from it, so the limit tells bf16 products from float32.
- **module**: ``LSTM``, ``GRU`` (``test_torch_gru_bf16.py`` holds its
  kernels' contract) and ``PermutationInvariantTrainingModel`` with
  ``compute_dtype='bfloat16'``, bidirectional, ragged lengths, against the
  JAX modules' scan backend with the same weights: outputs within 5e-2,
  input gradients within atol 0.35, rtol 0.05 (the JAX package's limits
  for its two backends, ``tests/test_modules/test_recurrent.py``);
  parameter gradients and states float32.

Sizes are small: T=12, three rows a direction, H of 8 and 12 (12 is not a
multiple of 8).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models.bss import (
    PermutationInvariantTrainingModel as JaxPIT)
from padertorch_tpu.modules.recurrent import (
    GRU as JaxGRU, LSTM as JaxLSTM, set_rnn_backend)
from padertorch_tpu.ops.pallas import lstm as jax_lstm
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.modules.recurrent import GRU, LSTM, project
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_bwd_plain, lstm_cell_scan_plain,
    lstm_cell_scan_train_plain, recurrent_weight_grad)

torch.set_num_threads(2)

T, B = 12, 3
STREAM_ATOL = 1e-5
PRODUCT_ATOL = 1e-5
PRODUCT_F32_MIN = 2e-4
MODULE_ATOL = 5e-2
GRAD_ATOL, GRAD_RTOL = 0.35, 0.05

STREAM_CASES = [(2, 'suffix', 8), (2, 'prefix', 8), (1, None, 12)]


def bf16_ulp(x):
    """A bf16 unit in the last place of each value of ``x`` (float64)."""
    x = np.abs(np.asarray(x, 'float64'))
    exponent = np.floor(np.log2(np.where(x > 0, x, 1.0)))
    return np.where(x > 0, 2.0 ** (exponent - 7), 0.0)


def assert_within_an_ulp(got, want, name):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), 'float64')
    assert got.shape == want.shape, name
    excess = np.abs(got - want) - bf16_ulp(want) - STREAM_ATOL
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
    gates_x = (rng.randn(T, rows, 4 * hdim) * 0.5).astype('float32')
    w = (rng.randn(n_dir, hdim, 4 * hdim) * 0.3).astype('float32')
    states = [(rng.randn(rows, hdim) * 0.1).astype('float32')
              for _ in range(2)]
    cot = [rng.randn(T, rows, hdim).astype('float32'),
           rng.randn(rows, hdim).astype('float32'),
           rng.randn(rows, hdim).astype('float32')]
    return gates_x, w, mask, states, cot


@pytest.fixture(scope='module', params=STREAM_CASES,
                ids=[f'{n}dir-{k}-H{h}' for n, k, h in STREAM_CASES])
def streams(request):
    """The case's inputs, and the JAX interpret kernel's residuals and
    gradients on bf16 ``gates_x`` (float32 products)."""
    n_dir, kind, hdim = request.param
    gates_x, w, mask, (h0, c0), (d_out, dh, dc) = _stream_case(*request.param)
    gx16 = jnp.asarray(gates_x).astype(jnp.bfloat16)
    m = None if mask is None else jnp.asarray(mask)
    args = (jnp.asarray(w), jnp.asarray(h0), jnp.asarray(c0))
    residuals = jax_lstm._fwd_call(gx16, args[0], m, *args[1:], True,
                                   'bfloat16')
    _, vjp = jax.vjp(
        lambda g, w_, a, b: jax_lstm.lstm_cell_scan(
            g, w_, m, a, b, True, 'bfloat16'), gx16, *args)
    grads = vjp((jnp.asarray(d_out).astype(jnp.bfloat16), jnp.asarray(dh),
                 jnp.asarray(dc)))
    port = dict(
        gates_x=torch.from_numpy(np.array(gx16.astype(jnp.float32))).to(
            torch.bfloat16),
        w=torch.from_numpy(w), mask=None if mask is None else
        torch.from_numpy(mask), h0=torch.from_numpy(h0),
        c0=torch.from_numpy(c0),
        d_out=torch.from_numpy(d_out).to(torch.bfloat16),
        dh=torch.from_numpy(dh), dc=torch.from_numpy(dc), n_dir=n_dir)
    return port, residuals, grads


def test_stream_axis_forward_and_residuals_match_the_interpret_kernel(
        streams):
    p, want, _ = streams
    got = lstm_cell_scan_train_plain(p['gates_x'], p['w'], p['mask'],
                                     p['h0'], p['c0'])
    out, c_seq, gates, h_t, c_t = got
    assert out.dtype == c_seq.dtype == gates.dtype == torch.bfloat16
    assert h_t.dtype == c_t.dtype == torch.float32
    for name, g, w in zip(('out', 'c_seq', 'gates', 'h_T', 'c_T'), got,
                          want):
        assert_within_an_ulp(g, w, name)
    # the lean forward (what a CPU tensor runs) is the same arithmetic
    lean = lstm_cell_scan(p['gates_x'], p['w'], p['mask'], p['h0'], p['c0'])
    for g, w in zip(lean, (out, h_t, c_t)):
        assert torch.equal(g, w)


def test_stream_axis_gradients_match_the_interpret_kernel(streams):
    p, _, want = streams
    out, c_seq, gates, _, _ = lstm_cell_scan_train_plain(
        p['gates_x'], p['w'], p['mask'], p['h0'], p['c0'])
    dgx, dh0, dc0 = lstm_cell_scan_bwd_plain(
        gates, c_seq, p['w'], p['mask'], p['d_out'], p['dh'], p['dc'])
    dw = recurrent_weight_grad(dgx, out, p['h0'], p['mask'], p['n_dir'])
    assert dgx.dtype == torch.bfloat16
    assert dw.dtype == dh0.dtype == dc0.dtype == torch.float32
    for name, g, w in zip(('dgates_x', 'dW_hh', 'dh0', 'dc0'),
                          (dgx, dw, dh0, dc0), want):
        assert_within_an_ulp(g, w, name)


@pytest.mark.parametrize('hdim', [8, 12])
def test_product_axis_matches_the_jax_cell_step(hdim):
    rng = np.random.RandomState(hdim)
    w = (rng.randn(hdim, 4 * hdim) * 0.3).astype('float32')
    gates_x = (rng.randn(T, B, 4 * hdim) * 0.5).astype('float32')
    h0, c0 = ((rng.randn(B, hdim) * 0.1).astype('float32') for _ in range(2))
    cell = JaxLSTM(hdim, hdim, compute_dtype='bfloat16')
    w16 = jnp.asarray(w).astype(jnp.bfloat16)

    @jax.jit
    def scan(gx, h, c):
        return jax.lax.scan(lambda carry, g: cell._cell_step(carry, g, w16),
                            (h, c), gx)

    (h_t, c_t), out = scan(jnp.asarray(gates_x), jnp.asarray(h0),
                           jnp.asarray(c0))
    want = [np.asarray(a) for a in (out, h_t, c_t)]
    args = [torch.from_numpy(a) for a in (gates_x, w)]
    states = [torch.from_numpy(a) for a in (h0, c0)]

    def distance(compute_dtype):
        got = lstm_cell_scan_plain(*args, None, *states, compute_dtype)
        assert all(g.dtype == torch.float32 for g in got)
        return max(float(np.abs(g.numpy() - w).max())
                   for g, w in zip(got, want))

    assert distance('bfloat16') <= PRODUCT_ATOL
    # the limit tells bf16 products from float32 ones
    assert distance(None) > PRODUCT_F32_MIN


@pytest.mark.parametrize('n_dir,batch', [(2, 1), (1, 1), (2, 3)])
def test_bf16_projection_rounds_once_and_its_gradients(n_dir, batch):
    """gates = bf16(x @ w^T + bias) from bf16 operands, float32 sums and a
    float32 bias, in the cell scan's contiguous (T, D * B, G) layout (one
    row a direction included); the gradients as the float32 products of
    the bf16 values give them, rounded to each operand's dtype."""
    rng = np.random.RandomState(batch + n_dir)
    x = torch.from_numpy(rng.randn(n_dir, T, batch, 6).astype(
        'float32')).to(torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy(rng.randn(n_dir, 16, 6).astype('float32')).to(
        torch.bfloat16).requires_grad_(True)
    bias = torch.from_numpy(rng.randn(n_dir, 16).astype(
        'float32')).requires_grad_(True)
    gates = project(x, w, bias)
    assert gates.dtype == torch.bfloat16 and gates.is_contiguous()
    x64, w64 = x.detach().double(), w.detach().double()
    want = (torch.einsum('dtbf,dgf->tdbg', x64, w64)
            + bias.detach().double()[None, :, None, :]).reshape(
        T, n_dir * batch, 16)
    assert torch.equal(gates, want.float().to(torch.bfloat16))
    d_gates = torch.from_numpy(rng.randn(T, n_dir * batch, 16).astype(
        'float32')).to(torch.bfloat16)
    gates.backward(d_gates)
    dg = d_gates.double().reshape(T, n_dir, batch, 16)
    for got, want in (
            (x.grad, torch.einsum('tdbg,dgf->dtbf', dg, w64)),
            (w.grad, torch.einsum('tdbg,dtbf->dgf', dg, x64)),
            (bias.grad, dg.sum(dim=(0, 2)))):
        assert got.dtype == (torch.float32 if got is bias.grad
                             else torch.bfloat16)
        np.testing.assert_allclose(
            got.double().numpy(), want.numpy(),
            rtol=2 ** -8, atol=1e-6)



@pytest.mark.parametrize('n_dir,batch', [(2, 1), (2, 3)])
def test_float32_projection_takes_the_same_route(n_dir, batch):
    """The float32 projection is the same Function: float32 gates and
    gradients as float64 einsums give them, and no input adjoint where the
    input needs none (a model's first layer)."""
    rng = np.random.RandomState(batch + n_dir)
    x = torch.from_numpy(rng.randn(n_dir, T, batch, 6).astype('float32'))
    w = torch.from_numpy(rng.randn(n_dir, 16, 6).astype(
        'float32')).requires_grad_(True)
    bias = torch.from_numpy(rng.randn(n_dir, 16).astype(
        'float32')).requires_grad_(True)
    gates = project(x, w, bias)
    assert gates.dtype == torch.float32 and gates.is_contiguous()
    x64, w64 = x.double(), w.detach().double()
    want = (torch.einsum('dtbf,dgf->tdbg', x64, w64)
            + bias.detach().double()[None, :, None, :]).reshape(
        T, n_dir * batch, 16)
    np.testing.assert_allclose(gates.detach().double().numpy(),
                               want.numpy(), rtol=1e-6, atol=1e-6)
    d_gates = torch.from_numpy(rng.randn(T, n_dir * batch, 16).astype(
        'float32'))
    gates.backward(d_gates)
    dg = d_gates.double().reshape(T, n_dir, batch, 16)
    assert x.grad is None
    for got, want in ((w.grad, torch.einsum('tdbg,dtbf->dgf', dg, x64)),
                      (bias.grad, dg.sum(dim=(0, 2)))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-5)


LENS = np.array([12, 7, 3])


def _module_pair(bidirectional=True, gru=False):
    jax_cls, cls = (JaxGRU, GRU) if gru else (JaxLSTM, LSTM)
    ptrandom.seed(3)
    jax_rnn = set_rnn_backend(jax_cls(
        6, 8, num_layers=2, bidirectional=bidirectional,
        compute_dtype='bfloat16'), 'scan')
    port = from_jax_state_dict(
        cls(6, 8, num_layers=2, bidirectional=bidirectional,
            compute_dtype='bfloat16'), jax_rnn.state_dict())
    return jax_rnn, port


@pytest.mark.parametrize('gru', [False, True], ids=['LSTM', 'GRU'])
def test_module_matches_the_jax_scan_backend(gru):
    """Both modules' plain versions compute the contract on the CPU (the
    card runs their bf16 kernels)."""
    jax_rnn, port = _module_pair(gru=gru)
    x = np.random.RandomState(1).randn(3, T, 6).astype('float32')
    lens = jnp.asarray(LENS)

    @jax.jit
    def forward(x):
        return jax_rnn(x, seq_lens=lens)

    grad = jax.jit(jax.grad(
        lambda x: jnp.sum(jax_rnn(x, seq_lens=lens)[0] ** 2)))
    want_out, want_states = forward(jnp.asarray(x))
    want_grad = np.asarray(grad(jnp.asarray(x)))

    tx = torch.from_numpy(x).requires_grad_(True)
    out, states = port(tx, seq_lens=LENS)
    states = (states,) if gru else states
    want_states = (want_states,) if gru else want_states
    # an f32 model stays f32 outside the RNN; states are f32
    assert {out.dtype} | {s.dtype for s in states} == {torch.float32}
    for got, want in zip((out, *states), (want_out, *want_states)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=MODULE_ATOL, rtol=0)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_grad, atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
    for name, p in port.named_parameters():
        if p.requires_grad:
            assert p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name


def test_module_keeps_a_bf16_stream_bf16_and_its_states_f32():
    _, port = _module_pair(bidirectional=False)
    x = torch.from_numpy(
        np.random.RandomState(2).randn(3, T, 6).astype('float32'))
    out32, (h32, _) = port(x, seq_lens=LENS)
    out16, (h16, c16) = port(x.to(torch.bfloat16), seq_lens=LENS)
    assert out16.dtype == torch.bfloat16
    assert h16.dtype == c16.dtype == torch.float32
    # a bf16 input is the f32 input rounded: the outputs stay close
    np.testing.assert_allclose(out16.float().detach().numpy(),
                               out32.detach().numpy(), atol=MODULE_ATOL)


def _pit_batch():
    rng = np.random.RandomState(4)
    return {
        'Y_abs': np.abs(rng.randn(3, T, 17)).astype('float32'),
        'num_frames': LENS.astype('int32'),
    }


def test_pit_model_with_compute_dtype_matches_the_jax_scan_backend():
    size = dict(F=17, recurrent_layers=2, units=8, K=2,
                compute_dtype='bfloat16')
    ptrandom.seed(5)
    jax_model = set_rnn_backend(JaxPIT(**size), 'scan')
    port = from_jax_state_dict(PermutationInvariantTrainingModel(**size),
                               jax_model.state_dict())
    batch = _pit_batch()

    @jax.jit
    def forward(y):
        return jax_model({'Y_abs': y,
                          'num_frames': jnp.asarray(batch['num_frames'])})

    want = np.asarray(forward(jnp.asarray(batch['Y_abs'])))
    y = torch.from_numpy(batch['Y_abs']).requires_grad_(True)
    masks = port({'Y_abs': y, 'num_frames': batch['num_frames']})
    assert masks.dtype == torch.float32
    np.testing.assert_allclose(masks.detach().numpy(), want,
                               atol=MODULE_ATOL, rtol=0)
    masks.sum().backward()
    assert torch.isfinite(y.grad).all()
    for name, p in port.named_parameters():
        if p.requires_grad:
            assert p.grad.dtype == torch.float32, name
