"""The port's ``LSTM`` module against the JAX package's ``LSTM``.

The JAX side runs both its ``lax.scan`` backend and its Pallas backend
(interpret mode on the CPU, where a bidirectional LSTM takes the
time-major stack).  Weights move with the port's ``from_jax_state_dict``
and, the other way, with ``padertorch_tpu.migrate.import_torch_state_dict``.
Tolerance 1e-4 (f32, two layers, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.migrate import import_torch_state_dict
from padertorch_tpu.modules.recurrent import LSTM as JaxLSTM, set_rnn_backend
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.modules.recurrent import LSTM

torch.set_num_threads(2)

B, T, F, H = 3, 15, 10, 16
LENS = np.array([15, 9, 4], dtype='int32')
ATOL = 1e-4


def _run_jax(model, x, state=None):
    out, (h, c) = model(jnp.asarray(x), seq_lens=jnp.asarray(LENS),
                        state=state)
    return [np.asarray(a) for a in (out, h, c)]


def _run_port(model, x, state=None):
    with torch.no_grad():
        out, (h, c) = model(torch.from_numpy(x),
                            seq_lens=torch.from_numpy(LENS), state=state)
    return [a.numpy() for a in (out, h, c)]


def _assert_close(got, want):
    for name, g, w in zip(('out', 'h_n', 'c_n'), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def _x(seed=0):
    return np.random.RandomState(seed).randn(B, T, F).astype('float32')


@pytest.mark.parametrize('bidirectional', [True, False])
@pytest.mark.parametrize('backend', ['scan', 'pallas'])
def test_matches_jax_lstm(backend, bidirectional):
    ptrandom.seed(0)
    jax_lstm = set_rnn_backend(
        JaxLSTM(F, H, num_layers=2, bidirectional=bidirectional), backend)
    port = from_jax_state_dict(
        LSTM(F, H, num_layers=2, bidirectional=bidirectional),
        jax_lstm.state_dict())
    x = _x()
    want = _run_jax(jax_lstm, x)
    got = _run_port(port, x)
    _assert_close(got, want)
    # padding is zero in the output, as for packed sequences
    assert np.all(got[0][2, LENS[2]:] == 0)


def test_import_torch_state_dict_moves_port_weights_to_jax():
    torch.manual_seed(0)
    port = LSTM(F, H, num_layers=2, bidirectional=True)
    ptrandom.seed(1)
    jax_lstm = import_torch_state_dict(
        JaxLSTM(F, H, num_layers=2, bidirectional=True),
        {k: v.detach().numpy() for k, v in port.state_dict().items()})
    x = _x(1)
    _assert_close(_run_port(port, x), _run_jax(jax_lstm, x))


def test_initial_state_matches_jax():
    ptrandom.seed(2)
    jax_lstm = JaxLSTM(F, H, num_layers=2, bidirectional=True)
    port = from_jax_state_dict(
        LSTM(F, H, num_layers=2, bidirectional=True), jax_lstm.state_dict())
    rng = np.random.RandomState(2)
    h0, c0 = (rng.randn(4, B, H).astype('float32') * 0.5 for _ in range(2))
    x = _x(2)
    want = _run_jax(jax_lstm, x, state=(jnp.asarray(h0), jnp.asarray(c0)))
    got = _run_port(port, x, state=(torch.from_numpy(h0),
                                     torch.from_numpy(c0)))
    _assert_close(got, want)


def test_parameter_names_and_layouts_are_torch_nn_lstm():
    port = LSTM(F, H, num_layers=2, bidirectional=True)
    reference = torch.nn.LSTM(F, H, num_layers=2, bidirectional=True)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in reference.state_dict().items()}


def _port_grads_in_jax_layout(port):
    """Parameter gradients keyed like the JAX LSTM's ``state_dict``:
    ``w_ih.{i}``, ``w_hh.{i}`` transposed, ``b.{i}`` from ``bias_ih``."""
    grads = {}
    for layer in range(port.num_layers):
        for d, suffix in enumerate(port._suffixes()):
            i = layer * port.num_directions + d
            get = lambda n: getattr(port, f'{n}_l{layer}{suffix}')  # noqa
            grads[f'w_ih.{i}'] = get('weight_ih').grad.numpy().T
            grads[f'w_hh.{i}'] = get('weight_hh').grad.numpy().T
            grads[f'b.{i}'] = get('bias_ih').grad.numpy()
            assert get('bias_hh').grad is None
    return grads


@pytest.mark.parametrize('backend', ['scan', 'pallas'])
def test_gradients_match_jax_lstm(backend):
    """d loss / d input and d loss / d every parameter of a 2-layer
    bidirectional LSTM against ``jax.grad`` of the JAX module, for a loss
    that weighs the output and both final states; 1e-4."""
    import jax
    from padertorch_tpu.module import combine, partition, state_dict

    ptrandom.seed(3)
    jax_lstm = set_rnn_backend(
        JaxLSTM(F, H, num_layers=2, bidirectional=True), backend)
    port = from_jax_state_dict(
        LSTM(F, H, num_layers=2, bidirectional=True), jax_lstm.state_dict())
    x = _x(3)
    rng = np.random.RandomState(3)
    w_out = rng.randn(B, T, 2 * H).astype('float32')
    w_h, w_c = (rng.randn(4, B, H).astype('float32') for _ in range(2))

    params, static = partition(jax_lstm)

    def jax_loss(params, x):
        out, (h, c) = combine(params, static)(x, seq_lens=jnp.asarray(LENS))
        return (jnp.sum(out * w_out) + jnp.sum(h * w_h) + jnp.sum(c * w_c))

    want_params, want_x = jax.grad(jax_loss, argnums=(0, 1))(
        params, jnp.asarray(x))
    want_params = state_dict(want_params)

    x_t = torch.from_numpy(x).requires_grad_()
    out, (h, c) = port(x_t, seq_lens=torch.from_numpy(LENS))
    loss = ((out * torch.from_numpy(w_out)).sum()
            + (h * torch.from_numpy(w_h)).sum()
            + (c * torch.from_numpy(w_c)).sum())
    loss.backward()
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(want_x),
                               atol=ATOL, rtol=0)
    got = _port_grads_in_jax_layout(port)
    assert got.keys() == want_params.keys()
    for name in got:
        np.testing.assert_allclose(got[name], np.asarray(want_params[name]),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_only_bias_ih_is_trained():
    """The JAX LSTM has one fused bias: ``bias_hh`` stays in the module
    and its ``state_dict`` under torch's name, starts at zero, is used in
    the sum and does not require a gradient."""
    from padertorch_tpu_torch.migrate import to_jax_state_dict
    torch.manual_seed(4)
    port = LSTM(F, H, num_layers=1, bidirectional=True)
    frozen = [n for n, p in port.named_parameters() if not p.requires_grad]
    assert frozen == ['bias_hh_l0', 'bias_hh_l0_reverse']
    assert set(frozen) < set(port.state_dict())
    assert all(float(getattr(port, n).abs().max()) == 0 for n in frozen)
    x = torch.from_numpy(_x(4))
    before = port(x)[0]
    with torch.no_grad():
        port.bias_hh_l0.add_(0.5)
    assert float((port(x)[0] - before).abs().max()) > 1e-3
    np.testing.assert_allclose(
        to_jax_state_dict(port)['b.0'],
        (port.bias_ih_l0 + port.bias_hh_l0).detach().numpy())


def test_dropout_between_layers_takes_the_modules_generator():
    port = LSTM(F, H, num_layers=2, bidirectional=True, dropout=0.5).train()
    x = torch.from_numpy(_x(5))
    outs = []
    for _ in range(2):
        port.generator = torch.Generator().manual_seed(7)
        torch.manual_seed(len(outs))  # the global generator differs
        outs.append(port(x)[0])
    assert torch.equal(outs[0], outs[1])
    port.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(port(x)[0], outs[0])
    assert torch.equal(port.eval()(x)[0], port(x)[0])
