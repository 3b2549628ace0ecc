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
