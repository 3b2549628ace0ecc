"""The port's ``GRU`` module against the JAX package's ``GRU``.

The JAX side runs both its ``lax.scan`` backend and its Pallas backend
(interpret mode on the CPU).  Weights move with the port's
``from_jax_state_dict``.  Outputs, final states and gradients 1e-4 (f32,
two layers, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules.recurrent import GRU as JaxGRU, set_rnn_backend
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.modules.recurrent import GRU, LSTM, _RNNBase

torch.set_num_threads(2)

B, T, F, H = 3, 15, 10, 16
LENS = np.array([15, 9, 4], dtype='int32')
ATOL = 1e-4


def _x(seed=0):
    return np.random.RandomState(seed).randn(B, T, F).astype('float32')


def _pair(seed, backend, num_layers, bidirectional):
    ptrandom.seed(seed)
    jax_gru = set_rnn_backend(
        JaxGRU(F, H, num_layers=num_layers, bidirectional=bidirectional),
        backend)
    port = from_jax_state_dict(
        GRU(F, H, num_layers=num_layers, bidirectional=bidirectional),
        jax_gru.state_dict())
    return jax_gru, port


@pytest.mark.parametrize('num_layers', [1, 2])
@pytest.mark.parametrize('bidirectional', [True, False])
@pytest.mark.parametrize('backend', ['scan', 'pallas'])
def test_matches_jax_gru(backend, bidirectional, num_layers):
    jax_gru, port = _pair(0, backend, num_layers, bidirectional)
    x = _x()
    for lens in (None, LENS):
        want_out, want_h = jax_gru(
            jnp.asarray(x),
            seq_lens=None if lens is None else jnp.asarray(lens))
        with torch.no_grad():
            out, h = port(torch.from_numpy(x), seq_lens=lens)
        n_dir = 2 if bidirectional else 1
        assert tuple(out.shape) == (B, T, n_dir * H)
        assert tuple(h.shape) == (num_layers * n_dir, B, H)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                   atol=ATOL, rtol=0)
        if lens is not None:
            # padding is zero in the output, as for packed sequences
            assert np.all(out.numpy()[2, LENS[2]:] == 0)


def test_lengths_as_tensor_list_and_numpy_agree():
    _, port = _pair(1, 'scan', 1, True)
    x = torch.from_numpy(_x(1))
    with torch.no_grad():
        outs = [port(x, seq_lens=lens)[0] for lens in (
            LENS, LENS.tolist(), torch.from_numpy(LENS))]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize('backend', ['scan', 'pallas'])
def test_initial_state_matches_jax(backend):
    jax_gru, port = _pair(2, backend, 2, True)
    h0 = (np.random.RandomState(2).randn(4, B, H) * 0.5).astype('float32')
    x = _x(2)
    want_out, want_h = jax_gru(jnp.asarray(x), seq_lens=jnp.asarray(LENS),
                               state=jnp.asarray(h0))
    with torch.no_grad():
        out, h = port(torch.from_numpy(x), seq_lens=LENS,
                      state=torch.from_numpy(h0))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL,
                               rtol=0)


def test_parameter_names_and_layouts_are_torch_nn_gru():
    port = GRU(F, H, num_layers=2, bidirectional=True)
    reference = torch.nn.GRU(F, H, num_layers=2, bidirectional=True)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in reference.state_dict().items()}
    assert isinstance(port, _RNNBase) and isinstance(
        LSTM(F, H), _RNNBase)


def test_agrees_with_torch_nn_gru_without_hidden_bias():
    """With ``bias_hh`` zero the cell is torch's own."""
    torch.manual_seed(0)
    port = GRU(F, H, num_layers=2, bidirectional=True)
    reference = torch.nn.GRU(F, H, num_layers=2, bidirectional=True,
                             batch_first=True)
    reference.load_state_dict(port.state_dict())
    x = torch.from_numpy(_x(3))
    with torch.no_grad():
        out, h = port(x)
        want_out, want_h = reference(x)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(h, want_h, atol=1e-5, rtol=0)


@pytest.mark.parametrize('backend', ['scan', 'pallas'])
def test_gradients_match_jax_gru(backend):
    """d loss / d input and d loss / d every trained parameter of a 2-layer
    bidirectional GRU against ``jax.grad`` of the JAX module, for a loss
    that weighs the output and the final state; 1e-4 of each gradient's
    largest entry."""
    jax_gru, port = _pair(3, backend, 2, True)
    x = _x(3)
    rng = np.random.RandomState(3)
    w_out = rng.randn(B, T, 2 * H).astype('float32')
    w_h = rng.randn(4, B, H).astype('float32')
    params, static = partition(jax_gru)

    def jax_loss(params, x):
        out, h = combine(params, static)(x, seq_lens=jnp.asarray(LENS))
        return jnp.sum(out * w_out) + jnp.sum(h * w_h)

    want_params, want_x = jax.grad(jax_loss, argnums=(0, 1))(
        params, jnp.asarray(x))
    want_params = state_dict(want_params)

    x_t = torch.from_numpy(x).requires_grad_()
    out, h = port(x_t, seq_lens=LENS)
    ((out * torch.from_numpy(w_out)).sum()
     + (h * torch.from_numpy(w_h)).sum()).backward()

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, atol=ATOL * np.abs(want).max(), rtol=0, err_msg=name)

    close(x_t.grad.numpy(), want_x, 'x')
    # the port's gradients in the JAX layout: as weights move, so do they
    grads = GRU(F, H, num_layers=2, bidirectional=True)
    with torch.no_grad():
        for (name, p), g in zip(port.named_parameters(),
                                grads.parameters()):
            if p.requires_grad:
                g.copy_(p.grad)
            else:
                assert p.grad is None and 'bias_hh' in name
                g.zero_()
    got = to_jax_state_dict(grads)
    assert got.keys() == want_params.keys()
    for name in got:
        close(got[name], want_params[name], name)


def test_only_bias_ih_is_trained_and_a_hidden_n_bias_is_refused():
    """The JAX GRU has one fused bias added to ``gx``: ``bias_hh`` stays in
    the module under torch's name, starts at zero and is frozen.  Its r and
    z blocks fold into the fused bias; its n block sits inside ``r * (...)``
    in ``torch.nn.GRU`` and has no JAX counterpart."""
    torch.manual_seed(4)
    port = GRU(F, H, num_layers=1, bidirectional=True)
    frozen = [n for n, p in port.named_parameters() if not p.requires_grad]
    assert frozen == ['bias_hh_l0', 'bias_hh_l0_reverse']
    assert all(float(getattr(port, n).abs().max()) == 0 for n in frozen)
    with torch.no_grad():
        port.bias_hh_l0[:2 * H].add_(0.5)
    np.testing.assert_allclose(
        to_jax_state_dict(port)['b.0'],
        (port.bias_ih_l0 + port.bias_hh_l0).detach().numpy())
    with torch.no_grad():
        port.bias_hh_l0[2 * H:].add_(0.5)
    with pytest.raises(ValueError, match='n block'):
        to_jax_state_dict(port)


def test_dropout_between_layers_takes_the_modules_generator():
    port = GRU(F, H, num_layers=2, bidirectional=True, dropout=0.5).train()
    x = torch.from_numpy(_x(5))
    outs = []
    for _ in range(2):
        port.generator = torch.Generator().manual_seed(7)
        outs.append(port(x)[0])
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(port.eval()(x)[0], port(x)[0])


@pytest.mark.parametrize('cls', [GRU, LSTM])
def test_weight_gradients_in_groups_of_steps(cls, monkeypatch):
    """On the card the weight-gradient products that reduce over all steps
    and rows into a small result run in groups of steps (``time_groups``;
    one group on the CPU).  Forced to 5 groups here: the same outputs, and
    the same gradients up to the order of the sums."""
    from padertorch_tpu_torch.ops.kernels import lstm as lstm_kernels

    def run(groups):
        # the projection's and the recurrence's weight gradients both sum
        # through lstm_kernels.sum_outer
        monkeypatch.setattr(lstm_kernels, 'time_groups',
                            lambda *args: groups)
        torch.manual_seed(0)
        port = cls(F, H, num_layers=2, bidirectional=True)
        x = torch.from_numpy(_x(6)).requires_grad_()
        out, _ = port(x, seq_lens=LENS)
        (out ** 2).sum().backward()
        return out.detach(), [x.grad] + [
            p.grad for p in port.parameters() if p.requires_grad]

    out_1, grads_1 = run(1)
    out_5, grads_5 = run(5)  # T = 15 steps in 5 groups of 3
    torch.testing.assert_close(out_5, out_1, atol=1e-6, rtol=0)
    for g5, g1 in zip(grads_5, grads_1):
        torch.testing.assert_close(g5, g1, atol=1e-5, rtol=1e-5)
    # the kernels' dW_hh product takes the same grouping
    a, b = torch.randn(15, 6, 4), torch.randn(15, 6, 12)
    torch.testing.assert_close(
        lstm_kernels.sum_outer(a, b, 2),
        torch.einsum('tdbm,tdbn->dmn', a.reshape(15, 2, 3, 4),
                     b.reshape(15, 2, 3, 12)), atol=1e-5, rtol=0)


def test_time_groups_is_one_on_the_cpu():
    from padertorch_tpu_torch.ops.kernels.lstm import time_groups
    assert time_groups(100, 128, 384, 2, torch.device('cpu')) == 1
