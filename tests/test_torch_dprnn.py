"""The port's dual-path RNN against the JAX package's.

``segment`` and ``overlap_add`` are held exactly (they move values and add
at most ``ceil(K / hop)`` of them per sample; with two addends the sum has
one order), for even, odd and ``'auto'`` sizes, with and without lengths.
``DPRNN`` for every chunk RNN type at 1e-4 (f32, two blocks of two
recurrences each), with weights carried over by ``from_jax_state_dict``;
the JAX side through its ``scan`` backend and, for the recurrent types,
its Pallas backend in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.modules import dual_path_rnn as jax_dprnn
from padertorch_tpu.modules.recurrent import set_rnn_backend
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.modules import dual_path_rnn as dprnn

torch.set_num_threads(2)

ATOL = 1e-4
SIZES = [(50, 10, 20), (53, 5, 10), (47, 3, 7), (30, 4, 9), (64, 8, 16)]


@pytest.mark.parametrize('with_lengths', [False, True])
@pytest.mark.parametrize('length,hop,window', SIZES)
def test_segment_and_overlap_add_match_jax(length, hop, window,
                                           with_lengths):
    rng = np.random.RandomState(length)
    x = rng.randn(2, length, 3).astype('float32')
    lens = np.array([length, length - 11]) if with_lengths else None
    want, want_lens = jax_dprnn.segment(
        jnp.asarray(x), hop, window,
        None if lens is None else jnp.asarray(lens))
    got, got_lens = dprnn.segment(torch.from_numpy(x), hop, window, lens)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if with_lengths:
        assert isinstance(got_lens, np.ndarray)  # host integers
        np.testing.assert_array_equal(got_lens, np.asarray(want_lens))
    else:
        assert got_lens is None and want_lens is None
    for unpad in (True, False):
        want_sum = np.asarray(jax_dprnn.overlap_add(want, hop, unpad=unpad))
        got_sum = dprnn.overlap_add(got, hop, unpad=unpad).numpy()
        assert got_sum.shape == want_sum.shape
        if window <= 2 * hop:
            np.testing.assert_array_equal(got_sum, want_sum)
        else:  # three addends: the order of the sum may differ
            np.testing.assert_allclose(got_sum, want_sum, atol=1e-6, rtol=0)


def test_overlap_add_is_deterministic_and_differentiable():
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, 9, 11).astype('float32')).requires_grad_()
    a = dprnn.overlap_add(x, 4)
    assert torch.equal(a, dprnn.overlap_add(x, 4))
    a.sum().backward()
    assert float(x.grad.min()) >= 0 and float(x.grad.max()) == 1


def test_pack_unpack_and_apply_examplewise_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 2).astype('float32')
    lens = [7, 3, 5]
    packed = dprnn.pack(torch.from_numpy(x), lens)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_dprnn.pack(jnp.asarray(x), lens)))
    np.testing.assert_array_equal(
        dprnn.unpack(packed, lens).numpy(),
        np.asarray(jax_dprnn.unpack(jnp.asarray(packed.numpy()), lens)))
    y = x.transpose(0, 2, 1).copy()  # time last
    want = jax_dprnn.apply_examplewise(
        lambda a: a - a.mean(-1, keepdims=True), jnp.asarray(y), lens,
        time_axis=-1)
    got = dprnn.apply_examplewise(
        lambda a: a - a.mean(-1, keepdim=True), torch.from_numpy(y), lens,
        time_axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _pair(rnn_type, window, hop, backend):
    ptrandom.seed(0)
    kwargs = dict(window_length=window, hop_size=hop, num_blocks=2,
                  inter_chunk_type=rnn_type, intra_chunk_type=rnn_type)
    jax_model = jax_dprnn.DPRNN(16, 8, **kwargs)
    if backend == 'pallas':
        set_rnn_backend(jax_model, 'pallas')
    port = from_jax_state_dict(dprnn.DPRNN(16, 8, **kwargs),
                               jax_model.state_dict())
    return jax_model, port


CASES = [(t, b) for t in ('blstm', 'bgru', 'lstm', 'gru')
         for b in ('scan', 'pallas')] + [('cnn', 'scan')]


@pytest.mark.parametrize('window,hop', [(10, 5), ('auto', 'auto'), (9, 4)])
@pytest.mark.parametrize('rnn_type,backend', CASES)
def test_dprnn_matches_jax(rnn_type, backend, window, hop):
    jax_model, port = _pair(rnn_type, window, hop, backend)
    x = np.random.RandomState(2).randn(2, 37, 16).astype('float32')
    lens = np.array([37, 21])
    for sequence_lengths in (None, lens):
        want = jax_model(
            jnp.asarray(x), None if sequence_lengths is None
            else jnp.asarray(sequence_lengths))
        with torch.no_grad():
            got = port(torch.from_numpy(x), sequence_lengths)
        assert tuple(got.shape) == (2, 37, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize('rnn_type', ['blstm', 'bgru', 'cnn'])
def test_weights_round_trip_exactly(rnn_type):
    jax_model, port = _pair(rnn_type, 10, 5, 'scan')
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_unknown_chunk_rnn_type_raises():
    with pytest.raises(ValueError, match='Unknown rnn_type'):
        dprnn.DPRNN(16, 8, 10, 5, 1, inter_chunk_type='rnn')
