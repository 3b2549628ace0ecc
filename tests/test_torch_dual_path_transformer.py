"""The port's dual-path transformer against the JAX package's, on the CPU.

The same weights (through ``from_jax_state_dict``) and the same numpy
inputs go through both packages, with and without lengths, for fixed and
``'auto'`` chunk sizes, on the dense attention backend and on the fused
one (the JAX side runs the Pallas kernel in its interpreter, the port the
kernels' plain version).  Outputs agree to 1e-4 (float32; two to four
transformer layers, a layer norm per stack, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.mk.modules.transformer import (
    set_attention_backend as jax_set_attention_backend)
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu.modules import dual_path_transformer as jax_dpt
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    MultiheadAttention, set_attention_backend)
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.modules import dual_path_transformer as dpt
from padertorch_tpu_torch.ops.kernels import attention

torch.set_num_threads(2)

ATOL = 1e-4


def _pair(use_flash, window=10, hop=5, seed=0, **kwargs):
    ptrandom.seed(seed)
    ctor = dict(input_size=16, window_length=window, hop_size=hop,
                num_blocks=2, num_layers_intra=1, num_layers_inter=1,
                num_heads=2)
    ctor.update(kwargs)
    jax_model = jax_dpt.DualPathTransformer(**ctor).eval()
    port = from_jax_state_dict(dpt.DualPathTransformer(**ctor).eval(),
                               jax_model.state_dict())
    jax_set_attention_backend(jax_model, use_flash)
    set_attention_backend(port, use_flash)
    return jax_model, port


@pytest.mark.parametrize('use_flash', [False, True])
@pytest.mark.parametrize('window,hop', [(10, 5), ('auto', 'auto'), (9, 4)])
def test_dual_path_transformer_matches_jax(window, hop, use_flash):
    jax_model, port = _pair(use_flash, window, hop)
    x = np.random.RandomState(2).randn(2, 37, 16).astype('float32')
    for lens in (None, np.array([37, 21])):
        want = jax_model(jnp.asarray(x),
                         None if lens is None else jnp.asarray(lens))
        with torch.no_grad():
            got = port(torch.from_numpy(x), lens)
        assert tuple(got.shape) == (2, 37, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_lengths_may_be_a_tensor_or_a_host_sequence():
    _, port = _pair(True)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(2, 37, 16).astype('float32'))
    with torch.no_grad():
        want = port(x, np.array([37, 21]))
        assert torch.equal(port(x, [37, 21]), want)
        assert torch.equal(port(x, torch.tensor([37, 21])), want)


@pytest.mark.parametrize('use_flash', [False, True])
def test_parameter_gradients_match_jax(use_flash):
    jax_model, port = _pair(use_flash, num_layers_intra=2, seed=1)
    x = np.random.RandomState(4).randn(2, 33, 16).astype('float32')
    lens = np.array([33, 19])
    cot = np.random.RandomState(5).randn(2, 33, 16).astype('float32')
    params, static = partition(jax_model)

    def loss(params):
        out = combine(params, static)(jnp.asarray(x), jnp.asarray(lens))
        return jnp.sum(out * cot)

    want = {k: np.asarray(v)
            for k, v in state_dict(jax.grad(loss)(params)).items()}
    (port(torch.from_numpy(x), lens) * torch.from_numpy(cot)).sum().backward()
    holder = dpt.DualPathTransformer(
        16, 10, 5, 2, num_layers_intra=2, num_layers_inter=1, num_heads=2)
    with torch.no_grad():
        for (name, p), g in zip(port.named_parameters(),
                                holder.parameters()):
            assert p.grad is not None, name
            g.copy_(p.grad)
    got = to_jax_state_dict(holder)
    assert set(want) <= set(got)
    # a key bias has a zero gradient in exact arithmetic (a softmax does
    # not see a shift of all its logits): the floor follows the others
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name], w, rtol=0,
            atol=ATOL * max(float(np.abs(w).max()), floor), err_msg=name)


def test_both_backends_agree_where_the_sequence_is_valid():
    """Only keys are padded, and padded chunks are masked after each
    stack: the model's outputs agree although the backends differ on fully
    masked rows."""
    _, port = _pair(False)
    x = torch.from_numpy(
        np.random.RandomState(3).randn(2, 50, 16).astype('float32'))
    lens = np.array([50, 35])
    with torch.no_grad():
        dense = port(x, lens)
        fused = set_attention_backend(port, True)(x, lens)
    np.testing.assert_allclose(fused.numpy(), dense.numpy(), atol=3e-5,
                               rtol=0)
    assert float((fused - dense).abs().max()) > 0  # another code path


def test_trailing_padding_chunks_do_not_change_the_valid_prefix():
    _, port = _pair(True)
    x = torch.from_numpy(
        np.random.RandomState(1).randn(1, 60, 16).astype('float32'))
    x_long = torch.nn.functional.pad(x, (0, 0, 0, 40))
    with torch.no_grad():
        out = port(x, [60])
        out_long = port(x_long, [60])
    np.testing.assert_allclose(out_long[:, :60].numpy(), out.numpy(),
                               atol=ATOL, rtol=0)


def test_the_forced_backend_calls_the_fused_attention_once_per_layer(
        monkeypatch):
    """2 blocks x (1 intra + 1 inter) layers: four calls, the inter-chunk
    ones with the chunk counts repeated K times."""
    _, port = _pair(True)
    calls = []
    plain = attention.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((tuple(q.shape), kwargs['key_padding_lens']))
        return plain(q, k, v, **kwargs)

    monkeypatch.setattr(
        'padertorch_tpu_torch.contrib.mk.modules.transformer'
        '.flash_attention', spy)
    x = torch.zeros((2, 37, 16))
    with torch.no_grad():
        port(x, np.array([37, 21]))
    # 37 frames, hop 5, window 10: 9 chunks; 21 frames: 6 chunks
    assert [shape for shape, _ in calls] == [
        (18, 2, 10, 8), (20, 2, 9, 8)] * 2
    assert calls[0][1] is None
    assert calls[1][1].tolist() == [9] * 10 + [6] * 10
    calls.clear()
    with torch.no_grad():
        set_attention_backend(port, False)(x, np.array([37, 21]))
    assert not calls


def test_weights_round_trip_exactly():
    jax_model, port = _pair('auto', num_layers_inter=2, seed=5)
    want = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    got = to_jax_state_dict(port)
    assert got.keys() == want.keys()
    assert 'dpt_blocks.1.inter_chunk.layers.1.self_attn.rope.inv_freq' in got
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert sum(isinstance(m, MultiheadAttention)
               for m in port.modules()) == 6
