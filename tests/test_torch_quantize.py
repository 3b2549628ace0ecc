"""The port's weight-only int8 quantization against the JAX package's, on
the CPU (mirrors ``tests/test_quantize.py``).

Modules are built in both packages with the same weights
(``from_jax_state_dict``) and quantized in each: ``weight_q`` and
``scale`` agree bit for bit, from float32 and from bf16 layers.  Outputs
of the composed route (``use_kernel=False``) and of the kernel route
(``True``; its plain version on the CPU, the JAX package's interpret mode
on its side) agree within 1e-5 of the largest output in float32.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import padertorch_tpu as pt
from padertorch_tpu import nn as jax_nn
from padertorch_tpu import random as ptrandom
from padertorch_tpu import quantize as jax_quantize
from padertorch_tpu.contrib.mk.modules import transformer as jax_tf
from padertorch_tpu_torch.contrib.mk.modules import transformer as tf
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.ops.kernels.int8_matmul import int8_matmul
from padertorch_tpu_torch.ops.kernels.int8_matmul import (
    INT8_KERNEL_MAX_ROWS)
from padertorch_tpu_torch.quantize import (
    QuantizedLinear, kernel_route, quantization_error, quantize_module)

torch.set_num_threads(2)

RTOL = 1e-5


def _linear_pair(k, n, seed=0):
    ptrandom.seed(seed)
    jax_lin = jax_nn.Linear(k, n).eval()
    port = torch.nn.Linear(k, n).eval()
    from_jax_state_dict(port, jax_lin.state_dict())
    return jax_lin, port


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_weight_q_and_scale_equal_jax_bit_for_bit(dtype):
    jax_lin, port = _linear_pair(128, 64)
    if dtype == 'bfloat16':
        # quantized in the weight's own type: amax and scale in bf16
        jax_lin.weight = jax_lin.weight.astype(jnp.bfloat16)
        jax_lin.bias = jax_lin.bias.astype(jnp.bfloat16)
        port = port.to(torch.bfloat16)
    want = jax_quantize.QuantizedLinear.from_linear(jax_lin)
    got = QuantizedLinear.from_linear(port)
    assert got.weight_q.dtype == torch.int8 and got.scale.dtype == \
        torch.float32
    assert tuple(got.weight_q.shape) == (128, 64)
    np.testing.assert_array_equal(got.weight_q.numpy(),
                                  np.asarray(want.weight_q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.bias.dtype == getattr(torch, dtype)


@pytest.mark.parametrize('use_kernel', [False, True, 'interpret'])
def test_outputs_of_both_routes_match_jax(use_kernel):
    jax_lin, port = _linear_pair(128, 64, seed=2)
    want_q = jax_quantize.QuantizedLinear.from_linear(jax_lin)
    got_q = QuantizedLinear.from_linear(port)
    want_q.use_kernel = 'interpret' if use_kernel else False
    got_q.use_kernel = use_kernel
    x = _x((8, 128))
    want = np.asarray(want_q(jnp.asarray(x)))
    with torch.no_grad():
        got = got_q(torch.from_numpy(x)).numpy()
    _close(got, want)
    # per-channel symmetric int8: about 1% of the output's range
    ref = port(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - ref).max() < 0.02 * np.abs(ref).max()


def test_auto_dispatch_on_the_cpu_takes_the_composed_route():
    _, port = _linear_pair(64, 32, seed=3)
    q = QuantizedLinear.from_linear(port)
    x = torch.from_numpy(_x((4, 64)))
    composed = x @ (q.weight_q.float() * q.scale)
    composed = composed + q.bias
    assert q.use_kernel is None
    with torch.no_grad():
        assert torch.equal(q(x), composed)
    assert int8_matmul.launches == 0


@pytest.mark.parametrize('rows', [1, 8, 16, 17, 64, 128, 129, 256, 1000])
def test_auto_route_is_a_function_of_device_and_rows(rows, monkeypatch):
    """``use_kernel=None`` takes the kernel on a CUDA card for up to
    ``INT8_KERNEL_MAX_ROWS`` rows (phase 20's table) and the composed route
    above it and on the CPU; the module asks ``kernel_route`` with the rows
    of x, whatever its leading axes."""
    assert not kernel_route(torch.device('cpu'), rows)
    assert kernel_route(torch.device('cuda', 0), rows) == (
        rows <= INT8_KERNEL_MAX_ROWS)
    import padertorch_tpu_torch.quantize as quantize
    q = QuantizedLinear.from_linear(_linear_pair(16, 8)[1])
    asked = []
    monkeypatch.setattr(quantize, 'kernel_route',
                        lambda device, n: asked.append((device, n)))
    q._route(torch.zeros((rows, 1, 16)))
    assert asked == [(torch.device('cpu'), rows)]


def test_quantize_module_walks_lists_and_skips_small():
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.big = torch.nn.Linear(64, 64)
            self.small = torch.nn.Linear(4, 4)       # below min_params
            self.layers = torch.nn.ModuleList(
                [torch.nn.Linear(64, 32), torch.nn.Linear(64, 32)])

    m = M().eval()
    assert quantize_module(m, min_params=256) == 3
    assert isinstance(m.big, QuantizedLinear)
    assert isinstance(m.small, torch.nn.Linear)
    assert all(isinstance(layer, QuantizedLinear) for layer in m.layers)


def _decoder_pair(seed=2, **kwargs):
    ptrandom.seed(seed)
    args = dict(d_model=32, num_layers=2, num_heads=4, **kwargs)
    jax_dec = jax_tf.TransformerDecoder(**args).eval()
    port = tf.TransformerDecoder(**args).eval()
    from_jax_state_dict(port, jax_dec.state_dict())
    return jax_dec, port


def test_a_decoder_quantizes_as_in_jax_and_its_bytes_shrink():
    jax_dec, port = _decoder_pair()
    before = sum(t.numel() * t.element_size()
                 for t in [*port.parameters(), *port.buffers()])
    assert jax_quantize.quantize_module(jax_dec) == \
        quantize_module(port) == 2 * 10
    after = sum(t.numel() * t.element_size()
                for t in [*port.parameters(), *port.buffers()])
    assert after < before * 0.4  # about 4x on the Linear weights
    want, got = jax_dec.state_dict(), to_jax_state_dict(port)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # and the quantized decoder moves back into a fresh quantized port
    fresh = _decoder_pair()[1]
    quantize_module(fresh)
    from_jax_state_dict(fresh, want)
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), port.state_dict().values()))


def test_quantization_error_agrees_with_jax():
    jax_lin, port = _linear_pair(64, 32, seed=4)

    class JaxM(pt.Module):
        def __init__(self, lin):
            self.lin = lin

        def forward(self, x):
            return self.lin(x)

    jax_m = JaxM(jax_lin).eval()
    jax_q = copy.deepcopy(jax_m)
    jax_quantize.quantize_module(jax_q)
    port_m = torch.nn.Sequential(port).eval()
    port_q = copy.deepcopy(port_m)
    quantize_module(port_q)
    x = _x((4, 64), seed=5)
    want = jax_quantize.quantization_error(jax_m, jax_q, jnp.asarray(x))
    got = quantization_error(port_m, port_q, torch.from_numpy(x))
    assert 0 <= got < 0.02
    assert abs(got - want) < 1e-5


def test_a_pre_padded_jax_layer_migrates_and_round_trips():
    """JAX's ``from_linear`` pads a Linear(128, 120) to (128, 128) but keeps
    the bias logical; the port cuts the weight and scale back, computes the
    same outputs, and writes the padded layout again."""
    jax_lin, port = _linear_pair(128, 120, seed=3)
    jax_q = jax_quantize.QuantizedLinear.from_linear(jax_lin)
    assert jax_q.weight_q.shape == (128, 128) and jax_q.bias.shape == (120,)
    model = torch.nn.Sequential(QuantizedLinear.from_linear(port))
    sd = {f'layers.0.{k}': v for k, v in jax_q.state_dict().items()}
    from_jax_state_dict(model, sd)
    q = model[0]
    assert tuple(q.weight_q.shape) == (128, 120)
    np.testing.assert_array_equal(q.weight_q.numpy(),
                                  np.asarray(jax_q.weight_q)[:, :120])
    x = _x((4, 128), seed=1)
    jax_q.use_kernel = 'interpret'
    want = np.asarray(jax_q(jnp.asarray(x)))
    q.use_kernel = True
    with torch.no_grad():
        got = q(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 120)
    _close(got, want)
    back = to_jax_state_dict(model)
    assert set(back) == set(sd)
    for name in sd:
        np.testing.assert_array_equal(back[name], sd[name])


def test_casting_to_bf16_keeps_the_scales_and_rope_in_float32():
    _, port = _decoder_pair(use_rope=True)
    quantize_module(port)
    port = port.to(torch.bfloat16)
    q = port.layers[0].self_attn.q_proj
    assert isinstance(q, QuantizedLinear)
    assert q.scale.dtype == torch.float32 and q.weight_q.dtype == torch.int8
    assert q.bias.dtype == torch.bfloat16
    assert port.layers[0].self_attn.rope.inv_freq.dtype == torch.float32
    assert port.layers[0].norm1.weight.dtype == torch.bfloat16
