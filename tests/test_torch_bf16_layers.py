"""The port's primitive layers in bf16 against the JAX package's, on the
CPU.

``padertorch_tpu/nn.py`` computes each layer in the input's type one
operation at a time: ``Linear`` and the convolutions round the product,
then add the bias and round again; ``LayerNorm`` rounds its mean, its
variance and each step after them.  torch's fused layers round once, which
moved 28% to 31% of a bf16 projection's outputs by one unit against the
JAX layer.  ``padertorch_tpu_torch/nn.py`` repairs that; this file held
the parent tree's layers (torch's own) and failed there.

Limits: every element within one bf16 unit in the last place of the larger
of the two values (plus ``ATOL``: float32 sums in another order), and at
most ``SHARE`` of the elements other than the JAX layer's; torch's fused
layer must exceed that share wherever the JAX layer rounds more than once.
In float32 each layer is torch's own, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu import nn as jax_nn
from padertorch_tpu import random as ptrandom
from padertorch_tpu.module import combine, partition
from padertorch_tpu.train.precision import Precision as JaxPrecision
from padertorch_tpu_torch import nn
from padertorch_tpu_torch.migrate import from_jax_state_dict

torch.set_num_threads(2)

ATOL = 1e-6
SHARE = 0.05

# name: (JAX layer, port layer, torch's own layer, input shape), each
# layer made by a function of no arguments
CASES = {
    'linear': (lambda: jax_nn.Linear(48, 40),
               lambda: nn.Linear(48, 40),
               lambda: torch.nn.Linear(48, 40), (64, 48)),
    'conv1d': (lambda: jax_nn.Conv1d(8, 16, 5, stride=2, padding=2),
               lambda: nn.Conv1d(8, 16, 5, stride=2, padding=2),
               lambda: torch.nn.Conv1d(8, 16, 5, stride=2, padding=2),
               (3, 8, 60)),
    'conv1d_encoder': (lambda: jax_nn.Conv1d(1, 32, 20, stride=10),
                       lambda: nn.Conv1d(1, 32, 20, stride=10),
                       lambda: torch.nn.Conv1d(1, 32, 20, stride=10),
                       (2, 1, 400)),
    'conv2d': (lambda: jax_nn.Conv2d(4, 8, 3, stride=(2, 1), padding=1),
               lambda: nn.Conv2d(4, 8, 3, stride=(2, 1), padding=1),
               lambda: torch.nn.Conv2d(4, 8, 3, stride=(2, 1), padding=1),
               (2, 4, 16, 20)),
    'conv_transpose1d': (
        lambda: jax_nn.ConvTranspose1d(16, 4, 20, stride=10),
        lambda: nn.ConvTranspose1d(16, 4, 20, stride=10),
        lambda: torch.nn.ConvTranspose1d(16, 4, 20, stride=10),
        (2, 16, 40)),
    'layer_norm': (lambda: jax_nn.LayerNorm(32),
                   lambda: nn.LayerNorm(32),
                   lambda: torch.nn.LayerNorm(32), (4, 25, 32)),
}


def ulp_distance(got, want):
    """(largest difference beyond one bf16 unit in the last place of the
    larger of the two values, share of elements that differ)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(big > 0, big, torch.ones_like(big)))) - 7),
        torch.zeros_like(big))
    return (float((diff - ulp).max().detach()),
            float((diff > 0).float().mean()))


def _layers(name):
    """(the JAX layer, the port's, torch's own), all with the same
    weights: the JAX layer's from seed 0, its LayerNorm scale and shift
    drawn so that they round too."""
    make_jax, make_port, make_torch, _ = CASES[name]
    ptrandom.seed(0)
    jax_layer = make_jax()
    if name == 'layer_norm':
        rng = np.random.RandomState(3)
        jax_layer.weight = jnp.asarray(
            1 + 0.3 * rng.randn(32).astype('float32'))
        jax_layer.bias = jnp.asarray(0.3 * rng.randn(32).astype('float32'))
    port, own = make_port(), make_torch()
    from_jax_state_dict(port, jax_layer.state_dict())
    own.load_state_dict(port.state_dict())
    return jax_layer, port, own


def _input(name):
    shape = CASES[name][3]
    return np.random.RandomState(sum(map(ord, name))).randn(
        *shape).astype('float32')


@pytest.mark.parametrize('name', sorted(CASES))
def test_float32_layers_are_torchs_own(name):
    """A float32 input takes torch's fused call: the same bits."""
    _, port, own = _layers(name)
    x = torch.from_numpy(_input(name))
    assert type(port).__mro__[1] is type(own)
    assert torch.equal(port(x), own(x))


@pytest.mark.parametrize('name', sorted(CASES))
def test_bf16_layers_match_the_jax_layers(name):
    """bf16 weights (the JAX policy's cast, the port's ``.to``) and a bf16
    input: within one unit, at most ``SHARE`` other; torch's fused layer,
    which rounds once, differs in more than ``SHARE`` of the elements."""
    jax_layer, port, own = _layers(name)
    params, static = partition(jax_layer)
    jax_layer = combine(JaxPrecision('bfloat16').cast_floating(params),
                        static)
    x = _input(name)
    want = torch.from_numpy(np.asarray(
        jax_layer(jnp.asarray(x).astype(jnp.bfloat16))).astype('float32'))
    x16 = torch.from_numpy(x).bfloat16()
    got = port.to(torch.bfloat16)(x16)
    assert got.dtype == torch.bfloat16
    excess, share = ulp_distance(got, want)
    assert excess <= ATOL and share <= SHARE, (name, excess, share)
    with torch.no_grad():
        fused = own.to(torch.bfloat16)(x16)
    assert ulp_distance(fused, want)[1] > SHARE, name


def test_the_bias_is_added_after_the_rounded_product():
    """A bf16 ``Linear`` with a bias is the rounded product plus the bias,
    rounded again; without a bias the fused call."""
    torch.manual_seed(0)
    layer = nn.Linear(16, 8).to(torch.bfloat16)
    x = torch.randn(5, 16).bfloat16()
    product = torch.nn.functional.linear(x, layer.weight)
    assert torch.equal(layer(x), product + layer.bias)
    layer.bias = None
    assert torch.equal(layer(x), product)
