"""The port's ``int8_matmul`` against the JAX package's Pallas kernel, on the
CPU.

The same numpy arrays go through ``padertorch_tpu.ops.pallas.int8_matmul
.int8_matmul(..., interpret=True)`` and through the port's wrapper, which
on a CPU tensor runs ``int8_matmul_plain`` (the CUDA kernel's arithmetic).
Float32 agrees within 1e-5 of the output's largest value (the same sums in
another order); bf16 within one bf16 unit in the last place of each output
(both round a float32 sum once).  The CUDA kernel itself is held against
the plain version on the card (``test_torch_cuda_kernels.py``,
``chip_smoke.py`` phase 20).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops.pallas.int8_matmul import (
    int8_matmul as jax_int8_matmul)
from padertorch_tpu_torch.ops.kernels import int8_matmul as kernels
from padertorch_tpu_torch.ops.kernels.int8_matmul import (
    int8_matmul, int8_matmul_plain, split_rows)

torch.set_num_threads(2)

RTOL = 1e-5


def _arrays(m, k, n, seed=0, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype('float32')
    w_q = rng.randint(-127, 128, size=(k, n)).astype('int8')
    scale = (rng.rand(n).astype('float32') + 0.5) / 127.0
    b = rng.randn(n).astype('float32') if bias else None
    return x, w_q, scale, b


def _bf16_ulp(values):
    """One bf16 unit in the last place at each of ``values``."""
    mag = np.maximum(np.abs(values.astype('float32')), np.float32(1e-30))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('bias', [True, False])
def test_plain_version_matches_the_pallas_kernel(dtype, bias):
    x, w_q, scale, b = _arrays(3, 96, 200, bias=bias)
    j_x = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_int8_matmul(
        j_x, jnp.asarray(w_q), jnp.asarray(scale),
        None if b is None else jnp.asarray(b), interpret=True)
        .astype(jnp.float32))
    t_x = torch.from_numpy(x).to(getattr(torch, dtype))
    got = int8_matmul(t_x, torch.from_numpy(w_q), torch.from_numpy(scale),
                      None if b is None else torch.from_numpy(b))
    assert got.dtype == t_x.dtype and tuple(got.shape) == (3, 200)
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * np.abs(want).max())
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_leading_axes_pre_padded_weight_and_cut_output():
    """The JAX wrapper's contract: leading axes pass through, a weight
    with declared zero-padding rows (``k_logical``) and padded columns
    (``out_features``) gives the logical product, and a bias of the
    logical width is padded."""
    x, w_q, scale, b = _arrays(6, 40, 30, seed=1)
    w_pad = np.zeros((64, 48), 'int8')
    w_pad[:40, :30] = w_q
    s_pad = np.ones(48, 'float32')
    s_pad[:30] = scale
    x3 = x.reshape(2, 3, 40)
    want = np.asarray(jax_int8_matmul(
        jnp.asarray(x3), jnp.asarray(w_pad), jnp.asarray(s_pad),
        jnp.asarray(b), out_features=30, k_logical=40, interpret=True))
    got = int8_matmul(torch.from_numpy(x3), torch.from_numpy(w_pad),
                      torch.from_numpy(s_pad), torch.from_numpy(b),
                      out_features=30, k_logical=40)
    assert tuple(got.shape) == (2, 3, 30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    logical = int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w_q),
                                torch.from_numpy(scale), torch.from_numpy(b))
    np.testing.assert_allclose(got.reshape(6, 30).numpy(), logical.numpy(),
                               rtol=0, atol=RTOL * np.abs(want).max())


def test_the_contract_raises():
    x, w_q, scale, b = (torch.from_numpy(a) for a in _arrays(2, 32, 16))
    with pytest.raises(ValueError, match='int8'):
        int8_matmul(x, w_q.to(torch.int16), scale)
    with pytest.raises(ValueError, match='contraction mismatch'):
        int8_matmul(x[:, :30], w_q, scale)
    with pytest.raises(ValueError, match='contraction mismatch'):
        int8_matmul(x[:, :30], w_q, scale, k_logical=28)
    assert tuple(int8_matmul(x[:, :30], w_q, scale, k_logical=30).shape) \
        == (2, 16)
    with pytest.raises(ValueError, match='bias length'):
        int8_matmul(x, w_q, scale, b[:10])
    assert tuple(int8_matmul(x, w_q, scale, b[:12], out_features=12).shape) \
        == (2, 12)
    for dtype in (torch.float64, torch.float16, torch.int32):
        with pytest.raises(TypeError, match='float32 or bfloat16'):
            int8_matmul(x.to(dtype), w_q, scale)
    with pytest.raises(ValueError, match='is on meta'):
        int8_matmul(x, w_q.to('meta'), scale)
    with pytest.raises(ValueError, match='scale'):
        int8_matmul(x, w_q, scale[:8])


def test_inference_only_a_gradient_raises():
    x, w_q, scale, b = (torch.from_numpy(a) for a in _arrays(2, 32, 16))
    leaf = x.clone().requires_grad_()
    for fn in (int8_matmul, int8_matmul_plain):
        with pytest.raises(ValueError, match='inference only'):
            fn(leaf, w_q, scale, b)
        with torch.no_grad():
            assert fn(leaf, w_q, scale, b).grad_fn is None
        with pytest.raises(ValueError, match='inference only'):
            fn(x, w_q, scale, b.clone().requires_grad_())


def test_a_cpu_tensor_never_counts_a_launch():
    before = int8_matmul.launches
    x, w_q, scale, b = (torch.from_numpy(a) for a in _arrays(4, 64, 40))
    int8_matmul(x, w_q, scale, b)
    int8_matmul(x.to(torch.bfloat16), w_q, scale, b.to(torch.bfloat16))
    assert int8_matmul.launches == before


def test_rows_per_split_depend_on_the_weight_alone():
    """The kernel's order of summation is fixed by (K, N): rows per split
    are a multiple of the 32 threads that share a column, at most 1024
    (its shared memory), and give about two blocks per SM."""
    for k, n in [(1024, 1024), (1024, 4096), (4096, 1024), (1000, 1030),
                 (96, 200), (50000, 64)]:
        rows = split_rows(k, n)
        assert rows % 32 == 0 and 64 <= rows <= 1024
        blocks = -(-n // 128) * -(-k // rows)
        assert blocks >= min(kernels._TARGET_BLOCKS // 2, -(-k // 64)
                             * -(-n // 128)), (k, n, rows, blocks)
    assert 1 <= kernels.INT8_KERNEL_MAX_ROWS <= 128
