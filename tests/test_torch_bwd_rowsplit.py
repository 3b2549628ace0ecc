"""The two backward kernels' arithmetic on the CPU, at the shapes where
their card versions split the work.

(a) The LSTM backward at the row counts whose rows the card kernel splits
    over blocks (260 and 400 rows per direction, as a dual-path RNN's
    chunk batches have them), with the chunk-count mask of a ragged batch:
    the port's plain training forward and plain backward (with the
    ``dW_hh`` product) against ``jax.vjp`` of the JAX package's Pallas
    kernel in interpret mode.  1e-5: the same f32 operations in another
    framework, over a few steps of width 8.

(b) The attention backward's limit.  The card kernels form every product
    of the forward recomputation and of the backward as three TF32
    products ("3xTF32"): an operand x is split into hi, x with its 13 low
    mantissa bits cleared, and lo = x - hi, read as TF32 by its leading
    bits, and a product is lo*hi + hi*lo + hi*hi summed in f32.  Here the
    plain masked-softmax attention runs with every matrix product emulated
    that way (TF32 rounding by masking mantissa bits), and its autograd
    gradients stay within a tenth of the card's gradient limit
    (``chip_smoke.py``'s ``ATTENTION_GRAD_RTOL``, 5e-5 of each gradient's
    largest entry) of the float32 gradients at the SepFormer's head size;
    with one TF32 product (hi*hi alone) they fail that limit.  So the
    limit tells the kernels' arithmetic from plain TF32.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.ops.pallas import lstm as jax_lstm
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention_plain, tf32_round, visible_mask, _lens_tensor)
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan_bwd_plain, lstm_cell_scan_train_plain,
    recurrent_weight_grad)

torch.set_num_threads(2)

ATOL = 1e-5
# chip_smoke.py's limit on the attention kernels' gradients
ATTENTION_GRAD_RTOL = 5e-5


@pytest.fixture(autouse=True)
def _pinned_cpu_arithmetic():
    """Two intra-op threads, float32 matmuls at full precision, and torch's
    float32 ``exp`` and ``log`` already called once: the first ``exp`` of a
    process can come back off by several times the limits here (as
    ``test_torch_attention_kernel.py`` found)."""
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision('highest')
    torch.log(torch.exp(torch.linspace(-30.0, 0.0, 1 << 16)))
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _chunk_mask(t_len, batch):
    """The inter-chunk RNN's mask: four examples' chunk counts, each
    repeated over the rows of its example; the backward direction
    reversed in time."""
    lens = np.repeat([t_len, t_len - 1, t_len - 2, t_len - 4], batch // 4)
    fwd = np.arange(t_len)[:, None] < lens[None, :]
    return np.concatenate([fwd, fwd[::-1]], axis=1).astype('float32')


@pytest.mark.parametrize('batch,masked', [(260, False), (260, True),
                                          (400, True)])
def test_plain_backward_matches_pallas_at_split_row_counts(batch, masked):
    t_len, hdim = 5, 8
    rng = np.random.RandomState(batch + masked)
    rows = 2 * batch
    arrays = [(rng.randn(t_len, rows, 4 * hdim) * 0.5).astype('float32'),
              (rng.randn(2, hdim, 4 * hdim) * 0.3).astype('float32'),
              _chunk_mask(t_len, batch) if masked else None,
              (rng.randn(rows, hdim) * 0.3).astype('float32'),
              (rng.randn(rows, hdim) * 0.3).astype('float32')]
    cotangents = [rng.randn(t_len, rows, hdim).astype('float32'),
                  rng.randn(rows, hdim).astype('float32'),
                  rng.randn(rows, hdim).astype('float32')]
    gx, w, mask, h0, c0 = [None if a is None else jnp.asarray(a)
                           for a in arrays]
    _, vjp = jax.vjp(
        lambda gx, w, h0, c0: jax_lstm.lstm_cell_scan(
            gx, w, mask, h0, c0, True), gx, w, h0, c0)
    want = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cotangents)))]

    gx, w, mask, h0, c0 = [None if a is None else torch.from_numpy(a)
                           for a in arrays]
    out, c_seq, gates, _, _ = lstm_cell_scan_train_plain(gx, w, mask, h0, c0)
    dgx, dh0, dc0 = lstm_cell_scan_bwd_plain(
        gates, c_seq, w, mask, *map(torch.from_numpy, cotangents))
    dw = recurrent_weight_grad(dgx, out, h0, mask, 2)
    for name, g, e in zip(('dgates_x', 'dW_hh', 'dh0', 'dc0'),
                          (dgx, dw, dh0, dc0), want):
        np.testing.assert_allclose(g.numpy(), e, atol=ATOL, rtol=0,
                                   err_msg=name)


def _mm(a, b, terms):
    """a @ b from TF32 products: 3 terms lo*hi + hi*lo + hi*hi, or 1."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if terms == 3:
        a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
        out = (a_lo @ b_hi + a_hi @ b_lo) + out
    return out


class _TF32Matmul(torch.autograd.Function):
    """A matrix product whose forward and backward products are TF32
    products (``terms`` of them each)."""

    @staticmethod
    def forward(ctx, a, b, terms):
        ctx.save_for_backward(a, b)
        ctx.terms = terms
        return _mm(a, b, terms)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        return (_mm(grad, b.transpose(-1, -2), ctx.terms),
                _mm(a.transpose(-1, -2), grad, ctx.terms), None)


def _attention(q, k, v, terms, key_padding_lens=None):
    """``flash_attention_plain``'s formula (explicit zeros for masked
    probabilities, -1e30 for masked logits) with TF32 products."""
    lens = _lens_tensor(key_padding_lens, q.shape[0], q.device)
    valid = visible_mask(q.shape[2], k.shape[2], lens, False, None,
                         q.device)
    s = _TF32Matmul.apply(q, k.transpose(-1, -2), terms)
    s = torch.where(valid, s * (1.0 / math.sqrt(q.shape[-1])),
                    s.new_tensor(-1e30))
    m = s.max(dim=-1, keepdim=True).values.detach()
    p = torch.where(valid, torch.exp(s - m), s.new_zeros(()))
    l_safe = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return _TF32Matmul.apply(p, v, terms) / l_safe


def _rel_err(got, want):
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize('name,shape,lens', [
    ('intra', (6, 2, 100, 16), None),
    ('inter ragged', (6, 2, 66, 16), [66, 55, 46, 36, 1, 20]),
])
def test_three_tf32_products_meet_the_attention_gradient_limit(
        name, shape, lens):
    rng = np.random.RandomState(len(name))
    q, k, v, d_o = (torch.from_numpy(rng.randn(*shape).astype('float32'))
                    for _ in range(4))
    kwargs = {} if lens is None else {'key_padding_lens': lens}

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, d_o)

    # the split loses nothing: x = hi + lo exactly
    hi = tf32_round(q)
    assert torch.equal(hi + (q - hi), q)
    want = grads(lambda *x: flash_attention_plain(*x, **kwargs))
    three = _rel_err(grads(lambda *x: _attention(*x, 3, lens)), want)
    one = _rel_err(grads(lambda *x: _attention(*x, 1, lens)), want)
    assert three <= ATTENTION_GRAD_RTOL / 10, three
    assert one > ATTENTION_GRAD_RTOL, one
