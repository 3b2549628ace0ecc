"""The attention forward kernel's arithmetic on the CPU.

The card's forward (``csrc/flash_attention.cu``) forms, per tile of 64 keys,
S = Q K^T and O_tile = P V on the tensor cores as 3xTF32 (an operand x is
split into hi, x with its 13 low mantissa bits cleared, and lo = x - hi,
read as TF32; a product is lo*hi + hi*lo + hi*hi summed in float32), takes
an online softmax over the tiles with exp2 of log2(e)-scaled logits, and
adds each tile's O_tile into the running output in float32 outside the
tensor cores.  ``_forward`` below repeats that arithmetic with the TF32
rounding of ``tf32_round`` (as ``test_torch_bwd_rowsplit.py`` does for the
backward).

Its O and log-sum-exp stay within ``LIMIT`` of a float64 reference and of
the JAX package's Pallas kernel in interpret mode, in every mask mode, at
the SepFormer's head size (16) and at 64, with rows that see no key, and
at the length the card times (T = 2048).  ``LIMIT`` is a quarter of the
card's limit (``chip_smoke.py``'s ``ATTENTION_TOL``, 1e-5): 3xTF32 carries
22 of float32's 24 mantissa bits of each operand, so a row that averages
few values (the first rows of a causal mask) differs from float64 by up to
about 2^-21 of the largest |v| (2.1e-6 here).  With one TF32 product (hi*hi
alone) the output fails the card's limit: the limit tells the kernel's
arithmetic from plain TF32.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.ops.pallas import attention as jax_attention
from padertorch_tpu_torch.ops.kernels.attention import (
    tf32_round, visible_mask, _lens_tensor)

torch.set_num_threads(2)

CARD_LIMIT = 1e-5   # chip_smoke.py ATTENTION_TOL: kernel vs plain, O and lse
LIMIT = CARD_LIMIT / 4
NEG = -1e30
LOG2E = 1.4426950408889634
BS = 64             # keys per tile of the card's forward at D <= 64

# name: (B, H, T, D, kwargs)
CASES = {
    'd16 full': (2, 2, 200, 16, {}),
    'd64 full': (2, 2, 200, 64, {}),
    'd16 causal': (2, 2, 200, 16, {'causal': True}),
    'd64 causal': (2, 2, 300, 64, {'causal': True}),
    'd64 window (256, 256)': (1, 2, 600, 64, {'window': (256, 256)}),
    'd16 ragged, a row with no key': (
        3, 2, 200, 16, {'key_padding_lens': [200, 77, 0]}),
    'd64 causal ragged, rows with one key and none': (
        3, 2, 150, 64, {'causal': True, 'key_padding_lens': [150, 1, 0]}),
    'T=2048 D=64 full': (1, 1, 2048, 64, {}),
}


@pytest.fixture(autouse=True)
def _pinned_cpu_arithmetic():
    """Two intra-op threads, float32 matmuls at full precision, and torch's
    float32 ``exp`` and ``log`` already called once (the first ``exp`` of
    a process can be off, as ``test_torch_attention_kernel.py`` found)."""
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision('highest')
    torch.log(torch.exp(torch.linspace(-30.0, 0.0, 1 << 16)))
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _arrays(name):
    b, h, t, d, kwargs = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return [rng.randn(b, h, t, d).astype('float32') for _ in range(3)], \
        kwargs


def _mm(a, b, terms):
    """a @ b from TF32 products: 3 terms lo*hi + hi*lo + hi*hi, or 1."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if terms == 3:
        a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
        out = (a_lo @ b_hi + a_hi @ b_lo) + out
    return out


def _fma(a, b, c):
    """a * b + c rounded once to float32, as the kernel's fmaf."""
    return (a.double() * b.double() + c.double()).float()


def _forward(q, k, v, terms, causal=False, key_padding_lens=None,
             window=None):
    """The card forward's arithmetic: (O, lse), lse -1e30 where a row
    sees no key."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    valid = visible_mask(tq, tk, _lens_tensor(key_padding_lens, b, q.device),
                         causal, window, q.device).expand(b, h, tq, tk)
    scale2 = torch.tensor(1.0 / math.sqrt(d) * LOG2E, dtype=torch.float32)
    s = _mm(q, k.transpose(-1, -2), terms)
    m = torch.full((b, h, tq), NEG)
    l = torch.zeros((b, h, tq))
    acc = torch.zeros_like(q)
    for j0 in range(0, tk, BS):
        s_t, vis = s[..., j0:j0 + BS], valid[..., j0:j0 + BS]
        x = torch.where(vis, s_t * scale2, torch.tensor(-math.inf))
        mx = torch.maximum(m, x.max(-1).values)
        alpha = torch.exp2(m - mx)
        p = torch.where(vis, torch.exp2(_fma(s_t, scale2, -mx[..., None])),
                        torch.tensor(0.0))
        l = _fma(l, alpha, p.sum(-1))
        acc = _fma(acc, alpha[..., None], _mm(p, v[..., j0:j0 + BS, :],
                                               terms))
        m = mx
    o = acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]
    lse = torch.where(l > 0, _fma(m, torch.tensor(math.log(2.0)),
                                  torch.log(l)), torch.tensor(NEG))
    return o, lse


def _reference(q, k, v, causal=False, key_padding_lens=None, window=None):
    """softmax attention in float64: (O, lse, rows that see a key)."""
    b, h, tq, d = q.shape
    valid = visible_mask(tq, k.shape[2],
                         _lens_tensor(key_padding_lens, b, q.device), causal,
                         window, q.device)
    s = (q.double() @ k.double().transpose(-1, -2)) / math.sqrt(d)
    s = torch.where(valid, s, torch.tensor(-math.inf, dtype=torch.float64))
    seen = valid.any(-1).expand(b, h, tq)
    m = torch.where(seen, s.max(-1).values, torch.zeros(()).double())
    p = torch.exp(s - m[..., None])
    l = torch.where(seen, p.sum(-1), torch.ones(()).double())
    o = torch.where(seen[..., None], (p @ v.double()) / l[..., None],
                    torch.zeros(()).double())
    return o, m + torch.log(l), seen


def _pallas_forward(q, k, v, causal=False, key_padding_lens=None,
                    window=None):
    """(O, lse) of the JAX package's Pallas forward kernel in interpret
    mode, padded and called as its ``flash_attention`` does."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    block = 64 if max(tq, tk) <= 600 else 256
    tq_p, tk_p = -(-tq // block) * block, -(-tk // block) * block

    def prep(x, t_p):
        x = np.pad(x, ((0, 0), (0, 0), (0, t_p - x.shape[2]), (0, 128 - d)))
        return jnp.asarray(x.reshape(-1, t_p, 128))

    lens = np.full(b, tk) if key_padding_lens is None \
        else np.minimum(key_padding_lens, tk)
    lens = jnp.asarray(np.repeat(lens, h).astype('int32'))
    left, right = (None, None) if window is None else window
    config = (bool(causal), (left, right), block, block,
              1.0 / math.sqrt(d), 1, True)
    o, lse = jax_attention._fwd_call(config, lens, prep(q, tq_p),
                                     prep(k, tk_p), prep(v, tk_p))
    o = np.asarray(o).reshape(b, h, tq_p, 128)[:, :, :tq, :d]
    return o, np.asarray(lse).reshape(b, h, tq_p)[:, :, :tq]


@pytest.mark.parametrize('name', sorted(CASES))
def test_three_tf32_products_hold_o_and_lse_to_float64(name):
    arrays, kwargs = _arrays(name)
    q, k, v = map(torch.from_numpy, arrays)
    o, lse = _forward(q, k, v, 3, **kwargs)
    want_o, want_lse, seen = _reference(q, k, v, **kwargs)
    err_o = float((o.double() - want_o).abs().max())
    err_lse = float((lse.double() - want_lse)[seen].abs().max())
    assert err_o <= LIMIT and err_lse <= LIMIT, (err_o, err_lse)
    # a row that sees no key: exactly 0 and -1e30, as the card's
    assert bool((o[~seen] == 0.0).all())
    assert bool((lse[~seen] == NEG).all())


@pytest.mark.parametrize('name', sorted(CASES))
def test_three_tf32_products_match_the_pallas_kernel(name):
    arrays, kwargs = _arrays(name)
    o, lse = _forward(*map(torch.from_numpy, arrays), 3, **kwargs)
    want_o, want_lse = _pallas_forward(*arrays, **kwargs)
    seen = _reference(*map(torch.from_numpy, arrays), **kwargs)[2].numpy()
    np.testing.assert_allclose(o.numpy(), want_o, atol=LIMIT, rtol=0)
    np.testing.assert_allclose(lse.numpy()[seen], want_lse[seen],
                               atol=LIMIT, rtol=0)


@pytest.mark.parametrize('name', sorted(CASES))
def test_one_tf32_product_fails_the_card_limit(name):
    arrays, kwargs = _arrays(name)
    q, k, v = map(torch.from_numpy, arrays)
    o, _ = _forward(q, k, v, 1, **kwargs)
    want_o = _reference(q, k, v, **kwargs)[0]
    assert float((o.double() - want_o).abs().max()) > CARD_LIMIT
