"""The port's CTC and RNN-T losses, their decoders, ``edit_distance`` and
``NGramLM`` against the JAX package's, on the CPU.

- ``ctc_loss``: ragged batches with repeated labels, ``blank != 0`` and an
  infeasible example (the JAX function's optax recursion gives a large
  finite loss there, as the port does); losses 1e-4 relative, gradients
  1e-4 of their largest entry; ``torch.nn.functional.ctc_loss`` as a
  second oracle on the feasible examples;
- ``rnnt_loss``: ragged frames and labels, ``blank != 0``; the same
  limits; the uniform-logits closed form ``(T+U) log V - log C(T-1+U, U)``
  per example;
- the greedy and beam decoders of both (with LM fusion for CTC) and
  ``edit_distance``, exact; ``NGramLM`` scores 1e-6.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.evaluation.ngram_lm import NGramLM as JaxNGramLM
from padertorch_tpu.ops.losses import ctc as jax_ctc
from padertorch_tpu.ops.losses import rnnt as jax_rnnt
from padertorch_tpu_torch.evaluation import NGramLM
from padertorch_tpu_torch.ops.losses import (
    ctc_beam_search_decode, ctc_greedy_decode, ctc_loss, edit_distance,
    rnnt_beam_search, rnnt_greedy_decode, rnnt_loss)

RTOL = 1e-4


def _ctc_case(blank, seed):
    rng = np.random.RandomState(seed)
    v = 6
    logits = (2 * rng.randn(4, 12, v)).astype('float32')
    logit_lengths = np.array([12, 9, 7, 3], 'int32')
    # repeats (2, 2 needs a blank between), a short one, and an
    # infeasible one: 3 labels with a repeat need 4 frames, it has 3
    labels = np.array([[1, 2, 2, 3, 4], [5, 5, 5, 1, 0],
                       [3, 1, 0, 0, 0], [4, 4, 2, 0, 0]], 'int32')
    label_lengths = np.array([5, 4, 2, 3], 'int32')
    if blank != 0:
        # the label ids avoid ``blank``; 0 becomes an ordinary token
        labels = np.where(labels == blank, 0, labels)
        labels = np.where(np.arange(5)[None] < label_lengths[:, None],
                          labels, 0)
    return logits, logit_lengths, labels, label_lengths


def _ctc_both(blank, dtype, examples):
    """Both packages' losses of the whole batch and gradients of the sum
    over ``examples``, in ``dtype``."""
    logits, logit_lengths, labels, label_lengths = _ctc_case(blank, blank)
    logits = logits.astype(dtype)

    def jax_total(x):
        return jax_ctc.ctc_loss(x, logit_lengths, labels, label_lengths,
                                blank=blank)[np.array(examples)].sum()

    want = np.asarray(jax_ctc.ctc_loss(
        jnp.asarray(logits), logit_lengths, labels, label_lengths,
        blank=blank))
    want_grad = np.asarray(jax.grad(jax_total)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(x, torch.from_numpy(logit_lengths),
                   torch.from_numpy(labels), torch.from_numpy(label_lengths),
                   blank=blank)
    got[examples].sum().backward()
    assert got.dtype == x.dtype and want.dtype == logits.dtype
    return got.detach().numpy(), want, x.grad.numpy(), want_grad


@pytest.mark.parametrize('blank', [0, 2])
def test_ctc_loss_and_gradients_match_jax(blank):
    # float32: every loss, and the gradient of the feasible examples
    got, want, grad, want_grad = _ctc_both(blank, 'float32', [0, 1, 2])
    assert np.isfinite(got).all()
    assert want[3] > 1e4 and got[3] > 1e4        # infeasible, finite
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(grad, want_grad, rtol=0,
                               atol=RTOL * np.abs(want_grad).max())
    assert not grad[3].any()


@pytest.mark.parametrize('blank', [0, 2])
def test_ctc_infeasible_gradient_matches_jax_in_float64(blank):
    """The infeasible example's loss sits near 1e5, where a float32 unit
    in the last place is 0.0078: its float32 gradient (the softmax of
    such sums) is set by rounding, in either package.  In float64 both
    follow the same recursion to far below the limit."""
    with jax.enable_x64(True):
        got, want, grad, want_grad = _ctc_both(blank, 'float64', [3])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(grad, want_grad, rtol=0,
                               atol=RTOL * np.abs(want_grad).max())
    assert np.abs(want_grad[3]).max() > 0.1


@pytest.mark.parametrize('blank', [0, 2])
def test_ctc_loss_matches_torch_on_feasible_examples(blank):
    logits, logit_lengths, labels, label_lengths = _ctc_case(blank, 7)
    got = ctc_loss(torch.from_numpy(logits), logit_lengths,
                   torch.from_numpy(labels), label_lengths, blank=blank)
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.from_numpy(logit_lengths),
        torch.from_numpy(label_lengths), blank=blank, reduction='none')
    np.testing.assert_allclose(got[:3].numpy(), want[:3].numpy(), rtol=RTOL)
    assert math.isinf(want[3].item()) and math.isfinite(got[3].item())


def _rnnt_case(seed, blank):
    rng = np.random.RandomState(seed)
    b, t, u, v = 3, 7, 4, 5
    logits = (2 * rng.randn(b, t, u + 1, v)).astype('float32')
    logit_lengths = np.array([7, 5, 2], 'int32')
    label_lengths = np.array([4, 2, 3], 'int32')
    choices = [k for k in range(v) if k != blank]
    labels = rng.choice(choices, (b, u)).astype('int32')
    labels *= np.arange(u)[None] < label_lengths[:, None]
    return logits, logit_lengths, labels, label_lengths


@pytest.mark.parametrize('blank', [0, 3])
def test_rnnt_loss_and_gradients_match_jax(blank):
    logits, logit_lengths, labels, label_lengths = _rnnt_case(blank, blank)

    def jax_total(x):
        return jax_rnnt.rnnt_loss(x, logit_lengths, labels, label_lengths,
                                  blank=blank).sum()

    want = np.asarray(jax_rnnt.rnnt_loss(
        jnp.asarray(logits), logit_lengths, labels, label_lengths,
        blank=blank))
    want_grad = np.asarray(jax.grad(jax_total)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = rnnt_loss(x, torch.from_numpy(logit_lengths),
                    torch.from_numpy(labels),
                    torch.from_numpy(label_lengths), blank=blank)
    got.sum().backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0,
                               atol=RTOL * np.abs(want_grad).max())


@pytest.mark.parametrize('dtype, rtol', [(torch.float64, 1e-9),
                                         (torch.float32, RTOL)])
def test_rnnt_uniform_logits_closed_form(dtype, rtol):
    """Uniform logits: every lattice path has T+U emissions of 1/V, and
    there are C(T-1+U, U) paths.  In float32 the label positions past an
    example's length hold -1e4 (``_NEG_INF``), whose sums cost the shorter
    examples a few 1e-5 relative, in both packages alike."""
    _, logit_lengths, labels, label_lengths = _rnnt_case(1, 0)
    v = 5
    got = rnnt_loss(torch.zeros((3, 7, 5, v), dtype=dtype), logit_lengths,
                    torch.from_numpy(labels), label_lengths).numpy()
    for i, (t, u) in enumerate(zip(logit_lengths, label_lengths)):
        t, u = int(t), int(u)
        want = (t + u) * math.log(v) - math.log(math.comb(t - 1 + u, u))
        assert got[i] == pytest.approx(want, rel=rtol)


def _peaked_logits(seed, b=3, t=14, v=6):
    """Random logits with a strong framewise winner, so the decoders have
    real choices to make but no near ties."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, v)
    logits[np.arange(b)[:, None], np.arange(t)[None],
           rng.randint(0, v, (b, t))] += 3.0
    return logits, np.array([t, t - 4, 5])


def test_ctc_decoders_match_jax():
    logits, lengths = _peaked_logits(0)
    assert ctc_greedy_decode(logits, lengths) == \
        jax_ctc.ctc_greedy_decode(logits, lengths)
    assert ctc_greedy_decode(logits, lengths, blank=2) == \
        jax_ctc.ctc_greedy_decode(logits, lengths, blank=2)
    corpus = [[1, 2, 3, 4], [2, 3, 4, 5], [1, 2, 1, 2]]
    lm, jax_lm = (cls(order=2).fit(corpus) for cls in (NGramLM, JaxNGramLM))
    for beam, lm_fn, jax_lm_fn, weight in (
            (4, None, None, 0.0), (1, None, None, 0.0),
            (4, lm, jax_lm, 0.8)):
        got = ctc_beam_search_decode(logits, lengths, beam_width=beam,
                                     lm_fn=lm_fn, lm_weight=weight)
        want = jax_ctc.ctc_beam_search_decode(
            logits, lengths, beam_width=beam, lm_fn=jax_lm_fn,
            lm_weight=weight)
        assert got == want
        assert all(h for h in got)


def test_edit_distance_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        ref = rng.randint(0, 4, rng.randint(0, 8)).tolist()
        hyp = rng.randint(0, 4, rng.randint(0, 8)).tolist()
        assert edit_distance(ref, hyp) == jax_ctc.edit_distance(ref, hyp)
    assert edit_distance([], [1, 2]) == 2


def _joint(rng_seed, v=5, e=4):
    """A numpy joint over (frame, prefix): scores depend on both."""
    w = np.random.RandomState(rng_seed).randn(e + 3, v)

    def joint_fn(frame, prefix):
        last = prefix[-1] if prefix else 0
        feats = np.concatenate([frame, [len(prefix), last, 1.0]])
        return np.tanh(feats) @ w

    def joint_batch_fn(frame, prefixes):
        return np.stack([joint_fn(frame, list(p)) for p in prefixes])

    return joint_fn, joint_batch_fn


def test_rnnt_decoders_match_jax():
    enc = np.random.RandomState(5).randn(2, 6, 4)
    lengths = np.array([6, 4])
    joint_fn, joint_batch_fn = _joint(6)
    got = rnnt_greedy_decode(joint_fn, enc, lengths)
    assert got == jax_rnnt.rnnt_greedy_decode(joint_fn, enc, lengths)
    for beam in (1, 4):
        got_beam = rnnt_beam_search(joint_fn, enc, lengths, beam_width=beam)
        assert got_beam == jax_rnnt.rnnt_beam_search(
            joint_fn, enc, lengths, beam_width=beam)
        assert got_beam == rnnt_beam_search(
            None, enc, lengths, beam_width=beam,
            joint_batch_fn=joint_batch_fn)
    assert any(got)


def test_ngram_lm_matches_jax():
    corpus = [[1, 2, 3], [1, 2, 1, 2], [3, 3, 1]]
    for order in (1, 2, 3):
        lm = NGramLM(order=order, add_k=0.3).fit(corpus)
        jax_lm = JaxNGramLM(order=order, add_k=0.3).fit(corpus)
        assert lm.vocab == jax_lm.vocab
        for prefix in ((), (1,), (2, 1), (3, 3, 3)):
            for token in (1, 2, 3, 7):
                assert lm(prefix, token) == pytest.approx(
                    jax_lm(prefix, token), abs=1e-6)
        assert lm.perplexity(corpus) == pytest.approx(
            jax_lm.perplexity(corpus), abs=1e-6)
