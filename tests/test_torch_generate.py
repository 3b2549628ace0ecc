"""The port's generation loops against the JAX package's, on the CPU
(mirrors the generation cases of
``tests/test_contrib/test_mk_decode_cache.py`` and ``tests/test_quantize.py``).

Decoders, heads and embeddings carry the JAX weights into the port
(``from_jax_state_dict``).  Greedy tokens and lengths are equal to JAX's,
beam search gives the same tokens and lengths with scores within 1e-4,
speculative decoding equals plain greedy in both packages; sampled tokens
follow the softmax (the generators differ, so only in distribution).
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import nn as jax_nn
from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.mk.modules import transformer as jax_tf
from padertorch_tpu_torch.contrib.mk.modules import transformer as tf
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.quantize import quantize_module

torch.set_num_threads(2)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype('float32')


class _Model:
    """A decoder, its head and its embedding table in both packages."""

    def __init__(self, seed, vocab, d=16, **kwargs):
        ptrandom.seed(seed)
        self.jax_dec = jax_tf.TransformerDecoder(d_model=d, **kwargs).eval()
        self.dec = tf.TransformerDecoder(d_model=d, **kwargs).eval()
        from_jax_state_dict(self.dec, self.jax_dec.state_dict())
        ptrandom.seed(seed + 1)
        self.jax_head = jax_nn.Linear(d, vocab)
        self.head = torch.nn.Linear(d, vocab)
        from_jax_state_dict(self.head, self.jax_head.state_dict())
        self.emb = _x((vocab, d), seed + 2)
        self.vocab = vocab

    def jax_kwargs(self):
        emb = jnp.asarray(self.emb)
        return dict(embed=lambda t: emb[t], logits_head=self.jax_head)

    def kwargs(self):
        emb = torch.from_numpy(self.emb)
        return dict(embed=lambda t: emb[t], logits_head=self.head)


@pytest.mark.parametrize('eos_id', [1, None])
def test_greedy_tokens_and_lengths_equal_jax(eos_id):
    m = _Model(5, vocab=11, num_layers=2, num_heads=4, use_rope=True)
    memory, lens = _x((3, 4, 16), 9), [2, 4, 3]
    want_t, want_l = jax_tf.autoregressive_generate(
        m.jax_dec, jnp.asarray(memory), bos_id=0, max_len=7,
        memory_seq_len=lens, eos_id=eos_id, **m.jax_kwargs())
    got_t, got_l = tf.autoregressive_generate(
        m.dec, torch.from_numpy(memory), bos_id=0, max_len=7,
        memory_seq_len=lens, eos_id=eos_id, **m.kwargs())
    assert got_t.dtype == got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    if eos_id is not None:
        for b in range(3):
            eos = np.nonzero(got_t[b].numpy() == eos_id)[0]
            assert got_l[b] == (eos[0] + 1 if eos.size else 7)
            if eos.size:
                assert (got_t[b, eos[0]:] == eos_id).all()


def test_sampling_follows_the_softmax():
    """Draws of a one-layer decoder's first step follow
    ``softmax(logits / temperature)`` restricted to the top k; the
    generator makes them reproducible; top_k=1 is greedy."""
    m = _Model(7, vocab=9, num_layers=1, num_heads=4)
    memory = torch.from_numpy(_x((1, 3, 16), 11)).expand(2000, 3, 16)

    def gen(temperature, top_k, seed, max_len=1, mem=memory):
        return tf.autoregressive_generate(
            m.dec, mem, bos_id=0, max_len=max_len, temperature=temperature,
            top_k=top_k, generator=torch.Generator().manual_seed(seed),
            **m.kwargs())[0]

    with torch.no_grad():
        cache = m.dec.init_cache(memory[:1], 1)
        out, _ = m.dec.decode_step(
            torch.from_numpy(m.emb[[0]])[:, None], cache, 0)
        logits = m.head(out[0, 0]).double()
    for temperature, top_k in ((1.0, None), (0.7, 3)):
        draws = gen(temperature, top_k, seed=0)[:, 0].numpy()
        keep = (logits >= torch.topk(logits, top_k).values[-1]
                if top_k else torch.ones_like(logits, dtype=torch.bool))
        p = torch.softmax(torch.where(keep, logits / temperature,
                                      torch.tensor(-np.inf)), 0).numpy()
        freq = np.bincount(draws, minlength=m.vocab) / len(draws)
        # 2000 draws: within 5 standard deviations of each probability
        assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / len(draws))
                + 1e-9).all(), (freq, p)
    a, b = gen(1.0, None, 3, 5, memory[:4]), gen(1.0, None, 3, 5, memory[:4])
    assert torch.equal(a, b)
    greedy = gen(0.0, None, 0, 6, memory[:4])
    assert torch.equal(gen(1e-6, 1, 4, 6, memory[:4]), greedy)
    with pytest.raises(ValueError, match='Generator'):
        tf.autoregressive_generate(m.dec, memory[:2], bos_id=0, max_len=3,
                                   temperature=0.5, **m.kwargs())


@pytest.mark.parametrize('eos_id,length_penalty', [(1, 0.0), (1, 1.0),
                                                    (None, 0.0)])
def test_beam_search_equals_jax(eos_id, length_penalty):
    m = _Model(60, vocab=5, num_layers=2, num_heads=4, use_rope=True)
    memory, lens = _x((2, 4, 16), 63), [3, 4]
    args = dict(bos_id=0, max_len=6, beam_size=3, eos_id=eos_id,
                memory_seq_len=lens, length_penalty=length_penalty)
    want = jax_tf.beam_search_generate(
        m.jax_dec, jnp.asarray(memory), **args, **m.jax_kwargs())
    got = tf.beam_search_generate(m.dec, torch.from_numpy(memory), **args,
                                  **m.kwargs())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_beam_of_one_equals_greedy_and_ties_go_to_the_lower_index():
    m = _Model(30, vocab=7, num_layers=1, num_heads=4)
    memory = torch.from_numpy(_x((2, 3, 16), 33))
    greedy, _ = tf.autoregressive_generate(
        m.dec, memory, bos_id=0, max_len=5, eos_id=1, **m.kwargs())
    beams, _, _ = tf.beam_search_generate(
        m.dec, memory, bos_id=0, max_len=5, beam_size=1, eos_id=1,
        **m.kwargs())
    assert torch.equal(beams[:, 0], greedy)
    # jax.lax.top_k order: ties to the lower index, best first
    x = torch.tensor([[0.0, 2.0, 2.0, -1.0, 2.0, 0.0]])
    values, indices = tf._top_k(x, 4)
    j_values, j_indices = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert indices.tolist() == np.asarray(j_indices).tolist() == \
        [[1, 2, 4, 0]]


def test_beam_search_is_exact_on_a_tiny_space():
    """A beam that holds every prefix equals exhaustive search."""
    vocab, steps = 3, 3
    m = _Model(40, vocab=vocab, num_layers=1, num_heads=4)
    memory = torch.from_numpy(_x((2, 3, 16), 43))
    beams, scores, _ = tf.beam_search_generate(
        m.dec, memory, bos_id=0, max_len=steps,
        beam_size=vocab ** (steps - 1), **m.kwargs())
    emb = torch.from_numpy(m.emb)
    with torch.no_grad():
        for b in range(2):
            best = max(
                (float(torch.log_softmax(m.head(m.dec(
                    emb[torch.tensor((0,) + seq[:-1])][None],
                    memory[b:b + 1])[0]), -1)[range(steps), seq].sum()), seq)
                for seq in itertools.product(range(vocab), repeat=steps))
            assert tuple(beams[b, 0].tolist()) == best[1]
            assert abs(float(scores[b, 0]) - best[0]) < 1e-4


@pytest.mark.parametrize('draft_is_target', [True, False])
def test_speculative_equals_plain_greedy(draft_is_target):
    target = _Model(60, vocab=13, num_layers=2, num_heads=4, use_rope=True)
    draft = target if draft_is_target else _Model(
        61, vocab=13, num_layers=1, num_heads=2)
    memory, lens = _x((3, 4, 16), 63), [2, 4, 3]
    want, _ = jax_tf.autoregressive_generate(
        target.jax_dec, jnp.asarray(memory), bos_id=0, max_len=9,
        memory_seq_len=lens, **target.jax_kwargs())
    d_kwargs = draft.kwargs()
    got = tf.speculative_generate(
        target.dec, draft.dec, torch.from_numpy(memory), bos_id=0,
        max_len=9, num_draft=3, memory_seq_len=lens,
        draft_embed=d_kwargs['embed'], draft_logits_head=d_kwargs[
            'logits_head'], **target.kwargs())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_generation_runs_both_routes():
    m = _Model(3, vocab=11, d=32, num_layers=2, num_heads=4, use_rope=True)
    memory = torch.from_numpy(_x((2, 5, 32), 5))
    ref, _ = tf.autoregressive_generate(m.dec, memory, bos_id=0, max_len=6,
                                        eos_id=1, **m.kwargs())
    assert quantize_module(m.dec) >= 2 * 4
    results = []
    for use_kernel in (False, True):
        for mod in m.dec.modules():
            if hasattr(mod, 'use_kernel'):
                mod.use_kernel = use_kernel
        toks, lens = tf.autoregressive_generate(
            m.dec, memory, bos_id=0, max_len=6, eos_id=1, **m.kwargs())
        assert toks.shape == ref.shape and (lens <= 6).all()
        results.append(toks)
    # the same int8 weights: the two routes differ by float32 rounding
    assert torch.equal(results[0], results[1])
