"""The port's continuous batcher, on the CPU (mirrors
``tests/test_continuous_batching.py``).

In-flight batched greedy decoding equals decoding each request alone with
``autoregressive_generate``, through staggered arrivals, slot reuse over
stale cache rows, forced prompts and per-slot memory lengths; and the
port's batcher returns the JAX package's tokens for the same weights and
requests.
"""
import numpy as np
import torch

from padertorch_tpu import nn as jax_nn
from padertorch_tpu import random as ptrandom
from padertorch_tpu import serve as jax_serve
from padertorch_tpu.contrib.mk.modules import transformer as jax_tf
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    TransformerDecoder, autoregressive_generate)
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.quantize import quantize_module
from padertorch_tpu_torch.serve import ContinuousBatcher

torch.set_num_threads(2)

D_MODEL, D_MEM, VOCAB = 16, 12, 9
BOS, EOS = 0, 8


def _setup(seed=0):
    """(port decoder, embed, head) and the JAX ones, with equal weights."""
    ptrandom.seed(seed)
    jax_dec = jax_tf.TransformerDecoder(
        D_MODEL, num_layers=2, num_heads=2, d_memory=D_MEM).eval()
    jax_embed = jax_nn.Embedding(VOCAB, D_MODEL)
    jax_head = jax_nn.Linear(D_MODEL, VOCAB)
    decoder = TransformerDecoder(
        D_MODEL, num_layers=2, num_heads=2, d_memory=D_MEM).eval()
    embed = torch.nn.Embedding(VOCAB, D_MODEL)
    head = torch.nn.Linear(D_MODEL, VOCAB)
    for port, jax_module in ((decoder, jax_dec), (embed, jax_embed),
                             (head, jax_head)):
        from_jax_state_dict(port, jax_module.state_dict())
    return (decoder, embed, head), (jax_dec, jax_embed, jax_head)


def _memory(s, seed):
    return np.random.RandomState(seed).randn(s, D_MEM).astype('float32')


def _reference(decoder, embed, head, memory, max_len):
    with torch.no_grad():
        tokens, lengths = autoregressive_generate(
            decoder, torch.from_numpy(memory)[None], embed=embed,
            logits_head=head, bos_id=BOS, max_len=max_len, eos_id=EOS)
    return tokens[0, :int(lengths[0])].tolist()


def _staggered(batcher, requests):
    """2 requests now, 1 after three steps, 2 more one step later."""
    ids = [batcher.submit(requests[0]), batcher.submit(requests[1])]
    batcher.step(), batcher.step(), batcher.step()
    ids.append(batcher.submit(requests[2]))
    batcher.step()
    ids += [batcher.submit(requests[3]), batcher.submit(requests[4])]
    return ids, batcher.run_until_done()


REQUESTS = [_memory(5, 1), _memory(3, 2), _memory(7, 3), _memory(2, 4),
            _memory(6, 5)]


def test_batcher_equals_individual_greedy():
    (decoder, embed, head), _ = _setup()
    max_len = 12
    expected = [_reference(decoder, embed, head, m, max_len)
                for m in REQUESTS]
    batcher = ContinuousBatcher(
        decoder, embed=embed, logits_head=head, num_slots=2,
        max_len=max_len, max_memory_len=8, d_memory=D_MEM,
        bos_id=BOS, eos_id=EOS)
    ids, outputs = _staggered(batcher, REQUESTS)
    assert set(outputs) == set(ids)
    for rid, exp in zip(ids, expected):
        assert outputs[rid] == exp, (rid, outputs[rid], exp)
    assert batcher.num_active == 0


def test_batcher_returns_jax_tokens_on_the_same_weights():
    (decoder, embed, head), (jax_dec, jax_embed, jax_head) = _setup(seed=1)
    args = dict(num_slots=2, max_len=12, max_memory_len=8, d_memory=D_MEM,
                bos_id=BOS, eos_id=EOS)
    _, want = _staggered(jax_serve.ContinuousBatcher(
        jax_dec, embed=jax_embed, logits_head=jax_head, **args), REQUESTS)
    _, got = _staggered(ContinuousBatcher(
        decoder, embed=embed, logits_head=head, **args), REQUESTS)
    assert got == want


def test_batcher_prompt_continuation():
    """A forced prompt conditions the continuation: the batcher's output
    after prompt [a, b] equals hand-stepping the cache through bos, a, b
    and decoding greedily from there."""
    (decoder, embed, head), _ = _setup(seed=3)
    memory = _memory(4, 7)
    prompt = [3, 5]
    batcher = ContinuousBatcher(
        decoder, embed=embed, logits_head=head, num_slots=1,
        max_len=10, max_memory_len=8, d_memory=D_MEM,
        bos_id=BOS, eos_id=EOS, max_new_tokens=4)
    rid = batcher.submit(memory, prompt=prompt)
    out = batcher.run_until_done()[rid]
    assert len(out) <= 4
    with torch.no_grad():
        cache = decoder.init_cache(torch.from_numpy(memory)[None], 10)
        toks = [BOS] + prompt
        for t, tok in enumerate(toks):
            h, cache = decoder.decode_step(
                embed(torch.tensor([tok]))[:, None, :], cache, t)
        expected, pos = [], len(toks)
        nxt = int(head(h[:, 0]).argmax(-1)[0])
        for _ in range(4):
            expected.append(nxt)
            if nxt == EOS:
                break
            h, cache = decoder.decode_step(
                embed(torch.tensor([nxt]))[:, None, :], cache, pos)
            pos += 1
            nxt = int(head(h[:, 0]).argmax(-1)[0])
    assert out == expected, (out, expected)


def test_batcher_respects_memory_lengths():
    """Each slot's cross-attention sees its own memory length: a request
    of 3 frames equals its own reference, not the zero-padded 8."""
    (decoder, embed, head), _ = _setup(seed=5)
    mem = _memory(6, 11)
    short = mem[:3]
    batcher = ContinuousBatcher(
        decoder, embed=embed, logits_head=head, num_slots=2,
        max_len=8, max_memory_len=8, d_memory=D_MEM,
        bos_id=BOS, eos_id=EOS, max_new_tokens=6)
    r_full, r_short = batcher.submit(mem), batcher.submit(short)
    outputs = batcher.run_until_done()
    ref_full = _reference(decoder, embed, head, mem, 8)[:6]
    ref_short = _reference(decoder, embed, head, short, 8)[:6]
    assert outputs[r_full] == ref_full[:len(outputs[r_full])]
    assert outputs[r_short] == ref_short[:len(outputs[r_short])]
    assert len(outputs[r_full]) == len(ref_full)


def test_quantized_batcher_equals_individual_greedy():
    """The serving path of the card, on the CPU: int8 weights on the kernel
    route (its plain version here) in the batcher and alone."""
    (decoder, embed, head), _ = _setup(seed=2)
    quantize_module(decoder, min_params=64)
    for mod in decoder.modules():
        if hasattr(mod, 'use_kernel'):
            mod.use_kernel = True
    batcher = ContinuousBatcher(
        decoder, embed=embed, logits_head=head, num_slots=3, max_len=10,
        max_memory_len=8, d_memory=D_MEM, bos_id=BOS, eos_id=EOS)
    ids = [batcher.submit(m) for m in REQUESTS]
    outputs = batcher.run_until_done()
    for rid, m in zip(ids, REQUESTS):
        assert outputs[rid] == _reference(decoder, embed, head, m, 10)


def test_each_request_stops_at_its_own_cap():
    """The port's ``submit(..., max_new_tokens=)``: a request's own output
    cap, the prefix of its uncapped output (eos never emitted here)."""
    (decoder, embed, head), _ = _setup(seed=4)
    batcher = ContinuousBatcher(
        decoder, embed=embed, logits_head=head, num_slots=2, max_len=10,
        max_memory_len=8, d_memory=D_MEM, bos_id=BOS, eos_id=-1)
    caps = [3, 7, 10]
    ids = [batcher.submit(REQUESTS[0], max_new_tokens=cap) for cap in caps]
    outputs = batcher.run_until_done()
    full = outputs[ids[-1]]
    assert [len(outputs[rid]) for rid in ids] == caps
    for rid, cap in zip(ids, caps):
        assert outputs[rid] == full[:cap]
