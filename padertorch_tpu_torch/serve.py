"""Serving: continuous batching over a KV-cache decoder.

Counterpart of ``padertorch_tpu/serve.py``, its ``ContinuousBatcher``.

Not ported yet (ROADMAP.md): ``export_model``, ``export_fn``,
``export_generate``, ``dump_exported`` and ``load_exported``, which wait for
``torch.export`` and kernels bound as ``torch.library`` custom ops.
"""
import collections

import numpy as np
import torch

__all__ = ['ContinuousBatcher']


class ContinuousBatcher:
    """Continuous (in-flight) batching over a KV-cache decoder.

    A fixed pool of ``num_slots`` cache rows, each slot decoding one request
    at its own position.  Requests are admitted into free slots as they
    arrive and leave the moment they emit EOS.  Every step is one
    ``TransformerDecoder.decode_step`` with per-row positions, and one
    read-back of the greedy tokens.

    Slot reuse needs no zeroing of the cache: a new request restarts at
    position 0 and overwrites the stale K/V rows it reaches; stale entries
    past its position stay hidden by the causal mask.  A slot without a
    request has ``memory_seq_len`` 0, so its cross-attention sees no key
    (the mean of the values, never NaN), and decodes at position 0; its
    output is dropped.

    Batched greedy output equals decoding each request alone with
    ``autoregressive_generate`` (on the card up to near ties of the logits:
    attention sums over caches of another length in another order).

    Args:
        decoder: a :class:`TransformerDecoder` (or the same protocol).
        embed: (B,) int64 ids -> (B, d_model).
        logits_head: (B, d_model) -> (B, vocab).
        num_slots: concurrent requests (the batch of every step).
        max_len: per-request position budget (self-cache length).
        max_memory_len: encoder-memory budget (cross-cache length).
        d_memory: encoder feature size.
        bos_id, eos_id: start / stop token ids.
        max_new_tokens: per-request output cap (default ``max_len``).
        dtype: cache and memory type.
        device: where the caches live (default: the decoder's).
    """

    def __init__(self, decoder, *, embed, logits_head, num_slots,
                 max_len, max_memory_len, d_memory, bos_id, eos_id,
                 max_new_tokens=None, dtype=torch.float32, device=None):
        if device is None:
            device = next(iter([*decoder.parameters(),
                                *decoder.buffers()])).device
        self.decoder = decoder
        self.embed = embed
        self.logits_head = logits_head
        self.device = torch.device(device)
        self.dtype = dtype
        self.num_slots = num_slots
        self.max_len = max_len
        self.max_memory_len = max_memory_len
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.max_new_tokens = max_new_tokens or max_len
        with torch.no_grad():
            zero_mem = torch.zeros((num_slots, max_memory_len, d_memory),
                                   dtype=dtype, device=self.device)
            self.cache = decoder.init_cache(zero_mem, max_len, dtype=dtype)
        self.tokens = np.full((num_slots,), bos_id, 'int64')
        self.positions = np.zeros((num_slots,), 'int64')
        self.mem_lens = np.zeros((num_slots,), 'int64')
        self.active = np.zeros((num_slots,), bool)
        self._prompt = [[] for _ in range(num_slots)]
        self._output = [[] for _ in range(num_slots)]
        self._request = [None] * num_slots
        self._cap = [self.max_new_tokens] * num_slots
        self.pending = collections.deque()
        self.finished = {}
        self._next_id = 0

    def submit(self, memory, memory_len=None, prompt=(),
               max_new_tokens=None):
        """Queue a request.  ``memory``: (S, d_memory) encoder output, an
        array or a tensor (S <= ``max_memory_len``); ``prompt``: token ids
        forced after BOS before free-running generation;
        ``max_new_tokens``: this request's output cap (the port's
        addition; default the batcher's).  Returns a request id."""
        memory = torch.as_tensor(memory)
        assert memory.dim() == 2, memory.shape
        s = memory.shape[0]
        assert s <= self.max_memory_len, (s, self.max_memory_len)
        request_id = self._next_id
        self._next_id += 1
        self.pending.append(
            (request_id, memory, int(memory_len or s), list(prompt),
             max_new_tokens or self.max_new_tokens))
        return request_id

    @property
    def num_active(self):
        return int(self.active.sum())

    def _admit(self, slot, memory):
        """Write the slot's cross K/V (an indexed copy per layer)."""
        padded = torch.zeros((1, self.max_memory_len, memory.shape[-1]),
                             dtype=self.dtype, device=self.device)
        padded[0, :memory.shape[0]] = memory.to(self.device, self.dtype)
        for layer, cross in zip(self.decoder.layers, self.cache['cross']):
            kv = layer.cross_attn.precompute_kv(padded)
            cross['k'][slot] = kv['k'][0]
            cross['v'][slot] = kv['v'][0]

    @torch.no_grad()
    def _try_admit(self):
        while self.pending and not self.active.all():
            slot = int(np.argmin(self.active))  # first free slot
            request_id, memory, mem_len, prompt, cap = \
                self.pending.popleft()
            self._admit(slot, memory)
            self.tokens[slot] = self.bos_id
            self.positions[slot] = 0
            self.mem_lens[slot] = mem_len
            self.active[slot] = True
            self._prompt[slot] = prompt
            self._output[slot] = []
            self._request[slot] = request_id
            self._cap[slot] = cap

    def _finish(self, slot):
        self.finished[self._request[slot]] = list(self._output[slot])
        self.active[slot] = False
        self._request[slot] = None

    @torch.no_grad()
    def step(self):
        """Admit pending requests, then run one decode step for every
        active slot.  Returns the number of active slots stepped."""
        self._try_admit()
        if not self.active.any():
            return 0
        tokens = torch.from_numpy(self.tokens).to(self.device)
        mem_lens = torch.from_numpy(
            np.where(self.active, self.mem_lens, 0)).to(self.device)
        out, self.cache = self.decoder.decode_step(
            self.embed(tokens)[:, None, :], self.cache,
            np.where(self.active, self.positions, 0),
            memory_seq_len=mem_lens)
        greedy = torch.argmax(self.logits_head(out[:, 0]),
                              dim=-1).cpu().numpy()
        stepped = 0
        for slot in range(self.num_slots):
            if not self.active[slot]:
                continue
            stepped += 1
            self.positions[slot] += 1
            if self._prompt[slot]:
                # teacher-forced prompt feed (chunkless prefill)
                self.tokens[slot] = self._prompt[slot].pop(0)
                continue
            token = int(greedy[slot])
            self._output[slot].append(token)
            self.tokens[slot] = token
            if (token == self.eos_id
                    or len(self._output[slot]) >= self._cap[slot]
                    or self.positions[slot] >= self.max_len):
                self._finish(slot)
        return stepped

    def run_until_done(self, max_steps=100000):
        """Drive :meth:`step` until every request finished; returns
        ``{request_id: token list (eos included if emitted)}``."""
        for _ in range(max_steps):
            if not self.pending and not self.active.any():
                break
            self.step()
        else:
            raise RuntimeError('run_until_done: step budget exhausted')
        return dict(self.finished)
