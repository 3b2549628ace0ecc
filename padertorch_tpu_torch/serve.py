"""Serving: exported artifacts and continuous batching.

Counterpart of ``padertorch_tpu/serve.py``.  A model's forward pass (or any
callable, or a whole greedy generation loop) is exported with
``torch.export`` into a self-contained artifact that loads in any process
without the Python model code, with symbolic batch (and, on request, other)
axes.  The hand-written kernels are the custom operators
``torch.ops.ptt.*`` (``ops/kernels/_ops.py``): the artifact records them as
single nodes, and a loaded artifact launches the same kernels as the eager
model, counted by the same counters.  Like the JAX package's lowering, an
artifact takes the routes of the device it was traced on (a model traced
on the card keeps ``QuantizedLinear``'s dispatch by rows inside the int8
operator; one traced on the CPU keeps the composed route).

>>> class M(torch.nn.Module):
...     def __init__(self):
...         super().__init__()
...         self.lin = torch.nn.Linear(4, 2)
...     def forward(self, batch):
...         return self.lin(batch['x'])
>>> _ = torch.manual_seed(0)
>>> m = M().eval()
>>> blob = export_model(m, {'x': np.zeros((3, 4), 'float32')})
>>> fn = load_exported(blob, device='cpu')
>>> tuple(fn({'x': np.ones((5, 4), 'float32')}).shape)  # batch-polymorphic
(5, 2)

A loaded artifact runs on the card unless ``device`` asks for another; on
a machine without one, asking for the card raises.  Serving a batch of 1
from an artifact exported from a batch of 2 or more works (an example of
size 1 would fix the axis: ``torch.export`` specializes sizes 0 and 1).
"""
import collections
import io
import json
from pathlib import Path

import numpy as np
import torch

__all__ = ['export_model', 'export_fn', 'export_generate', 'dump_exported',
           'load_exported', 'ContinuousBatcher', 'PLATFORMS']

# the device types an artifact may name in ``platforms``
PLATFORMS = ('cuda', 'cpu')
_FORMAT = 'padertorch_tpu_torch.serve.v1'
_META = 'ptt_meta.json'


def _tree_map(fn, tree):
    return torch.utils._pytree.tree_map(fn, tree)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _as_tensors(example, device):
    """The example's arrays as tensors on ``device`` (None: where they
    are; numpy arrays on the CPU)."""
    def convert(x):
        if isinstance(x, (np.ndarray, np.generic, int, float)):
            x = torch.as_tensor(np.asarray(x))
        if isinstance(x, torch.Tensor) and device is not None:
            x = x.to(device)
        return x
    return _tree_map(convert, example)


def _dynamic_shapes(example, polymorphic_batch, dynamic_axes):
    """``torch.export``'s ``dynamic_shapes`` for the one argument
    ``example``: with ``dynamic_axes`` ``{key: {axis: name}}`` a
    ``torch.export.Dim`` per name, shared by equal names across inputs
    (key None: a single-array example); else, with ``polymorphic_batch``,
    one ``Dim('b')`` on axis 0 of every array; else None (static)."""
    if dynamic_axes is not None:
        dims = {name: torch.export.Dim(name)
                for axes in dynamic_axes.values() for name in axes.values()}

        def spec(axes):
            def leaf(x):
                if not isinstance(x, torch.Tensor):
                    return None
                return {axis % x.dim(): dims[name]
                        for axis, name in axes.items()} or None
            return leaf

        if isinstance(example, dict):
            return ({key: _tree_map(spec(dynamic_axes.get(key, {})), value)
                     for key, value in example.items()},)
        return (_tree_map(spec(dynamic_axes.get(None, {})), example),)
    if polymorphic_batch:
        batch = torch.export.Dim('b')
        return (_tree_map(
            lambda x: ({0: batch} if isinstance(x, torch.Tensor)
                       and x.dim() else None), example),)
    return None


def _check_platforms(platforms):
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(
            f'platforms={platforms!r}: the port exports for '
            f'{PLATFORMS} (the JAX package\'s lowering platforms such as '
            "'tpu' are not the port's)")
    return platforms


class _Call(torch.nn.Module):
    """``fn(batch)`` as a module; tensors ``fn`` reaches through a closure
    become the exported program's constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, batch):
        return self.fn(batch)


def _example_device(module, example):
    for x in _leaves(example):
        if isinstance(x, torch.Tensor):
            return x.device
    for x in [*module.parameters(), *module.buffers()]:
        return x.device
    return torch.device('cpu')


def _trace(module, example, dynamic_shapes):
    """``torch.export.export`` under no_grad.  Where the program holds only
    for part of a symbolic axis's range (a fading crop needs a few frames,
    say), the range is narrowed as ``torch.export`` suggests and the trace
    repeated; an axis the program would fix to one size raises."""
    from torch._dynamo.exc import UserError
    from torch.export.dynamic_shapes import (
        refine_dynamic_shapes_from_suggested_fixes)
    for _ in range(3):
        try:
            with torch.no_grad():
                return torch.export.export(
                    module, (example,), dynamic_shapes=dynamic_shapes,
                    prefer_deferred_runtime_asserts_over_guards=True)
        except UserError as error:
            if dynamic_shapes is None:
                raise
            message, _, tail = str(error).partition('Suggested fixes:')
            fixes = [line for line in tail.splitlines() if ' = ' in line]
            if not fixes:
                raise
            refined = refine_dynamic_shapes_from_suggested_fixes(
                '\n'.join([message + 'Suggested fixes:', *fixes]),
                dynamic_shapes)
            static = [d for d in _leaves(refined)
                      if not isinstance(d, torch.export.Dim)]
            if static or refined == dynamic_shapes:
                raise
            dynamic_shapes = refined
    raise RuntimeError('torch.export kept narrowing the symbolic axes')


def _export(module, example, polymorphic_batch, dynamic_axes, platforms,
            device):
    example = _as_tensors(example, device)
    device = _example_device(module, example)
    if platforms is None:
        platforms = (device.type,)
    platforms = _check_platforms(platforms)
    program = _trace(module, example, _dynamic_shapes(
        example, polymorphic_batch, dynamic_axes))
    meta = {'format': _FORMAT, 'traced_on': device.type,
            'platforms': list(platforms)}
    buffer = io.BytesIO()
    torch.export.save(program, buffer,
                      extra_files={_META: json.dumps(meta)})
    return buffer.getvalue()


def export_model(model, example, polymorphic_batch=True, *,
                 dynamic_axes=None, platforms=None, device=None):
    """Serialize ``model``'s forward to a ``torch.export`` artifact (bytes).

    Args:
        model: a ``torch.nn.Module`` called as ``model(batch)``; it is
            exported in ``eval()`` mode (restored after) and under
            ``torch.no_grad()``, its parameters and buffers baked in.
        example: example input pytree (numpy arrays or tensors): dtypes
            and the static sizes.  Give a batch of 2 or more where the
            batch axis is symbolic.
        polymorphic_batch: a symbolic leading (batch) axis, one size for
            every input.
        dynamic_axes: finer-grained alternative (overrides
            ``polymorphic_batch``): ``{input_key: {axis: dim_name}}``
            marks any axes symbolic, e.g. ``{'Y_abs': {0: 'b', 1: 't'},
            'num_frames': {0: 'b'}}``; equal names are equal sizes.  Key
            None for a single-array example.
        platforms: device types the artifact may be loaded on, of
            ``('cuda', 'cpu')`` (default: the device it is traced on);
            another name, such as the JAX package's ``'tpu'``, raises.
            The artifact keeps the routes of the device it was traced on.
        device: where numpy examples are put for the trace (default: the
            model's device).

    Returns:
        bytes for :func:`load_exported` (no model code needed to load).
    """
    was_training = model.training
    model.eval()
    try:
        if device is None:
            device = _example_device(model, ())
        return _export(model, example, polymorphic_batch,
                       dynamic_axes, platforms, device)
    finally:
        model.train(was_training)


def export_fn(fn, example, polymorphic_batch=True, *, dynamic_axes=None,
              platforms=None, device=None):
    """Like :func:`export_model` for any callable taking one input pytree
    (a closure over modules, a generation loop); the tensors it reaches
    through the closure are baked in as constants.  ``device``: where
    numpy examples are put (default: where the example's tensors are, or
    the CPU)."""
    return _export(_Call(fn), example, polymorphic_batch, dynamic_axes,
                   platforms, device)


def export_generate(decoder, example_memory, *, embed, logits_head,
                    bos_id, max_len, eos_id=None, memory_seq_len=None,
                    polymorphic_batch=True, dynamic_axes=None,
                    platforms=None, device=None, **generate_kwargs):
    """Export a whole greedy generation loop as one artifact.

    The artifact maps encoder memory to ``(tokens, lengths)``: cache
    set-up, every decode step (``max_len`` of them, unrolled: the loop of
    ``autoregressive_generate`` reads nothing back from the device), the
    head, the pick and the eos bookkeeping, so the serving side needs no
    model code and no host loop per step.  The trace grows with
    ``max_len`` times the decoder's layers (about 200 graph nodes a layer
    a step), and so do the export's and the load's seconds.

    Args:
        decoder, embed, logits_head, bos_id, max_len, eos_id: as in
            ``contrib/mk/modules/transformer.py``
            ``autoregressive_generate`` (``embed`` and ``logits_head`` are
            baked in).
        example_memory: (B, S, d_memory) example encoder output, B >= 2
            for a symbolic batch.
        memory_seq_len: optionally a (B,) example; the artifact then
            takes ``{'memory': ..., 'memory_seq_len': ...}``.

    Returns:
        bytes for :func:`load_exported`.
    """
    from padertorch_tpu_torch.contrib.mk.modules.transformer import (
        autoregressive_generate)
    # the loop without its no_grad decorator: the export runs under
    # no_grad already, and the decorator's grad-mode switches would each be
    # a node of the graph
    generate = autoregressive_generate.__wrapped__

    def run(memory, seq_len=None):
        return generate(
            decoder, memory, embed=embed, logits_head=logits_head,
            bos_id=bos_id, max_len=max_len, eos_id=eos_id,
            memory_seq_len=seq_len, **generate_kwargs)

    if device is None:
        device = _example_device(decoder, ())
    if memory_seq_len is None:
        example = example_memory

        def fn(memory):
            return run(memory)
    else:
        example = {'memory': example_memory,
                   'memory_seq_len': np.asarray(memory_seq_len)
                   if not isinstance(memory_seq_len, torch.Tensor)
                   else memory_seq_len}

        def fn(batch):
            return run(batch['memory'], batch['memory_seq_len'])

    was_training = decoder.training
    decoder.eval()
    try:
        return export_fn(fn, example, polymorphic_batch,
                         dynamic_axes=dynamic_axes, platforms=platforms,
                         device=device)
    finally:
        decoder.train(was_training)


def dump_exported(model, example, path, **kwargs):
    """Write a serving artifact directory: ``forward.pt2`` (the
    :func:`export_model` bytes) and ``meta.json`` (the model class, the
    input shapes and dtypes, and the export options, for the serving
    side's checks).  Load it with ``load_exported(path)``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    blob = export_model(model, example, **kwargs)
    (path / 'forward.pt2').write_bytes(blob)
    leaves = [np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor)
              else np.asarray(x) for x in _leaves(example)]
    meta = {
        'format': _FORMAT,
        'model': type(model).__module__ + '.' + type(model).__name__,
        'input_shapes': [list(x.shape) for x in leaves],
        'input_dtypes': [x.dtype.name for x in leaves],
        'options': {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in kwargs.items()
            if isinstance(v, (str, int, float, bool, tuple, list, dict,
                              type(None)))
        },
    }
    (path / 'meta.json').write_text(json.dumps(meta, indent=2, default=str))
    return path


def load_exported(blob, device='cuda'):
    """Bytes, an artifact file or an artifact directory -> ``fn(batch)``.

    Only the port's operator registrations are imported (no model code).
    The program and its constants are moved to ``device`` (the card by
    default; ``'cuda'`` without a card raises) with
    ``torch.export.passes.move_to_device_pass``, and ``fn`` takes numpy
    arrays or tensors, puts them there and returns tensors there.  A
    device type outside the artifact's ``platforms`` raises.
    """
    # the ptt:: operators must exist before the program is deserialized
    import padertorch_tpu_torch.ops.kernels  # noqa: F401
    from torch.export.passes import move_to_device_pass

    if isinstance(blob, (str, Path)):
        blob = Path(blob)
        if blob.is_dir():
            blob = blob / 'forward.pt2'
        blob = blob.read_bytes()
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'load_exported: the artifact runs on the card by default and '
            "no CUDA device is available; pass device='cpu' to run it on "
            'the CPU')
    extra = {_META: ''}
    program = torch.export.load(io.BytesIO(bytes(blob)), extra_files=extra)
    meta = json.loads(extra[_META]) if extra[_META] else {}
    platforms = meta.get('platforms', list(PLATFORMS))
    if device.type not in platforms:
        raise ValueError(
            f'the artifact was exported for {platforms}, not for '
            f'{device.type}')
    program = move_to_device_pass(program, device)
    module = program.module()

    def fn(batch):
        with torch.no_grad():
            return module(_as_tensors(batch, device))

    fn.program = program
    fn.meta = meta
    return fn


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
