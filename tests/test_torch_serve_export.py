"""The port's serving artifacts (``padertorch_tpu_torch/serve.py``: export
over ``torch.export``), on the CPU; mirrors ``tests/test_serve.py`` and
the export case of ``tests/test_quantize.py``.

Dynamic batch and time axes, names shared across inputs, the platforms
the port takes, the directory round trip, whole generation loops with and
without memory lengths, a BLSTM whose recurrence is the ``ptt`` kernel
operator under a symbolic batch, and the bf16 policy.  Parity: the same
weights (carried over by ``migrate.py``) exported by the JAX package's
``serve.export_model``/``export_generate`` and by the port give the same
outputs from their loaded artifacts, at 1e-4 for a small BLSTM separator
and token for token for a small quantized decoder.  An artifact loads in
a process that imports only torch and the port's operator registrations.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    TransformerDecoder, autoregressive_generate)
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.modules.recurrent import LSTM
from padertorch_tpu_torch.quantize import quantize_module
from padertorch_tpu_torch.serve import (
    dump_exported, export_fn, export_generate, export_model, load_exported)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


class SeqModel(torch.nn.Module):
    """Length-agnostic model: per-frame linear and masked pooling."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 2)

    def forward(self, batch):
        x = batch['audio']                     # (B, T, 4)
        frames = self.lin(x)                   # (B, T, 2)
        mask = (torch.arange(x.shape[1])[None, :]
                < batch['seq_len'][:, None])
        pooled = (frames * mask[..., None]).sum(1) \
            / torch.clamp(batch['seq_len'], min=1)[:, None]
        return {'frames': frames, 'pooled': pooled}


def _model():
    torch.manual_seed(0)
    return SeqModel().eval()


def _batch(b, t):
    rng = np.random.RandomState(b * 100 + t)
    return {'audio': rng.randn(b, t, 4).astype('float32'),
            'seq_len': np.full((b,), t, 'int64')}


def _eager(model, batch):
    with torch.no_grad():
        return model({k: torch.from_numpy(v) for k, v in batch.items()})


def test_dynamic_axes_batch_and_time():
    m = _model()
    blob = export_model(
        m, _batch(2, 8),
        dynamic_axes={'audio': {0: 'b', 1: 't'}, 'seq_len': {0: 'b'}})
    served = load_exported(blob, device='cpu')
    for b, t in [(2, 8), (3, 17), (1, 40)]:
        batch = _batch(b, t)
        out = served(batch)
        assert tuple(out['frames'].shape) == (b, t, 2)
        np.testing.assert_allclose(out['pooled'].numpy(),
                                   _eager(m, batch)['pooled'].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_dynamic_axes_shared_name_ties_dims():
    served = load_exported(export_model(
        _model(), _batch(2, 8),
        dynamic_axes={'audio': {0: 'b'}, 'seq_len': {0: 'b'}}),
        device='cpu')
    served(_batch(5, 8))
    bad = _batch(5, 8)
    bad['seq_len'] = bad['seq_len'][:3]
    with pytest.raises(Exception):
        served(bad)
    with pytest.raises(Exception):
        served(_batch(5, 9))   # time was not marked dynamic


def test_multi_platform_export_runs_on_cpu():
    blob = export_model(_model(), _batch(2, 8), platforms=('cuda', 'cpu'))
    out = load_exported(blob, device='cpu')(_batch(4, 8))
    assert tuple(out['pooled'].shape) == (4, 2)
    # the JAX package's platform names are not the port's
    with pytest.raises(ValueError):
        export_model(_model(), _batch(2, 8), platforms=('cpu', 'tpu'))
    # an artifact runs only where it was exported for, and on the card by
    # default: here there is none
    cpu_only = export_model(_model(), _batch(2, 8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            load_exported(cpu_only)
    with pytest.raises(ValueError):
        load_exported(cpu_only, device='meta')


def test_dump_exported_directory_round_trip(tmp_path):
    path = dump_exported(
        _model(), _batch(2, 8), tmp_path / 'artifact',
        dynamic_axes={'audio': {0: 'b', 1: 't'}, 'seq_len': {0: 'b'}})
    assert (path / 'forward.pt2').exists()
    meta = json.loads((path / 'meta.json').read_text())
    assert meta['format'] == 'padertorch_tpu_torch.serve.v1'
    assert meta['model'].endswith('SeqModel')
    assert meta['input_shapes'] == [[2, 8, 4], [2]]
    assert meta['input_dtypes'] == ['float32', 'int64']
    out = load_exported(path, device='cpu')(_batch(3, 12))
    assert tuple(out['frames'].shape) == (3, 12, 2)
    out = load_exported(path / 'forward.pt2', device='cpu')(_batch(2, 5))
    assert tuple(out['frames'].shape) == (2, 5, 2)


def _decoder(seed, vocab, num_layers=1, **kwargs):
    torch.manual_seed(seed)
    dec = TransformerDecoder(d_model=16, num_layers=num_layers,
                             num_heads=4, **kwargs).eval()
    emb = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(vocab, 16)).astype('float32'))
    return dec, (lambda t: emb[t]), torch.nn.Linear(16, vocab)


def test_export_generate_round_trip():
    dec, embed, head = _decoder(40, 9, num_kv_heads=2, use_rope=True)
    memory = np.random.default_rng(42).normal(
        size=(2, 5, 16)).astype('float32')
    fn = load_exported(export_generate(
        dec, memory, embed=embed, logits_head=head, bos_id=0, max_len=5,
        eos_id=1), device='cpu')
    # batch-polymorphic: serve other batch sizes, one among them
    for b in (3, 1):
        big = torch.from_numpy(np.random.default_rng(43 + b).normal(
            size=(b, 5, 16)).astype('float32'))
        tokens, lengths = fn(big)
        assert tuple(tokens.shape) == (b, 5) and tuple(lengths.shape) == (b,)
        want_tokens, want_lengths = autoregressive_generate(
            dec, big, embed=embed, logits_head=head, bos_id=0, max_len=5,
            eos_id=1)
        assert torch.equal(tokens, want_tokens)
        assert torch.equal(lengths, want_lengths)


def test_export_generate_with_memory_lens():
    dec, embed, head = _decoder(41, 7)
    memory = np.random.default_rng(45).normal(
        size=(2, 6, 16)).astype('float32')
    fn = load_exported(export_generate(
        dec, memory, embed=embed, logits_head=head, bos_id=0, max_len=4,
        eos_id=1, memory_seq_len=[4, 6]), device='cpu')
    tokens, lengths = fn({'memory': memory,
                          'memory_seq_len': np.asarray([3, 5])})
    assert tuple(tokens.shape) == (2, 4)
    want, _ = autoregressive_generate(
        dec, torch.from_numpy(memory), embed=embed, logits_head=head,
        bos_id=0, max_len=4, eos_id=1, memory_seq_len=[3, 5])
    assert torch.equal(tokens, want)


class _BLSTM(torch.nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        self.rnn = LSTM(8, 16, num_layers=1, bidirectional=True,
                        compute_dtype=compute_dtype)
        self.head = torch.nn.Linear(32, 4)

    def forward(self, inputs):
        out, _ = self.rnn(inputs['x'])
        return self.head(out)


def _x(b, seed):
    return np.random.RandomState(seed).randn(b, 10, 8).astype('float32')


def test_export_polymorphic_batch_through_the_kernel_operator():
    """The recurrence is one ``ptt.lstm_cell_scan`` node per layer, and
    the artifact serves other batch sizes (the JAX package's Pallas RNN
    falls back to its scan here; the port's operator needs no fallback)."""
    torch.manual_seed(0)
    m = _BLSTM().eval()
    fn = load_exported(export_model(m, {'x': _x(2, 0)}), device='cpu')
    nodes = [str(n.target) for n in fn.program.graph.nodes]
    assert nodes.count('ptt.lstm_cell_scan.default') == 1
    assert tuple(fn({'x': _x(2, 0)}).shape) == (2, 10, 4)
    x5 = _x(5, 1)
    want = _eager(m, {'x': x5})
    np.testing.assert_allclose(fn({'x': x5}).numpy(), want.numpy(),
                               atol=1e-5)


def test_export_model_with_bf16_compute_policy():
    torch.manual_seed(0)
    m = _BLSTM(compute_dtype='bfloat16').eval()
    fn = load_exported(export_model(m, {'x': _x(2, 0)}), device='cpu')
    x5 = _x(5, 1)
    np.testing.assert_allclose(fn({'x': x5}).numpy(),
                               _eager(m, {'x': x5}).numpy(), atol=1e-4)


def test_quantized_generation_and_export():
    dec, embed, head = _decoder(3, 11, num_layers=2, use_rope=True)
    memory = np.random.default_rng(5).normal(
        size=(2, 5, 16)).astype('float32')
    kwargs = dict(embed=embed, logits_head=head, bos_id=0, max_len=4,
                  eos_id=1)
    n = quantize_module(dec, min_params=256)
    assert n >= 2 * 4       # at least the attention projections a layer
    q_tokens, _ = autoregressive_generate(dec, torch.from_numpy(memory),
                                          **kwargs)
    fn = load_exported(export_generate(dec, memory, **kwargs),
                       device='cpu')
    assert torch.equal(fn(memory)[0], q_tokens)


def test_closure_constants_move_with_the_program():
    """Tensors a closure reaches become the program's constants, and
    ``load_exported`` moves them with it (to the meta device here)."""
    table = torch.arange(12.0).reshape(3, 4)
    blob = export_fn(lambda x: x @ table, np.ones((2, 3), 'float32'),
                     platforms=('cpu', 'cuda'))
    from torch.export.passes import move_to_device_pass
    fn = load_exported(blob, device='cpu')
    np.testing.assert_array_equal(fn(np.ones((4, 3), 'float32')).numpy(),
                                  np.ones((4, 3)) @ table.numpy())
    moved = move_to_device_pass(fn.program, 'meta')
    constants = [*moved.constants.values(), *moved.state_dict.values()]
    assert constants and all(c.device.type == 'meta' for c in constants)


# -- parity with the JAX package's artifacts --------------------------------

def test_separator_artifact_equals_the_jax_artifact():
    import jax.numpy as jnp
    from padertorch_tpu import random as ptrandom
    from padertorch_tpu.models.bss import (
        PermutationInvariantTrainingModel as JaxPIT)
    from padertorch_tpu.modules.recurrent import set_rnn_backend
    from padertorch_tpu.serve import (
        export_model as jax_export_model, load_exported as jax_load)
    ptrandom.seed(0)
    jax_model = set_rnn_backend(
        JaxPIT(F=9, recurrent_layers=2, units=8, K=2).eval(), 'scan')
    model = PermutationInvariantTrainingModel(
        F=9, recurrent_layers=2, units=8, K=2).eval()
    from_jax_state_dict(model, jax_model.state_dict())

    def batch(b, t, seed):
        rng = np.random.RandomState(seed)
        return {'Y_abs': np.abs(rng.randn(b, t, 9)).astype('float32'),
                'num_frames': np.asarray([t] + [t - 2] * (b - 1), 'int32')}

    axes = {'Y_abs': {0: 'b', 1: 't'}, 'num_frames': {0: 'b'}}
    port = load_exported(export_model(model, batch(2, 6, 0),
                                      dynamic_axes=axes), device='cpu')
    jax_fn = jax_load(jax_export_model(jax_model, batch(2, 6, 0),
                                       dynamic_axes=axes))
    for b, t in ((3, 11), (1, 7)):
        x = batch(b, t, b + t)
        want = np.asarray(jax_fn({k: jnp.asarray(v) for k, v in x.items()}))
        got = port(x).numpy()
        assert got.shape == want.shape == (b, t, 2, 9)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_quantized_decoder_artifact_equals_the_jax_artifact():
    import jax.numpy as jnp
    from padertorch_tpu import nn as jax_nn
    from padertorch_tpu import random as ptrandom
    from padertorch_tpu.contrib.mk.modules import transformer as jax_tf
    from padertorch_tpu.quantize import quantize_module as jax_quantize
    from padertorch_tpu.serve import (
        export_generate as jax_export_generate, load_exported as jax_load)
    ptrandom.seed(7)
    jax_dec = jax_tf.TransformerDecoder(
        d_model=32, num_layers=1, num_heads=4, use_rope=True).eval()
    jax_quantize(jax_dec)
    jax_head = jax_nn.Linear(32, 11)
    dec = TransformerDecoder(d_model=32, num_layers=1, num_heads=4,
                             use_rope=True).eval()
    quantize_module(dec)
    from_jax_state_dict(dec, jax_dec.state_dict())
    head = torch.nn.Linear(32, 11)
    from_jax_state_dict(head, jax_head.state_dict())
    emb = np.random.default_rng(8).normal(size=(11, 32)).astype('float32')
    memory = np.random.default_rng(9).normal(
        size=(2, 5, 32)).astype('float32')
    jax_emb, emb_t = jnp.asarray(emb), torch.from_numpy(emb)
    jax_fn = jax_load(jax_export_generate(
        jax_dec, memory, embed=lambda t: jax_emb[t], logits_head=jax_head,
        bos_id=0, max_len=4, eos_id=1))
    port = load_exported(export_generate(
        dec, memory, embed=lambda t: emb_t[t], logits_head=head, bos_id=0,
        max_len=4, eos_id=1), device='cpu')
    other = np.random.default_rng(10).normal(
        size=(3, 5, 32)).astype('float32')
    for x in (memory, other):
        want_tokens, want_lengths = jax_fn(x)
        tokens, lengths = port(x)
        np.testing.assert_array_equal(tokens.numpy(),
                                      np.asarray(want_tokens))
        np.testing.assert_array_equal(lengths.numpy(),
                                      np.asarray(want_lengths))


def test_artifact_loads_with_only_the_operator_registrations(tmp_path):
    """A fresh process imports torch and the port's operator registrations
    (``padertorch_tpu_torch.ops.kernels``), no model code, and serves the
    artifact of a BLSTM (its ``ptt.lstm_cell_scan`` node) from disk."""
    torch.manual_seed(0)
    m = _BLSTM().eval()
    path = dump_exported(m, {'x': _x(2, 0)}, tmp_path / 'blstm')
    x = _x(3, 4)
    np.save(tmp_path / 'x.npy', x)
    script = (
        'import numpy as np, torch\n'
        'import padertorch_tpu_torch.ops.kernels\n'
        f'program = torch.export.load({str(path / "forward.pt2")!r})\n'
        f'x = torch.from_numpy(np.load({str(tmp_path / "x.npy")!r}))\n'
        'with torch.no_grad():\n'
        '    out = program.module()({"x": x})\n'
        f'np.save({str(tmp_path / "out.npy")!r}, out.numpy())\n')
    proc = subprocess.run([sys.executable, '-c', script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, 'PYTHONPATH': str(REPO)})
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(np.load(tmp_path / 'out.npy'),
                               _eager(m, {'x': x}).numpy(), atol=1e-6)
