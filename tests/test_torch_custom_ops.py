"""The six inference kernels as ``torch.library`` custom operators
(``padertorch_tpu_torch/ops/kernels/_ops.py``), on the CPU.

Each operator passes ``torch.library.opcheck`` (schema, fake tensors,
dynamic shapes), its CPU result is the kernel's plain version bit for bit,
a ``torch.export`` of each wrapper records it, and it has no path that
runs the plain version on a CUDA tensor: the CUDA implementation is the
launch (here, without a card, it reaches the kernel library and no
further).
"""
import numpy as np
import pytest
import torch
from torch.library import opcheck

from padertorch_tpu_torch.ops import STFT
from padertorch_tpu_torch.ops.kernels import _build, _ops
from padertorch_tpu_torch.ops.kernels import attention, gru, int8_matmul
from padertorch_tpu_torch.ops.kernels import logmel, lstm, masked_istft

torch.set_num_threads(2)

OPS = ('lstm_cell_scan', 'gru_cell_scan', 'flash_attention', 'fused_logmel',
       'masked_istft', 'int8_matmul')


def _t(*shape, seed=0, scale=1.0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype('float32')).to(dtype)


def _mask(t_len, rows, seed=0):
    lens = np.random.RandomState(seed).randint(1, t_len + 1, size=rows)
    lens[0] = t_len
    return torch.from_numpy(
        (np.arange(t_len)[:, None] < lens[None, :]).astype('float32'))


def _scan_args(gates, t_len=6, rows=4, hdim=8, bf16=False, masked=True):
    gx = _t(t_len, rows, gates * hdim, seed=1,
            dtype=torch.bfloat16 if bf16 else torch.float32)
    w = _t(2, hdim, gates * hdim, seed=2, scale=0.3)
    h0 = _t(rows, hdim, seed=3, scale=0.1)
    mask = _mask(t_len, rows) if masked else None
    if gates == 4:
        return (gx, w, mask, h0, _t(rows, hdim, seed=4, scale=0.1), bf16)
    return (gx, w, mask, h0, bf16)


def _stft(size=64, shift=16, window_length=None):
    return STFT(size, shift, window_length=window_length,
                complex_representation='stacked')


def _istft_args(size=64, shift=16, window_length=None, with_mask=True):
    stft = _stft(size, shift, window_length)
    spec = stft(_t(2, 200, seed=5))
    mask = torch.rand((3, 2) + spec.shape[1:3],
                      generator=torch.Generator().manual_seed(0))
    re, im, mask, _ = masked_istft._split(spec, mask if with_mask else None,
                                          stft)
    return masked_istft._operands(re, im, mask, stft)


def _logmel_args(size=64, shift=16, window_length=None, fading='full',
                 samples=150):
    frontend = logmel.LogMelFrontend(size=size, shift=shift,
                                     window_length=window_length, n_mels=8,
                                     fading=fading)
    return frontend._operands(_t(3, samples, seed=6))


def _int8_args(rows=5, bf16=False, bias=True, max_rows=-1):
    w_q = torch.from_numpy(np.random.RandomState(7).randint(
        -127, 128, (16, 12)).astype('int8'))
    scale = torch.rand(12, generator=torch.Generator().manual_seed(1)) / 100
    return (_t(rows, 16, seed=8,
               dtype=torch.bfloat16 if bf16 else torch.float32),
            w_q, scale, _t(12, seed=9) if bias else None, max_rows)


def _attention_args(d=16, bf16=False, lens=True, causal=False,
                    window=(-1, -1), heads_kv=2):
    dtype = torch.bfloat16 if bf16 else torch.float32
    q = _t(2, 4, 5, d, seed=10, dtype=dtype)
    k, v = (_t(2, heads_kv, 7, d, seed=s, dtype=dtype) for s in (11, 12))
    key_lens = torch.tensor([7, 3], dtype=torch.int32) if lens else None
    return (q, k, v, key_lens, causal, *window)


CASES = {
    'lstm f32 masked': ('lstm_cell_scan', lambda: _scan_args(4)),
    'lstm bf16': ('lstm_cell_scan',
                  lambda: _scan_args(4, bf16=True, masked=False)),
    'gru f32 masked': ('gru_cell_scan', lambda: _scan_args(3)),
    'gru bf16 masked': ('gru_cell_scan', lambda: _scan_args(3, bf16=True)),
    'attention padded keys': ('flash_attention', _attention_args),
    'attention causal window bf16': (
        'flash_attention',
        lambda: _attention_args(bf16=True, lens=False, causal=True,
                                window=(2, -1))),
    'attention head 24': ('flash_attention',
                          lambda: _attention_args(d=24, heads_kv=4)),
    'logmel full': ('fused_logmel', _logmel_args),
    'logmel half, hop not dividing': (
        'fused_logmel',
        lambda: _logmel_args(shift=20, window_length=50, fading='half')),
    'logmel no fading, short': (
        'fused_logmel', lambda: _logmel_args(fading=None, samples=30)),
    'istft fft route': ('masked_istft', _istft_args),
    'istft dft route, no mask': (
        'masked_istft', lambda: _istft_args(50, 10, with_mask=False)),
    'istft short window': ('masked_istft',
                           lambda: _istft_args(64, 16, window_length=48)),
    'int8 f32': ('int8_matmul', _int8_args),
    'int8 bf16 no bias': ('int8_matmul',
                          lambda: _int8_args(bf16=True, bias=False)),
    'int8 above the kernel rows': ('int8_matmul',
                                   lambda: _int8_args(max_rows=3)),
}


def _plain(name, args):
    """The kernel's plain version on the operator's arguments."""
    if name == 'lstm_cell_scan':
        *rest, bf16 = args
        return lstm.lstm_cell_scan_plain(*rest,
                                         'bfloat16' if bf16 else None)
    if name == 'gru_cell_scan':
        *rest, bf16 = args
        return gru.gru_cell_scan_plain(*rest, 'bfloat16' if bf16 else None)
    if name == 'flash_attention':
        q, k, v, lens, causal, left, right = args
        window = (None if left < 0 and right < 0 else
                  (None if left < 0 else left, None if right < 0 else right))
        return attention.flash_attention_plain(
            q, k, v, causal=causal, key_padding_lens=lens, window=window)
    if name == 'fused_logmel':
        return logmel._op_plain(*args)
    if name == 'masked_istft':
        re, im, mask, k_real, k_imag, _, _, shift, _ = args
        return masked_istft._rows_plain(re, im, mask, k_real, k_imag, shift)
    x2, w_q, scale, bias, max_rows = args
    if 0 <= max_rows < x2.shape[0]:
        return int8_matmul.composed(x2, w_q, scale, bias).to(x2.dtype)
    return int8_matmul.int8_matmul_plain(x2, w_q, scale, bias)


def _outputs(result):
    return result if isinstance(result, (tuple, list)) else (result,)


@pytest.mark.parametrize('case', list(CASES))
def test_opcheck(case):
    name, make = CASES[case]
    opcheck(getattr(torch.ops.ptt, name).default, make())


@pytest.mark.parametrize('case', list(CASES))
def test_cpu_result_is_the_plain_version(case):
    name, make = CASES[case]
    args = make()
    got = _outputs(getattr(torch.ops.ptt, name)(*args))
    want = _outputs(_plain(name, args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


class _Wrapper(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _wrappers():
    """{operator: (a module calling its wrapper, example)}, as the models
    and recipes call them."""
    from padertorch_tpu_torch.contrib.mk.modules.transformer import (
        MultiheadAttention)
    from padertorch_tpu_torch.modules.recurrent import GRU, LSTM
    from padertorch_tpu_torch.quantize import QuantizedLinear
    torch.manual_seed(0)
    mha = MultiheadAttention(32, 4).eval()
    mha.use_flash = True               # as the recipes' --flash forces it
    q_lin = QuantizedLinear.from_linear(torch.nn.Linear(16, 12))
    q_lin.use_kernel = True
    frontend = logmel.LogMelFrontend(size=64, shift=16, n_mels=8)
    stft = _stft()
    spec = stft(_t(2, 200, seed=5))
    return {
        'lstm_cell_scan': (LSTM(6, 8, bidirectional=True).eval(),
                           _t(3, 7, 6)),
        'gru_cell_scan': (GRU(6, 8).eval(), _t(3, 7, 6)),
        'flash_attention': (mha, _t(3, 7, 32)),
        'fused_logmel': (_Wrapper(frontend), _t(3, 150)),
        'masked_istft': (_Wrapper(lambda m: masked_istft.masked_istft(
            spec, m, stft=stft)), torch.rand((2,) + spec.shape[:3])),
        'int8_matmul': (q_lin, _t(3, 5, 16)),
    }


@pytest.mark.parametrize('name', OPS)
def test_export_records_the_operator(name):
    module, example = _wrappers()[name]
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    targets = {str(node.target) for node in program.graph.nodes}
    assert f'ptt.{name}.default' in targets
    with torch.no_grad():
        want = module(example)
    got = program.module()(example)
    leaves = torch.utils._pytree.tree_leaves
    for g, w in zip(leaves(got), leaves(want), strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize('name', OPS)
def test_no_cuda_path_runs_the_plain_version(name, monkeypatch):
    """The operator has a CPU and a CUDA kernel and no default one; its
    CUDA implementation goes to the launch (the kernel library), which
    raises here, where no card and no nvcc are."""
    qualname = f'{_ops.NAMESPACE}::{name}'
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualname, 'CPU') and has(qualname, 'CUDA')
    for key in ('CompositeExplicitAutograd', 'CompositeImplicitAutograd'):
        assert not has(qualname, key)

    class Launched(Exception):
        pass

    def launch():
        raise Launched

    monkeypatch.setattr(_build, 'load_library', launch)
    monkeypatch.setattr(_build, 'stream_and_device',
                        lambda tensor: (0, 0))
    monkeypatch.setattr(logmel, 'device_limits',
                        lambda device: (132, 232448))
    case = next(make for op_name, make in CASES.values() if op_name == name)
    args = [x.to('meta') if isinstance(x, torch.Tensor) else
            [t.to('meta') for t in x] if isinstance(x, list) else x
            for x in case()]
    with pytest.raises(Launched):
        OPERATORS[name].cuda_impl(*args)


@pytest.mark.parametrize('name', OPS)
def test_cuda_implementation_takes_any_strides(name, monkeypatch):
    """An exported graph drops a ``.contiguous()`` that was a no-op at the
    traced shapes (a B=1 request then hands the LSTM a strided
    ``gates_x``): the CUDA implementation makes its inputs contiguous and
    reaches the launch, where it used to raise."""

    class Launched(Exception):
        pass

    def launch():
        raise Launched

    monkeypatch.setattr(_build, 'load_library', launch)
    monkeypatch.setattr(_build, 'stream_and_device', lambda tensor: (0, 0))
    monkeypatch.setattr(logmel, 'device_limits',
                        lambda device: (132, 232448))

    def strided(x):
        if not isinstance(x, torch.Tensor) or x.dim() < 2:
            return x
        x = x.to('meta')
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)

    case = next(make for op_name, make in CASES.values() if op_name == name)
    args = [strided(x) for x in case()]
    assert any(isinstance(x, torch.Tensor) and not x.is_contiguous()
               for x in args)
    args = [x.to('meta') if isinstance(x, torch.Tensor) else
            [t.to('meta') for t in x] if isinstance(x, list) else x
            for x in args]
    with pytest.raises(Launched):
        OPERATORS[name].cuda_impl(*args)


OPERATORS = {'lstm_cell_scan': lstm.lstm_cell_scan_op,
             'gru_cell_scan': gru.gru_cell_scan_op,
             'flash_attention': attention.flash_attention_op,
             'fused_logmel': logmel.fused_logmel_op,
             'masked_istft': masked_istft.masked_istft_op,
             'int8_matmul': int8_matmul.int8_matmul_op}


def test_wrappers_take_the_operator_without_a_gradient(monkeypatch):
    """In eval under no_grad every wrapper calls its operator; with a
    gradient the LSTM stays on autograd through the plain version."""
    calls = []
    real = _ops.call

    def spy(op, *args):
        calls.append(op)
        return real(op, *args)

    monkeypatch.setattr(_ops, 'call', spy)
    gx, w, mask, h0, c0, _ = _scan_args(4)
    with torch.no_grad():
        lstm.lstm_cell_scan(gx, w, mask, h0, c0)
    assert calls == [lstm.lstm_cell_scan_op]
    w.requires_grad_(True)
    out, _, _ = lstm.lstm_cell_scan(gx, w, mask, h0, c0)
    out.sum().backward()
    assert calls == [lstm.lstm_cell_scan_op] and w.grad is not None
