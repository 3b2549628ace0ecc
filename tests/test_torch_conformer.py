"""The port's conformer modules against the JAX package's, on the CPU.

The same weights (through ``from_jax_state_dict``) and the same ragged
batches, made with numpy, go through ``padertorch_tpu/modules/conformer.py``
and ``padertorch_tpu_torch/modules/conformer.py`` at a cut size (d_model
16 or 32, 1 or 2 layers, 2 heads, kernel 5 or 7):

- ``ConformerConvModule`` with the masked batch norm and with the layer
  norm, causal and not; ``ConformerBlock`` (also with a sliding window)
  and ``ConformerEncoder``: outputs in training and eval mode 1e-4, the
  running statistics after the training-mode call 1e-5, the gradient of
  every parameter 1e-4 of its largest entry (in training mode, through the
  batch statistics);
- padding invariance: the valid frames' outputs do not change when the
  padded frames hold other values or the batch is padded further;
- carried-state streaming: ``stream_step`` on chunks equals the causal
  one-shot forward, 1e-5, for the conv module, a block and the encoder,
  and equals the JAX package's ``stream_step``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.modules import conformer as jax_conformer
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu_torch.migrate import (
    _jax_to_port, from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.modules import conformer

torch.set_num_threads(2)

ATOL = 1e-4
STATS_ATOL = 1e-5
STREAM_ATOL = 1e-5
LENS = np.array([13, 9, 4], 'int32')


def _pair(name, seed, **kwargs):
    ptrandom.seed(seed)
    jax_module = getattr(jax_conformer, name)(**kwargs)
    port = from_jax_state_dict(getattr(conformer, name)(**kwargs),
                               jax_module.state_dict())
    return jax_module, port


def _inputs(seed, channels, t=13, lens=LENS):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lens), t, channels).astype('float32')
    x *= (np.arange(t)[None, :] < lens[:, None])[..., None]
    return x


def _call(module, x, lens, package):
    if package == 'jax':
        return np.asarray(module(jnp.asarray(x), seq_len=jnp.asarray(lens)))
    with torch.no_grad():
        return module(torch.from_numpy(x),
                      seq_len=torch.from_numpy(lens)).numpy()


def _valid(y, lens):
    return y * (np.arange(y.shape[1])[None, :] < lens[:, None])[..., None]


def _check_modes(jax_module, port, x, lens):
    """Training mode first (the statistics move), then eval mode: valid
    frames' outputs, and every array of the state (statistics included)
    after the training-mode call."""
    for mode in ('train', 'eval'):
        getattr(jax_module, mode)()
        getattr(port, mode)()
        want = _call(jax_module, x, lens, 'jax')
        got = _call(port, x, lens, 'port')
        np.testing.assert_allclose(_valid(got, lens), _valid(want, lens),
                                   atol=ATOL, rtol=0, err_msg=mode)
        if mode == 'train':
            stats = to_jax_state_dict(port)
            for name, value in jax_module.state_dict().items():
                np.testing.assert_allclose(stats[name], np.asarray(value),
                                           atol=STATS_ATOL, rtol=0,
                                           err_msg=name)


def _check_gradients(jax_module, port, x, lens, zero=()):
    """Every parameter's gradient 1e-4 of its largest entry; those named
    in ``zero`` (suffixes) are zero in exact arithmetic, and both packages'
    must be rounding noise against the largest gradient."""
    jax_module.train()
    port.train()
    weights = np.random.RandomState(9).randn(
        *_call(port.eval(), x, lens, 'port').shape).astype('float32')
    port.train()
    mask = (np.arange(x.shape[1])[None, :] < lens[:, None])[..., None]
    weights = weights * mask
    params, static = partition(jax_module)

    def jax_loss(params):
        module = combine(params, static)
        y = module(jnp.asarray(x), seq_len=jnp.asarray(lens))
        return jnp.sum(y * weights)

    want = {k: np.asarray(v)
            for k, v in state_dict(jax.grad(jax_loss)(params)).items()}
    y = port(torch.from_numpy(x), seq_len=torch.from_numpy(lens))
    (y * torch.from_numpy(weights)).sum().backward()
    names = {id(p) for p in port.parameters() if p.requires_grad}
    got = {}
    for jax_name, targets in _jax_to_port(port).items():
        param, convert = targets[0][:2]
        if id(param) in names:
            got[jax_name] = convert(param.grad.numpy())
    assert set(want) == set(got)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        if zero and name.endswith(zero):
            for g in (got[name], w):
                assert np.abs(g).max() <= ATOL * largest, name
            continue
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(
            got[name], w, rtol=0, atol=ATOL * float(np.abs(w).max()),
            err_msg=name)


CONV_CASES = [('batch_norm', False), ('batch_norm', True),
              ('layer_norm', False), ('layer_norm', True)]
# the depthwise conv's bias is a per-channel constant before the
# training-mode batch norm: its gradient is zero
BATCH_NORM_ZERO = ('depthwise.bias',)


@pytest.mark.parametrize('norm, causal', CONV_CASES)
def test_conv_module_matches_jax(norm, causal):
    jax_module, port = _pair('ConformerConvModule', 0, d_model=16,
                             kernel_size=5, norm=norm, causal=causal)
    _check_modes(jax_module, port, _inputs(0, 16), LENS)
    if norm == 'batch_norm':
        n = port.norm_conv.num_tracked_values
        assert float(n.min()) == LENS.sum()


@pytest.mark.parametrize('norm, causal', CONV_CASES)
def test_conv_module_gradients_match_jax(norm, causal):
    jax_module, port = _pair('ConformerConvModule', 1, d_model=16,
                             kernel_size=5, norm=norm, causal=causal)
    _check_gradients(jax_module, port, _inputs(1, 16), LENS,
                     BATCH_NORM_ZERO if norm == 'batch_norm' else ())


BLOCK_CASES = {
    'full': {},
    'causal': {'causal': True},
    'window': {'attn_window': (3, 2)},
    'layer-norm causal': {'causal': True, 'conv_norm': 'layer_norm'},
}


@pytest.mark.parametrize('case', list(BLOCK_CASES))
def test_block_matches_jax(case):
    kwargs = dict(d_model=16, num_heads=2, kernel_size=5,
                  **BLOCK_CASES[case])
    jax_module, port = _pair('ConformerBlock', 2, **kwargs)
    assert port.self_attn.rope is not None
    _check_modes(jax_module, port, _inputs(2, 16), LENS)
    jax_module, port = _pair('ConformerBlock', 3, **kwargs)
    _check_gradients(jax_module, port, _inputs(3, 16), LENS,
                     () if kwargs.get('conv_norm') == 'layer_norm'
                     else BATCH_NORM_ZERO)


@pytest.mark.parametrize('causal', [False, True])
def test_encoder_matches_jax(causal):
    kwargs = dict(d_model=32, num_layers=2, num_heads=2, kernel_size=7,
                  input_size=12, causal=causal)
    jax_module, port = _pair('ConformerEncoder', 4, **kwargs)
    x = _inputs(4, 12)
    _check_modes(jax_module, port, x, LENS)
    # the encoder zeroes the padded frames itself
    assert not _call(port, x, LENS, 'port')[2, 4:].any()
    jax_module, port = _pair('ConformerEncoder', 5, **kwargs)
    _check_gradients(jax_module, port, _inputs(5, 12), LENS,
                     BATCH_NORM_ZERO)


@pytest.mark.parametrize('causal', [False, True])
def test_encoder_padding_invariance(causal):
    _, port = _pair('ConformerEncoder', 6, d_model=32, num_layers=2,
                    num_heads=2, kernel_size=7, input_size=12,
                    causal=causal)
    x = _inputs(6, 12)
    for mode in ('train', 'eval'):
        getattr(port, mode)()
        state = {k: v.clone() for k, v in port.state_dict().items()}
        want = _call(port, x, LENS, 'port')
        # other values in the padded frames, and 5 more padded frames
        noisy = x + np.float32(3.0) * (np.arange(13)[None, :, None]
                                       >= LENS[:, None, None])
        longer = np.concatenate([noisy, np.ones((3, 5, 12), 'float32')],
                                axis=1)
        port.load_state_dict(state)
        got = _call(port, longer, LENS, 'port')
        np.testing.assert_allclose(_valid(got[:, :13], LENS), want,
                                   atol=STREAM_ATOL, rtol=0, err_msg=mode)
        port.load_state_dict(state)


def _trained_causal(name, seed, **kwargs):
    """A causal module whose batch norm has moved off its initial
    statistics (one training-mode call), in eval mode."""
    jax_module, port = _pair(name, seed, causal=True, **kwargs)
    channels = kwargs.get('input_size', kwargs['d_model'])
    x = _inputs(seed, channels)
    port.train()
    _call(port, x, LENS, 'port')
    jax_module = jax_module.load_state_dict(to_jax_state_dict(port))
    return jax_module.eval(), port.eval()


@pytest.mark.parametrize('chunk', [1, 3, 4])
def test_conv_module_stream_equals_causal_forward(chunk):
    jax_module, port = _trained_causal('ConformerConvModule', 7,
                                       d_model=16, kernel_size=5)
    x = _inputs(7, 16, lens=np.array([12, 12, 12]))
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
        state = port.init_stream_state(3)
        outs = []
        for start in range(0, 12, chunk):
            y, state = port.stream_step(
                torch.from_numpy(x[:, start:start + chunk]), state)
            outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, 1), want[:, :12],
                               atol=STREAM_ATOL, rtol=0)
    state = jax_module.init_stream_state(3)
    jax_outs = []
    for start in range(0, 12, chunk):
        y, state = jax_module.stream_step(
            jnp.asarray(x[:, start:start + chunk]), state)
        jax_outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs, 1),
                               np.concatenate(jax_outs, 1),
                               atol=STREAM_ATOL, rtol=0)


@pytest.mark.parametrize('name, chunk', [('ConformerBlock', 2),
                                         ('ConformerEncoder', 3),
                                         ('ConformerEncoder', 12)])
def test_stream_step_equals_causal_forward(name, chunk):
    kwargs = dict(d_model=16, num_heads=2, kernel_size=5)
    if name == 'ConformerEncoder':
        kwargs.update(num_layers=2, input_size=12)
    jax_module, port = _trained_causal(name, 8, **kwargs)
    x = _inputs(8, kwargs.get('input_size', 16),
                lens=np.array([12, 12, 12]))[:, :12]
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
        state = port.init_stream_state(3, 12)
        outs = []
        for start in range(0, 12, chunk):
            y, state = port.stream_step(
                torch.from_numpy(x[:, start:start + chunk]), state, start)
            outs.append(y.numpy())
    got = np.concatenate(outs, 1)
    np.testing.assert_allclose(got, want, atol=STREAM_ATOL, rtol=0)
    state = jax_module.init_stream_state(3, 12)
    jax_outs = []
    for start in range(0, 12, chunk):
        y, state = jax_module.stream_step(
            jnp.asarray(x[:, start:start + chunk]), state, start)
        jax_outs.append(np.asarray(y))
    np.testing.assert_allclose(got, np.concatenate(jax_outs, 1),
                               atol=STREAM_ATOL, rtol=0)


def test_streaming_needs_the_causal_variant():
    _, port = _pair('ConformerBlock', 9, d_model=16, num_heads=2,
                    kernel_size=5)
    with pytest.raises(AssertionError):
        port.init_stream_state(1, 8)
    _, port = _pair('ConformerBlock', 9, d_model=16, num_heads=2,
                    kernel_size=5, causal=True, attn_window=(4, 0))
    with pytest.raises(AssertionError):
        port.init_stream_state(1, 8)
