"""The port's speech-recognition models against the JAX package's, on the
CPU: ``AcousticEncoder`` and the three heads of the ctc recipe
(``ConformerCTC``, ``TransducerASR``, ``AttentionASR``).

The same weights (through ``from_jax_state_dict``) and the same synthetic
batch, made by the port's data pipeline (checked equal to the JAX one's),
go through both packages at a cut size (d_model 32, one conformer layer,
2 heads, kernel 7, 8 subsampling channels), the models in training mode
with the front end in eval mode (the packages draw SpecAugment's masks
from different generators):

- ``forward`` outputs 1e-4; ``review`` loss 1e-4 relative, its scalars;
  the gradient of every parameter 1e-4 of its largest entry;
- SpecAugment's masks in training mode held to their counts and widths
  (the packages draw them differently);
- greedy transcripts equal to the JAX package's for every head; the
  port's own contracts: decode bookkeeping of every head, greedy and
  beam; the causal variant's exact prefix property; the acoustic encoder
  streamed chunk by chunk equal to its one-shot forward, 1e-5;
  ``stream_decode`` equal to the offline greedy transcript;
  ``serve_decode`` equal to the greedy ``decode``;
- the weights' round trip through both layouts, exact, and the prediction
  network's fused bias (``bias_hh`` zero and frozen).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.contrib.examples.speech_recognition.ctc import (
    data as jax_data, model as jax_model_module)
from padertorch_tpu.module import combine, partition, state_dict
from padertorch_tpu_torch.contrib.examples.speech_recognition.ctc import (
    data, model as port_model_module)
from padertorch_tpu_torch.migrate import (
    _jax_to_port, from_jax_state_dict, to_jax_state_dict)

torch.set_num_threads(2)

ATOL = 1e-4
SMALL = {'vocab_size': 10, 'd_model': 32, 'num_layers': 1, 'num_heads': 2,
         'kernel_size': 7, 'subsample_channels': 8}
HEADS = {
    'ctc': ('ConformerCTC', {}),
    'transducer': ('TransducerASR', {'pred_hidden': 16, 'joint_dim': 16}),
    'aed': ('AttentionASR', {'decoder_layers': 1, 'max_decode_len': 12}),
}


# parameters whose gradient is zero in exact arithmetic: the depthwise
# conv's bias, a per-channel constant before the training-mode batch norm;
# the cross-attention's key bias (no RoPE there), which adds the same
# q . b_k to every logit of a row, and the softmax does not see that
ZERO_GRADIENTS = ('conv.depthwise.bias', 'cross_attn.k_proj.bias')


def _models(head, seed=0, **updates):
    name, extra = HEADS[head]
    config = {**SMALL, **extra, **updates}
    ptrandom.seed(seed)
    jax_cls = getattr(jax_model_module, name)
    jax_model = jax_cls.from_config(jax_cls.get_config(dict(config)))
    cls = getattr(port_model_module, name)
    port = cls.from_config(cls.get_config(dict(config)))
    return jax_model, from_jax_state_dict(port, jax_model.state_dict())


_BATCHES = {}


def _batch(batch_size=4, num_examples=4):
    """The first batch of the recipe's pipeline on the synthetic data."""
    key = (batch_size, num_examples)
    if key not in _BATCHES:
        _BATCHES[key] = next(iter(data.prepare_dataset(
            data.synthetic_database(num_examples=num_examples),
            batch_size=batch_size, shuffle=False, prefetch=False)))
    return _BATCHES[key]


def _jnp(batch):
    return {k: v if k == 'example_id' else jnp.asarray(v)
            for k, v in batch.items()}


def _torch(batch):
    return {k: v if k == 'example_id' else torch.from_numpy(v)
            for k, v in batch.items()}


def _train_with_eval_front_end(*models):
    for m in models:
        m.train()
        m.acoustic.feature_extractor.eval()


def test_data_pipeline_matches_jax():
    batch = _batch()
    want = next(iter(jax_data.prepare_dataset(
        jax_data.synthetic_database(num_examples=4), batch_size=4,
        shuffle=False, prefetch=False)))
    assert set(batch) == set(want)
    assert list(batch['example_id']) == list(want['example_id'])
    for key in ('stft', 'seq_len', 'labels', 'label_lengths'):
        assert batch[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_allclose(batch[key], np.asarray(want[key]),
                                   atol=1e-5, rtol=0, err_msg=key)


def test_acoustic_encoder_matches_jax():
    jax_model, port = _models('ctc', seed=1)
    batch = _batch()
    _train_with_eval_front_end(jax_model, port)
    want, want_len = jax_model.acoustic(jnp.asarray(batch['stft']),
                                        seq_len=jnp.asarray(batch['seq_len']))
    with torch.no_grad():
        got, got_len = port.acoustic(torch.from_numpy(batch['stft']),
                                     seq_len=torch.from_numpy(
                                         batch['seq_len']))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(
        got_len.numpy(), -(-(-(-batch['seq_len'] // 2)) // 2))
    assert got.shape == want.shape and got.shape[-1] == 32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # the conv module's batch norm moved its statistics alike
    stats = to_jax_state_dict(port)
    for name, value in jax_model.state_dict().items():
        np.testing.assert_allclose(stats[name], np.asarray(value),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize('head', list(HEADS))
def test_forward_and_review_match_jax(head):
    jax_model, port = _models(head, seed=2)
    batch = _batch()
    _train_with_eval_front_end(jax_model, port)
    want = jax_model(_jnp(batch))
    want_review = jax_model.review(_jnp(batch), want)
    with torch.no_grad():
        got = port(_torch(batch))
        review = port.review(_torch(batch), got)
    assert set(got) == set(want)
    for key, value in want.items():
        want_value = np.asarray(value)
        got_value = got[key].numpy()
        assert got_value.shape == want_value.shape, key
        if want_value.dtype.kind == 'f':
            np.testing.assert_allclose(got_value, want_value, atol=ATOL,
                                       rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got_value, want_value)
    np.testing.assert_allclose(float(review['loss']),
                               float(want_review['loss']), rtol=ATOL)
    assert set(review['scalars']) == set(want_review['scalars'])
    for key, value in want_review['scalars'].items():
        np.testing.assert_allclose(float(review['scalars'][key]),
                                   float(value), rtol=ATOL, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize('head', list(HEADS))
def test_gradients_match_jax(head):
    jax_model, port = _models(head, seed=3)
    batch = _batch()
    _train_with_eval_front_end(jax_model, port)
    params, static = partition(jax_model)

    def jax_loss(params):
        model = combine(params, static)
        return model.review(_jnp(batch), model(_jnp(batch)))['loss']

    want = {k: np.asarray(v)
            for k, v in state_dict(jax.grad(jax_loss)(params)).items()}
    port.review(_torch(batch), port(_torch(batch)))['loss'].backward()
    trainable = {id(p) for p in port.parameters() if p.requires_grad}
    got = {}
    for jax_name, targets in _jax_to_port(port).items():
        param, convert = targets[0][:2]
        if id(param) in trainable:
            got[jax_name] = convert(param.grad.numpy())
    assert set(want) == set(got)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        if name.endswith(ZERO_GRADIENTS):
            # zero in exact arithmetic: both packages give rounding noise
            for g in (got[name], w):
                assert np.abs(g).max() <= ATOL * largest, name
            continue
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(
            got[name], w, rtol=0, atol=ATOL * float(np.abs(w).max()),
            err_msg=name)


@pytest.mark.parametrize('head, beam', [
    ('ctc', None), ('ctc', 3), ('transducer', None), ('transducer', 3),
    ('aed', None), ('aed', 3)])
def test_decode_bookkeeping(head, beam):
    _, port = _models(head, seed=4)
    batch = _batch()
    port.eval()
    results = port.decode(batch, beam_width=beam)
    assert list(results) == list(batch['example_id'])
    for i, (example_id, r) in enumerate(results.items()):
        n = int(batch['label_lengths'][i])
        assert r['reference'] == batch['labels'][i, :n].tolist()
        assert r['num_tokens'] == n
        assert r['num_errors'] <= max(n, len(r['hypothesis']))
        assert all(1 <= tok <= 10 for tok in r['hypothesis'])
    assert not any(p.grad is not None for p in port.parameters())


def _runs(flags):
    """Lengths of the runs of True in a 1-D boolean array."""
    edges = np.diff(np.concatenate([[0], flags.astype(int), [0]]))
    return np.flatnonzero(edges == -1) - np.flatnonzero(edges == 1)


def test_specaugment_masks_only_in_train_mode():
    """The recipe's SpecAugment (2 time masks of at most 20 frames, 1
    frequency mask of at most 8 mel bands) in training mode only.  The
    port draws the masks from a ``torch.Generator``, the JAX package from
    a key, so only their counts and widths are held: every feature the
    masks leave is the eval-mode feature, bit for bit."""
    _, port = _models('ctc', seed=14)
    extractor = port.feature_extractor
    extractor.norm.frozen_stats = True      # the same statistics in both
    batch = _batch()
    stft = torch.from_numpy(batch['stft'])
    lens = torch.from_numpy(batch['seq_len'])
    with torch.no_grad():
        clean, _ = extractor.eval()(stft, seq_len=lens)
        assert torch.equal(clean, extractor(stft, seq_len=lens)[0])
        widths = []
        for seed in range(6):
            torch.manual_seed(seed)
            masked, _ = extractor.train()(stft, seq_len=lens)
            hidden = (masked == 0) & (clean != 0)
            assert torch.equal(masked[~hidden], clean[~hidden])
            for row, n in zip(hidden[:, 0].numpy(), batch['seq_len']):
                row = row[:, :n]            # (M, T) of the valid frames
                times = _runs(row.all(axis=0))
                bands = _runs(row.all(axis=1))
                # two masks may overlap or touch and show as one run
                assert len(times) <= 2 and times.sum() <= 2 * 20, times
                assert len(bands) <= 1 and bands.sum() <= 8, bands
                # a hidden feature lies in a masked frame or band
                assert not (row & ~row.all(axis=0)[None]
                            & ~row.all(axis=1)[:, None]).any()
                widths += [*times, *bands]
    assert max(widths) > 0


@pytest.mark.parametrize('head', list(HEADS))
def test_greedy_decode_matches_jax(head):
    """The same weights and batch decode to the same greedy transcripts in
    both packages (their logits agree to about 1e-6, far inside every
    choice's margin here)."""
    jax_model, port = _models(head, seed=19)
    batch = _batch(batch_size=2, num_examples=2)
    # one symbol a frame: the JAX decode compiles its prediction network
    # once per prefix length
    kwargs = {'max_symbols_per_frame': 1} if head == 'transducer' else {}
    want = jax_model.eval().decode(_jnp(batch), **kwargs)
    got = port.eval().decode(batch, **kwargs)
    assert {k: v['hypothesis'] for k, v in got.items()} == \
        {k: v['hypothesis'] for k, v in want.items()}
    assert any(v['hypothesis'] for v in got.values())


def test_ctc_decode_with_lm_fusion():
    from padertorch_tpu_torch.evaluation import NGramLM
    _, port = _models('ctc', seed=4)
    batch = _batch()
    lm = NGramLM(order=2).fit([[1, 2, 3], [2, 3, 4]])
    fused = port.eval().decode(batch, beam_width=3, lm_fn=lm, lm_weight=0.5)
    assert list(fused) == list(batch['example_id'])


@pytest.mark.parametrize('head', list(HEADS))
def test_causal_prefix_property(head):
    """For ``causal=True`` the encoder frames of a truncated input equal
    the same frames of the whole input (left-padded subsampling convs, a
    causal encoder), and so do the CTC logits."""
    _, port = _models(head, seed=5, causal=True)
    batch = _batch(batch_size=2)
    port.eval()
    t_prefix = batch['stft'].shape[2] // 2 + 3
    lens = np.minimum(batch['seq_len'], t_prefix).astype('int32')
    with torch.no_grad():
        full, _ = port.acoustic(torch.from_numpy(batch['stft']),
                                seq_len=torch.from_numpy(batch['seq_len']))
        prefix, prefix_len = port.acoustic(
            torch.from_numpy(batch['stft'][:, :, :t_prefix]),
            seq_len=torch.from_numpy(lens))
    for b in range(2):
        n = int(prefix_len[b])
        assert n > 0
        np.testing.assert_allclose(prefix[b, :n].numpy(),
                                   full[b, :n].numpy(), atol=1e-5, rtol=0)


def _stream_input(batch, row=0, chunk=8):
    """The first whole chunks of one utterance: ``(stft (1, 1, T, F, 2),
    T)`` with T a multiple of ``chunk``."""
    t_in = (int(batch['seq_len'][row]) // chunk) * chunk
    return batch['stft'][row:row + 1, :, :t_in], t_in


def test_acoustic_encoder_stream_equals_one_shot():
    jax_model, port = _models('ctc', seed=6, causal=True)
    batch = _batch()
    # running statistics off their initial values
    port.train()
    with torch.no_grad():
        port(_torch(batch))
    port.eval()
    stft, t_in = _stream_input(batch)
    with torch.no_grad():
        full, _ = port.acoustic(torch.from_numpy(stft))
        state = port.acoustic.init_stream(1, max_frames=t_in)
        outs = []
        for start in range(0, t_in, 8):
            y, state = port.acoustic.stream_step(
                torch.from_numpy(stft[:, :, start:start + 8]), state, start)
            outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, 1), full.numpy(),
                               atol=1e-5, rtol=0)
    jax_model = jax_model.load_state_dict(to_jax_state_dict(port)).eval()
    want, _ = jax_model.acoustic(jnp.asarray(stft))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_transducer_stream_decode_equals_offline_greedy():
    _, port = _models('transducer', seed=7, causal=True)
    batch = _batch()
    port.eval()
    for row in range(2):
        stft, t_in = _stream_input(batch, row)
        offline = port.decode({
            'example_id': ['x'], 'stft': stft,
            'seq_len': np.asarray([t_in], 'int32'),
            'labels': batch['labels'][row:row + 1],
            'label_lengths': batch['label_lengths'][row:row + 1]})
        chunks = [stft[0, 0, s:s + 8] for s in range(0, t_in, 8)]
        streamed = port.stream_decode(chunks, max_frames=t_in)
        assert streamed == offline['x']['hypothesis']


def test_aed_serve_decode_equals_greedy():
    _, port = _models('aed', seed=8)
    batch = _batch()
    port.eval()
    greedy = port.decode(batch)
    served = port.serve_decode(batch, num_slots=2)
    assert {k: v['hypothesis'] for k, v in served.items()} \
        == {k: v['hypothesis'] for k, v in greedy.items()}


@pytest.mark.parametrize('head', list(HEADS))
def test_weights_round_trip_exactly(head):
    jax_model, port = _models(head, seed=9)
    port.train()
    with torch.no_grad():
        port(_torch(_batch()))                      # move the statistics
    got = to_jax_state_dict(port)
    assert set(got) == set(jax_model.state_dict())
    for key in ('acoustic.subsample_convs.1.weight',
                'acoustic.encoder.layers.0.conv.depthwise.weight',
                'acoustic.encoder.layers.0.conv.norm_conv.running_power',
                'acoustic.encoder.layers.0.self_attn.rope.inv_freq'):
        assert key in got, key
    assert got['acoustic.encoder.layers.0.conv.depthwise.weight'].shape \
        == (32, 1, 7)
    again = to_jax_state_dict(from_jax_state_dict(
        _models(head, seed=10)[1], got))
    for name in got:
        np.testing.assert_array_equal(again[name], got[name], err_msg=name)
    loaded = jax_model.load_state_dict(got).eval()
    batch = _batch()
    with torch.no_grad():
        want = port.eval()(_torch(batch))
    first = 'logits'
    np.testing.assert_allclose(np.asarray(loaded(_jnp(batch))[first]),
                               want[first].numpy(), atol=ATOL, rtol=0)


def test_prediction_network_fused_bias():
    jax_model, port = _models('transducer', seed=11)
    rnn = port.pred_rnn
    assert not rnn.bias_hh_l0.requires_grad and not rnn.bias_hh_l0.any()
    with torch.no_grad():
        rnn.bias_hh_l0.fill_(0.25)
    sd = to_jax_state_dict(port)
    np.testing.assert_allclose(
        sd['pred_rnn.b.0'], rnn.bias_ih_l0.detach().numpy() + 0.25,
        rtol=0, atol=0)
    np.testing.assert_array_equal(sd['pred_rnn.w_hh.0'],
                                  rnn.weight_hh_l0.detach().numpy().T)
    back = from_jax_state_dict(_models('transducer', seed=12)[1], sd)
    assert not back.pred_rnn.bias_hh_l0.any()
    np.testing.assert_array_equal(back.pred_rnn.bias_ih_l0.detach().numpy(),
                                  sd['pred_rnn.b.0'])
