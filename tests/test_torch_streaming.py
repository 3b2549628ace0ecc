"""The port's streaming STFT and iSTFT (``padertorch_tpu_torch/ops/
streaming.py``) and ``StatefulLSTM`` on the CPU; mirrors
``tests/test_ops/test_streaming.py``.

Streaming equals the offline transform (every representation, overlaps
that are not a multiple of the shift, short windows, chunk sizes, no
fading with its warm-up), the reconstruction round trip, and an online
enhancer (streaming STFT, a ``StatefulLSTM`` mask, streaming iSTFT) equal
to offline processing.  Frame by frame, the port's streamers equal the JAX
package's at 1e-5 (of the frames' largest magnitude).
"""
import numpy as np
import pytest
import torch

from padertorch_tpu_torch.modules.recurrent import StatefulLSTM
from padertorch_tpu_torch.ops import STFT, StreamingISTFT, StreamingSTFT

torch.set_num_threads(2)


def _signal(shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype('float32'))


def _close(got, want, atol):
    if torch.is_complex(got):
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=atol)


@pytest.mark.parametrize('size,shift,window_length', [
    (512, 128, None),
    (512, 160, None),   # overlap not a multiple of shift
    (512, 128, 400),    # window shorter than the FFT
    (256, 64, None),
])
@pytest.mark.parametrize('rep', ['complex', 'stacked', 'concat'])
def test_streaming_stft_equals_offline_full_fading(
        size, shift, window_length, rep):
    stft = STFT(size, shift, window_length=window_length, fading='full',
                complex_representation=rep)
    streamer = StreamingSTFT(stft)
    assert streamer.warmup_frames == 0
    x = _signal((2, 20 * shift))
    got = streamer.process(x, chunk_size=4 * shift)
    want = stft(x)
    assert got.shape == want.shape
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize('chunk_shifts', [1, 4, 5, 20])
def test_streaming_stft_chunk_size_invariance(chunk_shifts):
    stft = STFT(512, 128)
    x = _signal((3, 20 * 128))
    _close(StreamingSTFT(stft).process(x, chunk_size=chunk_shifts * 128),
           stft(x), atol=1e-4)


def test_streaming_stft_no_fading_warmup_drop():
    stft = STFT(512, 128, fading=None)
    streamer = StreamingSTFT(stft)
    assert streamer.warmup_frames == 3  # (512 - 128) / 128
    x = _signal((2, 16 * 128))
    _close(streamer.process(x, chunk_size=4 * 128), stft(x), atol=1e-4)


def test_streaming_stft_multidim_batch_and_steps():
    stft = STFT(512, 128)
    streamer = StreamingSTFT(stft)
    x = _signal((2, 3, 12 * 128))
    state = streamer.init_state((2, 3))
    outs = []
    for start in range(0, x.shape[-1], 512):
        state, frames = streamer.step(state, x[..., start:start + 512])
        outs.append(frames)
    outs.append(streamer.finalize(state))
    assert streamer.finalize_frames == outs[-1].shape[-2]
    _close(torch.cat(outs, dim=-2), stft(x), atol=1e-5 * 30)


def test_streaming_stft_rejects_bad_config():
    with pytest.raises(NotImplementedError):
        StreamingSTFT(STFT(512, 128, fading='half'))
    with pytest.raises(ValueError):
        # overlap 352 not a multiple of shift 160: no warm-up alignment
        StreamingSTFT(STFT(512, 160, fading=None))
    streamer = StreamingSTFT(STFT(512, 128))
    with pytest.raises(AssertionError):
        streamer.step(streamer.init_state((1,)), torch.zeros((1, 100)))


@pytest.mark.parametrize('size,shift', [(512, 128), (512, 160), (256, 64)])
@pytest.mark.parametrize('fading', ['full', None])
def test_streaming_istft_equals_offline(size, shift, fading):
    stft = STFT(size, shift, fading=fading)
    frames = stft(_signal((2, 20 * shift)))
    want = stft.inverse(frames)
    got = StreamingISTFT(stft).process(frames, chunk_frames=4)
    assert got.shape == want.shape
    _close(got, want, atol=1e-5)


def test_streaming_istft_single_frame_chunks():
    stft = STFT(512, 128)
    frames = stft(_signal((1, 12 * 128)))
    _close(StreamingISTFT(stft).process(frames, chunk_frames=1),
           stft.inverse(frames), atol=1e-5)


def test_streaming_roundtrip_reconstructs_signal():
    stft = STFT(512, 128)
    streamer, synth = StreamingSTFT(stft), StreamingISTFT(stft)
    n = 24 * 128
    x = _signal((2, n))
    a_state, s_state = streamer.init_state((2,)), synth.init_state((2,))
    outs = []
    for start in range(0, n, 512):
        a_state, frames = streamer.step(a_state, x[..., start:start + 512])
        s_state, samples = synth.step(s_state, frames)
        outs.append(samples)
    s_state, samples = synth.step(s_state, streamer.finalize(a_state))
    outs += [samples, synth.finalize(s_state)]
    y = torch.cat(outs, dim=-1)[..., synth.warmup_samples:]
    _close(y[..., :n], x, atol=1e-5)


def _magnitude(frames):
    return torch.sqrt(frames[..., 0] ** 2 + frames[..., 1] ** 2 + 1e-8)


def test_online_enhancer_equals_offline():
    """Causal chunked enhancement (streaming STFT, a ``StatefulLSTM``
    mask, streaming iSTFT, 4 frames a chunk) == offline processing of the
    whole utterance."""
    size, shift, bins = 256, 64, 129
    stft = STFT(size, shift, complex_representation='stacked')
    torch.manual_seed(0)
    lstm = StatefulLSTM(bins, 32).eval()
    head = torch.nn.Linear(32, bins)

    def mask_net(feats):
        return torch.sigmoid(head(lstm(feats)))

    x = _signal((2, 32 * shift), seed=7)
    with torch.no_grad():
        spec = stft(x)                             # (B, T, F, 2)
        want = stft.inverse(spec * mask_net(_magnitude(spec))[..., None])
        del lstm.states                            # a new stream
        streamer, synth = StreamingSTFT(stft), StreamingISTFT(stft)
        a_state, s_state = streamer.init_state((2,)), synth.init_state((2,))
        outs = []
        for start in range(0, x.shape[-1], 4 * shift):
            a_state, frames = streamer.step(
                a_state, x[..., start:start + 4 * shift])
            mask = mask_net(_magnitude(frames))
            s_state, samples = synth.step(s_state, frames * mask[..., None])
            outs.append(samples)
        tail = streamer.finalize(a_state)
        mask = mask_net(_magnitude(tail))
        s_state, samples = synth.step(s_state, tail * mask[..., None])
        outs += [samples, synth.finalize(s_state)]
    got = torch.cat(outs, dim=-1)[..., synth.warmup_samples:]
    assert got.shape == want.shape
    _close(got, want, atol=1e-5)


# -- frame by frame against the JAX package ---------------------------------

@pytest.mark.parametrize('fading', ['full', None])
def test_streamers_equal_jax_frame_by_frame(fading):
    import jax.numpy as jnp
    from padertorch_tpu.ops import STFT as JaxSTFT
    from padertorch_tpu.ops import StreamingISTFT as JaxStreamingISTFT
    from padertorch_tpu.ops import StreamingSTFT as JaxStreamingSTFT
    kwargs = dict(window_length=384, fading=fading,
                  complex_representation='stacked')
    stft, jax_stft = STFT(512, 128, **kwargs), JaxSTFT(512, 128, **kwargs)
    pairs = [(StreamingSTFT(stft), JaxStreamingSTFT(jax_stft)),
             (StreamingISTFT(stft), JaxStreamingISTFT(jax_stft))]
    (analysis, jax_analysis), (synthesis, jax_synthesis) = pairs
    x = _signal((2, 16 * 128), seed=3)
    states = [analysis.init_state((2,)), jax_analysis.init_state((2,)),
              synthesis.init_state((2,)), jax_synthesis.init_state((2,))]
    for start in range(0, x.shape[-1], 512):
        chunk = x[..., start:start + 512]
        states[0], frames = analysis.step(states[0], chunk)
        states[1], jax_frames = jax_analysis.step(
            states[1], jnp.asarray(chunk.numpy()))
        scale = float(np.abs(np.asarray(jax_frames)).max())
        np.testing.assert_allclose(frames.numpy(), np.asarray(jax_frames),
                                   rtol=0, atol=1e-5 * scale)
        # the synthesis of the same frames (the JAX ones, both sides)
        states[2], samples = synthesis.step(
            states[2], torch.from_numpy(np.array(jax_frames)))
        states[3], jax_samples = jax_synthesis.step(states[3], jax_frames)
        np.testing.assert_allclose(samples.numpy(), np.asarray(jax_samples),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(states[2].numpy(),
                                   np.asarray(states[3]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        analysis.finalize(states[0]).numpy(),
        np.asarray(jax_analysis.finalize(states[1])), rtol=0,
        atol=1e-5 * scale)
    np.testing.assert_allclose(
        synthesis.finalize(states[2]).numpy(),
        np.asarray(jax_synthesis.finalize(states[3])), rtol=0, atol=1e-5)
