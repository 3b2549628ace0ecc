"""Streaming (online) STFT analysis and synthesis.

Counterpart of ``padertorch_tpu/ops/streaming.py``.  Online deployment
(live speech enhancement, ASR front ends, incremental vocoding) processes
audio in fixed-size chunks at a fixed latency.  The offline
:class:`~padertorch_tpu_torch.ops._stft.STFT` pads the whole utterance
(fading) and transforms it at once; these wrappers carry the overlap across
chunk boundaries instead, so that streaming a signal chunk by chunk yields
the offline transform's frames and samples (up to the order of the sums).

The carried state is a fixed-size tensor on the signal's device
(``window_length - shift`` samples for analysis, the overlap-add tail that
is not final yet for synthesis), and ``step`` is a function of its inputs
alone.  Chunk lengths must be multiples of ``shift`` (pad the last chunk
and keep the true lengths).

Example (analysis)::

    stft = STFT(512, 128, fading='full')
    streamer = StreamingSTFT(stft)
    state = streamer.init_state(batch_shape=(B,))
    for chunk in chunks:                  # (B, S), S % shift == 0
        state, frames = streamer.step(state, chunk)
    tail = streamer.finalize(state)
    # cat(frames..., tail) == stft(cat(chunks...))
"""
import copy

import torch

from padertorch_tpu_torch.ops._stft import STFT

__all__ = ['StreamingSTFT', 'StreamingISTFT']


def _inner_nofade(stft: STFT) -> STFT:
    """The same transform without fading and end padding (the kernels are
    shared)."""
    inner = copy.copy(stft)
    inner.fading = None
    inner.pad = False
    return inner


def _check_fading(fading):
    if fading == 'half':
        raise NotImplementedError(
            "fading='half' pads (window_length - shift) // 2 samples, "
            'which is not a whole number of shifts: stream with '
            "fading='full' (the default) or fading=None.")
    return fading in [True, 'full']


def _frames_axis(stft):
    return -3 if stft.complex_representation == 'stacked' else -2


class StreamingSTFT:
    """Chunkwise STFT analysis, equal to the offline ``STFT``.

    The state is the last ``window_length - shift`` samples of the
    (conceptually zero-prefixed) stream.  For ``fading='full'`` the
    zero-initialized state is the offline fading pad, so the very first
    chunk already yields offline frames.  For ``fading=None`` the first
    :attr:`warmup_frames` frames of the stream cover the zero prefix and
    must be dropped (which needs ``(window_length - shift) % shift == 0``).
    """

    def __init__(self, stft: STFT):
        self._full_fading = _check_fading(stft.fading)
        self.stft = stft
        self.shift = stft.shift
        self.overlap = stft.window_length - stft.shift
        assert self.overlap >= 0, (stft.window_length, stft.shift)
        self._inner = _inner_nofade(stft)
        if not self._full_fading and self.overlap % self.shift:
            raise ValueError(
                f'fading=None streaming needs shift ({self.shift}) to '
                f'divide window_length - shift ({self.overlap}) so the '
                f'warmup frames align.')

    @property
    def warmup_frames(self) -> int:
        """Leading stream frames to drop (0 for ``fading='full'``)."""
        return 0 if self._full_fading else self.overlap // self.shift

    def init_state(self, batch_shape=(), dtype=None, device=None):
        return torch.zeros((*batch_shape, self.overlap),
                           dtype=dtype or self.stft.dtype, device=device)

    def step(self, state, chunk):
        """(state, [..., S]) -> (state, [..., S // shift, bins])."""
        assert chunk.shape[-1] % self.shift == 0, (
            f'chunk length {chunk.shape[-1]} must be a multiple of '
            f'shift={self.shift}')
        assert chunk.shape[-1] >= self.shift
        x = torch.cat([state, chunk.to(state.dtype)], dim=-1)
        frames = self._inner(x)
        return x[..., x.shape[-1] - self.overlap:], frames

    @property
    def _tail_zeros(self) -> int:
        """Trailing zeros the offline transform appends after the data."""
        if self._full_fading:
            tail = self.overlap  # the fading pad
            if self.stft.pad:
                tail += (-self.overlap) % self.shift
        else:
            tail = (self.overlap % self.shift) if self.stft.pad else 0
        return tail

    @property
    def finalize_frames(self) -> int:
        """Number of frames :meth:`finalize` emits."""
        n = (self.overlap + self._tail_zeros
             - self.stft.window_length) // self.shift + 1
        return max(0, n)

    def finalize(self, state):
        """Emit the frames that cover the offline end padding."""
        if self.finalize_frames <= 0:
            bins = self.stft.size // 2 + 1
            shape = {
                'complex': (0, bins), 'concat': (0, 2 * bins),
                'stacked': (0, bins, 2),
            }[self.stft.complex_representation]
            dtype = (torch.complex64
                     if self.stft.complex_representation == 'complex'
                     else state.dtype)
            return torch.zeros((*state.shape[:-1], *shape), dtype=dtype,
                               device=state.device)
        pad = state.new_zeros((*state.shape[:-1], self._tail_zeros))
        return self._inner(torch.cat([state, pad], dim=-1))

    def process(self, signal, chunk_size):
        """Reference driver: stream ``signal`` and return the concatenated
        frames; equals ``self.stft(signal)``."""
        assert signal.shape[-1] % chunk_size == 0, (signal.shape, chunk_size)
        state = self.init_state(signal.shape[:-1], signal.dtype,
                                signal.device)
        outs = []
        for start in range(0, signal.shape[-1], chunk_size):
            state, frames = self.step(
                state, signal[..., start:start + chunk_size])
            outs.append(frames)
        outs.append(self.finalize(state))
        axis = _frames_axis(self.stft)
        frames = torch.cat(outs, dim=axis)
        if self.warmup_frames:
            frames = frames.narrow(frames.dim() + axis, self.warmup_frames,
                                   frames.shape[axis] - self.warmup_frames)
        return frames


class StreamingISTFT:
    """Chunkwise iSTFT synthesis, equal to ``STFT.inverse``.

    The state is the ``window_length - shift`` sample overlap-add tail that
    future frames still add to.  Each ``step`` takes ``F`` frames and emits
    exactly ``F * shift`` final samples.  For ``fading='full'`` the first
    :attr:`warmup_samples` emitted samples reconstruct the fading pad the
    offline inverse cuts off (drop them), and :meth:`finalize` emits
    nothing (the tail is the trailing fade).  For ``fading=None`` nothing
    is dropped and :meth:`finalize` emits the tail.
    """

    def __init__(self, stft: STFT):
        self._full_fading = _check_fading(stft.fading)
        self.stft = stft
        self.shift = stft.shift
        self.overlap = stft.window_length - stft.shift
        self._inner = _inner_nofade(stft)

    @property
    def warmup_samples(self) -> int:
        return self.overlap if self._full_fading else 0

    def init_state(self, batch_shape=(), dtype=None, device=None):
        return torch.zeros((*batch_shape, self.overlap),
                           dtype=dtype or self.stft.dtype, device=device)

    def step(self, state, frames):
        """(state, [..., F, bins]) -> (state, [..., F * shift])."""
        y = self._inner.inverse(frames)  # [..., F * shift + overlap]
        emit_len = y.shape[-1] - self.overlap
        assert emit_len >= 1, (y.shape, self.overlap)
        if self.overlap:
            y = torch.cat([y[..., :self.overlap] + state.to(y.dtype),
                           y[..., self.overlap:]], dim=-1)
        return y[..., emit_len:], y[..., :emit_len]

    def finalize(self, state):
        """The samples left after the last frame (may be none)."""
        keep = 0 if self._full_fading else self.overlap
        return state[..., :keep]

    def process(self, frames, chunk_frames):
        """Reference driver; equals ``self.stft.inverse(frames)``."""
        axis = _frames_axis(self.stft)
        n = frames.shape[axis]  # the last chunk may be shorter
        state = self.init_state(frames.shape[:frames.dim() + axis],
                                device=frames.device)
        outs = []
        for start in range(0, n, chunk_frames):
            chunk = frames.narrow(frames.dim() + axis, start,
                                  min(chunk_frames, n - start))
            state, emit = self.step(state, chunk)
            outs.append(emit)
        outs.append(self.finalize(state))
        return torch.cat(outs, dim=-1)[..., self.warmup_samples:]
