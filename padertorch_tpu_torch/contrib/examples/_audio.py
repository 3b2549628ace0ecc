"""Small audio-file helpers shared by the recipes (no soundfile dep)."""
import wave

import numpy as np

__all__ = ['write_wav']


def write_wav(path, audio, sample_rate):
    """16-bit PCM mono wav writer via the stdlib."""
    pcm = np.clip(np.asarray(audio), -1.0, 1.0)
    pcm = (pcm * 32767).astype('<i2')
    with wave.open(str(path), 'wb') as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(int(sample_rate))
        fh.writeframes(pcm.tobytes())
