"""GAN vocoder data pipeline.

Counterpart of ``padertorch_tpu/contrib/examples/audio_synthesis/
gan_vocoder/data.py``: the WaveNet vocoder's front end (1 s segments,
log-mel conditioning at hop 200 / window 800 / 80 mels), so that both
vocoder recipes consume the same features.
"""
from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet.data \
    import (SAMPLE_RATE, STFT_SHIFT, STFT_WINDOW, STFT_SIZE, NUM_MELS,
            synthetic_database, extract_features, post_batch,
            prepare_dataset)

__all__ = [
    'SAMPLE_RATE', 'STFT_SHIFT', 'STFT_WINDOW', 'STFT_SIZE', 'NUM_MELS',
    'synthetic_database', 'extract_features', 'post_batch',
    'prepare_dataset',
]
