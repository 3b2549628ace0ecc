"""WaveNet vocoder data pipeline: 1 s segments, log-mel conditioning.

Counterpart of ``padertorch_tpu/contrib/examples/audio_synthesis/wavenet/
data.py`` (reference ``contrib/examples/audio_synthesis/wavenet/data.py``):
Segmenter (1 s), host STFT and log-mel, batching.
"""
import numpy as np

from padertorch_tpu_torch.contrib.je.modules.features import get_fbanks
from padertorch_tpu_torch.data import dataset as lazy
from padertorch_tpu_torch.data.segment import Segmenter
from padertorch_tpu_torch.data.utils import collate_fn, pad_batch
from padertorch_tpu_torch.ops._stft import HostSTFT as STFT

SAMPLE_RATE = 16000
STFT_SHIFT = 200
STFT_WINDOW = 800
STFT_SIZE = 1024
NUM_MELS = 80

_stft = STFT(
    size=STFT_SIZE, shift=STFT_SHIFT, window_length=STFT_WINDOW,
    fading='full', complex_representation='complex', dtype='float32')

_fbanks = get_fbanks(
    SAMPLE_RATE, STFT_SIZE, NUM_MELS).astype('float32')
_fbanks = _fbanks / (_fbanks.sum(-1, keepdims=True) + 1e-6)


def synthetic_database(num_examples=12, num_samples=16000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / SAMPLE_RATE
    examples = {}
    for i in range(num_examples):
        f0 = rng.uniform(80, 300)
        audio = 0.4 * np.sin(2 * np.pi * f0 * t) \
            + 0.2 * np.sin(2 * np.pi * 2 * f0 * t) \
            + 0.02 * rng.randn(num_samples)
        examples[f'utt_{i}'] = {
            'example_id': f'utt_{i}',
            'audio_data': np.clip(audio, -1, 1).astype('float32'),
            'num_samples': num_samples,
        }
    return lazy.from_dict(examples)


def extract_features(example):
    audio = np.asarray(example['audio_data'])
    spec = np.asarray(_stft(audio))  # (frames, F)
    logmel = np.log(
        (np.abs(spec) ** 2) @ _fbanks.T + 1e-12)  # (frames, M)
    example['features'] = logmel.T.astype('float32')  # (M, frames)
    return example


def post_batch(batch):
    batch = collate_fn(batch)
    features, num_frames = pad_batch(batch['features'], axis=-1)
    audio, num_samples = pad_batch(batch['audio_data'], axis=-1)
    return {
        'example_id': list(batch['example_id']),
        'features': features,
        'audio_data': audio,
        'num_samples': np.asarray(num_samples, dtype='int32'),
    }


def prepare_dataset(dataset, batch_size=4, segment_length=16000,
                    shuffle=True, prefetch=True):
    if segment_length and segment_length > 0:
        segmenter = Segmenter(
            length=segment_length,
            include_keys=('audio_data',),
            copy_keys=('example_id',),
            anchor='random' if shuffle else 'left',
        )
        dataset = dataset.map(segmenter).catch().unbatch()
    dataset = dataset.map(extract_features)
    if shuffle:
        dataset = dataset.shuffle(buffer_size=32)
    dataset = dataset.batch(batch_size).map(post_batch)
    if prefetch:
        dataset = dataset.prefetch(4, 8)
    return dataset
