"""Data pipeline for uPIT on WSJ0-2mix-style data.

Counterpart of ``padertorch_tpu/contrib/examples/source_separation/pit/
data.py`` (reference ``contrib/examples/source_separation/pit/data.py``):
on-the-fly host STFT (512/128), magnitude/phase features and padded
batches; ``read_audio`` loads the WAV files a ``JsonDatabase`` example
names (``audio_path.observation``, ``audio_path.speech_source``) through
``AudioReader``; the synthetic two-speaker sinusoid database serves runs
without data.
"""
import numpy as np

from padertorch_tpu_torch.data import dataset as lazy
from padertorch_tpu_torch.data.batch import Sorter
from padertorch_tpu_torch.data.utils import collate_fn, pad_batch
from padertorch_tpu_torch.ops._stft import HostSTFT as STFT

STFT_SIZE = 512
STFT_SHIFT = 128
K = 2


def synthetic_database(num_examples=16, num_samples=16000, seed=0):
    """Two-speaker mixtures of modulated tones + noise (for smoke tests)."""
    rng = np.random.RandomState(seed)
    examples = {}
    t = np.arange(num_samples) / 8000
    for i in range(num_examples):
        f1, f2 = rng.uniform(100, 1500, 2)
        s1 = np.sin(2 * np.pi * f1 * t) * rng.uniform(0.3, 1.0)
        s2 = np.sin(2 * np.pi * f2 * t + rng.uniform(0, 6)) \
            * rng.uniform(0.3, 1.0)
        s1 = s1 * (1 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
        s2 = s2 * (1 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
        n = num_samples - rng.randint(0, num_samples // 4)
        examples[f'ex_{i}'] = {
            'example_id': f'ex_{i}',
            'speech_source': np.stack([s1, s2]).astype('float32')[:, :n],
            'observation': (s1 + s2).astype('float32')[:n],
            'num_samples': n,
        }
    return lazy.from_dict(examples)


def read_audio(example):
    """Load audio for real databases (audio_path entries)."""
    from padertorch_tpu_torch.contrib.je.data.transforms import AudioReader
    reader = AudioReader()
    observation = reader.read_file(example['audio_path']['observation'])
    sources = np.stack([
        reader.read_file(p)
        for p in example['audio_path']['speech_source']
    ])
    return {
        'example_id': example['example_id'],
        'observation': observation,
        'speech_source': sources,
        'num_samples': observation.shape[-1],
    }


_stft = STFT(
    size=STFT_SIZE, shift=STFT_SHIFT, fading='full',
    complex_representation='complex', dtype='float32')


def pre_batch_transform(example):
    """Time signals -> STFT features (host side)."""
    obs = np.asarray(_stft(example['observation']))
    sources = np.asarray(_stft(example['speech_source']))  # (K, T, F)
    x = np.moveaxis(sources, 0, 1)  # (T, K, F)
    phase_diff = np.angle(obs[:, None, :]) - np.angle(x)
    return {
        'example_id': example['example_id'],
        'Y_abs': np.abs(obs).astype('float32'),
        'X_abs': np.abs(x).astype('float32'),
        'cos_phase_difference': np.cos(phase_diff).astype('float32'),
        'num_frames': obs.shape[-2],
    }


def post_batch_transform(batch):
    """List of examples -> padded arrays + length vector."""
    batch = collate_fn(batch)
    y, num_frames = pad_batch(batch['Y_abs'], axis=0)
    x, _ = pad_batch(batch['X_abs'], axis=0)
    cpd, _ = pad_batch(batch['cos_phase_difference'], axis=0)
    return {
        'example_id': list(batch['example_id']),
        'Y_abs': y,
        'X_abs': x,
        'cos_phase_difference': cpd,
        'num_frames': np.asarray(num_frames, dtype='int32'),
    }


def prepare_dataset(dataset, batch_size=4, shuffle=True, prefetch=True):
    if shuffle:
        dataset = dataset.shuffle(reshuffle=True)
    dataset = (
        dataset
        .map(pre_batch_transform)
        .batch(batch_size)
        .map(Sorter('num_frames'))
        .map(post_batch_transform)
    )
    if prefetch:
        dataset = dataset.prefetch(4, 8)
    return dataset
