"""Log-mel data pipeline for supervised speaker classification.

Counterpart of ``padertorch_tpu/contrib/examples/speaker_classification/
supervised/data.py`` (reference
``contrib/examples/speaker_classification/supervised/data.py``): STFT
512/160/400 + 64 mel bins, LabelEncoder over speaker ids, train/dev/test
split per speaker; numpy only, copied.  ``read_audio`` reads a
``JsonDatabase`` example's WAV file (``audio_path``) through ``AudioReader``;
the JAX recipe's ``--database`` branch takes examples that hold their audio
already, which pass it as they are.
"""
import numpy as np

from padertorch_tpu_torch.data import dataset as lazy
from padertorch_tpu_torch.data.utils import collate_fn, pad_batch
from padertorch_tpu_torch.contrib.je.data.transforms import (
    AudioReader, STFT, LabelEncoder,
)

STFT_PARAMS = dict(shift=160, size=512, window_length=400, pad=True,
                   fading=None)
NUM_MELS = 64
SAMPLE_RATE = 16000


def read_audio(example):
    """The example's WAV file (``audio_path``) read into ``audio_data``
    and ``seq_len`` at the recipe's sample rate; an example that holds
    its audio already is returned as it is."""
    if 'audio_path' not in example:
        return example
    return AudioReader(target_sample_rate=SAMPLE_RATE)(example)


def train_test_split(dataset, dev_split=0.1, test_split=0.1, seed=0):
    """Random index split of an indexable dataset into
    (train, dev, test) (reference ``supervised/data.py:48``: draw the
    test indices first, then the dev indices from the remainder).

    Intentional deviation from the reference: the train set is
    ``np.setdiff1d(indices, dev_candidates)`` where the reference uses
    ``np.delete(indices, dev_candidates)`` — delete-by-POSITION on an
    index array that is no longer contiguous after the test removal,
    which can overlap train/dev membership or raise ``IndexError``.
    Same-seed splits therefore differ from the reference's; this is a
    bug fix, not a parity regression.

    >>> ds = lazy.from_list([{'i': i} for i in range(20)])
    >>> tr, dev, te = train_test_split(ds, dev_split=0.2, test_split=0.2)
    >>> len(tr), len(dev), len(te)
    (12, 4, 4)
    >>> sorted(e['i'] for s in (tr, dev, te) for e in s) == list(range(20))
    True
    """
    r = np.random.RandomState(seed)
    try:
        num_examples = len(dataset)
    except TypeError:
        raise RuntimeError('dataset must be indexable!')
    indices = np.arange(num_examples)
    dev_size = int(num_examples * dev_split)
    test_size = int(num_examples * test_split)
    test_candidates = r.choice(indices, size=test_size, replace=False)
    indices = np.delete(indices, test_candidates)
    dev_candidates = r.choice(indices, size=dev_size, replace=False)
    train_candidates = np.setdiff1d(indices, dev_candidates)
    return (
        dataset[[int(i) for i in train_candidates]],
        dataset[[int(i) for i in dev_candidates]],
        dataset[[int(i) for i in test_candidates]],
    )


def synthetic_database(num_speakers=8, per_speaker=12, num_samples=8000,
                       seed=0):
    """Speaker-colored noise database for smoke runs: each speaker has a
    fixed random spectral envelope."""
    rng = np.random.RandomState(seed)
    envelopes = rng.uniform(0.1, 1.0, (num_speakers, 257))
    examples = {}
    for s in range(num_speakers):
        for i in range(per_speaker):
            n_frames = -(-num_samples // 512)
            noise = rng.randn(n_frames, 512)
            spec = np.fft.rfft(noise * np.hanning(512))
            spec = spec * envelopes[s]
            audio = np.fft.irfft(spec).reshape(-1)[:num_samples]
            examples[f'spk{s}_{i}'] = {
                'example_id': f'spk{s}_{i}',
                'audio_data': audio.astype('float32'),
                'seq_len': num_samples,
                'speaker_id': f'speaker_{s}',
            }
    return lazy.from_dict(examples)


def finalize(example):
    return {
        'example_id': example['example_id'],
        'stft': example['stft'][None].astype('float32'),  # (C=1, T, F, 2)
        'seq_len': example['seq_len'],
        'speaker_id': example['speaker_id'],
    }


def post_batch(batch):
    batch = collate_fn(batch)
    stft, seq_len = pad_batch(batch['stft'], axis=1)
    return {
        'example_id': list(batch['example_id']),
        'stft': stft,
        'seq_len': np.asarray(batch['seq_len'], dtype='int32'),
        'speaker_id': np.asarray(batch['speaker_id'], dtype='int32'),
    }


def prepare_dataset(dataset, label_encoder, batch_size=8, shuffle=True,
                    prefetch=True):
    stft = STFT(**STFT_PARAMS)
    dataset = dataset.map(stft).map(label_encoder).map(finalize)
    if shuffle:
        dataset = dataset.shuffle(reshuffle=True)
    dataset = dataset.batch(batch_size).map(post_batch)
    if prefetch:
        dataset = dataset.prefetch(4, 8)
    return dataset


def finalize_audio(example):
    """On-device-frontend variant: ship raw audio, no host STFT."""
    return {
        'example_id': example['example_id'],
        'audio_data': np.asarray(example['audio_data'], dtype='float32'),
        'seq_len': example['seq_len'],
        'speaker_id': example['speaker_id'],
    }


def post_batch_audio(batch):
    batch = collate_fn(batch)
    audio, seq_len = pad_batch(batch['audio_data'], axis=0)
    return {
        'example_id': list(batch['example_id']),
        'audio_data': audio,
        'seq_len': np.asarray(batch['seq_len'], dtype='int32'),
        'speaker_id': np.asarray(batch['speaker_id'], dtype='int32'),
    }


def prepare_dataset_audio(dataset, label_encoder, batch_size=8,
                          shuffle=True, prefetch=True):
    """Pipeline for the on-device front end: the batch carries
    raw audio (64 kB per 4 s utterance vs ~1 MB of stacked STFT)."""
    dataset = dataset.map(label_encoder).map(finalize_audio)
    if shuffle:
        dataset = dataset.shuffle(reshuffle=True)
    dataset = dataset.batch(batch_size).map(post_batch_audio)
    if prefetch:
        dataset = dataset.prefetch(4, 8)
    return dataset


def get_label_encoder(storage_dir, dataset):
    encoder = LabelEncoder(label_key='speaker_id', storage_dir=storage_dir)
    encoder.initialize_labels(dataset=dataset, verbose=True)
    return encoder
