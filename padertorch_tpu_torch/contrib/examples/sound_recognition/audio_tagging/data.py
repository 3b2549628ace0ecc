"""Real-data pipeline for the audio-tagging recipe (AudioSet-style).

Counterpart of ``padertorch_tpu/contrib/examples/sound_recognition/
audio_tagging/data.py`` (reference
``contrib/examples/sound_recognition/audio_tagging/data.py:11-131``),
copied (numpy only): ``get_datasets`` (JsonDatabase + multi-hot event
encoder persisted to the storage dir as ``eventss.json``,
train/validate/eval splits) and ``prepare_dataset`` (length filtering,
audio read + per-example normalization, random gain scaling in training
[log-truncated-normal], shuffle, STFT, event encoding, finalize, prefetch,
mixup, dynamic time-series bucketing, collate).  The randomness draws from
the same numpy generators in the same order as the JAX module, so the two
pipelines give the same batches from the same seed.
"""
import numpy as np

from padertorch_tpu_torch.data import dataset as lazy
from padertorch_tpu_torch.contrib.je.data.transforms import (
    AudioReader, STFT, MultiHotEncoder, Collate,
)

__all__ = ['get_datasets', 'prepare_dataset', 'log_truncated_normal']


def log_truncated_normal(size, loc=1.0, scale=1.0, truncation=3.0,
                         rng=np.random):
    """exp of a truncated normal (paderbox ``LogTruncatedNormal``):
    redraw until |x - loc| <= truncation, then exponentiate."""
    x = rng.normal(loc, scale, size=size)
    for _ in range(100):
        bad = np.abs(x - loc) > truncation
        if not bad.any():
            break
        x[bad] = rng.normal(loc, scale, size=int(bad.sum()))
    return np.exp(np.clip(x, loc - truncation, loc + truncation))


def get_datasets(database_json, audio_reader, stft, batch_size,
                 storage_dir, num_workers=8, max_padding_rate=.05,
                 min_signal_length=None, max_signal_length=None,
                 mixup_probs=(1,), min_mixup_overlap=0.,
                 max_mixup_length=None, training_set='balanced_train'):
    """Assemble (train, validate, eval) datasets from a JsonDatabase
    (ref ``data.py:11``).  ``audio_reader``/``stft`` are kwargs dicts
    for :class:`AudioReader`/:class:`STFT`.
    """
    from padertorch_tpu_torch.data.database import JsonDatabase
    db = JsonDatabase(database_json)
    training = db.get_dataset(training_set)

    event_encoder = MultiHotEncoder(
        label_key='events', storage_dir=storage_dir)
    event_encoder.initialize_labels(dataset=training, verbose=True)

    kwargs = dict(
        audio_reader=audio_reader, stft=stft,
        event_encoder=event_encoder, num_workers=num_workers,
        batch_size=batch_size, max_padding_rate=max_padding_rate,
        min_signal_length=min_signal_length,
        max_signal_length=max_signal_length,
        mixup_probs=mixup_probs,
        min_mixup_overlap=min_mixup_overlap,
        max_mixup_length=max_mixup_length,
    )
    return (
        prepare_dataset(training, training=True, **kwargs),
        prepare_dataset(db.get_dataset('validate'), **kwargs),
        prepare_dataset(db.get_dataset('eval'), **kwargs),
    )


def _superpose(example, other, min_overlap, max_length,
               rng=np.random):
    """Mixup by superposing two STFT examples at a random offset with
    at least ``min_overlap`` fractional overlap; events are OR-ed
    (the reference's ``SuperposeEvents`` semantics)."""
    x1, x2 = example['stft'], other['stft']
    t1, t2 = x1.shape[1], x2.shape[1]
    max_shift = int((1 - min_overlap) * min(t1, t2))
    shift = rng.randint(-max_shift, max_shift + 1)
    o1 = max(-shift, 0)
    o2 = max(shift, 0)
    total = max(t1 + o1, t2 + o2)
    if max_length is not None:
        total = min(total, max_length)
    out = np.zeros((x1.shape[0], total) + x1.shape[2:], x1.dtype)
    s1 = min(t1, total - o1)
    s2 = min(t2, total - o2)
    if s1 > 0:
        out[:, o1:o1 + s1] += x1[:, :s1]
    if s2 > 0:
        out[:, o2:o2 + s2] += x2[:, :s2]
    return {
        'dataset': example.get('dataset', ''),
        'example_id': f"{example['example_id']}+{other['example_id']}",
        'stft': out,
        'seq_len': total,
        'events': np.maximum(example['events'], other['events']),
    }


class _MixUpDataset(lazy.Dataset):
    """Buffered mixup: with probability ``1 - mixup_probs[0]`` an
    example is superposed with a random partner from a sliding buffer
    (ref ``MixUpDataset``/``SampleMixupComponents``).  A lazy
    ``Dataset``: every epoch re-iterates the upstream pipeline, so
    shuffling/scaling/mixup re-randomize per epoch and nothing is
    materialized."""

    def __init__(self, dataset, mixup_probs, min_overlap, max_length,
                 buffer_size=64, seed=0):
        self.dataset = dataset
        self.mixup_probs = mixup_probs
        self.min_overlap = min_overlap
        self.max_length = max_length
        self.buffer_size = buffer_size
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return len(self.dataset)

    @property
    def indexable(self):
        return False

    def __iter__(self):
        self._epoch += 1
        rng = np.random.RandomState(self.seed + self._epoch)
        buffer = []
        n_components = np.arange(1, len(self.mixup_probs) + 1)
        for example in self.dataset:
            buffer.append(example)
            if len(buffer) > self.buffer_size:
                buffer.pop(0)
            n = rng.choice(n_components, p=self.mixup_probs)
            out = example
            for _ in range(int(n) - 1):
                partner = buffer[rng.randint(len(buffer))]
                out = _superpose(out, partner, self.min_overlap,
                                 self.max_length, rng)
            yield out


def prepare_dataset(dataset, audio_reader, stft, event_encoder,
                    num_workers, batch_size, max_padding_rate,
                    min_signal_length=None, max_signal_length=None,
                    training=False, mixup_probs=(1,),
                    min_mixup_overlap=0., max_mixup_length=None):
    """One split's pipeline (ref ``data.py:48``)."""
    assert np.isclose(np.sum(mixup_probs), 1.0), mixup_probs
    if min_signal_length is not None or max_signal_length is not None:
        dataset = dataset.filter(
            lambda ex: (
                (max_signal_length is None
                 or ex['audio_length'] <= max_signal_length)
                and (min_signal_length is None
                     or ex['audio_length'] >= min_signal_length)),
            lazy=False)

    audio_reader = AudioReader(**audio_reader)
    stft = STFT(**stft)
    if max_mixup_length is not None:
        max_mixup_length = stft.samples_to_frames(
            int(max_mixup_length * audio_reader.target_sample_rate))

    def normalize(example):
        audio = np.asarray(example['audio_data'], np.float32)
        audio = audio - audio.mean(-1, keepdims=True)
        if audio.ndim > 1:
            audio = audio.mean(0, keepdims=True)[0]
        audio = audio / (np.abs(audio).max() + 1e-3)
        example['audio_data'] = audio
        return example

    dataset = dataset.map(audio_reader).map(normalize)

    if training:
        def random_scale(example):
            example['audio_data'] = (
                example['audio_data']
                * log_truncated_normal(1, loc=1., truncation=3.)[0])
            return example
        dataset = dataset.map(random_scale)
        dataset = dataset.shuffle(reshuffle=True)

    dataset = dataset.map(stft).map(event_encoder)

    def finalize(example):
        return {
            'dataset': example.get('dataset', ''),
            'example_id': example['example_id'],
            # leading channel axis for the CNN frontend
            'stft': np.asarray(example['stft'], np.float32)[None],
            'seq_len': int(example['seq_len']),
            'events': np.asarray(example['events'], np.float32),
        }

    dataset = dataset.map(finalize)
    if num_workers and num_workers > 0:
        dataset = dataset.prefetch(
            num_workers, 10 * batch_size, catch_filter_exception=True)

    if training and mixup_probs[0] < 1.:
        dataset = _MixUpDataset(
            dataset, mixup_probs, min_mixup_overlap, max_mixup_length,
            buffer_size=80 * batch_size)

    def _collate(batch):
        out = Collate(pad_keys=('stft',), pad_axis=1)(batch)
        out['events'] = np.stack(list(out['events']))
        out['seq_len'] = np.asarray(out['seq_len'], 'int32')
        # keep string keys as python lists (device transfer skips them)
        out['example_id'] = [str(x) for x in out['example_id']]
        out['dataset'] = [str(x) for x in out['dataset']]
        return out

    return dataset.batch_dynamic_time_series_bucket(
        batch_size=batch_size, len_key='seq_len',
        max_padding_rate=max_padding_rate,
        expiration=1000 * batch_size, drop_incomplete=training,
        sort_key='seq_len', reverse_sort=True,
    ).map(_collate)
