"""Data pipeline for TasNet training (time-domain, 4 s segments).

Counterpart of ``padertorch_tpu/contrib/examples/source_separation/tasnet/
data.py`` (reference ``contrib/examples/source_separation/tasnet/train.py``
data handling): Segmenter into 4-second chunks, padded batches.  Real
databases are read by the pit recipe's ``read_audio``, re-exported here as
the JAX module does.
"""
import numpy as np

from padertorch_tpu_torch.data.segment import Segmenter
from padertorch_tpu_torch.data.utils import collate_fn, pad_batch
from padertorch_tpu_torch.contrib.examples.source_separation.pit.data import (
    synthetic_database, read_audio,
)

__all__ = ['prepare_dataset', 'synthetic_database', 'read_audio',
           'post_batch_transform']


def post_batch_transform(batch):
    batch = collate_fn(batch)
    y, num_samples = pad_batch(batch['observation'], axis=-1)
    s, _ = pad_batch(batch['speech_source'], axis=-1)
    return {
        'example_id': list(batch['example_id']),
        'y': y.astype('float32'),
        's': s.astype('float32'),
        'num_samples': np.asarray(num_samples, dtype='int32'),
    }


def prepare_dataset(dataset, batch_size=4, segment_length=32000,
                    shuffle=True, prefetch=True):
    if segment_length is not None and segment_length > 0:
        segmenter = Segmenter(
            length=segment_length,
            include_keys=('observation', 'speech_source'),
            copy_keys=('example_id',),
            anchor='random' if shuffle else 'left',
        )
        dataset = dataset.map(segmenter).catch().unbatch()
    if shuffle:
        dataset = dataset.shuffle(buffer_size=64)
    dataset = dataset.batch(batch_size).map(post_batch_transform)
    if prefetch:
        dataset = dataset.prefetch(4, 8)
    return dataset
