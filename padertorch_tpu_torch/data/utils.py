"""Collate and padding utilities. Reference parity: ``padertorch/data/utils.py``.

Copy of ``padertorch_tpu/data/utils.py``.
"""
import dataclasses

import numpy as np

__all__ = ['collate_fn', 'pad_tensor', 'pad_batch', 'pad_to_multiple']


def pad_tensor(vec, pad, axis):
    """Zero-pad ``vec`` to size ``pad`` along ``axis``.

    Reference parity: ``data/utils.py:5``.

    >>> pad_tensor(np.ones((2, 3)), 5, axis=1).shape
    (2, 5)
    """
    pad_width = [(0, 0)] * vec.ndim
    pad_width[axis] = (0, pad - vec.shape[axis])
    return np.pad(vec, pad_width, mode='constant')


def collate_fn(batch):
    """Move the list axis inside dicts/dataclasses recursively.

    Reference parity: ``data/utils.py:21``.

    >>> collate_fn([{'a': 1}, {'a': 2}])
    {'a': [1, 2]}
    >>> collate_fn(({'a': 1}, {'a': 2}))
    {'a': (1, 2)}
    >>> collate_fn([{'a': {'b': [1, 2]}}, {'a': {'b': [3, 4]}}])
    {'a': {'b': [[1, 2], [3, 4]]}}
    >>> Point = dataclasses.make_dataclass('Point', ['x', 'y'])
    >>> collate_fn([Point(1, 2), Point(3, 4)])
    Point(x=[1, 3], y=[2, 4])
    """
    assert isinstance(batch, (tuple, list)), (type(batch), batch)
    first = batch[0]
    if isinstance(first, dict):
        for b in batch[1:]:
            assert first.keys() == b.keys(), batch
        return first.__class__({
            k: collate_fn(batch.__class__([b[k] for b in batch]))
            for k in first
        })
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        for b in batch[1:]:
            assert type(first) is type(b), batch
        return first.__class__(**{
            f.name: collate_fn(
                batch.__class__([getattr(b, f.name) for b in batch]))
            for f in dataclasses.fields(first)
        })
    return batch


def pad_to_multiple(length, multiple, minimum=None):
    """Round ``length`` up to a multiple (static-shape bucketing helper).

    XLA compiles one program per distinct shape; padding sequence lengths
    to multiples bounds the number of compilations.

    >>> pad_to_multiple(130, 64)
    192
    """
    padded = -(-length // multiple) * multiple
    if minimum is not None:
        padded = max(padded, minimum)
    return padded


def pad_batch(arrays, axis=0, pad_to=None, multiple=None):
    """Stack variable-length arrays with zero padding; returns (stack, lens).

    The TPU-native replacement for PackedSequence construction: padded
    static shapes + a length vector (consumed by ``ops.compute_mask``).

    >>> stack, lens = pad_batch([np.ones(3), np.ones(5)])
    >>> stack.shape, lens.tolist()
    ((2, 5), [3, 5])
    >>> stack, lens = pad_batch([np.ones(3), np.ones(5)], multiple=4)
    >>> stack.shape
    (2, 8)
    """
    lens = np.array([a.shape[axis] for a in arrays])
    target = pad_to if pad_to is not None else int(lens.max())
    if multiple is not None:
        target = pad_to_multiple(target, multiple)
    padded = [pad_tensor(a, target, axis) for a in arrays]
    return np.stack(padded), lens
