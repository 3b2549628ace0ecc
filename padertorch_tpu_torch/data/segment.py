"""Chunk long utterances into fixed-length segments (host-side pipeline).

Counterpart of ``padertorch_tpu/data/segment.py`` (reference
``padertorch/data/segment.py``): ``Segmenter`` with anchor modes
(left/right/center/centered_cutout/random/random_max_segments), length
modes (max/min/constant), optional end padding, and ``FilterException``
for too-short utterances.  All numpy; the JAX package's native framing
routine for float32 audio is not carried over, ``segment_axis`` frames
every input with one ``np.take``.
"""
from copy import copy
from typing import Union, List

import numpy as np

from padertorch_tpu_torch.data.dataset import FilterException
from padertorch_tpu_torch.utils.nested import flatten, deflatten

__all__ = [
    'Segmenter',
    'segment',
    'segment_axis',
    'get_anchor',
    'get_segment_boundaries',
]

possible_anchor_modes = [
    'left', 'right', 'center', 'centered_cutout', 'random',
    'random_max_segments',
]
possible_segment_modes = ['constant', 'max', 'min']


def to_list(x, length=None):
    """Coerce ``x`` to a list, optionally broadcasting a scalar to ``length``.

    >>> to_list(1, 3)
    [1, 1, 1]
    >>> to_list((1, 2))
    [1, 2]
    >>> to_list('ab')
    ['ab']
    """
    if isinstance(x, list):
        pass
    elif isinstance(x, (tuple, range)):
        x = list(x)
    elif isinstance(x, (str, bytes)):
        x = [x]
    else:
        try:
            iter(x)
        except TypeError:
            x = [x]
        else:
            x = list(x)
    if length is not None:
        if len(x) == 1:
            x = x * length
        elif len(x) != length:
            raise ValueError(
                f'Expected list of length {length}, got {len(x)}: {x!r}')
    return x


def _get_rand_int(rng, *args, **kwargs):
    if hasattr(rng, 'randint'):
        return int(rng.randint(*args, **kwargs))
    return int(rng.integers(*args, **kwargs))


def segment_axis(x, length, shift, axis=-1, end='cut', pad_value=0):
    """Segment an array along an axis into overlapping frames.

    (The subset of ``paderbox.array.segment_axis`` the segmenter needs:
    ``end`` in {'cut', 'pad'}.)

    >>> segment_axis(np.arange(10), 4, 2, end='cut')
    array([[0, 1, 2, 3],
           [2, 3, 4, 5],
           [4, 5, 6, 7],
           [6, 7, 8, 9]])
    >>> segment_axis(np.arange(7), 4, 2, end='pad')
    array([[0, 1, 2, 3],
           [2, 3, 4, 5],
           [4, 5, 6, 0]])
    """
    x = np.asarray(x)
    axis = axis % x.ndim
    n = x.shape[axis]
    if end == 'pad':
        if n < length:
            n_frames = 1
        else:
            n_frames = -(-(n - length) // shift) + 1
        needed = (n_frames - 1) * shift + length
        if needed > n:
            pad_width = [(0, 0)] * x.ndim
            pad_width[axis] = (0, needed - n)
            x = np.pad(x, pad_width, constant_values=pad_value)
            n = needed
    elif end == 'cut':
        assert n >= length, (n, length)
        n_frames = (n - length) // shift + 1
    else:
        raise ValueError(end)
    idx = np.arange(n_frames)[:, None] * shift + np.arange(length)[None, :]
    return np.moveaxis(np.take(x, idx, axis=axis), axis, 0) \
        if axis != 0 else np.take(x, idx, axis=0)


def get_anchor(num_samples, length, shift=None, mode='left', rng=np.random):
    """Anchor (first value of a segment) for the chosen mode.

    Reference parity: ``data/segment.py:347``.

    >>> np.random.seed(3)
    >>> get_anchor(24, 10, 3, mode='left')
    0
    >>> get_anchor(24, 10, 3, mode='right')
    14
    >>> get_anchor(24, 10, 3, mode='center')
    12
    >>> get_anchor(24, 10, 3, mode='centered_cutout')
    1
    """
    assert num_samples >= length, (num_samples, length)
    if shift is None:
        shift = length
    assert shift > 0, shift
    if mode == 'left':
        return 0
    if mode == 'right':
        return num_samples - length
    if mode == 'center':
        return num_samples // 2
    if mode == 'centered_cutout':
        remainder = (num_samples - length) % shift
        return remainder // 2
    if mode == 'random':
        return _get_rand_int(rng, num_samples - length + 1)
    if mode == 'random_max_segments':
        start = _get_rand_int(rng, (num_samples - length) % shift + 1)
        anchors = np.arange(start, num_samples - length + 1, shift)
        # draw from the PASSED rng — np.random.choice would read (and
        # mutate) global RNG state, breaking seeded reproducibility
        return int(anchors[_get_rand_int(rng, len(anchors))])
    raise ValueError('Unknown mode', mode, 'choose one of',
                     possible_anchor_modes)


def _get_segment_length_for_mode(num_samples, length, shift=None,
                                 mode='constant', padding=False):
    """Adapt (length, shift, num_samples) per length mode.

    Reference parity (incl. doctest values): ``data/segment.py:517``.

    >>> _get_segment_length_for_mode(16000, 950, 250, 'max', True)
    (947, 247, 16014)
    >>> _get_segment_length_for_mode(16000, 950, 250, 'min', False)
    (950, 250, 16000)
    """
    if shift is None:
        shift = length
    if mode == 'constant':
        if padding:
            remainder = (num_samples - length) % shift
            if remainder > 0:
                num_samples += shift - remainder
        return length, shift, num_samples
    if mode in ('min', 'max'):
        overlap = length - shift
        if mode == 'max':
            n = (num_samples - overlap - 1) // shift + 1
            if padding:
                length = (num_samples - 1 - overlap) // n + 1 + overlap
            else:
                length = (num_samples - overlap) // n + overlap
        else:
            n = (num_samples - overlap) // shift
            if padding:
                delta = ((num_samples - overlap) % shift - 1) // n + 1
            else:
                delta = ((num_samples - overlap) % shift) // n
            length = length + delta
        shift = length - overlap
        if padding:
            num_samples = (n - 1) * shift + length
        return length, shift, num_samples
    raise ValueError(mode, possible_segment_modes)


def get_segment_boundaries(num_samples, length, shift=None, anchor='left',
                           mode='constant', rng=np.random):
    """B x 2 array of (start, stop) segment boundaries.

    >>> np.random.seed(3)
    >>> get_segment_boundaries(24, 10, 3, anchor='left').T
    array([[ 0,  3,  6,  9, 12],
           [10, 13, 16, 19, 22]])
    >>> get_segment_boundaries(24, 10, 3, anchor='right').T
    array([[ 2,  5,  8, 11, 14],
           [12, 15, 18, 21, 24]])
    """
    if shift is None:
        shift = length
    assert shift > 0, shift
    assert mode in possible_segment_modes, mode
    if isinstance(anchor, str):
        # mode='max' legally SHRINKS length for utterances shorter
        # than the nominal segment (down to one segment covering
        # everything) — the too-short check must therefore run AFTER
        # the mode adaptation, not before (a leading assert here used
        # to crash 'max' mode with a bare AssertionError on exactly
        # the inputs the Segmenter's FilterException check exempts)
        length, shift, num_samples = _get_segment_length_for_mode(
            num_samples, length, shift, mode)
        assert num_samples >= length, (num_samples, length)
        anchor = get_anchor(num_samples, length, shift, mode=anchor,
                            rng=rng)
    else:
        assert num_samples >= length, (num_samples, length)
    assert isinstance(anchor, int), (anchor, type(anchor))
    start = anchor % shift
    start = np.arange(start, num_samples - length + 1, shift)
    stop = start + length
    return np.stack([start, stop], axis=-1)


def segment(x, length, shift=None, anchor='left', axis=-1, mode='constant',
            padding=False, rng=np.random):
    """Segment a signal along an axis; segments stacked on a new axis 0.

    >>> np.random.seed(3)
    >>> segment(np.arange(0, 15), 10, 3, anchor='left')
    array([[ 0,  1,  2,  3,  4,  5,  6,  7,  8,  9],
           [ 3,  4,  5,  6,  7,  8,  9, 10, 11, 12]])
    """
    if padding:
        assert anchor in [0, 'left'], (padding, anchor)
        end = 'pad'
    else:
        end = 'cut'
    x = np.asarray(x)
    axis = axis % x.ndim
    num_samples = x.shape[axis]
    assert num_samples >= length, (num_samples, length)
    assert mode in possible_segment_modes, mode
    length, shift, num_samples = _get_segment_length_for_mode(
        num_samples, length, shift, mode)
    assert shift > 0, shift
    if isinstance(anchor, str):
        anchor = get_anchor(num_samples, length, shift, mode=anchor,
                            rng=rng)
    assert isinstance(anchor, int), (anchor, type(anchor))
    start = anchor % shift
    slc = [slice(None)] * x.ndim
    slc[axis] = slice(start, None)
    x = x[tuple(slc)]
    return segment_axis(x, length, shift, end=end, axis=axis)


class Segmenter:
    """Segment the arrays of an example dict; returns a list of examples.

    Reference parity: ``data/segment.py:24``.  Examples shorter than
    ``length`` raise ``FilterException`` (use ``dataset.catch()``).
    Adds ``segment_start`` / ``segment_stop`` to each output example.

    >>> segmenter = Segmenter(length=32000, include_keys=('x', 'y'),
    ...                       shift=16000)
    >>> ex = {'x': np.arange(65000), 'y': np.arange(65000),
    ...       'num_samples': 65000, 'gender': 'm'}
    >>> segmented = segmenter(ex)
    >>> [e['x'][0] for e in segmented]
    [np.int64(0), np.int64(16000), np.int64(32000)]
    >>> segmented[0]['gender']
    'm'
    >>> sorted(Segmenter(length=-1, include_keys=('x', 'y'))(ex)[0].keys())
    ['gender', 'num_samples', 'segment_start', 'segment_stop', 'x', 'y']
    """

    def __init__(self, length: int = -1, shift: int = None,
                 include_keys: Union[str, list, tuple] = None,
                 exclude_keys: Union[str, list, tuple] = None,
                 copy_keys: Union[str, bool, list, tuple] = True,
                 axis: Union[int, list, tuple, dict] = -1,
                 anchor: Union[int, str] = 'left',
                 mode: str = 'constant',
                 padding: bool = False,
                 flatten_separator: str = '.'):
        self.include = None if include_keys is None \
            else to_list(include_keys)
        self.exclude = [] if exclude_keys is None else to_list(exclude_keys)
        self.length = length
        if isinstance(axis, (dict, int)):
            self.axis = axis
            if isinstance(axis, dict):
                assert self.include is not None
                assert set(axis.keys()) == set(self.include)
        elif isinstance(axis, (tuple, list)):
            self.axis = to_list(axis)
            assert self.include is not None
            assert len(axis) == len(self.include)
        else:
            raise TypeError('Unknown type for axis', axis)
        if shift is None:
            shift = length
        assert shift <= length, (shift, length)
        self.shift = shift
        assert isinstance(anchor, (str, int)), anchor
        self.anchor = anchor
        self.copy_keys = to_list(copy_keys)
        assert all(isinstance(k, (bool, str)) for k in self.copy_keys)
        assert mode in possible_segment_modes, mode
        self.mode = mode
        if padding:
            assert anchor in [0, 'left'], (padding, anchor)
        self.padding = padding
        self.flatten_separator = flatten_separator

    def get_to_segment_keys(self, example):
        if self.include is not None:
            keys = []
            for inc in self.include:
                matches = [
                    k for k in example
                    if k == inc or k.startswith(
                        inc + self.flatten_separator)
                ]
                assert matches, (inc, sorted(example.keys()))
                keys.extend(matches)
        else:
            keys = [k for k in example
                    if isinstance(example[k], np.ndarray)]
        return [k for k in keys if k not in self.exclude]

    def get_axis_list(self, to_segment_keys):
        if isinstance(self.axis, int):
            return [self.axis] * len(to_segment_keys)
        if isinstance(self.axis, dict):
            return [
                self.axis[k.split(self.flatten_separator)[0]]
                if k not in self.axis else self.axis[k]
                for k in to_segment_keys
            ]
        assert self.include is not None
        axis_map = dict(zip(self.include, self.axis))
        return [
            axis_map.get(k, axis_map[k.split(self.flatten_separator)[0]])
            for k in to_segment_keys
        ]

    def __call__(self, example: dict, rng=np.random) -> List[dict]:
        example = flatten(example, sep=self.flatten_separator)
        to_segment_keys = self.get_to_segment_keys(example)
        axis = self.get_axis_list(to_segment_keys)
        to_segment = {key: example.pop(key) for key in to_segment_keys}

        if all(isinstance(k, str) for k in self.copy_keys):
            to_copy = {key: example.pop(key) for key in self.copy_keys}
        elif self.copy_keys[0] is True:
            assert len(self.copy_keys) == 1, self.copy_keys
            to_copy = example
        elif self.copy_keys[0] is False:
            assert len(self.copy_keys) == 1, self.copy_keys
            to_copy = dict()
        else:
            raise TypeError('Unknown type for copy keys', self.copy_keys)

        if any(not isinstance(v, np.ndarray) for v in to_segment.values()):
            raise ValueError(
                'This segmenter only works on numpy arrays. '
                'The following keys point to other types: '
                + '\n'.join(
                    f'{k} points to a {type(to_segment[k])}'
                    for k in to_segment_keys))

        lengths = [v.shape[axis[i]]
                   for i, v in enumerate(to_segment.values())]
        assert lengths[1:] == lengths[:-1], (
            'All entries to segment must have equal size along their '
            f'segment axis! keys: {to_segment_keys}, lengths: {lengths}')
        assert len(to_segment) > 0, (self.include, self.exclude)
        to_segment_length = lengths[0]

        if to_segment_length < self.length:
            if self.mode != 'max':
                raise FilterException()
            # 'max' shrinks the segment instead — but only while the
            # utterance still exceeds the fixed overlap (shorter and
            # no valid segmentation exists; the adaptation would
            # divide by a non-positive segment count)
            shift = self.length if self.shift in (None, -1) \
                else self.shift
            if to_segment_length <= self.length - shift:
                raise FilterException()

        if self.length == -1:
            to_copy.update(to_segment)
            to_copy.update(segment_start=0, segment_stop=to_segment_length)
            return [deflatten(to_copy, sep=self.flatten_separator)]

        boundaries, segmented = self.segment(
            to_segment, to_segment_length, axis=axis, rng=rng)

        segmented_examples = []
        for idx, (start, stop) in enumerate(boundaries):
            example_copy = copy(to_copy)
            example_copy.update({
                key: value[idx] for key, value in segmented.items()})
            example_copy.update(
                segment_start=int(start), segment_stop=int(stop))
            segmented_examples.append(
                deflatten(example_copy, sep=self.flatten_separator))
        return segmented_examples

    def segment(self, to_segment, to_segment_length, axis=-1,
                rng=np.random):
        """Returns (boundaries, {key: stacked segments})."""
        axis = to_list(axis, len(to_segment))
        boundaries = get_segment_boundaries(
            num_samples=to_segment_length, length=self.length,
            shift=self.shift, anchor=self.anchor, mode=self.mode,
            rng=rng)
        if self.padding:
            # extend to cover the padded tail
            length, shift, padded = _get_segment_length_for_mode(
                to_segment_length, self.length, self.shift, self.mode,
                padding=True)
            start = np.arange(0, padded - length + 1, shift)
            boundaries = np.stack([start, start + length], axis=-1)
        segmented = {}
        for i, (key, value) in enumerate(to_segment.items()):
            ax = axis[i] % value.ndim
            segs = []
            for start, stop in boundaries:
                slc = [slice(None)] * value.ndim
                slc[ax] = slice(start, stop)
                seg = value[tuple(slc)]
                if seg.shape[ax] < (stop - start):
                    pad_width = [(0, 0)] * value.ndim
                    pad_width[ax] = (0, (stop - start) - seg.shape[ax])
                    seg = np.pad(seg, pad_width)
                segs.append(seg)
            segmented[key] = np.stack(segs)
        return boundaries, segmented
