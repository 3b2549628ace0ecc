"""Moving a (nested) numpy example to a torch device, and sorting a batch.

Counterpart of ``padertorch_tpu/data/batch.py`` ``example_to_device`` and
``Sorter``.
"""
import operator

import numpy as np
import torch

from padertorch_tpu_torch.utils.nested import nested_op

__all__ = ['example_to_device', 'Sorter']


def example_to_device(example, device):
    """Numpy arrays (and tensors) of a nested example -> tensors on
    ``device``; every other leaf (ids, strings, ints) stays as it is.

    >>> ex = example_to_device({'x': np.ones(2), 'id': ['a']}, 'cpu')
    >>> ex['x'].dtype, ex['id']
    (torch.float64, ['a'])
    """
    def move(leaf):
        if isinstance(leaf, np.ndarray) and leaf.dtype.kind in 'biuf':
            return torch.from_numpy(leaf).to(device)
        if isinstance(leaf, torch.Tensor):
            return leaf.to(device)
        return leaf
    return nested_op(move, example)


class Sorter:
    """Sort a batch (list of examples) by a key, longest first.

    Reference parity: ``data/batch.py:134`` (there used so PackedSequence
    gets decreasing lengths; here it keeps padding tight).

    >>> batch = [{'num_samples': 2}, {'num_samples': 5}, {'num_samples': 3}]
    >>> [e['num_samples'] for e in Sorter('num_samples')(batch)]
    [5, 3, 2]
    """

    def __init__(self, key='num_samples', reverse=True):
        if callable(key):
            self.key = key
        else:
            self.key = operator.itemgetter(key)
        self.reverse = reverse

    def __call__(self, examples):
        return tuple(sorted(examples, key=self.key, reverse=self.reverse))
