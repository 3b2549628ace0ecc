"""Moving a (nested) numpy example to a torch device.

Counterpart of ``padertorch_tpu/data/batch.py`` ``example_to_device``.
"""
import numpy as np
import torch

from padertorch_tpu_torch.utils.nested import nested_op

__all__ = ['example_to_device']


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
