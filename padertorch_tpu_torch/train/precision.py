"""Mixed-precision training policy (bfloat16 compute, float32 masters).

Counterpart of ``padertorch_tpu/train/precision.py``.  The trainer holds
float32 *master* parameters and optimizer moments, while the forward and
backward pass run in ``compute_dtype`` (default bfloat16; no loss scaling,
since bf16 keeps float32's exponent range):

- floating example leaves are cast to ``compute_dtype`` before
  ``forward`` (``cast_examples``);
- every floating parameter is replaced, for the forward, by its cast: the
  cast is the first differentiable operation on the master, so **the
  gradients land in float32** on the masters and clipping and the
  optimizer update run in float32;
- floating buffers are cast for the forward too (``cast_buffers``); a
  buffer the forward changes (running statistics, in place or by
  assignment) is written back to the module in its master dtype, so state
  never degrades across steps; one the forward leaves alone keeps its
  master;
- the trainer casts the loss to float32 before the backward.

This is the JAX package's contract, not ``torch.autocast``'s per-operation
cast lists: every floating operand of the model is in ``compute_dtype``.
Usage::

    Trainer(model, storage_dir, optimizer, precision='bfloat16')
    Trainer(..., precision=Precision('bfloat16', cast_examples=False))

>>> import torch
>>> p = Precision()
>>> tree = {'w': torch.ones(2), 'i': torch.arange(2)}
>>> cast = p.cast_floating(tree)
>>> cast['w'].dtype, cast['i'].dtype
(torch.bfloat16, torch.int64)
>>> restored = p.restore_dtypes(cast, tree)
>>> restored['w'].dtype, restored['i'].dtype
(torch.float32, torch.int64)
"""
from contextlib import contextmanager

import numpy as np
import torch

from padertorch_tpu_torch.utils.nested import nested_op

__all__ = ['Precision']


def _to_dtype(dtype):
    """'bfloat16', a numpy or torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).rsplit('.', 1)[-1])


def _is_float(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    if isinstance(leaf, np.ndarray):
        return np.issubdtype(leaf.dtype, np.floating)
    return isinstance(leaf, (float, np.floating))


class Precision:
    """Cast policy for mixed-precision train and validation steps.

    Args:
        compute_dtype: dtype of the forward and backward ('bfloat16').
        cast_examples: also cast floating example leaves (inputs).  Turn
            off when the model's front end needs float32 inputs and casts
            down itself.
        cast_buffers: also cast floating buffers (running statistics) for
            the forward.  The module's buffers keep their own dtype either
            way.
    """

    def __init__(self, compute_dtype='bfloat16', cast_examples=True,
                 cast_buffers=True):
        self.compute_dtype = _to_dtype(compute_dtype)
        self.cast_examples = cast_examples
        self.cast_buffers = cast_buffers

    def cast_floating(self, tree):
        """Cast floating (real) leaves to ``compute_dtype``: tensors,
        numpy arrays and Python floats become tensors of that dtype.
        Integer, bool and complex leaves pass through unchanged."""
        def cast(leaf):
            if not _is_float(leaf):
                return leaf
            return torch.as_tensor(leaf).to(self.compute_dtype)
        return nested_op(cast, tree)

    def restore_dtypes(self, tree, like):
        """Cast ``tree``'s tensor leaves back to the dtypes of ``like``."""
        def restore(leaf, ref):
            dtype = getattr(ref, 'dtype', None)
            if not isinstance(leaf, torch.Tensor) or dtype is None:
                return leaf
            dtype = _to_dtype(dtype)
            return leaf if leaf.dtype == dtype else leaf.to(dtype)
        return nested_op(restore, tree, like)

    @contextmanager
    def cast_module(self, module):
        """Within the body ``module`` computes in ``compute_dtype``: each
        floating parameter is replaced by its cast (a differentiable
        operation, so gradients reach the float32 master), and with
        ``cast_buffers`` each floating buffer by its cast.  On exit the
        masters are put back; a buffer that the body changed, in place or
        by assignment, replaces its master, cast to the master's dtype."""
        swapped = []     # (owner dict, name, master, cast copy, version)
        for sub in module.modules():
            for store, cast in ((sub._parameters, True),
                                (sub._buffers, self.cast_buffers)):
                for name, master in list(store.items()):
                    if (not cast or master is None
                            or not master.is_floating_point()
                            or master.dtype == self.compute_dtype):
                        continue
                    copy = master.to(self.compute_dtype)
                    swapped.append((store, name, master, copy,
                                    copy._version))
                    store[name] = copy
        try:
            yield module
        finally:
            for store, name, master, copy, version in swapped:
                current = store[name]
                changed = current is not copy or copy._version != version
                if changed and not isinstance(master, torch.nn.Parameter):
                    # a buffer the body changed: keep the change
                    store[name] = current.detach().to(master.dtype)
                else:
                    store[name] = master

    def __repr__(self):
        return (f'{type(self).__name__}('
                f'compute_dtype={str(self.compute_dtype).split(".")[-1]!r}, '
                f'cast_examples={self.cast_examples}, '
                f'cast_buffers={self.cast_buffers})')
