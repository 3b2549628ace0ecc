"""Sequence padding masks, the stand-in for PackedSequence.

Counterpart of ``padertorch_tpu/ops/sequence/mask.py`` (reference
``padertorch/ops/sequence/mask.py:4``).
"""
import torch

__all__ = ['compute_mask']


def compute_mask(x, sequence_lengths, batch_axis=0, sequence_axis=1):
    """Mask of ones at non-padded positions, broadcast to ``x.shape``.

    >>> x = 2 * torch.ones((3, 1, 10, 4))
    >>> mask = compute_mask(x, [1, 2, 3], batch_axis=0, sequence_axis=-1)
    >>> mask.shape
    torch.Size([3, 1, 10, 4])
    >>> mask[:, 0, 0].tolist()
    [[1.0, 0.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 1.0, 0.0]]

    Args:
        x: tensor to be masked.
        sequence_lengths: per-sequence lengths (list/array/tensor), or None
            for an all-ones mask.
        batch_axis: axis along which sequences are stacked.
        sequence_axis: axis that contains padding.
    """
    if sequence_lengths is None:
        return torch.ones_like(x)
    ndim = x.dim()
    batch_axis = batch_axis % ndim
    sequence_axis = sequence_axis % ndim
    lengths = torch.as_tensor(sequence_lengths, device=x.device)
    shape_l = [1] * ndim
    shape_l[batch_axis] = -1
    lengths = lengths.reshape(shape_l)
    shape_i = [1] * ndim
    shape_i[sequence_axis] = -1
    idx = torch.arange(x.shape[sequence_axis], device=x.device).reshape(
        shape_i)
    return (idx < lengths).to(x.dtype).broadcast_to(x.shape)
