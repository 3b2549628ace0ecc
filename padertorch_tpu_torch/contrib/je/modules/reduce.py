"""Sequence reduction/pooling modules.

Counterpart of ``padertorch_tpu/contrib/je/modules/reduce.py`` (reference
``padertorch/contrib/je/modules/reduce.py``): Sum/Mean/Max/TakeLast/AutoPool
over a masked sequence axis.
"""
import torch

from padertorch_tpu_torch.ops.sequence.mask import compute_mask

__all__ = ['Sum', 'Mean', 'Max', 'TakeLast', 'AutoPool']


class _Reduce(torch.nn.Module):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis


class Sum(_Reduce):
    def forward(self, x, seq_len=None):
        mask = compute_mask(x, seq_len, 0, self.axis)
        return (x * mask).sum(dim=self.axis)


class Mean(_Reduce):
    def forward(self, x, seq_len=None):
        mask = compute_mask(x, seq_len, 0, self.axis)
        return ((x * mask).sum(dim=self.axis)
                / torch.clamp(mask.sum(dim=self.axis), min=1))


class Max(_Reduce):
    def forward(self, x, seq_len=None):
        mask = compute_mask(x, seq_len, 0, self.axis)
        neg = torch.finfo(x.dtype).min
        return torch.where(mask > 0, x, neg).amax(dim=self.axis)


class TakeLast(_Reduce):
    """The last valid step of each sequence.

    >>> x = torch.arange(12.).reshape(2, 3, 2)
    >>> TakeLast(axis=1)(x, [2, 3]).tolist()
    [[2.0, 3.0], [10.0, 11.0]]
    """

    def forward(self, x, seq_len=None):
        axis = self.axis % x.dim()
        if seq_len is None:
            return x.select(axis, -1)
        idx = torch.as_tensor(seq_len, device=x.device).long() - 1  # (B,)
        moved = x.movedim(axis, 1)  # (B, T, ...)
        idx = idx.reshape((-1, 1) + (1,) * (moved.dim() - 2)).expand(
            -1, 1, *moved.shape[2:])
        return torch.gather(moved, 1, idx)[:, 0]


class AutoPool(_Reduce):
    """Learned softmax pooling (McFee 2018). Reference: reduce.py:93."""

    def __init__(self, n_classes, axis=-1, alpha0=0.0, trainable=True):
        super().__init__(axis)
        self.alpha = torch.nn.Parameter(
            torch.full((n_classes,), float(alpha0)),
            requires_grad=trainable)

    def forward(self, x, seq_len=None):
        """x: (..., n_classes, T) with axis=-1 (default)."""
        axis = self.axis % x.dim()
        mask = compute_mask(x, seq_len, 0, axis)
        logits = x * self.alpha[:, None] if axis == x.dim() - 1 else x
        neg = torch.finfo(x.dtype).min
        weights = torch.softmax(
            torch.where(mask > 0, logits, neg), dim=axis)
        return (x * weights * mask).sum(dim=axis)
