"""Classification losses.  Counterpart of
``padertorch_tpu/ops/losses/classification.py`` (reference
``padertorch/ops/losses/classification.py``)."""
import torch

__all__ = ['softmax_cross_entropy', 'IGNORE_INDEX']

IGNORE_INDEX = -1


def softmax_cross_entropy(x, t):
    """Cross entropy over logits; labels equal to -1 are ignored.

    All axes but the last of ``x`` are independent: ``x: (..., K)``,
    ``t: (...)``.  The mean is taken over the non-ignored elements (torch
    ``CrossEntropyLoss(ignore_index=-1)`` semantics; all ignored gives 0).

    >>> x = torch.tensor([[10., 0.], [0., 10.]])
    >>> float(softmax_cross_entropy(x, torch.tensor([0, 1]))) < 1e-3
    True
    >>> float(softmax_cross_entropy(x, torch.tensor([0, -1]))) < 1e-3
    True
    """
    if tuple(x.shape[:-1]) != tuple(t.shape):
        raise ValueError(f'logits {tuple(x.shape)} and labels '
                         f'{tuple(t.shape)} do not fit')
    logp = torch.log_softmax(x, dim=-1)
    ignore = t == IGNORE_INDEX
    safe_t = torch.where(ignore, torch.zeros_like(t), t).long()
    picked = torch.gather(logp, -1, safe_t.unsqueeze(-1))[..., 0]
    picked = torch.where(ignore, torch.zeros_like(picked), picked)
    count = torch.clamp((~ignore).sum(), min=1)
    return -picked.sum() / count
