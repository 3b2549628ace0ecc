"""Regression losses for (speech) signal reconstruction.

Counterpart of ``padertorch_tpu/ops/losses/regression.py`` (reference
``padertorch/ops/losses/regression.py``), the same semantics: the time axis
(last) is always mean/sum-reduced as defined per loss; ``reduction``
('mean'/'sum'/None) applies to the remaining speaker/batch axes.  All
functions are differentiable.

>>> estimate = torch.tensor([[1., 2, 3], [4, 5, 6]])
>>> target = torch.tensor([[2., 3, 4], [4, 0, 6]])
>>> round(float(mse_loss(estimate, target)), 4)
9.3333
>>> [round(float(x), 4) for x in sdr_loss(estimate, target, reduction=None)]
[-9.8528, -3.1806]
>>> round(float(si_sdr_loss(estimate, target)), 4)
-10.7099
>>> round(float(log_mse_loss(estimate, target)), 4)
0.9208
>>> round(float(log1p_mse_loss(estimate, target)), 4)
1.2711
>>> round(float(source_aggregated_sdr_loss(estimate, target)), 4)
-4.6133
"""
import torch

__all__ = [
    'mse_loss',
    'log_mse_loss',
    'sdr_loss',
    'si_sdr_loss',
    'log1p_mse_loss',
    'source_aggregated_sdr_loss',
]


def _sqnorm(x, dim=None, keepdim=False):
    x = torch.abs(x)
    if dim is None:
        return torch.sum(x * x)
    return torch.sum(x * x, dim=dim, keepdim=keepdim)


def _mse(estimate, target, dim=None):
    error = torch.abs(estimate - target)
    if dim is None:
        return torch.mean(error * error)
    return torch.mean(error * error, dim=dim)


def _get_scaling_factor(target, estimate):
    return (
        torch.sum(estimate * target, dim=-1, keepdim=True)
        / _sqnorm(target, dim=-1, keepdim=True)
    )


def _reduce(array, reduction):
    if reduction is None or reduction == 'none':
        return array
    if reduction == 'sum':
        return torch.sum(array)
    if reduction == 'mean':
        return torch.mean(array)
    raise ValueError(
        f'Unknown reduction: {reduction}. Choose from "sum", "mean".')


def _get_threshold(soft_sdr_max):
    """tau for the thresholded (soft-max'ed) SDR (Wisdom 2020)."""
    if soft_sdr_max is None:
        return None
    assert 1 < soft_sdr_max < 50, (
        f'Uncommon value for soft_sdr_max: {soft_sdr_max}')
    return 10 ** (-soft_sdr_max / 10)


def mse_loss(estimate, target, reduction='sum'):
    """MSE; time axis mean-reduced, ``reduction`` over the rest."""
    return _reduce(_mse(estimate, target, dim=-1), reduction=reduction)


def log_mse_loss(estimate, target, reduction='sum', soft_sdr_max=None):
    """log10-MSE (Heitkaemper 2019 eq. 11), optional soft SDR limit."""
    loss = _mse(estimate, target, dim=-1)
    if soft_sdr_max:
        loss = loss + _get_threshold(soft_sdr_max) * torch.mean(
            target * target, dim=-1)
    return _reduce(torch.log10(loss), reduction=reduction)


def sdr_loss(estimate, target, reduction='mean', soft_sdr_max=None):
    """Negative (scale-dependent) SDR/SNR, optional soft limit."""
    target_norm = _sqnorm(target, dim=-1)
    denominator = _sqnorm(estimate - target, dim=-1)
    if soft_sdr_max is not None:
        denominator = denominator + _get_threshold(soft_sdr_max) * target_norm
    sdr = 10 * torch.log10(target_norm / denominator)
    return -_reduce(sdr, reduction=reduction)


def si_sdr_loss(estimate, target, reduction='mean', offset_invariant=False,
                grad_stop=False, soft_sdr_max=None):
    """Negative scale-invariant SDR (TasNet paper, section 2.2.4).

    Args:
        estimate (... x T), target (... x T)
        reduction: 'mean', 'sum' or None over non-time axes.
        offset_invariant: mean-normalize first (shift+scale invariant).
        grad_stop: don't differentiate through the scaling factor.
        soft_sdr_max: soft SDR ceiling (Wisdom 2020).
    """
    assert estimate.shape == target.shape, (estimate.shape, target.shape)
    assert estimate.dim() >= 1, estimate.shape
    assert estimate.dim() == 1 or estimate.shape[-2] < 10, (
        f'Number of speakers should be small (<10, not {estimate.shape[-2]})!'
    )
    if offset_invariant:
        estimate = estimate - torch.mean(estimate, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)
    scaling_factor = _get_scaling_factor(target, estimate)
    if grad_stop:
        scaling_factor = scaling_factor.detach()
    s_target = scaling_factor * target
    return sdr_loss(
        estimate, s_target, reduction=reduction, soft_sdr_max=soft_sdr_max)


def log1p_mse_loss(estimate, target, reduction='sum'):
    """log10(1 + MSE) (von Neumann 2020 eq. 4)."""
    return _reduce(
        torch.log10(1 + _mse(estimate, target, dim=-1)),
        reduction=reduction)


def source_aggregated_sdr_loss(estimate, target, soft_sdr_max=None):
    """Source-aggregated SDR: powers summed over all axes before the ratio."""
    target_norm = _sqnorm(target)
    denominator = _sqnorm(estimate - target)
    if soft_sdr_max is not None:
        denominator = denominator + _get_threshold(soft_sdr_max) * target_norm
    sa_sdr = 10 * torch.log10(target_norm / denominator)
    return -sa_sdr
