"""Axis-flexible normalization with sequence-mask-aware statistics.

Counterpart of ``padertorch_tpu/modules/normalization.py`` (reference
``padertorch/modules/normalization.py:8,248``): ``data_format`` strings
('bcft' etc.), running mean/power buffers with momentum or cumulative
averaging, learnable gamma/beta per independent axis, freeze/unfreeze,
``inverse``.  The running statistics are buffers (``num_tracked_values``,
``running_mean``, ``running_power``) under the names the JAX module's
``state_dict()`` gives them; autograd differentiates the normalize
expression (the reference's hand-derived backward saved memory only).
"""
import torch

from padertorch_tpu_torch.ops.sequence.mask import compute_mask

__all__ = ['Normalization', 'InputNormalization', 'normalize',
           'mask_and_compute_stats']


def mask_and_compute_stats(x, sequence_lengths, statistics_axis, batch_axis,
                           sequence_axis):
    """Masked mean/power over ``statistics_axis``; returns
    (masked_x, mask, mean, power, n_values)."""
    mask = compute_mask(x, sequence_lengths, batch_axis, sequence_axis)
    x = x * mask
    n_values = mask.sum(dim=statistics_axis, keepdim=True)
    n = torch.clamp(n_values, min=1)
    mean = x.sum(dim=statistics_axis, keepdim=True) / n
    power = (x * x).sum(dim=statistics_axis, keepdim=True) / n
    return x, mask, mean, power, n_values


def normalize(x, gamma, beta, statistics_axis, batch_axis, sequence_axis,
              sequence_lengths, shift, scale, eps):
    """Normalize; returns (y, mean, power, n_values)."""
    x, mask, mean, power, n_values = mask_and_compute_stats(
        x, sequence_lengths, statistics_axis, batch_axis, sequence_axis)
    y = x
    if shift:
        y = y - mean
        var = power - mean * mean
    else:
        var = power
    if scale:
        y = y * torch.rsqrt(torch.clamp(var, min=0) + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y * mask, mean, power, n_values


class Normalization(torch.nn.Module):
    """See module docstring; API mirrors the reference.

    >>> norm = Normalization(data_format='bct', shape=(None, 10, None),
    ...                      statistics_axis='bt', momentum=0.5)
    >>> x, seq_len = 2 * torch.ones((3, 10, 4)), [1, 2, 3]
    >>> float(norm.running_mean[0, 0, 0]), float(norm.running_power[0, 0, 0])
    (0.0, 1.0)
    >>> y = norm(x, seq_len)
    >>> float(norm.running_mean[0, 0, 0]), float(norm.running_power[0, 0, 0])
    (1.0, 2.5)
    """

    def __init__(
            self,
            data_format='bcft',
            shape=None,
            *,
            statistics_axis='bft',
            independent_axis='c',
            batch_axis='b',
            sequence_axis='t',
            shift=True,
            scale=True,
            eps: float = 1e-5,
            momentum=0.95,
    ):
        super().__init__()
        self.data_format = data_format.lower()
        self.batch_axis = None if batch_axis is None \
            else self.data_format.index(batch_axis.lower())
        self.sequence_axis = None if sequence_axis is None \
            else self.data_format.index(sequence_axis.lower())
        self.statistics_axis = tuple(
            self.data_format.index(ax.lower()) for ax in statistics_axis)
        self.shift = shift
        self.scale = scale
        self.eps = eps
        self.track_running_stats = (
            batch_axis is not None and batch_axis in statistics_axis)
        stats = {'num_tracked_values': None, 'running_mean': None,
                 'running_power': None}
        if self.track_running_stats:
            reduced_shape = [*shape]
            for ax in self.statistics_axis:
                reduced_shape[ax] = 1
            if any(d is None for d in reduced_shape):
                raise ValueError(
                    f'shape {shape} leaves an axis outside '
                    f'statistics_axis={statistics_axis!r} without a size')
            stats['num_tracked_values'] = torch.zeros(reduced_shape)
            if shift:
                stats['running_mean'] = torch.zeros(reduced_shape)
            if scale:
                stats['running_power'] = torch.ones(reduced_shape)
        for name, value in stats.items():
            self.register_buffer(name, value)
        self.momentum = momentum

        self.gamma = None
        self.beta = None
        if independent_axis is not None:
            reduced_shape = len(self.data_format) * [1]
            for ax in independent_axis:
                ax = self.data_format.index(ax.lower())
                if shape[ax] is None:
                    raise ValueError(f'shape {shape} has no size for the '
                                     f'independent axis {ax}')
                reduced_shape[ax] = shape[ax]
            if scale:
                self.gamma = torch.nn.Parameter(torch.ones(reduced_shape))
            if shift:
                self.beta = torch.nn.Parameter(torch.zeros(reduced_shape))

        self.frozen_stats = False

    @property
    def running_var(self):
        # REFERENCE PARITY, quirks included
        # (padertorch/modules/normalization.py:154-162): the Bessel
        # correction multiplies only the power term (not
        # power - mean**2), and eps is added HERE as well as again by
        # the consumers (_running_norm/inverse), so running statistics
        # carried over from the reference or the JAX package normalize
        # identically.
        n = torch.clamp(self.num_tracked_values, min=2)
        running_var = self.running_power
        if self.shift:
            running_var = n / (n - 1) * running_var - self.running_mean ** 2
        running_var = torch.clamp(running_var, min=0.0)
        return running_var + self.eps

    def reset_running_stats(self):
        if self.track_running_stats:
            self.num_tracked_values = torch.zeros_like(
                self.num_tracked_values)
            if self.shift:
                self.running_mean = torch.zeros_like(self.running_mean)
            if self.scale:
                self.running_power = torch.ones_like(self.running_power)

    def freeze(self, freeze_stats=True):
        """Stop training gamma/beta and optionally freeze the statistics."""
        for p in (self.gamma, self.beta):
            if p is not None:
                p.requires_grad_(False)
        self.frozen_stats = freeze_stats

    def unfreeze(self):
        for p in (self.gamma, self.beta):
            if p is not None:
                p.requires_grad_(True)
        self.frozen_stats = False

    def forward(self, x, sequence_lengths=None):
        if (self.training and not self.frozen_stats) \
                or not self.track_running_stats:
            y, mean, power, n_values = normalize(
                x, gamma=self.gamma, beta=self.beta,
                statistics_axis=self.statistics_axis,
                batch_axis=self.batch_axis,
                sequence_axis=self.sequence_axis,
                sequence_lengths=sequence_lengths,
                shift=self.shift, scale=self.scale, eps=self.eps,
            )
            if self.track_running_stats:
                self._update_running_stats(mean, power, n_values)
            return y
        return self._running_norm(x, sequence_lengths)

    @torch.no_grad()
    def _update_running_stats(self, mean, power, n_values):
        # new tensors, not in-place updates: a graph built earlier in the
        # step may still hold the old statistics
        self.num_tracked_values = self.num_tracked_values + n_values
        if self.momentum is None:
            # cumulative average over everything seen so far
            momentum = 1 - n_values / self.num_tracked_values
        else:
            momentum = self.momentum
        if self.shift:
            self.running_mean = (
                momentum * self.running_mean + (1 - momentum) * mean)
        if self.scale:
            self.running_power = (
                momentum * self.running_power + (1 - momentum) * power)

    def _running_norm(self, x, sequence_lengths):
        if self.shift:
            x = x - self.running_mean
        if self.scale:
            x = x * torch.rsqrt(self.running_var + self.eps)
        if self.gamma is not None:
            x = x * self.gamma
        if self.beta is not None:
            x = x + self.beta
        return x * compute_mask(
            x, sequence_lengths, self.batch_axis, self.sequence_axis)

    def inverse(self, x, sequence_lengths=None):
        if not self.track_running_stats:
            raise NotImplementedError
        if self.beta is not None:
            x = x - self.beta
        if self.gamma is not None:
            x = x / self.gamma
        if self.scale:
            x = torch.sqrt(self.running_var + self.eps) * x
        if self.shift:
            x = x + self.running_mean
        return x * compute_mask(
            x, sequence_lengths, self.batch_axis, self.sequence_axis)


class InputNormalization(Normalization):
    """Normalizes with running statistics even in training.

    Reference parity: ``modules/normalization.py:248``.  Not suited for
    hidden layers (gradients do not flow through running statistics).
    """

    def forward(self, x, sequence_lengths=None):
        if self.track_running_stats:
            if self.training and not self.frozen_stats:
                with torch.no_grad():
                    _, _, mean, power, n_values = mask_and_compute_stats(
                        x, sequence_lengths, self.statistics_axis,
                        self.batch_axis, self.sequence_axis)
                self._update_running_stats(mean, power, n_values)
            return self._running_norm(x, sequence_lengths)
        return super().forward(x, sequence_lengths)
