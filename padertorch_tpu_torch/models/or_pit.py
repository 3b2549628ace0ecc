"""One-and-Rest PIT recursive source separation.

Counterpart of ``padertorch_tpu/models/or_pit.py`` (reference
``contrib/examples/source_separation/or_pit/model.py``; Takahashi 2019:
separate one speaker and the sum of the rest, then recurse on the rest).

Training is one separator step with the OR-PIT loss (all K candidate
assignments of the batch evaluated at once, the smallest kept per
example); inference unrolls the separator ``num_speakers - 1`` or
``max_iterations`` times.  On the card the default DPRNN separator runs
the ``lstm_cell_scan`` kernels.
"""
import numpy as np
import torch

from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.models.tasnet import TasNet, _masked_si_sdr
from padertorch_tpu_torch.modules.dual_path_rnn import _length_mask

__all__ = ['one_and_rest_permutation_invariant_loss', 'OneAndRestPIT']


def one_and_rest_permutation_invariant_loss(inputs, targets, loss_fn):
    """OR-PIT loss for one example (no batch axis).

    Args:
        inputs: (2, T) — the single-speaker estimate and the rest estimate.
        targets: (K, T) with K >= 1.
        loss_fn: callable(estimate (T,), target (T,)) -> scalar.

    Returns:
        (min_loss, argmin_index) — index of the target matched as 'one';
        of equal candidates the first, as ``jnp.argmin`` picks.

    >>> t = torch.stack([torch.ones(8), 2 * torch.ones(8)])
    >>> est = torch.stack([2 * torch.ones(8), torch.ones(8)])
    >>> loss, idx = one_and_rest_permutation_invariant_loss(
    ...     est, t, lambda e, tg: torch.mean((e - tg) ** 2))
    >>> float(loss), int(idx)
    (0.0, 1)
    """
    total = torch.sum(targets, dim=0)
    candidates = torch.stack([
        loss_fn(inputs[0], targets[i])
        + loss_fn(inputs[1], total - targets[i])
        for i in range(targets.shape[0])
    ])
    idx = torch.argmin(candidates)
    return candidates[idx], idx


class OneAndRestPIT(Model):
    """Recursive separator built on a 2-output TasNet.

    forward input: ``y`` (B, T), ``num_samples``; review uses ``s``
    (B, K, T).
    """

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['separator'] = {
            'factory': TasNet,
            'num_speakers': 2,
        }

    def __init__(self, separator: TasNet, max_iterations=2,
                 loss='si-sdr'):
        super().__init__()
        assert separator.num_speakers == 2, separator.num_speakers
        self.separator = separator
        self.max_iterations = max_iterations
        self.loss_name = loss

    def example_to_device(self, example, device=None):
        """As the separator's: ``num_samples`` stays on the host."""
        return self.separator.example_to_device(example, device)

    def _forward_step(self, batch):
        estimates = self.separator(batch)['out']  # (B, 2, T)
        return estimates[:, 0], estimates[:, 1]

    def forward(self, batch):
        one, rest = self._forward_step(batch)
        return {'one': one, 'rest': rest}

    def separate(self, batch, num_speakers=None):
        """Recursive inference: returns (B, K, T) estimates.

        Unrolls ``max_iterations`` separator steps; with
        ``num_speakers=k`` the recursion stops after k-1 splits.
        """
        iterations = (num_speakers - 1) if num_speakers \
            else self.max_iterations
        outputs = []
        current = batch
        rest = None
        for _ in range(iterations):
            one, rest = self._forward_step(current)
            outputs.append(one)
            current = dict(current)
            current['y'] = rest
        outputs.append(rest)
        return torch.stack(outputs, dim=1)

    def review(self, batch, outputs):
        s = batch['s']  # (B, K, T)
        one = outputs['one']
        rest = outputs['rest']
        t = one.shape[-1]
        num_samples = batch.get('num_samples')
        if num_samples is None:
            num_samples = np.full((s.shape[0],), t)
        # (B, 1, T): the masked negative SI-SDR with the reference's 1e-10
        # clamps, per example
        mask = _length_mask(num_samples, t, one.device, one.dtype)[:, None]
        targets = s[..., :t]
        total = torch.sum(targets, dim=1, keepdim=True)
        candidates = torch.stack([
            _masked_si_sdr(one[:, None], targets[:, i:i + 1], mask)
            + _masked_si_sdr(rest[:, None], total - targets[:, i:i + 1],
                             mask)
            for i in range(targets.shape[1])])              # (K, B)
        idx = torch.argmin(candidates, dim=0)
        loss = torch.gather(candidates, 0, idx[None])[0]
        return {'loss': torch.mean(loss)}
