"""Mask estimator for speech enhancement / beamforming.

Counterpart of ``padertorch_tpu/models/mask_estimator.py`` (reference
``contrib/examples/speech_enhancement/mask_estimator/model.py``;
SimpleMaskEstimator: Normalization + BLSTM + FF stack -> speech and noise
masks, trained with binary cross entropy against ideal masks).  On the
card the BLSTM runs the ``lstm_cell_scan`` kernels.
"""
import torch

from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch import nn
from padertorch_tpu_torch.modules.normalization import Normalization
from padertorch_tpu_torch.modules.recurrent import LSTM
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP

__all__ = ['SimpleMaskEstimator', 'binary_cross_entropy']


def binary_cross_entropy(prediction, target, eps=1e-7):
    """Mean elementwise BCE on probabilities clipped to ``[eps, 1 - eps]``.

    ``F.binary_cross_entropy`` clamps the log at -100 instead, another
    function.  The clip is ``minimum(maximum(p, eps), 1 - eps)`` as
    ``jnp.clip``: at a bound both packages split the gradient evenly.

    >>> p = torch.tensor([0.0, 1.0, 0.5])
    >>> round(float(binary_cross_entropy(p, torch.tensor([0., 1, 1]))), 4)
    0.231
    """
    low = torch.tensor(eps, dtype=prediction.dtype, device=prediction.device)
    high = torch.tensor(1 - eps, dtype=prediction.dtype,
                        device=prediction.device)
    p = torch.minimum(torch.maximum(prediction, low), high)
    return -torch.mean(target * torch.log(p) + (1 - target) * torch.log(1 - p))


class SimpleMaskEstimator(Model):
    """Norm + BLSTM + FF mask estimator (CHiME-style).

    forward input: dict with ``observation_abs`` (B, T, F) and optional
    ``num_frames`` (B,); review targets: ``speech_mask_target`` /
    ``noise_mask_target``.
    """

    def __init__(self, num_features, num_units=1024, dropout=0.5,
                 activation='elu'):
        super().__init__()
        self.num_features = num_features
        self.norm = Normalization(
            'btf', (1, 1, num_features), statistics_axis='t',
            independent_axis='f', batch_axis='b', sequence_axis='t')
        self.blstm = LSTM(
            num_features, num_units // 4, bidirectional=True)
        self.drop1 = nn.Dropout(dropout)
        self.lin1 = nn.Linear((num_units // 4) * 2, num_units)
        self.act1 = ACTIVATION_FN_MAP[activation]()
        self.drop2 = nn.Dropout(dropout)
        self.lin2 = nn.Linear(num_units, num_units)
        self.act2 = ACTIVATION_FN_MAP[activation]()
        self.lin_out = nn.Linear(num_units, 2 * num_features)

    def forward(self, batch):
        x = batch['observation_abs']
        seq_len = batch.get('num_frames')
        h = self.norm(x, sequence_lengths=seq_len)
        h, _ = self.blstm(h, seq_lens=seq_len)
        h = self.act1(self.lin1(self.drop1(h)))
        h = self.act2(self.lin2(self.drop2(h)))
        out = torch.sigmoid(self.lin_out(h))
        return dict(
            speech_mask_prediction=out[..., :self.num_features],
            noise_mask_prediction=out[..., self.num_features:],
        )

    def review(self, batch, output):
        noise_mask_loss = binary_cross_entropy(
            output['noise_mask_prediction'], batch['noise_mask_target'])
        speech_mask_loss = binary_cross_entropy(
            output['speech_mask_prediction'], batch['speech_mask_target'])
        review = dict(loss=noise_mask_loss + speech_mask_loss)
        if self.create_snapshot:
            review['snapshots'] = {
                'speech_mask': output['speech_mask_prediction'][0],
                'noise_mask': output['noise_mask_prediction'][0],
                'observed_stft': batch['observation_abs'][0],
                'speech_mask_target': batch['speech_mask_target'][0],
                'noise_mask_target': batch['noise_mask_target'][0],
            }
        return review

    def modify_summary(self, summary):
        from padertorch_tpu_torch.summary.tbx_utils import (
            mask_to_image, stft_to_image,
        )
        snapshots = summary['snapshots']
        for key in list(snapshots):
            value = snapshots.pop(key)
            if 'stft' in key:
                summary['images'][key] = stft_to_image(value)
            else:
                summary['images'][key] = mask_to_image(value)
        return super().modify_summary(summary)
