"""uPIT BLSTM mask estimator (Kolbaek 2017) and the BLSTM deep-clustering
model (Hershey 2016).

Counterpart of ``padertorch_tpu/models/bss.py``:
``PermutationInvariantTrainingModel`` (reference
``padertorch/contrib/examples/source_separation/pit/model.py:11``):
log1p -> BLSTM -> Linear/ReLU -> Linear/activation -> (B, T, K, F) masks,
and the review with the permutation-invariant losses; and
``DeepClusteringModel`` (reference ``padertorch/contrib/tcl/dc.py``): BLSTM
-> Linear -> (B, T, E, F) embeddings of unit norm over E, and the deep
clustering loss over the valid frames.  Batches are padded arrays plus a
``num_frames`` length vector, as in the JAX package; the losses mask
padded frames (mean over the valid frames per example, then mean over the
batch).  On the card the BLSTMs run the ``lstm_cell_scan`` kernels.
"""
import itertools

import torch

from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch import nn
from padertorch_tpu_torch.modules.recurrent import LSTM
from padertorch_tpu_torch.ops.losses.source_separation import (
    deep_clustering_loss)
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP

__all__ = ['PermutationInvariantTrainingModel', 'DeepClusteringModel']


def _masked_pit_mse(estimate, target, num_frames):
    """PIT MSE over valid frames per example, averaged over the batch.

    estimate/target: (B, T, K, F); num_frames: (B,).
    Equals the reference's per-example ``pit_loss(..., axis=-2)`` over
    unpadded tensors, averaged over the batch.  The batch is an axis here
    (the JAX package maps over it); the minimum over the K! permutations
    is taken per example on the device.
    """
    _, t, k, f = estimate.shape
    num_frames = torch.as_tensor(num_frames, device=estimate.device)
    mask = (torch.arange(t, device=estimate.device)[None, :]
            < num_frames[:, None]).to(estimate.dtype)[:, :, None, None]
    denom = (num_frames * (k * f)).to(estimate.dtype)
    parts = estimate.unbind(2)
    candidates = torch.stack([
        torch.sum(
            (torch.stack([parts[i] for i in p], dim=2) - target) ** 2 * mask,
            dim=(1, 2, 3)) / denom
        for p in itertools.permutations(range(k))
    ])                                                      # (K!, B)
    return torch.mean(torch.min(candidates, dim=0).values)


class PermutationInvariantTrainingModel(Model):
    """uPIT BLSTM mask estimator (K speakers, F frequency bins).

    forward input: dict with
      - ``Y_abs``: (B, T, F) magnitude spectrogram of the mixture
      - ``num_frames``: (B,) valid frame counts (optional)
    review additionally uses
      - ``X_abs``: (B, T, K, F) speaker magnitudes
      - ``cos_phase_difference``: (B, T, K, F) for the phase-sensitive loss
    """

    def __init__(
            self,
            F=257,
            recurrent_layers=3,
            units=600,
            K=2,
            dropout_input=0.,
            dropout_hidden=0.,
            dropout_linear=0.,
            output_activation='relu',
            compute_dtype=None,
            round_hidden_to_mxu=False,
    ):
        """``compute_dtype`` (None or 'bfloat16') goes to the BLSTM: bf16
        input projections and recurrent products with float32 sums, bf16
        streams between them; the rest of the model stays in the input's
        dtype (see ``modules/recurrent.py``).  ``round_hidden_to_mxu`` is
        TPU machinery (lane-padded hidden widths): the port takes only its
        default, False."""
        super().__init__()
        if round_hidden_to_mxu:
            raise NotImplementedError(
                'round_hidden_to_mxu=True: lane-padded checkpoints are '
                'not supported by the port')
        self.K = K
        self.F = F
        assert dropout_input <= 0.5, dropout_input
        self.dropout_input = nn.Dropout(dropout_input)
        assert dropout_hidden <= 0.5, dropout_hidden
        self.blstm = LSTM(F, units, num_layers=recurrent_layers,
                          bidirectional=True, dropout=dropout_hidden,
                          compute_dtype=compute_dtype)
        assert dropout_linear <= 0.5, dropout_linear
        self.dropout_linear = nn.Dropout(dropout_linear)
        self.relu = nn.ReLU()
        self.linear1 = nn.Linear(2 * units, 2 * units)
        self.linear2 = nn.Linear(2 * units, F * K)
        self.output_activation = ACTIVATION_FN_MAP[output_activation]()

    def forward(self, batch):
        """Returns masks of shape (B, T, K, F)."""
        y = batch['Y_abs']
        b, t, f = y.shape
        assert f == self.F, f'self.F = {self.F} != F = {f}'
        num_frames = batch.get('num_frames')
        h = self.dropout_input(y)
        h = torch.log1p(h)
        h, _ = self.blstm(h, seq_lens=num_frames)
        h = self.dropout_linear(h)
        h = self.relu(self.linear1(h))
        h = self.output_activation(self.linear2(h))
        return h.reshape(b, t, self.K, self.F)

    def review(self, batch, model_out):
        observation = batch['Y_abs'][:, :, None, :]  # (B, T, 1, F)
        target = batch['X_abs']
        num_frames = batch.get('num_frames')
        if num_frames is None:
            num_frames = torch.full((target.shape[0],), target.shape[1])
        estimate = model_out * observation
        pit_mse = _masked_pit_mse(estimate, target, num_frames)
        pit_ips = _masked_pit_mse(
            estimate, target * batch['cos_phase_difference'], num_frames)
        review = dict(losses={
            'pit_mse_loss': pit_mse,
            'pit_ips_loss': pit_ips,
        })
        if self.create_snapshot:
            # Raw tensors here; modify_summary converts them to images on
            # the host (the reference's snapshot pattern, base.py:300-306).
            b = 0
            snapshots = {'observation': batch['Y_abs'][b]}
            for i in range(model_out.shape[2]):
                snapshots[f'mask_{i}'] = model_out[b, :, i, :]
                snapshots[f'estimation_{i}'] = estimate[b, :, i, :]
            review['snapshots'] = snapshots
        return review

    def modify_summary(self, summary):
        from padertorch_tpu_torch.summary.tbx_utils import (
            stft_to_image, mask_to_image,
        )
        snapshots = summary['snapshots']
        for key in list(snapshots):
            value = snapshots.pop(key)
            if key.startswith('mask'):
                summary['images'][key] = mask_to_image(value)
            else:
                summary['images'][key] = stft_to_image(value)
        return super().modify_summary(summary)


class DeepClusteringModel(Model):
    """BLSTM deep-clustering embedding model.

    forward input: dict with ``Y_abs`` (B, T, F) and ``num_frames`` (B,);
    review uses ``target_mask`` (B, T, K, F).
    Returns embeddings (B, T, E, F), unit-norm over E.
    """

    def __init__(
            self,
            F=257,
            recurrent_layers=2,
            units=600,
            E=20,
            input_feature_transform='identity',
    ):
        super().__init__()
        self.E = E
        self.F = F
        self.input_feature_transform = input_feature_transform
        self.blstm = LSTM(
            F, units, num_layers=recurrent_layers, bidirectional=True)
        self.linear = nn.Linear(2 * units, F * E)

    def forward(self, batch):
        y = batch['Y_abs']
        b, t, f = y.shape
        assert f == self.F, f'self.F = {self.F} != F = {f}'
        if self.input_feature_transform == 'identity':
            h = y
        elif self.input_feature_transform == 'log1p':
            h = torch.log1p(y)
        elif self.input_feature_transform == 'log':
            h = torch.log(y + 1e-10)
        else:
            raise NotImplementedError(self.input_feature_transform)
        h, _ = self.blstm(h, seq_lens=batch.get('num_frames'))
        h = self.linear(h).reshape(b, t, self.E, self.F)
        # Hershey 2016: unit norm over the embedding axis
        return h / torch.clamp(
            torch.linalg.vector_norm(h, dim=2, keepdim=True), min=1e-12)

    def review(self, batch, model_out):
        target_mask = batch['target_mask']
        b, t, e, f = model_out.shape
        num_frames = batch.get('num_frames')
        if num_frames is None:
            num_frames = torch.full((b,), target_mask.shape[1])
        num_frames = torch.as_tensor(num_frames, device=model_out.device)
        valid = (torch.arange(t, device=model_out.device)[None, :]
                 < num_frames[:, None]).to(model_out.dtype)
        losses = []
        for i in range(b):
            # (T, E, F) -> (T*F, E); zero padded frames contribute zero
            # rows to every term, but the N^2 normalization must count
            # only valid frames
            v = valid[i][:, None, None]
            x = (model_out[i] * v).transpose(1, 2).reshape(-1, e)
            m = (target_mask[i] * v).transpose(1, 2).reshape(
                -1, target_mask.shape[2])
            # in float: the JAX package's int32 square wraps above
            # T * F = 46340
            n_valid = num_frames[i].to(torch.float32) * f
            losses.append(deep_clustering_loss(x, m) * (x.shape[0] ** 2)
                          / (n_valid ** 2))
        return {'losses': {'dc_loss': torch.mean(torch.stack(losses))}}
