"""uPIT BLSTM mask estimator (Kolbaek 2017).

Counterpart of ``padertorch_tpu/models/bss.py``
``PermutationInvariantTrainingModel`` (reference
``padertorch/contrib/examples/source_separation/pit/model.py:11``), its
inference forward: log1p -> BLSTM -> Linear/ReLU -> Linear/activation ->
(B, T, K, F) masks.  Batches are padded arrays plus a ``num_frames``
length vector, as in the JAX package.
"""
import torch

from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch import nn
from padertorch_tpu_torch.modules.recurrent import LSTM
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP

__all__ = ['PermutationInvariantTrainingModel']


class PermutationInvariantTrainingModel(Model):
    """uPIT BLSTM mask estimator (K speakers, F frequency bins).

    forward input: dict with
      - ``Y_abs``: (B, T, F) magnitude spectrogram of the mixture
      - ``num_frames``: (B,) valid frame counts (optional)
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
        """``compute_dtype`` and ``round_hidden_to_mxu`` are the JAX
        model's; the port computes in float32 with the logical hidden
        width, so it takes only their defaults (None and False), which
        is what configs of float32 runs hold."""
        super().__init__()
        if compute_dtype is not None:
            raise NotImplementedError(
                f'compute_dtype={compute_dtype!r}: the port computes in '
                'float32 only')
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
                          bidirectional=True, dropout=dropout_hidden)
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
