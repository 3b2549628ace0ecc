"""CNN + GRU + FC speaker classifier.

Counterpart of ``padertorch_tpu/contrib/examples/speaker_classification/
supervised/model.py`` (reference
``contrib/examples/speaker_classification/supervised/model.py``):
NormalizedLogMelExtractor front end (or the on-device
FusedAudioLogMelExtractor), 2-D CNN over (mel, time), GRU, take-last
pooling, linear head; ``modify_summary`` computes the overall accuracy from
buffered predictions.  On the card the GRU's recurrence and the fused front
end run in the hand-written kernels.

Under the trainer's bf16 policy (``precision='bfloat16'``) the front end
computes in float32 on the bf16-rounded audio (the fused kernel widens its
input, as the JAX package's does), and the layers after it take their
parameters' type; ``set_rnn_backend(model, 'pallas',
compute_dtype='bfloat16')`` gives the GRU bf16 products and streams.
"""
import numpy as np
import torch

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.contrib.je.modules.features import (
    FusedAudioLogMelExtractor, NormalizedLogMelExtractor,
)
from padertorch_tpu_torch.contrib.je.modules.reduce import TakeLast
from padertorch_tpu_torch.modules.recurrent import GRU
from padertorch_tpu_torch.ops.losses.classification import (
    softmax_cross_entropy)

__all__ = ['SpeakerClf']


class SpeakerClf(Model):
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['feature_extractor'] = {
            'factory': NormalizedLogMelExtractor,
            'sample_rate': 16000,
            'stft_size': 512,
            'number_of_filters': 64,
        }

    def __init__(self, feature_extractor, num_speakers=251,
                 cnn_channels=(32, 64), hidden_size=256):
        super().__init__()
        self.feature_extractor = feature_extractor
        channels = [1] + list(cnn_channels)
        layers = []
        for cin, cout in zip(channels[:-1], channels[1:]):
            layers += [
                nn.Conv2d(cin, cout, 3, stride=(2, 1), padding=1),
                nn.ReLU(),
            ]
        self.cnn = nn.Sequential(*layers)
        mels = (
            feature_extractor.mel_transform.number_of_filters
            if hasattr(feature_extractor, 'mel_transform')
            else feature_extractor.number_of_filters
        )
        reduced_mels = mels
        for _ in cnn_channels:
            reduced_mels = -(-reduced_mels // 2)
        self.gru = GRU(cnn_channels[-1] * reduced_mels, hidden_size)
        self.pool = TakeLast(axis=1)
        self.head = nn.Linear(hidden_size, num_speakers)

    def forward(self, inputs):
        seq_len = inputs.get('seq_len')
        if isinstance(self.feature_extractor, FusedAudioLogMelExtractor):
            # on-device front end: raw audio in the batch, log-mel computed
            # inside the step (the fused kernel on a CUDA tensor)
            x, seq_len = self.feature_extractor(
                inputs['audio_data'], seq_len=seq_len)
        else:
            x, seq_len = self.feature_extractor(
                inputs['stft'], seq_len=seq_len)  # (B, C, M, T)
        h = self.cnn(x.to(self.head.weight.dtype))  # (B, C', M', T)
        b, c, m, t = h.shape
        h = h.permute(0, 3, 1, 2).reshape(b, t, c * m)
        h, _ = self.gru(h, seq_lens=seq_len)
        h = self.pool(h, seq_len)
        return self.head(h)

    def review(self, inputs, outputs):
        labels = inputs['speaker_id']
        ce = softmax_cross_entropy(outputs, labels)
        predictions = torch.argmax(outputs, -1)
        accuracy = (predictions == labels).to(torch.float32).mean()
        return {
            'loss': ce,
            'scalars': {'accuracy': accuracy},
            'buffers': {'predictions': predictions, 'labels': labels},
        }

    def modify_summary(self, summary):
        buffers = summary['buffers']
        if 'predictions' in buffers:
            predictions = np.concatenate([
                np.atleast_1d(np.asarray(p))
                for p in buffers.pop('predictions')])
            labels = np.concatenate([
                np.atleast_1d(np.asarray(x))
                for x in buffers.pop('labels')])
            summary['scalars']['overall_accuracy'] = float(
                (predictions == labels).mean())
        return super().modify_summary(summary)
