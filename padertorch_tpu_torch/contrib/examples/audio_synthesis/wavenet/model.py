"""WaveNet vocoder model wrapper (feature alignment + CE loss).

Counterpart of ``padertorch_tpu/contrib/examples/audio_synthesis/wavenet/
model.py`` (reference ``contrib/examples/audio_synthesis/wavenet/
model.py``).
"""
import torch

from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.modules.wavenet import WaveNet
from padertorch_tpu_torch.ops.losses.classification import (
    softmax_cross_entropy)

__all__ = ['WaveNetVocoder']


class WaveNetVocoder(Model):
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['wavenet'] = {
            'factory': WaveNet,
            'n_cond_channels': 80,
            'upsamp_window': 800,
            'upsamp_stride': 200,
        }

    def __init__(self, wavenet, sample_rate=16000):
        super().__init__()
        self.wavenet = wavenet
        self.sample_rate = sample_rate

    def forward(self, inputs):
        features = inputs['features']  # (B, M, frames)
        audio = inputs['audio_data']   # (B, T)
        # crop audio so the cond upsampling relation holds
        frames = features.shape[-1]
        stride = self.wavenet.upsamp_stride
        window = self.wavenet.upsamp_window
        t = (frames - 1) * stride + window - 2 * (window - stride)
        audio = audio[..., :t]
        logits, quantized = self.wavenet(features, audio)
        return {'logits': logits, 'quantized': quantized}

    def review(self, inputs, outputs):
        logits = outputs['logits'].transpose(1, 2)  # (B, T, 256)
        ce = softmax_cross_entropy(logits, outputs['quantized'])
        accuracy = (torch.argmax(logits, -1) == outputs['quantized']) \
            .to(torch.float32).mean()
        review = {
            'loss': ce,
            'scalars': {'accuracy': accuracy},
        }
        if self.create_snapshot:
            review['snapshots'] = {'target_audio': inputs['audio_data'][0]}
        return review

    def modify_summary(self, summary):
        from padertorch_tpu_torch.summary.tbx_utils import audio
        for key in list(summary['snapshots']):
            summary['audios'][key] = audio(
                summary['snapshots'].pop(key),
                sampling_rate=self.sample_rate)
        return super().modify_summary(summary)

    def synthesize(self, features, chunk_length=None, chunk_overlap=0,
                   generator=None, parallel=False):
        """Autoregressive synthesis from (B, M, frames) features; on the
        card the sampler is the hand-written kernel."""
        return self.wavenet.infer(
            features, chunk_length=chunk_length,
            chunk_overlap=chunk_overlap, generator=generator,
            parallel=parallel)
