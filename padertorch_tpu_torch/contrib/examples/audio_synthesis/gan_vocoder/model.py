"""Adversarially trained mel-to-wave vocoder (HiFi-GAN-style, compact).

Counterpart of ``padertorch_tpu/contrib/examples/audio_synthesis/
gan_vocoder/model.py``: the generator is a feed-forward stack of
transposed convolutions and dilated residual blocks, the discriminators
strided convolutions at three average-pooled scales (MelGAN); LSGAN
objectives, feature matching and the multi-resolution STFT loss
(``ops/losses/stft.py``).  Trained with ``Trainer(adversarial=True,
optimizer={'generator': ..., 'discriminator': ...})``: each loss key
updates its own submodule.  Its convolutions are cuDNN's (no kernel of
the port on its path).
"""
import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.ops.losses.stft import multi_resolution_stft_loss

__all__ = ['Generator', 'MultiScaleDiscriminator', 'GANVocoder']

_slope = 0.1


def _lrelu(x):
    return F.leaky_relu(x, _slope)


class ResBlock(torch.nn.Module):
    """Dilated residual conv pair stack (HiFi-GAN MRF, one kernel)."""

    def __init__(self, channels, kernel_size=3, dilations=(1, 3, 5)):
        super().__init__()

        def pad(d):
            return (kernel_size - 1) * d // 2

        self.convs1 = torch.nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=pad(d))
            for d in dilations
        ])
        self.convs2 = torch.nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=1,
                      padding=pad(1))
            for _ in dilations
        ])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            y = c1(_lrelu(x))
            y = c2(_lrelu(y))
            x = x + y
        return x


class Generator(torch.nn.Module):
    """Mel (B, M, frames) -> waveform (B, frames * prod(upsample_rates)).

    Each stage: ConvTranspose1d (stride r, kernel 2r or 2r+1 so the
    output length is exactly t*r) followed by a dilated ResBlock.
    """

    def __init__(self, n_mels=80, base_channels=128,
                 upsample_rates=(5, 5, 4, 2),
                 resblock_kernel=3, resblock_dilations=(1, 3, 5)):
        super().__init__()
        self.n_mels = n_mels
        self.upsample_rates = tuple(upsample_rates)
        self.pre = nn.Conv1d(n_mels, base_channels, 7, padding=3)
        ups, blocks = [], []
        ch = base_channels
        for r in self.upsample_rates:
            out_ch = max(ch // 2, 8)
            # (t - 1) * r - 2p + k = t * r needs k - r even
            k = 2 * r if r % 2 == 0 else 2 * r + 1
            ups.append(nn.ConvTranspose1d(
                ch, out_ch, k, stride=r, padding=(k - r) // 2))
            blocks.append(ResBlock(
                out_ch, resblock_kernel, resblock_dilations))
            ch = out_ch
        self.ups = torch.nn.ModuleList(ups)
        self.blocks = torch.nn.ModuleList(blocks)
        self.post = nn.Conv1d(ch, 1, 7, padding=3)

    @property
    def hop_length(self):
        hop = 1
        for r in self.upsample_rates:
            hop *= r
        return hop

    def forward(self, mel):
        x = self.pre(mel)
        for up, block in zip(self.ups, self.blocks):
            x = up(_lrelu(x))
            x = block(x)
        wave = torch.tanh(self.post(_lrelu(x)))
        return wave[:, 0, :]  # (B, T)


class ScaleDiscriminator(torch.nn.Module):
    """Strided conv stack on raw waveform -> patch logits + features."""

    def __init__(self, base_channels=16, n_layers=4):
        super().__init__()
        convs = []
        ch_in = 1
        ch = base_channels
        for i in range(n_layers):
            convs.append(nn.Conv1d(
                ch_in, ch, 15 if i == 0 else 11,
                stride=1 if i == 0 else 4,
                padding=7 if i == 0 else 5))
            ch_in = ch
            ch = min(ch * 4, 256)
        self.convs = torch.nn.ModuleList(convs)
        self.post = nn.Conv1d(ch_in, 1, 3, padding=1)

    def forward(self, wave):
        x = wave[:, None, :]  # (B, 1, T)
        features = []
        for conv in self.convs:
            x = _lrelu(conv(x))
            features.append(x)
        logits = self.post(x)[:, 0, :]
        return logits, features


def _avg_pool1d(x, k):
    """(B, T) -> (B, T // k) mean pooling; a remainder is dropped."""
    t = (x.shape[-1] // k) * k
    return x[..., :t].reshape(x.shape[0], t // k, k).mean(-1)


class MultiScaleDiscriminator(torch.nn.Module):
    """Discriminators at x1 / x2 / x4 average-pooled scales (MelGAN)."""

    def __init__(self, base_channels=16, n_layers=4, n_scales=3):
        super().__init__()
        self.scales = torch.nn.ModuleList([
            ScaleDiscriminator(base_channels, n_layers)
            for _ in range(n_scales)
        ])

    def forward(self, wave):
        outs = []
        x = wave
        for i, disc in enumerate(self.scales):
            if i > 0:
                x = _avg_pool1d(x, 2)
            outs.append(disc(x))
        return outs  # list of (logits, features)


class GANVocoder(Model):
    """LSGAN vocoder: G gets adversarial + feature-matching + MR-STFT,
    D gets the least-squares real/fake objective.

    Train with ``Trainer(adversarial=True, optimizer={'generator': ...,
    'discriminator': ...})``: each loss key updates only its own
    submodule, so no ``detach`` appears in the review.
    """

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['generator'] = {'factory': Generator}
        config['discriminator'] = {'factory': MultiScaleDiscriminator}

    def __init__(self, generator=None, discriminator=None,
                 lambda_fm=2.0, lambda_stft=1.0, sample_rate=16000,
                 stft_sizes=(1024, 2048, 512),
                 stft_shifts=(120, 240, 50),
                 stft_window_lengths=(600, 1200, 240)):
        super().__init__()
        self.generator = generator if generator is not None else Generator()
        self.discriminator = (discriminator if discriminator is not None
                              else MultiScaleDiscriminator())
        self.lambda_fm = lambda_fm
        self.lambda_stft = lambda_stft
        self.sample_rate = sample_rate
        self.stft_sizes = tuple(stft_sizes)
        self.stft_shifts = tuple(stft_shifts)
        self.stft_window_lengths = tuple(stft_window_lengths)

    def forward(self, inputs):
        fake = self.generator(inputs['features'])
        target = inputs['audio_data']
        t = min(fake.shape[-1], target.shape[-1])
        return {'fake': fake[..., :t], 'target': target[..., :t]}

    def review(self, inputs, outputs):
        fake, real = outputs['fake'], outputs['target']

        fake_outs = self.discriminator(fake)
        real_outs = self.discriminator(real)

        adv_loss = 0.0
        fm_loss = 0.0
        d_loss = 0.0
        for (lf, ff), (lr_, fr) in zip(fake_outs, real_outs):
            adv_loss = adv_loss + torch.mean(torch.square(lf - 1.0))
            d_loss = d_loss + torch.mean(torch.square(lr_ - 1.0)) \
                + torch.mean(torch.square(lf))
            for a, b in zip(ff, fr):
                fm_loss = fm_loss + torch.mean(torch.abs(a - b))
        n = len(fake_outs)
        adv_loss = adv_loss / n
        d_loss = d_loss / n
        fm_loss = fm_loss / n

        stft_loss = multi_resolution_stft_loss(
            fake, real,
            sizes=self.stft_sizes, shifts=self.stft_shifts,
            window_lengths=self.stft_window_lengths)

        g_loss = (adv_loss + self.lambda_fm * fm_loss
                  + self.lambda_stft * stft_loss)
        review = {
            'losses': {'generator': g_loss, 'discriminator': d_loss},
            'scalars': {
                'adversarial_loss': adv_loss,
                'feature_matching_loss': fm_loss,
                'stft_loss': stft_loss,
            },
        }
        if self.create_snapshot:
            review['snapshots'] = {
                'generated_audio': fake[0],
                'target_audio': real[0],
            }
        return review

    def modify_summary(self, summary):
        from padertorch_tpu_torch.summary.tbx_utils import audio
        for key in list(summary['snapshots']):
            summary['audios'][key] = audio(
                summary['snapshots'].pop(key),
                sampling_rate=self.sample_rate)
        return super().modify_summary(summary)
