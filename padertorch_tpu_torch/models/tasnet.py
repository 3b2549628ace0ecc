"""TasNet / DPRNN-TasNet time-domain source separation.

Counterpart of ``padertorch_tpu/models/tasnet.py`` (reference
``contrib/examples/source_separation/tasnet/model.py:16`` and
``tas_coders.py``: TasEncoder/TasDecoder learned filterbanks,
StftEncoder/IstftDecoder).

Input contract: padded batches, ``y``: (B, T) mixture, ``s``: (B, K, T)
targets, ``num_samples``: (B,).  The PIT losses mask padded samples
exactly (sums over valid samples only), matching the reference's
per-example slicing semantics.  ``num_samples`` stays a numpy array on the
host (``example_to_device`` leaves it there): every length derived from it
(encoder frames, chunks) is host arithmetic, masks are built on the device
from a copy of the lengths, and no step waits for the device to read a
length.

The separator is a :class:`~padertorch_tpu_torch.modules.dual_path_rnn
.DPRNN` or a :class:`~padertorch_tpu_torch.modules.dual_path_transformer
.DualPathTransformer` (sepformer); the JAX package's ``ConvNet``
(Conv-TasNet) separator is not ported yet (``padertorch_tpu/modules/
convnet.py``, ROADMAP.md).
"""
import itertools
from typing import Optional

import numpy as np
import torch

from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch import nn
from padertorch_tpu_torch.modules.dual_path_rnn import (
    DPRNN, _host_lengths, _length_mask)
from padertorch_tpu_torch.modules.dual_path_transformer import (
    DualPathTransformer)
from padertorch_tpu_torch.ops._stft import STFT
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP

__all__ = ['TasNet', 'TasEncoder', 'TasDecoder', 'StftEncoder',
           'IstftDecoder']


class TasEncoder(nn.Module):
    """Learned analysis filterbank: 1-D conv + ReLU (tas_coders.py:9)."""

    def __init__(self, window_length: int = 20, feature_size: int = 256,
                 stride: int = None, bias: bool = False):
        super().__init__()
        if stride is None:
            stride = window_length // 2
        self.window_length = window_length
        self.feature_size = feature_size
        self.stride = stride
        self.encoder_1d = nn.Conv1d(
            1, feature_size, window_length, stride=stride, padding=0,
            bias=bias)

    def forward(self, x, sequence_lengths=None):
        """(B, T) -> ((B, N, T_enc), encoded_sequence_lengths)."""
        assert x.dim() in (1, 2), x.shape
        if x.dim() == 1:
            x = x[None]
        length = x.shape[-1]
        hop = self.window_length // 2
        sq_offset = -1
        if length % hop > 0:
            x = torch.nn.functional.pad(x, (0, hop - (length % hop)))
            sq_offset = 0
        if sequence_lengths is not None:
            sequence_lengths = _host_lengths(sequence_lengths) // hop \
                + sq_offset
        w = torch.relu(self.encoder_1d(x[:, None, :]))
        return w, sequence_lengths


class TasDecoder(nn.Module):
    """Learned synthesis filterbank: transposed 1-D conv (tas_coders.py:92)."""

    def __init__(self, window_length: int = 20, feature_size: int = 256,
                 stride: int = None, bias=False):
        super().__init__()
        if stride is None:
            stride = window_length // 2
        self.window_length = window_length
        self.feature_size = feature_size
        self.stride = stride
        self.decoder_1d = nn.ConvTranspose1d(
            feature_size, 1, kernel_size=window_length, stride=stride,
            bias=bias)

    def forward(self, w):
        """(B, N, T_enc) -> (B, T)."""
        return self.decoder_1d(w)[:, 0, :]


class StftEncoder(nn.Module):
    """STFT-based encoder variant (tas_coders.py:138)."""

    def __init__(self, window_length: int = 20, feature_size: int = 256,
                 stride: int = None):
        super().__init__()
        self.window_length = window_length
        self.feature_size = feature_size
        if stride is None:
            stride = window_length // 2
        self.stride = stride
        self.stft = STFT(
            size=feature_size - 2, shift=stride,
            window_length=window_length, fading=False,
            complex_representation='concat')

    def forward(self, inputs, sequence_lengths=None):
        encoded = self.stft(inputs).transpose(-1, -2)  # (..., fbins, frames)
        if sequence_lengths is not None:
            # samples -> frames (pad=True, fading=False)
            n = _host_lengths(sequence_lengths)
            wl, sh = self.window_length, self.stride
            return encoded, np.maximum(1, (n - wl + 2 * sh - 1) // sh)
        return encoded, None


class IstftDecoder(nn.Module):
    """iSTFT-based decoder variant (tas_coders.py:195)."""

    def __init__(self, window_length: int = 20, feature_size: int = 256,
                 stride: int = None):
        super().__init__()
        self.window_length = window_length
        self.feature_size = feature_size
        if stride is None:
            stride = window_length // 2
        self.stride = stride
        self.stft = STFT(
            size=feature_size - 2, shift=stride,
            window_length=window_length, fading=False,
            complex_representation='concat')

    def forward(self, stft_signal):
        return self.stft.inverse(stft_signal.transpose(-1, -2))


def _pit_min(estimate, target, loss_fn):
    """Per example, the smallest of ``loss_fn`` over the K! assignments of
    estimates to targets.  estimate, target: (B, K, T); ``loss_fn`` maps
    them to (B,), reducing over K and T.  The batch is an axis here (the
    JAX package maps a per-example ``pit_loss`` over it)."""
    k = estimate.shape[1]
    candidates = torch.stack([
        loss_fn(estimate[:, list(p)], target)
        for p in itertools.permutations(range(k))])         # (K!, B)
    return torch.min(candidates, dim=0).values


def _masked_si_sdr(estimate, target, mask):
    """SI-SDR on masked signals: exact under zero padding (sum-based)."""
    estimate = estimate * mask
    target = target * mask
    alpha = (torch.sum(estimate * target, -1, keepdim=True)
             / torch.clamp(torch.sum(target * target, -1, keepdim=True),
                           min=1e-10))
    s_t = alpha * target
    num = torch.sum(s_t * s_t, -1)
    den = torch.sum((estimate - s_t) ** 2, -1)
    return -torch.mean(
        10 * torch.log10(num / torch.clamp(den, min=1e-10)), dim=-1)


def _masked_log_mse(estimate, target, mask, n_valid):
    mse = torch.sum(((estimate - target) * mask) ** 2, -1) / n_valid
    return torch.sum(torch.log10(torch.clamp(mse, min=1e-12)), dim=-1)


def _masked_log1p_mse(estimate, target, mask, n_valid):
    mse = torch.sum(((estimate - target) * mask) ** 2, -1) / n_valid
    return torch.sum(torch.log10(1 + mse), dim=-1)


class TasNet(Model):
    """Time-domain separator: encoder -> separator (DPRNN or
    DualPathTransformer) -> decoder.

    forward input: dict with ``y`` (B, T), ``num_samples`` (B,);
    review additionally uses ``s`` (B, K, T).
    """

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['encoder'] = {'factory': TasEncoder}
        config['separator'] = {'factory': DPRNN}
        if config['separator']['factory'] == DPRNN:
            config['separator'].update(
                input_size=64, rnn_size=128, window_length=100,
                hop_size=50, num_blocks=6)
        elif config['separator']['factory'] == DualPathTransformer:
            config['separator'].update(
                input_size=128, window_length=100, hop_size=50,
                num_blocks=4, num_layers_intra=2, num_layers_inter=2,
                num_heads=8)
        config['decoder'] = {'factory': TasDecoder}
        if config['encoder']['factory'] == TasEncoder:
            config['decoder']['window_length'] = \
                config['encoder']['window_length']
            config['decoder']['feature_size'] = \
                config['encoder']['feature_size']

    def __init__(
            self,
            encoder: nn.Module,
            separator: nn.Module,
            decoder: nn.Module,
            mask: bool = True,
            output_nonlinearity: Optional[str] = 'sigmoid',
            num_speakers: int = 2,
            additional_out_size: int = 0,
            sample_rate: int = 8000,
    ):
        super().__init__()
        assert not mask or encoder.feature_size == decoder.feature_size, (
            'Encoder and decoder feature sizes must match when masking!')
        if not isinstance(separator, (DPRNN, DualPathTransformer)):
            raise NotImplementedError(
                f'separator {type(separator).__name__}: only the DPRNN and '
                'DualPathTransformer separators are ported; ConvNet '
                '(Conv-TasNet, padertorch_tpu/modules/convnet.py) is not '
                'ported yet (ROADMAP.md)')
        self.encoder = encoder
        self.separator = separator
        self.decoder = decoder
        self.mask = mask
        self.output_nonlinearity = ACTIVATION_FN_MAP[output_nonlinearity]()
        self.num_speakers = num_speakers
        self.additional_out_size = additional_out_size
        self.sample_rate = sample_rate

        self.encoded_input_norm = nn.LayerNorm(encoder.feature_size)
        self.input_proj = nn.Conv1d(
            encoder.feature_size, separator.input_size, 1)
        self.output_prelu = nn.PReLU()
        self.output_proj = nn.Conv1d(
            separator.hidden_size,
            decoder.feature_size * num_speakers + additional_out_size, 1)

    def example_to_device(self, example, device=None):
        """As the base class, but ``num_samples`` stays a numpy array on
        the host: lengths are host integers all the way down."""
        num_samples = example.get('num_samples')
        example = super().example_to_device(example, device)
        if num_samples is not None:
            example['num_samples'] = _host_lengths(num_samples)
        return example

    def forward(self, batch: dict) -> dict:
        sequence = batch['y']
        if sequence.dim() == 1:
            sequence = sequence[None]
        sequence_lengths = batch.get('num_samples')

        encoded_raw, encoded_sequence_lengths = self.encoder(
            sequence, sequence_lengths)

        encoded = encoded_raw.transpose(1, 2)  # b n l -> b l n
        encoded = self.encoded_input_norm(encoded)

        encoded = self.input_proj(encoded.transpose(1, 2)).transpose(1, 2)

        processed = self.separator(encoded, encoded_sequence_lengths)
        processed = processed.transpose(1, 2)  # b l n -> b n l

        processed = self.output_proj(self.output_prelu(processed))

        if self.additional_out_size > 0:
            additional_out = processed[..., :self.additional_out_size, :]
            processed = processed[..., self.additional_out_size:, :]

        # (K, B, N, L)
        processed = torch.stack(
            torch.chunk(processed, self.num_speakers, dim=1))
        processed = self.output_nonlinearity(processed)
        processed = processed[..., :encoded_raw.shape[-1]]

        if self.mask:
            processed = encoded_raw[None] * processed

        k, b = processed.shape[0], processed.shape[1]
        decoded = self.decoder(
            processed.reshape(k * b, *processed.shape[2:]))
        decoded = decoded.reshape(k, b, -1)
        decoded = decoded[..., :sequence.shape[-1]]
        # offset-invariance fix (see reference model.py:139)
        decoded = decoded - torch.mean(decoded, dim=-1, keepdim=True)

        out = {
            'out': decoded.transpose(0, 1),  # (B, K, T)
            'encoded': encoded_raw.transpose(1, 2),
            'encoded_out': processed.permute(1, 0, 3, 2),
            'encoded_sequence_lengths': encoded_sequence_lengths,
        }
        if self.additional_out_size > 0:
            out['additional_out'] = additional_out
        return out

    def loss(self, inputs: dict, outputs: dict) -> dict:
        s = inputs['s']  # (B, K, T)
        x = outputs['out']  # (B, K, T)
        t = x.shape[-1]
        num_samples = inputs.get('num_samples')
        if num_samples is None:
            num_samples = np.full((s.shape[0],), s.shape[-1])
        mask = _length_mask(num_samples, t, x.device, x.dtype)[:, None, :]
        n_valid = mask.sum(-1)                                # (B, 1)
        losses = {
            'si-sdr': _pit_min(
                x, s, lambda e, tg: _masked_si_sdr(e, tg, mask)),
            'log-mse': _pit_min(
                x, s, lambda e, tg: _masked_log_mse(e, tg, mask, n_valid)),
            'log1p-mse': _pit_min(
                x, s, lambda e, tg: _masked_log1p_mse(
                    e, tg, mask, n_valid)),
        }
        return {k: torch.mean(v) for k, v in losses.items()}

    def review(self, inputs: dict, outputs: dict) -> dict:
        review = dict(losses=self.loss(inputs, outputs))
        if self.create_snapshot:
            # Raw tensors; modify_summary turns them into normalized audio
            # snippets on the host.
            snapshots = {'observation': inputs['y'][0]}
            for i in range(outputs['out'].shape[1]):
                snapshots[f'estimate/{i}'] = outputs['out'][0, i]
            for i in range(inputs['s'].shape[1]):
                snapshots[f'target/{i}'] = inputs['s'][0, i]
            review['snapshots'] = snapshots
        return review

    def modify_summary(self, summary):
        from padertorch_tpu_torch.summary.tbx_utils import audio
        snapshots = summary['snapshots']
        for key in list(snapshots):
            summary['audios'][key] = audio(
                snapshots.pop(key), sampling_rate=self.sample_rate)
        return super().modify_summary(summary)
