"""WaveNet vocoder: training graph and autoregressive sampling.

Counterpart of ``padertorch_tpu/modules/wavenet/wavenet.py`` (reference
``padertorch/modules/wavenet/wavenet.py``; the structure follows NVIDIA's
nv-wavenet: embedding, k=2 dilated causal convs, conditioning upsampled by
a transposed conv with fading crop, res/skip, two output convs, mu-law in
and out).

Training (:meth:`WaveNet.forward`) is the teacher-forced stack of dilated
``Conv1d`` layers.  Sampling keeps, per layer, a ring buffer of the
activations the k=2 dilated convs need: on CUDA tensors the whole loop over
the samples is one launch of the hand-written kernel
(``ops/kernels/wavenet.py``, the place the reference's nv-wavenet CUDA
engine had), on CPU tensors the kernel's plain version, a step loop in
PyTorch with the same draws.  Chunked inference with overlap (:meth:`WaveNet.infer`) matches
the reference's chunking.
"""
import math

import numpy as np
import torch

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.ops.kernels.wavenet import wavenet_sample
from padertorch_tpu_torch.ops.mu_law import mu_law_encode, mu_law_decode

__all__ = ['WaveNet', 'Conv']


class Conv(torch.nn.Module):
    """Conv1d with optional causal padding and xavier-uniform init with
    torch's gains, drawn from ``generator`` (a ``torch.Generator``; None is
    torch's global generator, which the recipe seeds).

    Reference parity: ``wavenet.py:41``.
    """

    def __init__(self, in_channels, out_channels, kernel_size=1, stride=1,
                 dilation=1, bias=True, w_init_gain='linear',
                 is_causal=False, generator=None):
        super().__init__()
        self.is_causal = is_causal
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.conv = nn.Conv1d(
            in_channels, out_channels, kernel_size=kernel_size,
            stride=stride, dilation=dilation, bias=bias)
        torch.nn.init.xavier_uniform_(
            self.conv.weight, gain=torch.nn.init.calculate_gain(w_init_gain),
            generator=generator)

    def forward(self, signal):
        if self.is_causal:
            pad = int((self.kernel_size - 1) * self.dilation)
            signal = torch.nn.functional.pad(signal, (pad, 0))
        return self.conv(signal)


class WaveNet(torch.nn.Module):
    """See module docstring. Reference parity: ``wavenet.py:68``."""

    def __init__(
            self, n_cond_channels, upsamp_window, upsamp_stride,
            n_in_channels=256, n_layers=16, max_dilation=128,
            n_residual_channels=64, n_skip_channels=256,
            n_out_channels=256, fading='full',
    ):
        super().__init__()
        self.n_layers = n_layers
        self.max_dilation = max_dilation
        self.n_residual_channels = n_residual_channels
        self.n_out_channels = n_out_channels
        self.upsamp_stride = upsamp_stride
        self.upsamp_window = upsamp_window
        self.upsample = nn.ConvTranspose1d(
            n_cond_channels, n_cond_channels, upsamp_window, upsamp_stride)
        self.fading = fading
        self.cond_layers = Conv(
            n_cond_channels, 2 * n_residual_channels * n_layers,
            w_init_gain='tanh')
        self.dilate_layers = torch.nn.ModuleList()
        self.res_layers = torch.nn.ModuleList()
        self.skip_layers = torch.nn.ModuleList()
        self.embed = nn.Embedding(n_in_channels, n_residual_channels)
        self.conv_out = Conv(
            n_skip_channels, n_out_channels, bias=False, w_init_gain='relu')
        self.conv_end = Conv(
            n_out_channels, n_out_channels, bias=False,
            w_init_gain='linear')

        loop_factor = math.floor(math.log2(max_dilation)) + 1
        self.dilations = []
        for i in range(n_layers):
            dilation = int(2 ** (i % loop_factor))
            self.dilations.append(dilation)
            self.dilate_layers.append(Conv(
                n_residual_channels, 2 * n_residual_channels,
                kernel_size=2, dilation=dilation, w_init_gain='tanh',
                is_causal=True))
            if i < n_layers - 1:
                self.res_layers.append(Conv(
                    n_residual_channels, n_residual_channels,
                    w_init_gain='linear'))
            self.skip_layers.append(Conv(
                n_residual_channels, n_skip_channels, w_init_gain='relu'))

    # ------------------------------------------------------------------ #
    def forward(self, features, audio):
        """Teacher-forced training graph.

        Args:
            features: (B, n_cond_channels, frames) local conditioning.
            audio: (B, T) in [-1, 1].

        Returns:
            (logits (B, 256, T), shifted so position t predicts sample t,
             quantized targets (B, T))
        """
        quantized = mu_law_encode(audio)
        cond_input = self.get_cond_input(features)
        extra = cond_input.shape[-1] - quantized.shape[1]
        if not self.upsamp_stride > extra >= 0:
            raise ValueError(
                f'{tuple(features.shape)} features upsample to '
                f'{cond_input.shape[-1]} samples, the audio has '
                f'{quantized.shape[1]}: the difference must be in '
                f'[0, {self.upsamp_stride})')
        cond_input = cond_input[:, :, :quantized.shape[1]]

        forward_input = self.embed(quantized.long())  # (B, T, R)
        forward_input = forward_input.transpose(1, 2)  # (B, R, T)

        cond_acts = cond_input.reshape(
            cond_input.shape[0], self.n_layers, -1, cond_input.shape[2])
        r = self.n_residual_channels
        output = None
        for i in range(self.n_layers):
            in_act = self.dilate_layers[i](forward_input)
            in_act = in_act + cond_acts[:, i, :, :]
            acts = torch.tanh(in_act[:, :r, :]) \
                * torch.sigmoid(in_act[:, r:, :])
            if i < len(self.res_layers):
                forward_input = self.res_layers[i](acts) + forward_input
            if i == 0:
                output = self.skip_layers[i](acts)
            else:
                output = self.skip_layers[i](acts) + output

        output = torch.relu(output)
        output = self.conv_out(output)
        output = torch.relu(output)
        output = self.conv_end(output)

        # Position t must not see sample t: shift right, zero the first.
        output = torch.cat(
            [output[:, :, -1:] * 0.0, output[:, :, :-1]], dim=2)
        return output, quantized

    def get_cond_input(self, features):
        """Upsample features to sample rate and crop the fading region."""
        cond_input = self.upsample(features)
        if self.fading is not None:
            if self.fading not in ('half', 'full'):
                raise ValueError(f'unknown fading {self.fading!r}')
            pad_width = self.upsamp_window - self.upsamp_stride
            # non-overlapping upsamplers (window == stride) have no
            # fading region; a [0:-0] slice would be EMPTY, not a no-op
            if pad_width > 0:
                if self.fading == 'half':
                    front = pad_width // 2
                    back = math.ceil(pad_width / 2)
                    cond_input = cond_input[..., front:-back]
                else:
                    cond_input = cond_input[
                        ..., pad_width:-pad_width]
        return self.cond_layers(cond_input)

    def export_weights(self):
        """Weight dict for external samplers (reference ``wavenet.py:199``)."""
        def numpy(p):
            return p.detach().cpu().numpy()

        return {
            'embedding_prev': np.zeros(
                (self.n_out_channels, self.n_residual_channels), 'float32'),
            'embedding_curr': numpy(self.embed.weight),
            'conv_out_weight': numpy(self.conv_out.conv.weight),
            'conv_end_weight': numpy(self.conv_end.conv.weight),
            'dilate_weights': [numpy(l.conv.weight)
                               for l in self.dilate_layers],
            'dilate_biases': [numpy(l.conv.bias)
                              for l in self.dilate_layers],
            'max_dilation': self.max_dilation,
            'res_weights': [numpy(l.conv.weight) for l in self.res_layers],
            'res_biases': [numpy(l.conv.bias) for l in self.res_layers],
            'skip_weights': [numpy(l.conv.weight)
                             for l in self.skip_layers],
            'skip_biases': [numpy(l.conv.bias) for l in self.skip_layers],
            'use_embed_tanh': False,
        }

    # ------------------------------------------------------------------ #
    # autoregressive sampling (nv_wavenet equivalent)                     #
    # ------------------------------------------------------------------ #
    def sampler_weights(self):
        """The weights in the samplers' matmul layout, stacked over layers
        (the ``weights`` of ``ops/kernels/wavenet.py``), detached."""
        def mat(layer, tap=0):
            return layer.conv.weight.detach()[:, :, tap].t()

        def stack(tensors, shape):
            tensors = list(tensors)
            if not tensors:
                return self.embed.weight.new_zeros(shape)
            return torch.stack(tensors).contiguous()

        r = self.n_residual_channels
        return {
            # dilate conv weight (2R, R, 2): tap 0 sees the past sample
            'w_prev': stack((mat(l, 0) for l in self.dilate_layers), ()),
            'w_curr': stack((mat(l, 1) for l in self.dilate_layers), ()),
            'b_dil': stack((l.conv.bias.detach()
                            for l in self.dilate_layers), ()),
            'w_res': stack((mat(l) for l in self.res_layers), (0, r, r)),
            'b_res': stack((l.conv.bias.detach()
                            for l in self.res_layers), (0, r)),
            'w_skip': stack((mat(l) for l in self.skip_layers), ()),
            'b_skip': stack((l.conv.bias.detach()
                             for l in self.skip_layers), ()),
            'w_out': mat(self.conv_out).contiguous(),
            'w_end': mat(self.conv_end).contiguous(),
            'embed': self.embed.weight.detach(),
        }

    @staticmethod
    def _shift_cond(cond_acts):
        """(B, L, 2R, T) -> (T, B, L, 2R), shifted right by one step: the
        training graph shifts its output right by one (position t is
        predicted from conv position t-1), so step t must see cond[t-1];
        step 0 sees zeros (no information, like training)."""
        cond_t = cond_acts.detach().permute(3, 0, 1, 2)
        return torch.cat([torch.zeros_like(cond_t[:1]), cond_t[:-1]], dim=0)

    def sample(self, cond_acts, generator=None, sample=True,
               forced_input=None, return_logits=False):
        """Generate mu-law sample indices for one chunk (the counterpart of
        the JAX package's ``sample`` and ``sample_pallas``: one sampler on
        every device).

        Args:
            cond_acts: (B, n_layers, 2R, T) pre-computed conditioning
                activations (output of :meth:`get_cond_input`, reshaped).
            generator: CPU ``torch.Generator`` (None is the global
                generator); one draw from it is the ``seed`` of
                :meth:`sample_kernel`, so the same generator state gives
                the same draws on the CPU and on the card.
            sample: draw from the softmax (like nv-wavenet); otherwise
                greedy argmax.
            forced_input: optional (B, T) teacher-forcing indices.

        Returns:
            (B, T) int32 mu-law indices, or (indices, logits (B, O, T)).
        """
        seed = int(torch.randint(0, 2 ** 30, (), generator=generator))
        return self.sample_kernel(
            cond_acts, seed=seed, sample=sample, forced_input=forced_input,
            return_logits=return_logits)

    def sample_kernel(self, cond_acts, seed=0, sample=True,
                      forced_input=None, return_logits=False):
        """The persistent sampler (``ops/kernels/wavenet.py``): on CUDA
        tensors the whole loop is one kernel launch (it raises where a
        configuration exceeds what the kernel supports), on CPU tensors its
        plain version, a step loop with the same ring buffers.  Stochastic
        sampling is Gumbel-max over a counter-based generator keyed by
        ``seed``, which both reproduce bit for bit.

        Args and returns match :meth:`sample` (``seed`` replaces
        ``generator``).
        """
        two_r = cond_acts.shape[2]
        if two_r != 2 * self.n_residual_channels:
            raise ValueError(f'{two_r} conditioning channels per layer, '
                             f'expected {2 * self.n_residual_channels}')
        fi = None if forced_input is None else forced_input.t()
        out = wavenet_sample(
            self._shift_cond(cond_acts), self.sampler_weights(),
            tuple(self.dilations), seed=seed, sample=sample,
            forced_input=fi, return_logits=return_logits)
        if return_logits:
            idx, logits = out
            return idx.t(), logits.permute(1, 2, 0)  # (B, O, T)
        return out.t()

    @torch.no_grad()
    def infer(self, x, chunk_length=None, chunk_overlap=0, generator=None,
              sample=True, parallel=False):
        """Chunked autoregressive synthesis (reference ``wavenet.py:249``).

        Args:
            x: (B, n_cond_channels, frames) conditioning features.
            generator: CPU ``torch.Generator`` for the draws (None is the
                global generator): it seeds the sampler's counter-based
                generator once per sampler call, on every device.
            parallel: synthesize all chunks in one batched sampling pass
                instead of sequentially.  Chunks are independent (each
                conditions only on its local features, with
                ``chunk_overlap`` warm-up samples discarded), so on the
                card every chunk is a row of one kernel launch, and rows
                are what fills its SMs.
        Returns:
            (B, T) float audio in [-1, 1].
        """
        x = self.get_cond_input(x)
        x = x.reshape(x.shape[0], self.n_layers, -1, x.shape[2])
        length = x.shape[-1]
        if chunk_length is None or length <= chunk_length:
            chunks = [x]
            n_chunks = 1
        else:
            n_chunks = math.ceil(
                (length - chunk_overlap) / (chunk_length - chunk_overlap))
            chunk_length = math.ceil(length / n_chunks) + chunk_overlap
            chunks = None  # parallel path gathers; sequential slices

        if parallel and n_chunks > 1:
            # one gather builds all overlapping chunk windows, one sampler
            # call runs them as a batch, one reshape + slice reassembles
            b = x.shape[0]
            hop = chunk_length - chunk_overlap
            starts = np.arange(n_chunks) * hop
            tail = int(starts[-1] + chunk_length - length)
            if tail > 0:
                x = torch.nn.functional.pad(x, (0, tail))
            win = torch.from_numpy(
                starts[:, None] + np.arange(chunk_length)[None, :]).to(
                    x.device)
            windows = x[..., win]              # (B, L, 2R, N, C)
            stacked = windows.movedim(3, 0).reshape(
                n_chunks * b, self.n_layers, -1, chunk_length)
            si = self.sample(stacked, generator, sample=sample)
            si = mu_law_decode(si, self.n_out_channels)
            si = si.reshape(n_chunks, b, chunk_length)
            # chunk 0 keeps its head; later chunks drop the warm-up
            head = si[0]
            rest = si[1:, :, chunk_overlap:].movedim(0, 1).reshape(b, -1)
            return torch.cat([head, rest], dim=-1)[..., :length]

        if chunks is None:
            chunks = [
                x[..., onset:onset + chunk_length]
                for onset in range(0, length - chunk_overlap,
                                   chunk_length - chunk_overlap)
            ]

        audio = []
        for i, xi in enumerate(chunks):
            si = self.sample(xi, generator, sample=sample)
            si = mu_law_decode(si, self.n_out_channels)
            if i > 0:
                si = si[..., chunk_overlap:]
            audio.append(si)
        return torch.cat(audio, dim=-1)
