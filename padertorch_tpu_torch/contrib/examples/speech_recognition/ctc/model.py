"""Conformer speech recognizers: CTC, RNN-T (transducer) and attention
encoder-decoder heads over one acoustic encoder.

Counterpart of ``padertorch_tpu/contrib/examples/speech_recognition/ctc/
model.py``: normalized log-mel front end with SpecAugment, 4x
convolutional time subsampling and a conformer encoder, built from the
port's modules:

- front end: :class:`padertorch_tpu_torch.contrib.je.modules.features
  .NormalizedLogMelExtractor` (its SpecAugment masks drawn from a
  ``torch.Generator`` where the JAX package draws from a key);
- encoder: :class:`padertorch_tpu_torch.modules.conformer
  .ConformerEncoder`; on the card its self-attention runs the flash
  attention kernels;
- losses: :func:`padertorch_tpu_torch.ops.losses.ctc_loss` and
  :func:`padertorch_tpu_torch.ops.losses.rnnt_loss`;
- the transducer's prediction network is an :class:`LSTM` of one
  direction (on the card the ``lstm_cell_scan`` kernels: the training
  forward and backward in a step, the lean forward in decoding); the
  attention head's decoder is the port's ``TransformerDecoder``, decoded
  by ``autoregressive_generate``, ``beam_search_generate`` and the
  ``ContinuousBatcher``.

The decoders take a host (numpy) batch, move it to the model's device and
run without gradients.  Where the JAX transducer decode jit-compiles its
beam scorer and buckets its shapes, the port scores each beam level
eagerly, with the same results; its greedy decode runs the prediction
network once per emitted symbol (the JAX one reruns it for every joint
call on an unchanged prefix, which gives the same scores).
"""
import numpy as np
import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.contrib.je.modules.features import (
    NormalizedLogMelExtractor)
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    TransformerDecoder, autoregressive_generate, beam_search_generate)
from padertorch_tpu_torch.modules.conformer import ConformerEncoder
from padertorch_tpu_torch.modules.recurrent import LSTM
from padertorch_tpu_torch.ops.losses.ctc import (
    ctc_beam_search_decode, ctc_greedy_decode, ctc_loss, edit_distance)
from padertorch_tpu_torch.ops.losses.rnnt import rnnt_beam_search, rnnt_loss
from padertorch_tpu_torch.serve import ContinuousBatcher

__all__ = ['AcousticEncoder', 'ConformerCTC', 'TransducerASR',
           'AttentionASR']

_FRONTEND_DEFAULTS = {
    'factory': NormalizedLogMelExtractor,
    'sample_rate': 8000,
    'stft_size': 256,
    'number_of_filters': 40,
    # SpecAugment (train mode only)
    'n_time_masks': 2,
    'max_masked_time_steps': 20,
    'n_frequency_masks': 1,
    'max_masked_frequency_bands': 8,
}


def _ceil_half(n):
    return -(-n // 2)


class AcousticEncoder(nn.Module):
    """Log-mel frames -> conv subsample (4x) -> conformer states."""

    def __init__(self, feature_extractor, d_model=96, num_layers=2,
                 num_heads=4, d_ff=None, kernel_size=15, dropout=0.0,
                 conv_norm='batch_norm', causal=False, attn_window=None,
                 subsample_channels=32):
        super().__init__()
        self.feature_extractor = feature_extractor
        c = subsample_channels
        # two stride-2 convs over (mel, time): 4x frame-rate reduction.
        # The time padding is explicit in forward: kernel 3 / stride 2 /
        # total time pad 2 gives ceil(T/2) either way, but the causal
        # variant puts both pad frames on the left so no output frame sees
        # the future (exact prefix property)
        self.subsample_convs = torch.nn.ModuleList([
            nn.Conv2d(1, c, 3, stride=(2, 2), padding=0),
            nn.Conv2d(c, c, 3, stride=(2, 2), padding=0),
        ])
        self.causal = causal
        mels = feature_extractor.mel_transform.number_of_filters
        reduced_mels = _ceil_half(_ceil_half(mels))
        self.encoder = ConformerEncoder(
            d_model=d_model, num_layers=num_layers, num_heads=num_heads,
            d_ff=d_ff, kernel_size=kernel_size, dropout=dropout,
            conv_norm=conv_norm, causal=causal, attn_window=attn_window,
            input_size=c * reduced_mels,
        )
        self.d_model = d_model

    @staticmethod
    def _frames(h):
        b, c, m, t = h.shape
        return h.permute(0, 3, 1, 2).reshape(b, t, c * m)

    def forward(self, stft, seq_len=None):
        """(B, 1, T, F, 2) stacked STFT -> ((B, T', d_model), (B,))."""
        x, seq_len = self.feature_extractor(stft, seq_len=seq_len)
        t_pad = (2, 0) if self.causal else (1, 1)
        h = x                                               # (B, 1, M, T)
        for conv in self.subsample_convs:
            h = F.relu(conv(F.pad(h, (*t_pad, 1, 1))))
        if seq_len is not None:
            seq_len = _ceil_half(_ceil_half(
                torch.as_tensor(seq_len, device=h.device)))
        return self.encoder(self._frames(h), seq_len=seq_len), seq_len

    # ---- carried-state streaming (online recognition) -----------------
    # The causal variant's whole stack streams with O(chunk) work per call:
    # the front end is per frame in eval mode (running-statistics input
    # normalization, no deltas), the two stride-2 subsample convs carry
    # their last 2 input frames (zeros equal the causal left pad), and the
    # encoder streams on its KV caches and conv left contexts.  Chunks must
    # be multiples of 4 STFT frames so the stride-2 convs stay aligned.

    def init_stream(self, batch_size, max_frames, dtype=torch.float32,
                    device=None):
        """State for :meth:`stream_step`; ``max_frames`` counts input STFT
        frames (the encoder cache holds ``max_frames / 4``)."""
        assert self.causal, 'streaming requires the --causal variant'
        if device is None:
            device = self.subsample_convs[0].weight.device
        mels = self.feature_extractor.mel_transform.number_of_filters
        c = self.subsample_convs[0].out_channels
        return {
            'sub1': torch.zeros((batch_size, 1, mels, 2), dtype=dtype,
                                device=device),
            'sub2': torch.zeros((batch_size, c, _ceil_half(mels), 2),
                                dtype=dtype, device=device),
            'encoder': self.encoder.init_stream_state(
                batch_size, -(-max_frames // 4), dtype, device=device),
        }

    def stream_step(self, stft_chunk, state, frame_index):
        """Encode a chunk of STFT frames at absolute input positions
        ``[frame_index, frame_index + Tc)`` (``Tc`` and ``frame_index``
        multiples of 4).  Returns ``(encoder_frames, new_state)``."""
        h, _ = self.feature_extractor(stft_chunk)           # (B, 1, M, Tc)
        state = dict(state)
        for conv, key in zip(self.subsample_convs, ('sub1', 'sub2')):
            cat = torch.cat([state[key], h], dim=-1)
            state[key] = cat[..., cat.shape[-1] - 2:]
            h = F.relu(conv(F.pad(cat, (0, 0, 1, 1))))
        h, state['encoder'] = self.encoder.stream_step(
            self._frames(h), state['encoder'], frame_index // 4)
        return h, state


def _decode_results(batch, hyps):
    """Per-example reference/hypothesis bookkeeping shared by the
    decoders (WER = Levenshtein distance / reference length)."""
    results = {}
    labels = np.asarray(batch['labels'])
    label_lengths = np.asarray(batch['label_lengths'])
    for i, example_id in enumerate(batch['example_id']):
        ref = labels[i, :label_lengths[i]].tolist()
        hyp = list(hyps[i])
        results[example_id] = {
            'reference': ref,
            'hypothesis': hyp,
            'num_errors': edit_distance(ref, hyp),
            'num_tokens': len(ref),
        }
    return results


class _ASRModel(Model):
    """What the three heads share: the acoustic encoder, the front-end
    config and the host batch's move to the device."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['feature_extractor'] = dict(_FRONTEND_DEFAULTS)

    def __init__(self, feature_extractor, vocab_size, d_model, num_layers,
                 num_heads, d_ff, kernel_size, dropout, conv_norm, causal,
                 attn_window, subsample_channels):
        super().__init__()
        self.acoustic = AcousticEncoder(
            feature_extractor, d_model=d_model, num_layers=num_layers,
            num_heads=num_heads, d_ff=d_ff, kernel_size=kernel_size,
            dropout=dropout, conv_norm=conv_norm, causal=causal,
            attn_window=attn_window,
            subsample_channels=subsample_channels)
        self.vocab_size = vocab_size

    # recipe helpers reach the front end through the model
    @property
    def feature_extractor(self):
        return self.acoustic.feature_extractor

    @property
    def causal(self):
        return self.acoustic.causal

    def _encode(self, batch):
        """A host batch's encoder frames and lengths on the model's
        device."""
        inputs = self.example_to_device(
            {key: batch[key] for key in ('stft', 'seq_len') if key in batch})
        return self.acoustic(inputs['stft'], seq_len=inputs.get('seq_len'))


def _full_lengths(logits):
    return torch.full((logits.shape[0],), logits.shape[1],
                      dtype=torch.int32, device=logits.device)


class ConformerCTC(_ASRModel):
    """Acoustic encoder -> linear CTC head.

    ``vocab_size`` counts real tokens; the head has ``vocab_size + 1``
    outputs with blank = 0 (labels are ids in ``1..vocab_size``).
    """

    def __init__(self, feature_extractor, vocab_size,
                 d_model=96, num_layers=2, num_heads=4, d_ff=None,
                 kernel_size=15, dropout=0.0, conv_norm='batch_norm',
                 causal=False, attn_window=None,
                 subsample_channels=32):
        super().__init__(feature_extractor, vocab_size, d_model, num_layers,
                         num_heads, d_ff, kernel_size, dropout, conv_norm,
                         causal, attn_window, subsample_channels)
        self.head = nn.Linear(d_model, vocab_size + 1)
        self.blank = 0

    def forward(self, inputs):
        h, seq_len = self.acoustic(
            inputs['stft'], seq_len=inputs.get('seq_len'))
        return {'logits': self.head(h),       # (B, T', V+1)
                'logit_lengths': seq_len}

    def review(self, inputs, outputs):
        logits = outputs['logits']
        logit_lengths = outputs['logit_lengths']
        if logit_lengths is None:
            logit_lengths = _full_lengths(logits)
        label_lengths = torch.as_tensor(inputs['label_lengths'],
                                        device=logits.device)
        nll = ctc_loss(logits, logit_lengths, inputs['labels'],
                       label_lengths, blank=self.blank)
        per_token = nll / torch.clamp(label_lengths, min=1)
        return {
            'loss': per_token.mean(),
            'scalars': {
                'per_utt_nll': nll.mean(),
                'blank_rate': (torch.argmax(logits, -1) == self.blank)
                .to(torch.float32).mean(),
            },
        }

    @torch.no_grad()
    def decode(self, batch, beam_width=None, lm_fn=None, lm_weight=0.0):
        """Transcriptions and token error rates of a host batch.

        ``beam_width=None`` -> greedy best path; otherwise prefix beam
        search (sums over alignments, optional LM shallow fusion through
        ``lm_fn(prefix, token) -> logp``)."""
        logits, logit_lengths = self._encode(batch)
        logits = self.head(logits).cpu().numpy()
        logit_lengths = logit_lengths.cpu().numpy()
        if beam_width is None:
            hyps = ctc_greedy_decode(
                logits, logit_lengths, blank=self.blank)
        else:
            hyps = ctc_beam_search_decode(
                logits, logit_lengths, blank=self.blank,
                beam_width=beam_width, lm_fn=lm_fn, lm_weight=lm_weight)
        return _decode_results(batch, hyps)


class TransducerASR(_ASRModel):
    """Acoustic encoder + LSTM prediction network + additive joint,
    trained with the RNN-T loss (with ``causal=True`` both networks are
    causal and decoding is frame-synchronous).

    The joint is computed for the full (T', U+1) lattice in training.
    """

    def __init__(self, feature_extractor, vocab_size,
                 d_model=96, num_layers=2, num_heads=4, d_ff=None,
                 kernel_size=15, dropout=0.0, conv_norm='batch_norm',
                 causal=False, attn_window=None, subsample_channels=32,
                 pred_hidden=96, joint_dim=96):
        super().__init__(feature_extractor, vocab_size, d_model, num_layers,
                         num_heads, d_ff, kernel_size, dropout, conv_norm,
                         causal, attn_window, subsample_channels)
        # prediction network: blank-started label history -> states
        self.embed = nn.Embedding(vocab_size + 1, pred_hidden)
        self.pred_rnn = LSTM(pred_hidden, pred_hidden)
        # additive joint
        self.enc_proj = nn.Linear(d_model, joint_dim)
        self.pred_proj = nn.Linear(pred_hidden, joint_dim)
        self.joint_out = nn.Linear(joint_dim, vocab_size + 1)
        self.blank = 0

    def _predict(self, label_history):
        """(B, U+1) blank-started ids -> (B, U+1, H) states."""
        out, _ = self.pred_rnn(self.embed(label_history))
        return out

    def _joint(self, enc, pred):
        """(B, T', E), (B, U+1, H) -> (B, T', U+1, V+1)."""
        e = self.enc_proj(enc)[:, :, None, :]
        p = self.pred_proj(pred)[:, None, :, :]
        return self.joint_out(torch.tanh(e + p))

    def forward(self, inputs):
        enc, seq_len = self.acoustic(
            inputs['stft'], seq_len=inputs.get('seq_len'))
        labels = torch.as_tensor(inputs['labels'], device=enc.device)
        history = F.pad(labels.long(), (1, 0), value=self.blank)
        logits = self._joint(enc, self._predict(history))
        return {'logits': logits, 'logit_lengths': seq_len}

    def review(self, inputs, outputs):
        logits = outputs['logits']
        logit_lengths = outputs['logit_lengths']
        if logit_lengths is None:
            logit_lengths = _full_lengths(logits)
        label_lengths = torch.as_tensor(inputs['label_lengths'],
                                        device=logits.device)
        nll = rnnt_loss(logits, logit_lengths, inputs['labels'],
                        label_lengths, blank=self.blank)
        per_token = nll / torch.clamp(label_lengths, min=1)
        return {
            'loss': per_token.mean(),
            'scalars': {'per_utt_nll': nll.mean()},
        }

    def _history(self, prefixes):
        """Blank-started, blank-padded (K, L+1) ids of ``prefixes`` on the
        model's device, and each prefix's last position."""
        width = max(len(p) for p in prefixes) + 1
        history = np.full((len(prefixes), width), self.blank, 'int64')
        for j, p in enumerate(prefixes):
            history[j, 1:1 + len(p)] = p
        device = self.embed.weight.device
        return (torch.from_numpy(history).to(device),
                torch.tensor([len(p) for p in prefixes], device=device))

    def _greedy(self, enc, seq, max_symbols_per_frame, pred=None):
        """Extend ``seq`` (in place) greedily over the frames of ``enc``
        (1, T, E); ``pred`` is the prediction network's output for ``seq``
        (None: not computed yet), returned for the next call.  The network
        runs once per emitted symbol: its output for an unchanged prefix is
        kept."""
        for t in range(enc.shape[1]):
            for _ in range(max_symbols_per_frame):
                if pred is None:
                    history, _ = self._history([seq])
                    pred = self._predict(history)[:, -1:, :]
                scores = self._joint(enc[:, t:t + 1], pred)
                token = int(scores.reshape(-1).argmax())
                if token == self.blank:
                    break
                seq.append(token)
                pred = None
        return pred

    @torch.no_grad()
    def decode(self, batch, max_symbols_per_frame=4, beam_width=None):
        """Frame-synchronous transducer decoding of a host batch (a host
        loop over frames).

        ``beam_width=None`` -> greedy; otherwise depth-synchronous beam
        search (:func:`padertorch_tpu_torch.ops.losses.rnnt
        .rnnt_beam_search`), every expansion level scored in one batch.
        """
        model = self.eval()
        enc, seq_len = model._encode(batch)
        seq_len = seq_len.cpu().numpy()
        if beam_width is not None:
            def joint_batch_fn(frame, prefixes):
                history, last_idx = model._history(prefixes)
                pred = model._predict(history)              # (K, L+1, H)
                last = pred[torch.arange(len(prefixes)), last_idx][:, None]
                frame = torch.from_numpy(frame).to(enc.device)
                e = frame.expand(len(prefixes), 1, -1)
                return model._joint(e, last)[:, 0, 0, :].cpu().numpy()

            hyps = rnnt_beam_search(
                None, enc.cpu().numpy(), logit_lengths=seq_len,
                blank=model.blank, beam_width=beam_width,
                max_symbols_per_frame=max_symbols_per_frame,
                joint_batch_fn=joint_batch_fn)
            return _decode_results(batch, hyps)
        hyps = [[] for _ in range(enc.shape[0])]
        for i, seq in enumerate(hyps):
            model._greedy(enc[i:i + 1, :int(seq_len[i])], seq,
                          max_symbols_per_frame)
        return _decode_results(batch, hyps)

    @torch.no_grad()
    def stream_decode(self, stft_chunks, max_symbols_per_frame=4,
                      max_frames=4096):
        """Online (streaming) greedy recognition of one utterance.

        Requires the ``causal=True`` variant.  Each incoming chunk of STFT
        frames (a multiple of 4, shape ``(Tc, F, 2)`` or
        ``(1, 1, Tc, F, 2)``) costs O(chunk) encoder work through
        :meth:`AcousticEncoder.stream_step`; emitted tokens are final as
        soon as their frame arrives.  Equal to the offline greedy
        :meth:`decode` transcript.

        Args:
            stft_chunks: iterable of chunks (arrays or tensors).
            max_symbols_per_frame: transducer expansion bound.
            max_frames: upper bound on the input frames (sizes the
                preallocated attention cache).

        Returns:
            list of token ids.
        """
        model = self.eval()
        device = model.embed.weight.device
        state = model.acoustic.init_stream(1, max_frames)
        seq, pred = [], None
        frame_index = 0
        for chunk in stft_chunks:
            chunk = torch.as_tensor(np.asarray(chunk)).to(device)
            if chunk.dim() == 3:
                chunk = chunk[None, None]
            enc, state = model.acoustic.stream_step(chunk, state,
                                                    frame_index)
            frame_index += chunk.shape[2]
            pred = model._greedy(enc, seq, max_symbols_per_frame, pred)
        return seq


class AttentionASR(_ASRModel):
    """Attention encoder-decoder (AED) recognizer.

    The shared acoustic encoder feeds a KV-cache transformer decoder
    through cross-attention.  Training is teacher-forced label-smoothed
    cross-entropy; decoding runs the port's generation loops
    (``autoregressive_generate``, ``beam_search_generate``) or its
    ``ContinuousBatcher``.

    Token ids are shared with the other heads: real tokens are
    ``1..vocab_size``; ``0`` doubles as BOS (it is never a target) and
    ``vocab_size + 1`` is EOS, so the output head has ``vocab_size + 2``
    classes.
    """

    def __init__(self, feature_extractor, vocab_size,
                 d_model=96, num_layers=2, num_heads=4, d_ff=None,
                 kernel_size=15, dropout=0.0, conv_norm='batch_norm',
                 causal=False, attn_window=None, subsample_channels=32,
                 decoder_layers=2, label_smoothing=0.1,
                 max_decode_len=32):
        super().__init__(feature_extractor, vocab_size, d_model, num_layers,
                         num_heads, d_ff, kernel_size, dropout, conv_norm,
                         causal, attn_window, subsample_channels)
        self.embed = nn.Embedding(vocab_size + 2, d_model)
        self.decoder = TransformerDecoder(
            d_model, decoder_layers, num_heads, d_ff=d_ff,
            dropout=dropout, d_memory=d_model)
        self.head = nn.Linear(d_model, vocab_size + 2)
        self.bos = 0
        self.eos = vocab_size + 1
        self.label_smoothing = label_smoothing
        self.max_decode_len = max_decode_len

    def forward(self, inputs):
        enc, seq_len = self.acoustic(
            inputs['stft'], seq_len=inputs.get('seq_len'))
        labels = torch.as_tensor(inputs['labels'], device=enc.device)
        # teacher forcing: decoder input = [BOS, y_1 .. y_U]; padding rows
        # sit after every valid target, so causal self-attention of valid
        # positions never sees them
        history = F.pad(labels.long(), (1, 0), value=self.bos)
        h = self.decoder(self.embed(history), enc, memory_seq_len=seq_len)
        return {'logits': self.head(h),        # (B, U+1, V+2)
                'encoder_lengths': seq_len}

    def _targets_and_mask(self, inputs, num_positions, device):
        """Shift-by-one targets with EOS appended at ``label_length``:
        (B, U+1) target ids and a float mask selecting positions
        ``0 .. label_length`` (the EOS prediction is a real target)."""
        labels = torch.as_tensor(inputs['labels'], device=device).long()
        label_lengths = torch.as_tensor(inputs['label_lengths'],
                                        device=device)
        positions = torch.arange(num_positions, device=device)[None, :]
        targets = F.pad(labels, (0, 1))[:, :num_positions]
        targets = torch.where(positions == label_lengths[:, None],
                              self.eos, targets)
        mask = (positions <= label_lengths[:, None]).to(torch.float32)
        return targets, mask

    def review(self, inputs, outputs):
        logits = outputs['logits']
        targets, mask = self._targets_and_mask(inputs, logits.shape[1],
                                               logits.device)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        if self.label_smoothing:
            eps = self.label_smoothing
            # uniform smoothing over all classes
            nll = (1.0 - eps) * nll + eps * (-logp.mean(dim=-1))
        # per-utterance token mean, then batch mean (the other heads'
        # per-token normalization)
        per_utt = (nll * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
        correct = (torch.argmax(logits, -1) == targets).to(torch.float32)
        return {
            'loss': per_utt.mean(),
            'scalars': {
                'teacher_forced_accuracy':
                    (correct * mask).sum() / torch.clamp(mask.sum(),
                                                         min=1.0),
            },
        }

    @torch.no_grad()
    def decode(self, batch, beam_width=None, max_len=None,
               length_penalty=0.0):
        """Transcriptions and token error rates of a host batch.

        ``beam_width=None`` -> greedy; otherwise KV-cache beam search,
        each over ``max_len`` steps (default the model's
        ``max_decode_len``)."""
        model = self.eval()
        if max_len is None:
            max_len = model.max_decode_len
        enc, seq_len = model._encode(batch)
        if beam_width is None:
            tokens, lengths = autoregressive_generate(
                model.decoder, enc, embed=model.embed,
                logits_head=model.head, bos_id=model.bos,
                max_len=max_len, memory_seq_len=seq_len,
                eos_id=model.eos)
        else:
            tokens, _, lengths = beam_search_generate(
                model.decoder, enc, embed=model.embed,
                logits_head=model.head, bos_id=model.bos,
                max_len=max_len, beam_size=beam_width,
                eos_id=model.eos, memory_seq_len=seq_len,
                length_penalty=length_penalty)
            tokens, lengths = tokens[:, 0], lengths[:, 0]
        tokens = tokens.cpu().numpy()
        lengths = lengths.cpu().numpy()
        hyps = [self._clean_hyp(tokens[i, :int(lengths[i])].tolist())
                for i in range(tokens.shape[0])]
        return _decode_results(batch, hyps)

    def _clean_hyp(self, seq):
        if seq and seq[-1] == self.eos:  # strip the stop token
            seq = seq[:-1]
        return [t for t in seq if 1 <= t <= self.vocab_size]

    @torch.no_grad()
    def serve_decode(self, batch, num_slots=4, max_len=None):
        """Greedy decode through the continuous-batching server path
        (:class:`padertorch_tpu_torch.serve.ContinuousBatcher`): each
        utterance is an independent request in a fixed slot pool; short
        ones leave early and free their slot.  Transcripts are the greedy
        :meth:`decode` transcripts."""
        model = self.eval()
        if max_len is None:
            max_len = model.max_decode_len
        enc, seq_len = model._encode(batch)
        seq_len = seq_len.cpu().numpy()
        batcher = ContinuousBatcher(
            model.decoder, embed=model.embed, logits_head=model.head,
            num_slots=num_slots, max_len=max_len,
            max_memory_len=enc.shape[1], d_memory=enc.shape[-1],
            bos_id=model.bos, eos_id=model.eos,
            max_new_tokens=max_len, dtype=enc.dtype)
        ids = [batcher.submit(enc[i], memory_len=int(seq_len[i]))
               for i in range(enc.shape[0])]
        outputs = batcher.run_until_done()
        hyps = [self._clean_hyp(outputs[rid]) for rid in ids]
        return _decode_results(batch, hyps)
