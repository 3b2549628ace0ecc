"""Host-side data transforms for the recipes.

Counterpart of ``padertorch_tpu/contrib/je/data/transforms.py`` (reference
``padertorch/contrib/je/data/transforms.py``): ``AudioReader``, the numpy
``STFT`` and ``TimeWarpedSTFT``, the host ``MelTransform``, the
``LabelEncoder`` (which persists its label map to the storage dir as
``f'{label_key}s.json'``), ``MultiHotEncoder``, ``AlignmentEncoder``,
``MultiHotAlignmentEncoder``, ``StackArrays``, ``ConcatenateArrays`` and
``Collate``, copied as they are (numpy only; ``AudioReader`` decodes int16
through the native ``pcm16_to_float32`` of ``padertorch_tpu_torch/native``).
They run in the prefetch threads, not on the device.
"""
import json
from pathlib import Path

import numpy as np

from padertorch_tpu_torch.data.utils import collate_fn, pad_batch

__all__ = [
    'AudioReader',
    'STFT',
    'TimeWarpedSTFT',
    'MelTransform',
    'LabelEncoder',
    'MultiHotEncoder',
    'AlignmentEncoder',
    'MultiHotAlignmentEncoder',
    'Collate',
    'StackArrays',
    'ConcatenateArrays',
]


class AudioReader:
    """Read (and normalize) audio from example['audio_path'].

    Reference parity: ``je/data/transforms.py:20``.  Uses scipy's wav
    reader (no soundfile dependency in this environment).
    """

    def __init__(self, source_sample_rate=16000, target_sample_rate=16000,
                 average_channels=True, normalization_domain=None):
        self.source_sample_rate = source_sample_rate
        self.target_sample_rate = target_sample_rate
        self.average_channels = average_channels
        self.normalization_domain = normalization_domain

    def read_file(self, filepath):
        from scipy.io import wavfile
        sr, data = wavfile.read(filepath)
        if data.dtype == np.int16:
            # GIL-releasing native decode (native/_dataprep.cpp) — the
            # prefetch threads convert in parallel; /32768 matches the
            # reference's soundfile normalization
            from padertorch_tpu_torch.native import pcm16_to_float32
            data = pcm16_to_float32(data)
        elif data.dtype.kind == 'i':
            data = data / -float(np.iinfo(data.dtype).min)
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 2:
            data = data.T  # (channels, samples)
        if sr != self.target_sample_rate:
            from scipy.signal import resample_poly
            import math
            g = math.gcd(sr, self.target_sample_rate)
            data = resample_poly(
                data, self.target_sample_rate // g, sr // g, axis=-1)
        return data

    def __call__(self, example):
        audio = self.read_file(example['audio_path'])
        if audio.ndim == 2 and self.average_channels:
            audio = audio.mean(0)
        if self.normalization_domain == 'instance':
            audio = audio / (np.abs(audio).max() + 1e-6)
        example['audio_data'] = audio
        example['seq_len'] = audio.shape[-1]
        return example


class STFT:
    """Host numpy STFT (same parameters as the device op).

    Reference parity: ``je/data/transforms.py:193``.  With
    ``alignment_keys`` the transform also converts
    ``{key}_start_samples``/``{key}_stop_samples`` annotations to frame
    indices (``{key}_start_frames``/``{key}_stop_frames``).
    """

    def __init__(self, shift, size, window_length=None, pad=True,
                 fading='full', window='blackman', alignment_keys=None):
        from padertorch_tpu_torch.ops._stft import HostSTFT
        self._stft = HostSTFT(
            size=size, shift=shift, window_length=window_length, pad=pad,
            fading=fading, window=window,
            complex_representation='stacked')
        self.shift = shift
        self.size = size
        self.window_length = self._stft.window_length
        self.window = window
        self.pad = pad
        self.fading = fading
        self.alignment_keys = alignment_keys

    def __call__(self, example):
        audio = np.asarray(example['audio_data'])
        stft = np.asarray(self._stft(audio))
        example['stft'] = stft.astype(np.float32)
        if 'seq_len' in example:
            example['seq_len'] = self._stft.samples_to_frames(
                example['seq_len'])
        self.add_start_stop_frames(example)
        return example

    def samples_to_frames(self, samples):
        return self._stft.samples_to_frames(samples)

    def sample_index_to_frame_index(self, sample_index):
        return self._stft.sample_index_to_frame_index(sample_index)

    def add_start_stop_frames(self, example):
        """Frame-index annotations for every alignment key present."""
        for key in (self.alignment_keys or ()):
            for boundary in ('start', 'stop'):
                samples_key = f'{key}_{boundary}_samples'
                if samples_key in example:
                    example[f'{key}_{boundary}_frames'] = [
                        self.sample_index_to_frame_index(int(s))
                        for s in np.atleast_1d(example[samples_key])
                    ]


class TimeWarpedSTFT:
    """Piecewise time-warping STFT augmentation.

    Reference parity: ``je/data/transforms.py:229``.  Samples a warp
    anchor a in (0, 1) and a shift for it; the signal left of the anchor
    is analyzed with a smaller/larger frame shift and the right part
    with the complementary one, so total frame count is preserved while
    content moves relative to the anchor.  Alignment annotations
    (``alignment_keys`` of the base STFT) are warped accordingly.
    """

    def __init__(self, base_stft, anchor_sampling_fn,
                 anchor_shift_sampling_fn):
        self.base_stft = base_stft
        self.anchor_sampling_fn = anchor_sampling_fn
        self.anchor_shift_sampling_fn = anchor_shift_sampling_fn

    def __call__(self, example):
        from padertorch_tpu_torch.ops._stft import HostSTFT
        base = self.base_stft
        anchor = float(self.anchor_sampling_fn())
        anchor_shift = float(self.anchor_shift_sampling_fn())
        warp_factor = (anchor + anchor_shift) / anchor

        overlap = base.window_length - base.shift
        audio = self._pad_audio(np.atleast_2d(
            np.asarray(example['audio_data'])))
        num_samples = audio.shape[-1]
        # frame shift left of the anchor (squeezed by warp_factor) and
        # right of it (stretched so the total length matches)
        shift_left = round(base.shift / warp_factor)
        shift_right = round(
            base.shift * (1 - anchor) / (1 - anchor * warp_factor))
        warp_factor = base.shift / shift_left  # rounding-corrected

        boundary = (num_samples - overlap) * anchor
        boundary = round(boundary / shift_left) * shift_left + overlap

        segments = []
        for index, (onset, length, shift) in enumerate([
                (0, boundary, shift_left),
                (boundary - overlap, num_samples - boundary + overlap,
                 shift_right),
        ]):
            seg_stft = HostSTFT(
                size=base.size, shift=shift,
                window_length=base.window_length, window=base.window,
                pad=(index == 1) and base.pad, fading=None,
                complex_representation='stacked')
            segments.append(np.asarray(
                seg_stft(audio[..., onset:onset + length])))
        stft = np.concatenate(segments, axis=1).astype(np.float32)
        example['stft'] = stft
        num_frames = stft.shape[1]
        if 'seq_len' in example:
            example['seq_len'] = num_frames

        if base.alignment_keys:
            base.add_start_stop_frames(example)
            # boundary is in PADDED-audio coordinates; the frame-index
            # conversion adds the fading pad itself, so undo it first
            left_pad = self._pad_widths()[0]
            boundary_frame = base.sample_index_to_frame_index(
                boundary - left_pad)

            def warp(frame):
                if frame < boundary_frame:
                    return round(frame * warp_factor)
                return round(
                    boundary_frame * warp_factor
                    + (frame - boundary_frame)
                    * (num_frames - boundary_frame * warp_factor)
                    / (num_frames - boundary_frame))

            for key in base.alignment_keys:
                for boundary_name in ('start', 'stop'):
                    frames_key = f'{key}_{boundary_name}_frames'
                    if frames_key in example:
                        example[frames_key] = [
                            warp(f) for f in example[frames_key]]
        return example

    def _pad_widths(self):
        import math
        base = self.base_stft
        pad = base.window_length - base.shift
        if base.fading == 'full':
            return (pad, pad)
        if base.fading == 'half':
            return (pad // 2, math.ceil(pad / 2))
        if base.fading is None:
            return (0, 0)
        raise ValueError(f'Invalid fading {base.fading}.')

    def _pad_audio(self, audio):
        widths = self._pad_widths()
        if sum(widths):
            audio = np.pad(audio, [(0, 0), widths], mode='constant')
        return audio


class MelTransform:
    """Host log-mel from stacked-complex STFT. Reference: transforms.py:332."""

    def __init__(self, sample_rate, stft_size, number_of_filters,
                 lowest_frequency=50, highest_frequency=None, log=True):
        from padertorch_tpu_torch.contrib.je.modules.features import get_fbanks
        fbanks = get_fbanks(
            sample_rate, stft_size, number_of_filters,
            lowest_frequency=lowest_frequency,
            highest_frequency=highest_frequency,
        ).astype(np.float32)
        fbanks = fbanks / (fbanks.sum(axis=-1, keepdims=True) + 1e-6)
        self.fbanks = fbanks.T
        self.log = log

    def __call__(self, example):
        stft = example['stft']
        power = (stft[..., 0] ** 2 + stft[..., 1] ** 2)
        mel = power @ self.fbanks
        if self.log:
            mel = np.log(mel + 1e-12)
        example['mel'] = mel.astype(np.float32)
        return example


class LabelEncoder:
    """Map labels to indices; persists the map into the storage dir.

    Reference parity: ``je/data/transforms.py:343``.
    """

    def __init__(self, label_key='label', storage_dir=None, to_array=False):
        self.label_key = label_key
        self.storage_dir = storage_dir
        self.to_array = to_array
        self.label_mapping = None
        self.inverse_label_mapping = None

    def initialize_labels(self, labels=None, dataset=None, verbose=False):
        filename = f'{self.label_key}s.json'
        filepath = None if self.storage_dir is None \
            else Path(self.storage_dir) / filename
        if filepath and filepath.exists():
            labels = json.loads(filepath.read_text())
            if verbose:
                print(f'Restored {self.label_key}s from {filepath}')
        else:
            if labels is None:
                labels = set()
                for example in dataset:
                    value = example[self.label_key]
                    if isinstance(value, (list, tuple)):
                        labels.update(value)
                    else:
                        labels.add(value)
                labels = sorted(labels)
            if filepath:
                filepath.parent.mkdir(parents=True, exist_ok=True)
                filepath.write_text(json.dumps(labels))
                if verbose:
                    print(f'Saved {self.label_key}s to {filepath}')
        self.label_mapping = {
            label: i for i, label in enumerate(labels)}
        self.inverse_label_mapping = {
            i: label for label, i in self.label_mapping.items()}
        return self

    def __call__(self, example):
        value = example[self.label_key]
        if isinstance(value, (list, tuple)):
            encoded = [self.label_mapping[v] for v in value]
        else:
            encoded = self.label_mapping[value]
        if self.to_array:
            encoded = np.asarray(encoded)
        example[self.label_key] = encoded
        return example

    def inverse_transform(self, indices):
        if isinstance(indices, (list, tuple, np.ndarray)):
            return [self.inverse_label_mapping[int(i)] for i in indices]
        return self.inverse_label_mapping[int(indices)]


class MultiHotEncoder(LabelEncoder):
    """Multi-hot label vectors. Reference: ``je/data/transforms.py:402``."""

    def __init__(self, label_key='events', storage_dir=None):
        super().__init__(label_key=label_key, storage_dir=storage_dir)

    def __call__(self, example):
        values = example[self.label_key]
        if not isinstance(values, (list, tuple)):
            values = [values]
        multi_hot = np.zeros(len(self.label_mapping), dtype=np.float32)
        for v in values:
            multi_hot[self.label_mapping[v]] = 1.0
        example[self.label_key] = multi_hot
        return example


class AlignmentEncoder(LabelEncoder):
    """Expand per-event labels into a frame-level alignment vector
    (reference ``je/data/transforms.py:421``): frames in
    ``[<key>_start_frames[i], <key>_stop_frames[i])`` get label index i's
    encoded value; unlabeled frames stay 0.  Frame count comes from
    ``example['stft'].shape[1]``.
    """

    def __call__(self, example):
        labels = super().__call__(example)[self.label_key]
        if not isinstance(labels, (list, tuple, np.ndarray)):
            labels = [labels]
        n_frames = example['stft'].shape[1]
        ali = np.zeros(n_frames, dtype=np.float32)
        assert f'{self.label_key}_start_frames' in example, example.keys()
        for label, onset, offset in zip(
                labels,
                example[f'{self.label_key}_start_frames'],
                example[f'{self.label_key}_stop_frames'],
        ):
            ali[onset:offset] = label
        example[self.label_key] = ali
        return example


class MultiHotAlignmentEncoder(LabelEncoder):
    """Frame-level multi-hot alignment matrix ``(T, n_labels)``
    (reference ``je/data/transforms.py:440``); overlapping events are
    both active.
    """

    def __call__(self, example):
        assert f'{self.label_key}_start_frames' in example, example.keys()
        labels = super().__call__(example)[self.label_key]
        if not isinstance(labels, (list, tuple, np.ndarray)):
            labels = [labels]
        seq_len = example['stft'].shape[1]
        example[self.label_key] = self.encode_alignment(
            zip(
                example[f'{self.label_key}_start_frames'],
                example[f'{self.label_key}_stop_frames'],
                labels,
            ),
            seq_len=seq_len,
        )
        return example

    def encode_alignment(self, onset_offset_label, seq_len):
        ali = np.zeros((seq_len, len(self.label_mapping)), dtype=np.float32)
        for onset, offset, label in onset_offset_label:
            ali[onset:offset, label] = 1
        return ali


class StackArrays:
    """Stack a list of arrays that may differ in ONE dimension.

    Reference parity: ``je/data/transforms.py:465``.  Zero-pads to the
    per-axis maximum (or truncates to the minimum with ``cut_end``) and
    stacks along ``axis``.

    >>> batch = [np.ones((2, 3)), np.zeros((2, 5))]
    >>> StackArrays()(batch).shape
    (2, 2, 5)
    >>> StackArrays(axis=1)(batch).shape
    (2, 2, 5)
    >>> StackArrays(cut_end=True)(batch).shape
    (2, 2, 3)
    >>> StackArrays()({'x': batch})['x'].shape
    (2, 2, 5)
    """

    def __init__(self, axis=0, cut_end=False):
        self.axis = axis
        self.cut_end = cut_end

    def __call__(self, example):
        from padertorch_tpu_torch.utils.nested import nested_op
        if isinstance(example, dict):
            return nested_op(self.stack, example, sequence_type=())
        if isinstance(example, (list, tuple)):
            return self.stack(example)
        return example

    def stack(self, batch):
        if not (isinstance(batch, list) and batch
                and isinstance(batch[0], np.ndarray)):
            return batch
        shapes = np.asarray([array.shape for array in batch])
        target = shapes.min(0) if self.cut_end else shapes.max(0)
        # arrays may differ in ONE dimension globally (checking each
        # array against the target alone lets two-dim mismatches pass,
        # e.g. (2, 3) vs (3, 2) -> target (3, 3))
        varying_dims = np.flatnonzero((shapes != shapes[0]).any(0))
        assert varying_dims.size <= 1, (
            'arrays may differ in at most one dim',
            [tuple(shape) for shape in shapes])
        axis = self.axis if self.axis >= 0 \
            else len(target) + 1 + self.axis
        out_shape = [*target[:axis], len(batch), *target[axis:]]
        out = np.zeros(out_shape, dtype=batch[0].dtype)
        for i, array in enumerate(batch):
            region = tuple(
                slice(int(n)) for n in np.minimum(target, array.shape))
            out[(*region[:axis], i, *region[axis:])] = array[region]
        return out


class ConcatenateArrays:
    """Concatenate list-of-arrays leaves along ``axis``.

    Reference parity: ``je/data/transforms.py:520``.

    >>> ConcatenateArrays(axis=0)([np.ones((2, 3)), np.zeros((1, 3))]).shape
    (3, 3)
    """

    def __init__(self, axis):
        self.axis = axis

    def __call__(self, example):
        from padertorch_tpu_torch.utils.nested import nested_op
        if isinstance(example, dict):
            return nested_op(self.concatenate, example, sequence_type=())
        if isinstance(example, (list, tuple)):
            return self.concatenate(example)
        return example

    def concatenate(self, batch):
        if isinstance(batch, list) and batch \
                and isinstance(batch[0], np.ndarray):
            return np.concatenate(
                batch, axis=self.axis).astype(batch[0].dtype)
        return batch


class Collate:
    """Batch list -> dict of padded stacks. Reference: transforms.py:537."""

    def __init__(self, to_tensor=False, pad_keys=None, pad_axis=0):
        self.to_tensor = to_tensor
        self.pad_keys = pad_keys
        self.pad_axis = pad_axis

    def __call__(self, batch):
        batch = collate_fn(batch)
        out = {}
        for key, values in batch.items():
            if isinstance(values, (list, tuple)) and len(values) > 0 \
                    and isinstance(values[0], np.ndarray):
                if self.pad_keys is None or key in self.pad_keys:
                    stacked, lens = pad_batch(
                        list(values), axis=self.pad_axis)
                    out[key] = stacked
                    continue
            if isinstance(values, (list, tuple)) and len(values) > 0 \
                    and np.isscalar(values[0]):
                out[key] = np.asarray(values)
            else:
                out[key] = values
        return out
