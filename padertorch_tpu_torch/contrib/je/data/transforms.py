"""Host-side data transforms for the recipes.

Counterpart of ``padertorch_tpu/contrib/je/data/transforms.py`` (reference
``padertorch/contrib/je/data/transforms.py``): the numpy ``STFT`` and the
``LabelEncoder`` (which persists its label map to the storage dir), copied
as they are (numpy only).  They run in the prefetch threads, not on the
device.  ``AudioReader``, ``TimeWarpedSTFT``, the host ``MelTransform``,
the other encoders and the collating transforms are not ported yet
(ROADMAP.md Queue 1).
"""
import json
from pathlib import Path

import numpy as np

__all__ = ['STFT', 'LabelEncoder']


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
