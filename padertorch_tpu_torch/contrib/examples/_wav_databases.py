"""Write WAV trees and the JSON databases that list them, from a seed.

The recipes read JSON databases of the form ``{"datasets": {split:
{example_id: {...}}}}`` whose examples name WAV files under
``audio_path``.  This module writes small ones in the schemas the recipes'
``--database`` branches read, with the variety real corpora have: int16
mono files whose lengths differ by up to two times, a stereo file, an
int32 file and an 8 kHz file (which ``AudioReader`` resamples with
``resample_poly``):

- :func:`write_wsj0_2mix`: ``mix_2_spk_min_tr``/``_cv``/``_tt``, each
  example with ``audio_path.observation`` and two
  ``audio_path.speech_source`` files (the separation recipes);
- :func:`write_librispeech`: ``train_clean_100``, ``dev_clean`` and
  ``test_clean``, one ``audio_path`` and a ``speaker_id`` each (the vocoder
  and the speaker classifier);
- :func:`write_audioset`: ``balanced_train``, ``validate`` and ``eval``,
  one ``audio_path``, its ``audio_length`` in seconds and its ``events``
  (the audio tagger);
- :func:`write_chime`: ``et05_simu``, one file a channel under
  ``audio_path.observation`` and ``audio_path.speech_source`` (the mask
  estimator's evaluation).

The tests and ``chip_smoke.py`` build their real-audio runs on these.

>>> import tempfile
>>> with tempfile.TemporaryDirectory() as root:
...     db = json.loads(write_librispeech(root, num_speakers=2,
...                                       per_speaker=2).read_text())
>>> sorted(db['datasets']), len(db['datasets']['train_clean_100'])
(['dev_clean', 'test_clean', 'train_clean_100'], 4)
"""
import json
from pathlib import Path

import numpy as np
from scipy.io import wavfile

__all__ = ['write_wav', 'write_wsj0_2mix', 'write_librispeech',
           'write_audioset', 'write_chime']


def write_wav(path, audio, sample_rate, kind='int16'):
    """``audio`` in [-1, 1], (samples,) or (samples, channels), written
    as ``kind``: 'int16', 'int32' or 'float32'."""
    audio = np.clip(np.asarray(audio, np.float64), -1, 1)
    if kind == 'int16':
        audio = (audio * 32767).astype(np.int16)
    elif kind == 'int32':
        audio = (audio * 2147483647).astype(np.int32)
    elif kind == 'float32':
        audio = audio.astype(np.float32)
    else:
        raise ValueError(kind)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(str(path), int(sample_rate), audio)
    return str(path)


def _tone(rng, n, sample_rate):
    t = np.arange(n) / sample_rate
    f = rng.uniform(100, 1500)
    env = 1 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
    return (rng.uniform(0.2, 0.45) * env * np.sin(2 * np.pi * f * t)
            + 0.01 * rng.randn(n))


def _lengths(rng, count, min_samples):
    """Lengths in [min_samples, 2 * min_samples]: the longest of a set
    is up to twice the shortest."""
    lengths = rng.randint(min_samples, 2 * min_samples + 1, count)
    lengths[0], lengths[-1] = min_samples, 2 * min_samples
    return lengths


def _dump(root, name, datasets):
    path = Path(root) / f'{name}.json'
    path.write_text(json.dumps({'datasets': datasets}, indent=1))
    return path


def write_wsj0_2mix(root, examples_per_split=(6, 4, 3), min_samples=8000,
                    sample_rate=16000, seed=0):
    """Two-speaker mixtures in the wsj0-2mix ``min`` schema; returns the
    JSON's path.  The first mixture of each split is written at 8 kHz
    (half the samples), the second's observation as int32; the rest are
    int16 at ``sample_rate``."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    datasets = {}
    for split, count in zip(('mix_2_spk_min_tr', 'mix_2_spk_min_cv',
                             'mix_2_spk_min_tt'), examples_per_split):
        examples = {}
        for i, n in enumerate(_lengths(rng, count, min_samples)):
            sr = sample_rate // 2 if i == 0 else sample_rate
            n = n // 2 if i == 0 else n
            sources = [_tone(rng, n, sr) for _ in range(2)]
            folder = root / 'wsj0_2mix' / split
            example_id = f'{split}_{i}'
            examples[example_id] = {
                'audio_path': {
                    'observation': write_wav(
                        folder / 'mix' / f'{example_id}.wav',
                        sources[0] + sources[1], sr,
                        'int32' if i == 1 else 'int16'),
                    'speech_source': [
                        write_wav(folder / f's{k + 1}' / f'{example_id}.wav',
                                  s, sr)
                        for k, s in enumerate(sources)],
                },
                'num_samples': int(n),
            }
        datasets[split] = examples
    return _dump(root, 'wsj0_2mix', datasets)


def write_librispeech(root, num_speakers=4, per_speaker=3, min_samples=8000,
                      sample_rate=16000, seed=1):
    """Utterances of ``num_speakers`` speakers (each a voice of its own
    pitch) in each of the three LibriSpeech splits; returns the JSON's
    path.  The first utterance of each split is stereo, the second int32,
    the third 8 kHz."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    f0s = rng.uniform(90, 300, num_speakers)
    datasets = {}
    for split in ('train_clean_100', 'dev_clean', 'test_clean'):
        examples = {}
        lengths = _lengths(rng, num_speakers * per_speaker, min_samples)
        for i, n in enumerate(lengths):
            speaker = i % num_speakers
            sr = sample_rate // 2 if i == 2 else sample_rate
            n = n // 2 if i == 2 else n
            t = np.arange(n) / sr
            audio = (0.3 * np.sin(2 * np.pi * f0s[speaker] * t)
                     + 0.15 * np.sin(4 * np.pi * f0s[speaker] * t)
                     + 0.02 * rng.randn(n))
            if i == 0:
                audio = np.stack([audio, 0.5 * audio], axis=1)
            example_id = f'{split}_{speaker}_{i}'
            examples[example_id] = {
                'audio_path': write_wav(
                    root / 'librispeech' / split / f'{example_id}.wav',
                    audio, sr, 'int32' if i == 1 else 'int16'),
                'speaker_id': f'speaker_{speaker}',
                'num_samples': int(n),
            }
        datasets[split] = examples
    return _dump(root, 'librispeech', datasets)


EVENTS = ('dog', 'siren', 'speech', 'music')


def write_audioset(root, examples_per_split=(8, 4, 4), min_samples=8000,
                   sample_rate=16000, seed=2):
    """Clips whose events each add a tone of their own; returns the
    JSON's path.  The first clip of each split is stereo, the second
    int32, the third 8 kHz."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    freqs = 300 * 1.7 ** np.arange(len(EVENTS))
    datasets = {}
    for split, count in zip(('balanced_train', 'validate', 'eval'),
                            examples_per_split):
        examples = {}
        for i, n in enumerate(_lengths(rng, count, min_samples)):
            sr = sample_rate // 2 if i == 2 else sample_rate
            n = n // 2 if i == 2 else n
            t = np.arange(n) / sr
            active = [EVENTS[i % len(EVENTS)]]
            if i % 2:
                active.append(EVENTS[(i + 1) % len(EVENTS)])
            audio = 0.02 * rng.randn(n)
            for event in active:
                audio = audio + 0.3 * np.sin(
                    2 * np.pi * freqs[EVENTS.index(event)] * t)
            if i == 0:
                audio = np.stack([audio, audio[::-1]], axis=1)
            example_id = f'{split}_{i}'
            examples[example_id] = {
                'audio_path': write_wav(
                    root / 'audioset' / split / f'{example_id}.wav',
                    audio, sr, 'int32' if i == 1 else 'int16'),
                'audio_length': n / sr,
                'events': active,
                'dataset': split,
            }
        datasets[split] = examples
    return _dump(root, 'audioset', datasets)


def write_chime(root, num_examples=3, num_channels=4, min_samples=32000,
                sample_rate=16000, seed=3):
    """Multi-channel mixtures (delayed, attenuated speech plus noise of
    each channel's own) in a CHiME ``et05_simu``-style split; returns the
    JSON's path.  The first example is one multichannel file.  At the
    mask estimator's 8 kHz, two seconds (``min_samples`` at 16 kHz) leave
    STOI the 30 frames it needs."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    examples = {}
    for i, n in enumerate(_lengths(rng, num_examples, min_samples)):
        speech = _tone(rng, n, sample_rate)
        channels = [rng.uniform(0.7, 1.0) * np.roll(speech, rng.randint(8))
                    + 0.1 * rng.randn(n) for _ in range(num_channels)]
        example_id = f'et05_simu_{i}'
        folder = root / 'chime' / example_id
        if i == 0:
            observation = write_wav(folder / 'observation.wav',
                                    0.5 * np.stack(channels, axis=1),
                                    sample_rate)
        else:
            observation = {
                f'CH{c + 1}': write_wav(folder / f'CH{c + 1}.wav',
                                        0.5 * ch, sample_rate)
                for c, ch in enumerate(channels)}
        examples[example_id] = {
            'audio_path': {
                'observation': observation,
                'speech_source': write_wav(folder / 'speech.wav',
                                           0.5 * speech, sample_rate),
            },
            'num_samples': int(n),
        }
    return _dump(root, 'chime', {'et05_simu': examples})
