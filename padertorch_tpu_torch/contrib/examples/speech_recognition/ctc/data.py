"""Data pipeline for the Conformer speech recognition recipe.

Counterpart of ``padertorch_tpu/contrib/examples/speech_recognition/ctc/
data.py``, the same host STFT and padded collate (numpy, in the prefetch
threads), on the port's ``contrib/je/data/transforms.py`` ``STFT`` and
``data/utils.py``.

The synthetic task is "spoken token sequences": every vocabulary entry
is a pure tone at a token-specific frequency, utterances are 3-8 tokens
with short silences in between, plus broadband noise.  A CTC model has
to localize and order the tokens — the full alignment-free pipeline
(subsampled encoder frames vs label sequence) is exercised.
"""
import numpy as np

from padertorch_tpu_torch.data import dataset as lazy
from padertorch_tpu_torch.data.utils import collate_fn, pad_batch
from padertorch_tpu_torch.contrib.je.data.transforms import STFT

SAMPLE_RATE = 8000
STFT_PARAMS = dict(shift=128, size=256, window_length=256, pad=True,
                   fading=None)
VOCAB_SIZE = 10  # token ids 1..VOCAB_SIZE; 0 is the CTC blank


def synthetic_database(num_examples=96, vocab_size=VOCAB_SIZE,
                       min_tokens=3, max_tokens=8, seed=0,
                       noise_level=0.05, markov=0.0):
    """Tone-sequence utterances with token-id transcriptions.

    ``markov`` > 0 draws each next token as ``prev + 1`` (wrapping)
    with that probability instead of uniformly — structured
    transcripts that an n-gram LM can exploit (shallow fusion demo,
    ``evaluate.py --lm_order``).
    """
    rng = np.random.RandomState(seed)
    # token v -> tone at 200 + 170*v Hz (well below Nyquist = 4 kHz)
    freqs = 200.0 + 170.0 * np.arange(1, vocab_size + 1)

    def draw_labels(n):
        if markov <= 0:
            return rng.randint(1, vocab_size + 1, n)
        labels = [int(rng.randint(1, vocab_size + 1))]
        for _ in range(n - 1):
            if rng.rand() < markov:
                labels.append(labels[-1] % vocab_size + 1)
            else:
                labels.append(int(rng.randint(1, vocab_size + 1)))
        return np.asarray(labels)

    examples = {}
    for i in range(num_examples):
        n_tokens = int(rng.randint(min_tokens, max_tokens + 1))
        labels = draw_labels(n_tokens)
        pieces = [np.zeros(rng.randint(100, 300), dtype='float32')]
        for v in labels:
            dur = int(rng.randint(900, 1500))
            t = np.arange(dur) / SAMPLE_RATE
            phase = rng.uniform(0, 2 * np.pi)
            tone = 0.5 * np.sin(2 * np.pi * freqs[v - 1] * t + phase)
            # short fade in/out so token boundaries are not clicks
            ramp = np.minimum(np.arange(dur), np.arange(dur)[::-1])
            tone = tone * np.minimum(ramp / 80.0, 1.0)
            pieces += [tone.astype('float32'),
                       np.zeros(rng.randint(100, 300), dtype='float32')]
        audio = np.concatenate(pieces)
        audio = audio + noise_level * rng.randn(len(audio)).astype(
            'float32')
        examples[f'utt_{i}'] = {
            'example_id': f'utt_{i}',
            'audio_data': audio.astype('float32'),
            'seq_len': len(audio),
            'labels': labels.astype('int32'),
        }
    return lazy.from_dict(examples)


def finalize(example):
    return {
        'example_id': example['example_id'],
        'stft': example['stft'][None].astype('float32'),  # (C=1, T, F, 2)
        'seq_len': example['seq_len'],
        'labels': np.asarray(example['labels'], dtype='int32'),
        'num_labels': len(example['labels']),
    }


def post_batch(batch):
    # pad to multiples, as the JAX recipe does (lengths stay exact;
    # padding is masked by seq_len/label_lengths)
    batch = collate_fn(batch)
    stft, _ = pad_batch(batch['stft'], axis=1, multiple=32)
    labels, label_lengths = pad_batch(batch['labels'], axis=0, multiple=4)
    return {
        'example_id': list(batch['example_id']),
        'stft': stft,
        'seq_len': np.asarray(batch['seq_len'], dtype='int32'),
        'labels': labels.astype('int32'),
        'label_lengths': np.asarray(label_lengths, dtype='int32'),
    }


def prepare_dataset(dataset, batch_size=8, shuffle=True, prefetch=True):
    stft = STFT(**STFT_PARAMS)
    dataset = dataset.map(stft).map(finalize)
    if shuffle:
        dataset = dataset.shuffle(reshuffle=True)
    dataset = dataset.batch(batch_size).map(post_batch)
    if prefetch:
        dataset = dataset.prefetch(4, 8)
    return dataset
