"""Train a Conformer speech recognizer: CTC, transducer or attention head.

Counterpart of ``padertorch_tpu/contrib/examples/speech_recognition/ctc/
train.py``: argparse entry point, synthetic tone-sequence data or a JSON
database (``--database``, a ``JsonDatabase`` whose ``train`` and ``dev``
splits hold ``audio_data``, ``seq_len`` and integer ``labels``), the
trainer's config dumped to the storage dir, ``test_run`` before training.
It leaves a storage dir, with its per-experiment ``Makefile``
(``write_recipe_makefile``), that this package's ``evaluate.py`` loads.

On the card the conformer's self-attention runs the flash attention
kernels (forward with the log-sum-exp and backward in a training step),
the transducer's prediction network the ``lstm_cell_scan`` kernels (one
direction), and the attention head's decoder the attention kernels in its
causal self-attention and its cross-attention.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.speech_recognition.ctc.train \
        --storage_root /tmp/asr --synthetic --epochs 5 --model transducer
Run on the CPU: add ``--device cpu``.
"""
import argparse
from pathlib import Path

import torch

from padertorch_tpu_torch.contrib.examples._makefile import (
    evaluate_args_of, write_recipe_makefile)
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer
from padertorch_tpu_torch.utils.nested import nested_merge

from . import data
from .model import AttentionASR, ConformerCTC, TransducerASR

HEADS = {'ctc': ConformerCTC, 'transducer': TransducerASR,
         'aed': AttentionASR}


def get_trainer_config(storage_dir, model='ctc', vocab_size=data.VOCAB_SIZE,
                       d_model=96, num_layers=2, num_heads=4, kernel_size=15,
                       causal=False, epochs=50, updates=None):
    """The recipe's trainer config: the head ``model`` (one of
    :data:`HEADS`) at the given width, Adam (lr 3e-4, clip 10), a summary
    and a checkpoint each epoch; ``updates`` overrides."""
    return Trainer.get_config(nested_merge({
        'model': {
            'factory': HEADS[model],
            'vocab_size': vocab_size,
            'd_model': d_model,
            'num_layers': num_layers,
            'num_heads': num_heads,
            'kernel_size': kernel_size,
            'causal': causal,
        },
        'optimizer': {'factory': Adam, 'gradient_clipping': 10.0,
                      'lr': 3e-4},
        'storage_dir': str(storage_dir),
        'stop_trigger': (epochs, 'epoch'),
        'summary_trigger': (1, 'epoch'),
        'checkpoint_trigger': (1, 'epoch'),
    }, updates or {}))


def synthetic_split(num_examples, batch_size, vocab_size=data.VOCAB_SIZE,
                    markov=0.0):
    """(train, dev) of the synthetic utterances: at least ``6 *
    batch_size`` of them, every 5th to dev."""
    full = data.synthetic_database(
        num_examples=max(num_examples, 6 * batch_size),
        vocab_size=vocab_size, markov=markov)
    n = len(full)
    return (full[[i for i in range(n) if i % 5 != 0]],
            full[[i for i in range(n) if i % 5 == 0]])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--storage_root', default=None)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--epochs', type=int, default=50)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--num_examples', type=int, default=96)
    parser.add_argument('--vocab_size', type=int, default=data.VOCAB_SIZE)
    parser.add_argument('--d_model', type=int, default=96)
    parser.add_argument('--num_layers', type=int, default=2)
    parser.add_argument('--num_heads', type=int, default=4)
    parser.add_argument('--kernel_size', type=int, default=15)
    parser.add_argument(
        '--model', choices=tuple(HEADS), default='ctc',
        help='ctc: linear head + CTC loss; transducer: LSTM prediction '
             'network + additive joint + RNN-T loss; aed: attention '
             'encoder-decoder (teacher-forced label-smoothed CE, '
             'KV-cache beam decoding)')
    parser.add_argument(
        '--causal', action='store_true',
        help='streaming variant: causal attention + left-padded '
             'depthwise convs (exact prefix property)')
    parser.add_argument(
        '--markov', type=float, default=0.0,
        help='synthetic transcripts follow a +1 bigram chain with '
             'this probability (enables the LM fusion demo)')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    if args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(Path(args.storage_root) / 'ctc_asr')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('ctc_asr')

    if args.synthetic or args.database is None:
        train_ds, dev_ds = synthetic_split(
            args.num_examples, args.batch_size, args.vocab_size,
            args.markov)
    else:
        from padertorch_tpu_torch.data.database import JsonDatabase
        db = JsonDatabase(args.database)
        train_ds = db.get_dataset('train')
        dev_ds = db.get_dataset('dev')

    torch.manual_seed(0)
    config = get_trainer_config(
        storage_dir, args.model, args.vocab_size, args.d_model,
        args.num_layers, args.num_heads, args.kernel_size, args.causal,
        args.epochs)
    dump_config({'trainer': config}, storage_dir / 'config.json')
    write_recipe_makefile(
        storage_dir,
        'padertorch_tpu_torch.contrib.examples.speech_recognition.ctc.train',
        evaluate_module='padertorch_tpu_torch.contrib.examples'
                        '.speech_recognition.ctc.evaluate',
        evaluate_args=evaluate_args_of(args))
    trainer = Trainer.from_config(config)
    trainer.to(args.device)
    print(f'device: {args.device}')

    train = data.prepare_dataset(train_ds, batch_size=args.batch_size)
    dev = data.prepare_dataset(dev_ds, batch_size=args.batch_size,
                               shuffle=False, prefetch=False)
    trainer.test_run(
        data.prepare_dataset(train_ds, batch_size=args.batch_size,
                             shuffle=False, prefetch=False),
        dev)
    trainer.register_validation_hook(dev, metric='loss')
    trainer.train(train)
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
