"""Train the GAN vocoder (the trainer's adversarial mode).

Counterpart of ``padertorch_tpu/contrib/examples/audio_synthesis/
gan_vocoder/train.py``: a dict of two Adam optimizers with
``adversarial=True``, ``test_run``, the validation hook, then training;
it leaves a storage dir (``config.json``, ``checkpoints/``, an event file,
a ``Makefile``) that the ``evaluate.py`` of this package and of the JAX
package both load.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.audio_synthesis.gan_vocoder.train \\
        --storage_root /tmp/gv --synthetic --epochs 2
On a LibriSpeech-style ``JsonDatabase`` (splits ``train_clean_100`` and
``dev_clean``, each example's WAV file under ``audio_path``): replace
``--synthetic`` by ``--database /path/to/librispeech.json``.
Run on the CPU: add ``--device cpu`` (and ``--small`` for a tiny model).
``--async_checkpointing`` writes the checkpoints from a thread.
"""
import argparse
from pathlib import Path

import torch

from padertorch_tpu_torch.contrib.examples._makefile import (
    evaluate_args_of, write_recipe_makefile)
from padertorch_tpu_torch.contrib.je.data.transforms import AudioReader
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer
from padertorch_tpu_torch.utils.nested import nested_merge

from . import data
from .model import GANVocoder

SMALL = {
    'generator': {'base_channels': 16},
    'discriminator': {'base_channels': 4, 'n_layers': 3, 'n_scales': 2},
}


def get_trainer_config(storage_dir, updates=None):
    adam = {'factory': Adam, 'lr': 2e-4, 'betas': (0.8, 0.99),
            'gradient_clipping': 10.0}
    return Trainer.get_config(nested_merge({
        'model': {'factory': GANVocoder},
        'optimizer': {'generator': dict(adam), 'discriminator': dict(adam)},
        'adversarial': True,
        'storage_dir': str(storage_dir),
        'summary_trigger': (1, 'epoch'),
        'checkpoint_trigger': (1, 'epoch'),
    }, updates or {}))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--storage_root', default=None)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--epochs', type=int, default=50)
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--num_examples', type=int, default=None,
                        help='size of the synthetic training set')
    parser.add_argument('--small', action='store_true',
                        help='tiny channels + short segments (CPU smoke)')
    parser.add_argument('--async_checkpointing', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    if args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(Path(args.storage_root) / 'gan_vocoder')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('gan_vocoder')

    updates = {'stop_trigger': (args.epochs, 'epoch'),
               'async_checkpointing': args.async_checkpointing}
    segment_length = 16000
    if args.small:
        updates['model'] = SMALL
        segment_length = 4000

    torch.manual_seed(0)
    config = get_trainer_config(storage_dir, updates)
    dump_config({'trainer': config}, storage_dir / 'config.json')
    write_recipe_makefile(
        storage_dir,
        'padertorch_tpu_torch.contrib.examples.audio_synthesis.gan_vocoder'
        '.train',
        evaluate_module='padertorch_tpu_torch.contrib.examples'
                        '.audio_synthesis.gan_vocoder.evaluate',
        evaluate_args=evaluate_args_of(args))
    trainer = Trainer.from_config(config)
    trainer.to(args.device)
    print(f'device: {args.device}')

    if args.synthetic or args.database is None:
        train_ds = data.synthetic_database(
            num_examples=args.num_examples or max(12, 4 * args.batch_size))
        # at least 2 validation batches (test_run exercises two)
        dev_ds = data.synthetic_database(
            num_examples=2 * args.batch_size, seed=1)
    else:
        db = JsonDatabase(args.database)
        reader = AudioReader(target_sample_rate=data.SAMPLE_RATE)
        train_ds = db.get_dataset('train_clean_100').map(reader)
        dev_ds = db.get_dataset('dev_clean').map(reader)

    train = data.prepare_dataset(
        train_ds, batch_size=args.batch_size,
        segment_length=segment_length)
    dev = data.prepare_dataset(
        dev_ds, batch_size=args.batch_size,
        segment_length=segment_length, shuffle=False, prefetch=False)
    trainer.test_run(
        data.prepare_dataset(train_ds, batch_size=args.batch_size,
                             segment_length=segment_length,
                             shuffle=False, prefetch=False),
        dev)
    trainer.register_validation_hook(dev)
    trainer.train(train)
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
