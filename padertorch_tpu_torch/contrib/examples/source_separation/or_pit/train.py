"""Train One-and-Rest PIT (recursive separation on a 2-output TasNet).

Counterpart of ``padertorch_tpu/contrib/examples/source_separation/or_pit/
train.py`` (reference ``contrib/examples/source_separation/or_pit/
train.py``; the sacred CLI becomes argparse + the Configurable update
dict).  The data pipeline is the tasnet recipe's (4 s segments, padded
batches).  It runs ``test_run``, registers the validation hook, trains,
and leaves a storage dir (with a ``Makefile``) that the ``evaluate.py`` of this package and of
the JAX package both load.  The separator's default DPRNN runs the
``lstm_cell_scan`` kernels on the card.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.source_separation.or_pit.train \
        --storage_root /tmp/orpit --synthetic --epochs 2
Run on the CPU: add ``--device cpu`` (and ``--small`` for a tiny
separator).
"""
import argparse
from pathlib import Path

import torch

from padertorch_tpu_torch.contrib.examples._makefile import (
    evaluate_args_of, write_recipe_makefile)
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.models.or_pit import OneAndRestPIT
from padertorch_tpu_torch.models.tasnet import TasNet
from padertorch_tpu_torch.modules.recurrent import set_rnn_backend
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer
from padertorch_tpu_torch.utils.nested import nested_merge

from ..tasnet import data

SMALL = {'separator': {
    'encoder': {'feature_size': 32},
    'separator': {
        'input_size': 16, 'rnn_size': 8,
        'window_length': 10, 'hop_size': 5, 'num_blocks': 2,
    },
}}


def get_trainer_config(storage_dir, updates=None):
    return Trainer.get_config(nested_merge({
        'model': {
            'factory': OneAndRestPIT,
            'separator': {'factory': TasNet, 'num_speakers': 2},
            'max_iterations': 2,
        },
        'optimizer': {'factory': Adam, 'gradient_clipping': 5.0},
        'storage_dir': str(storage_dir),
        'summary_trigger': (1000, 'iteration'),
        'checkpoint_trigger': (1, 'epoch'),
        'stop_trigger': (100, 'epoch'),
    }, updates or {}))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--storage_root', default=None)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--epochs', type=int, default=100)
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--segment_length', type=int, default=32000)
    parser.add_argument('--small', action='store_true',
                        help='tiny separator for smoke runs')
    parser.add_argument(
        '--rnn_backend', default='pallas', choices=['scan', 'pallas'],
        help="the DPRNN's time loop, as the JAX recipe's flag; on the card "
             "only 'pallas' (the kernels) exists")
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    if args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(Path(args.storage_root) / 'or_pit')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('or_pit')

    torch.manual_seed(0)
    updates = {'stop_trigger': (args.epochs, 'epoch')}
    if args.small:
        updates['model'] = SMALL
    config = get_trainer_config(storage_dir, updates)
    dump_config({'trainer': config}, storage_dir / 'config.json')
    write_recipe_makefile(
        storage_dir,
        'padertorch_tpu_torch.contrib.examples.source_separation.or_pit'
        '.train',
        evaluate_module='padertorch_tpu_torch.contrib.examples'
                        '.source_separation.or_pit.evaluate',
        evaluate_args=evaluate_args_of(args))
    trainer = Trainer.from_config(config)
    trainer.to(args.device)
    try:
        set_rnn_backend(trainer.model, args.rnn_backend)
    except AssertionError:
        pass  # a separator without RNNs
    print(f'device: {args.device}')

    if args.synthetic or args.database is None:
        train_ds = data.synthetic_database(
            num_examples=max(16, 4 * args.batch_size))
        dev_ds = data.synthetic_database(
            num_examples=max(8, 2 * args.batch_size), seed=1)
        segment_length = 8000
    else:
        db = JsonDatabase(args.database)
        train_ds = db.get_dataset('mix_2_spk_min_tr').map(data.read_audio)
        dev_ds = db.get_dataset('mix_2_spk_min_cv').map(data.read_audio)
        segment_length = args.segment_length

    train = data.prepare_dataset(
        train_ds, batch_size=args.batch_size,
        segment_length=segment_length)
    dev = data.prepare_dataset(
        dev_ds, batch_size=args.batch_size,
        segment_length=segment_length, shuffle=False, prefetch=False)

    trainer.test_run(
        data.prepare_dataset(
            train_ds, batch_size=args.batch_size,
            segment_length=segment_length, shuffle=False,
            prefetch=False),
        dev,
    )
    trainer.register_validation_hook(dev)
    trainer.train(train)
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
