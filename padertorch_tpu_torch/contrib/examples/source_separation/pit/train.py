"""Train uPIT BLSTM source separation.

Counterpart of ``padertorch_tpu/contrib/examples/source_separation/pit/
train.py`` (reference ``contrib/examples/source_separation/pit/train.py``;
the sacred CLI becomes argparse + the Configurable update dict).  It runs
``test_run``, registers the validation hook, trains, and leaves a storage
dir (``config.json``, ``checkpoints/``, an event file, a ``Makefile``) that
the ``evaluate.py`` of this package and of the JAX package both load.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.source_separation.pit.train \
        --storage_root /tmp/pit --synthetic --epochs 2
Run on a WSJ0-2mix-style ``JsonDatabase`` (splits ``mix_2_spk_min_tr`` and
``mix_2_spk_min_cv``, WAV files under ``audio_path``):
    ... --database /path/to/wsj0_2mix.json
Run on the CPU: add ``--device cpu``.  ``--precision bfloat16`` trains
under the bf16 policy (bf16 casts of float32 masters, ``Trainer(precision=
...)``), ``--compute_dtype bfloat16`` gives the BLSTM bf16 products and
streams (the JAX package's benchmarked flagship sets both: bf16 kernels
and GEMMs, float32 masters and carries).
"""
import argparse
from pathlib import Path

import torch

from padertorch_tpu_torch.contrib.examples._makefile import (
    evaluate_args_of, write_recipe_makefile)
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer
from padertorch_tpu_torch.utils.nested import nested_merge

from . import data


def get_trainer_config(storage_dir, updates=None):
    config = Trainer.get_config(nested_merge({
        'model': {
            'factory': PermutationInvariantTrainingModel,
            'F': data.STFT_SIZE // 2 + 1,
            'recurrent_layers': 3,
            'units': 600,
            'K': data.K,
            'dropout_input': 0.,
            'dropout_hidden': 0.,
            'dropout_linear': 0.,
        },
        'optimizer': {'factory': Adam, 'gradient_clipping': 10.0},
        'loss_weights': {'pit_mse_loss': 1.0, 'pit_ips_loss': 0.0},
        'storage_dir': str(storage_dir),
        'summary_trigger': (1000, 'iteration'),
        'checkpoint_trigger': (1, 'epoch'),
        'stop_trigger': (100, 'epoch'),
    }, updates or {}))
    return config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--storage_root', default=None)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--epochs', type=int, default=100)
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--units', type=int, default=600)
    parser.add_argument('--layers', type=int, default=3)
    parser.add_argument('--rnn_backend', default='pallas',
                        choices=['scan', 'pallas'],
                        help="accepted for parity with the JAX recipe; on "
                             "the card only 'pallas' (the kernel) exists")
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--precision', default=None,
                        choices=['bfloat16'],
                        help="the trainer's mixed-precision policy")
    parser.add_argument('--compute_dtype', default=None,
                        choices=['bfloat16'],
                        help="the BLSTM's products and streams")
    parser.add_argument('--resume', default=None, metavar='STORAGE_DIR',
                        help='continue a crashed/stopped training from '
                             'its experiment dir (config + ckpt_latest)')
    args, rest = parser.parse_known_args()

    if args.rnn_backend != 'pallas' and args.device != 'cpu':
        raise NotImplementedError(
            f'--rnn_backend {args.rnn_backend}: on the card the recurrence '
            "runs in the kernel ('pallas') only")

    if args.resume:
        storage_dir = Path(args.resume)
        assert (storage_dir / 'config.json').exists(), (
            f'{storage_dir} has no config.json to resume from')
    elif args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(Path(args.storage_root) / 'pit')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('pit')

    torch.manual_seed(0)
    updates = {
        'stop_trigger': (args.epochs, 'epoch'),
        'model': {'units': args.units, 'recurrent_layers': args.layers,
                  'compute_dtype': args.compute_dtype},
        'precision': args.precision,
    }
    if rest:
        # sacred-style overrides (... with model.units=300 lr=1e-4) are
        # merged into the updates before get_config, so
        # finalize_dogmatic_config sees them (the dogmatic contract)
        from padertorch_tpu_torch.cli import parse_with_updates
        cli_updates, named = parse_with_updates(rest)
        assert not named, f'no named configs in this recipe: {named}'
        updates = nested_merge(updates, cli_updates)
    if args.resume:
        assert rest == [] and args.epochs == 100 and args.units == 600 \
            and args.layers == 3 and args.precision is None \
            and args.compute_dtype is None, (
                '--resume restores the stored config verbatim; config '
                'overrides (--epochs/--units/--layers/--precision/'
                '--compute_dtype/with k=v) are not applicable: edit '
                'config.json instead. '
                f'Got: epochs={args.epochs} units={args.units} '
                f'layers={args.layers} precision={args.precision} '
                f'compute_dtype={args.compute_dtype} rest={rest}')
        from padertorch_tpu_torch.io import load_config
        config = load_config(storage_dir / 'config.json')['trainer']
        # the dir may have been moved/copied: the CLI path wins over the
        # absolute storage_dir stored inside config.json
        config['storage_dir'] = str(storage_dir)
    else:
        config = get_trainer_config(storage_dir, updates)
        dump_config({'trainer': config}, storage_dir / 'config.json')
    write_recipe_makefile(
        storage_dir,
        'padertorch_tpu_torch.contrib.examples.source_separation.pit.train',
        evaluate_module='padertorch_tpu_torch.contrib.examples'
                        '.source_separation.pit.evaluate',
        evaluate_args=evaluate_args_of(args))
    trainer = Trainer.from_config(config)
    trainer.to(args.device)
    print(f'device: {args.device}')

    if args.synthetic or args.database is None:
        train_ds = data.synthetic_database(
            num_examples=max(32, 4 * args.batch_size))
        # at least 2 validation batches (test_run exercises two)
        dev_ds = data.synthetic_database(
            num_examples=2 * args.batch_size, seed=1)
    else:
        db = JsonDatabase(args.database)
        train_ds = db.get_dataset('mix_2_spk_min_tr').map(data.read_audio)
        dev_ds = db.get_dataset('mix_2_spk_min_cv').map(data.read_audio)

    train = data.prepare_dataset(train_ds, batch_size=args.batch_size)
    dev = data.prepare_dataset(
        dev_ds, batch_size=args.batch_size, shuffle=False, prefetch=False)

    if not args.resume:
        trainer.test_run(
            data.prepare_dataset(train_ds, batch_size=args.batch_size,
                                 shuffle=False, prefetch=False),
            dev,
        )
    trainer.register_validation_hook(dev)
    trainer.train(train, resume=bool(args.resume))
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
