"""Train TasNet / DPRNN-TasNet / SepFormer-TasNet.

Counterpart of ``padertorch_tpu/contrib/examples/source_separation/tasnet/
train.py`` (reference ``contrib/examples/source_separation/tasnet/
train.py``; the sacred named configs ``dprnn``, ``win2``, ``stft``,
``log_mse`` become the ``--variant``/``--loss`` flags; ``sepformer`` is the
dual-path transformer separator, ``--flash`` forces its attention onto the
fused kernels).  It runs
``test_run``, registers the validation hook on ``si-sdr``, trains, and
leaves a storage dir (``config.json``, ``checkpoints/``, an event file)
that the ``evaluate.py`` of this package and of the JAX package both load.
The ``convnet`` variant is not ported yet (``padertorch_tpu/modules/
convnet.py``, ROADMAP.md) and raises.

The chunk RNN type is part of the config, as in the JAX recipe: pass
``updates={'model': {'separator': {'inter_chunk_type': 'bgru',
'intra_chunk_type': 'bgru'}}}`` to :func:`get_trainer_config`, or on the
command line ``with model.separator.inter_chunk_type=bgru
model.separator.intra_chunk_type=bgru``.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.source_separation.tasnet.train \
        --storage_root /tmp/tasnet --synthetic --epochs 2 --variant dprnn
    python -m padertorch_tpu_torch.contrib.examples.source_separation.tasnet.train \
        --storage_root /tmp/tasnet --synthetic --epochs 2 --variant sepformer --flash
Run on the CPU: add ``--device cpu`` (and ``--small`` for a tiny model).
"""
import argparse
from pathlib import Path

import torch

from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.models.tasnet import (
    TasNet, TasEncoder, StftEncoder, IstftDecoder,
)
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    set_attention_backend)
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
from padertorch_tpu_torch.modules.dual_path_transformer import (
    DualPathTransformer)
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer
from padertorch_tpu_torch.utils.nested import nested_merge

from . import data

VARIANTS = {
    'dprnn': {
        'separator': {
            'factory': DPRNN,
            'input_size': 64, 'rnn_size': 128,
            'window_length': 100, 'hop_size': 50, 'num_blocks': 6,
        },
    },
    'sepformer': {
        'separator': {
            'factory': DualPathTransformer,
            'input_size': 128, 'window_length': 100, 'hop_size': 50,
            'num_blocks': 4, 'num_layers_intra': 2,
            'num_layers_inter': 2, 'num_heads': 8,
        },
    },
    'win2': {
        'encoder': {'factory': TasEncoder, 'window_length': 2},
    },
    'stft': {
        'encoder': {'factory': StftEncoder},
        'decoder': {'factory': IstftDecoder},
        'mask': True,
    },
}
# variants of the JAX recipe whose separators are not ported yet
NOT_PORTED = {
    'convnet': 'padertorch_tpu/modules/convnet.py (the TCN separator)',
}


def get_trainer_config(storage_dir, variant='dprnn', loss='si-sdr',
                       updates=None):
    if variant in NOT_PORTED:
        raise NotImplementedError(
            f'--variant {variant} needs {NOT_PORTED[variant]}, which is '
            'not ported yet (ROADMAP.md)')
    model_updates = nested_merge(
        {'factory': TasNet}, VARIANTS.get(variant, {}))
    loss_weights = {'si-sdr': 0.0, 'log-mse': 0.0, 'log1p-mse': 0.0}
    loss_weights[loss] = 1.0
    return Trainer.get_config(nested_merge({
        'model': model_updates,
        'optimizer': {'factory': Adam, 'gradient_clipping': 5.0},
        'loss_weights': loss_weights,
        'storage_dir': str(storage_dir),
        'summary_trigger': (1000, 'iteration'),
        'checkpoint_trigger': (1, 'epoch'),
        'stop_trigger': (200, 'epoch'),
    }, updates or {}))


SMALL = {
    'encoder': {'feature_size': 32},
    'separator': {
        'input_size': 16, 'rnn_size': 8,
        'window_length': 10, 'hop_size': 5, 'num_blocks': 2,
    },
}
SMALL_SEPFORMER = {
    'encoder': {'feature_size': 32},
    'separator': {
        'input_size': 16, 'window_length': 10, 'hop_size': 5,
        'num_blocks': 1, 'num_layers_intra': 1,
        'num_layers_inter': 1, 'num_heads': 2,
    },
}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--storage_root', default=None)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--variant', default='dprnn',
                        choices=sorted([*VARIANTS, *NOT_PORTED]))
    parser.add_argument('--loss', default='si-sdr',
                        choices=['si-sdr', 'log-mse', 'log1p-mse'])
    parser.add_argument('--epochs', type=int, default=200)
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument(
        '--flash', action='store_true',
        help='force the fused attention kernels for the sepformer variant '
             '(ops/kernels/attention.py); without it the attention '
             "dispatches on the measured crossover ('auto')")
    parser.add_argument('--segment_length', type=int, default=32000)
    parser.add_argument('--num_examples', type=int, default=None,
                        help='synthetic training-set size '
                             '(default: max(32, 4*batch_size))')
    parser.add_argument('--small', action='store_true',
                        help='tiny model for smoke tests')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args, rest = parser.parse_known_args()

    if args.database is not None:
        raise NotImplementedError(
            '--database waits for read_audio and the JSON database reader '
            '(no such files are in the repository yet); run with '
            '--synthetic')

    if args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(Path(args.storage_root) / 'tasnet')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('tasnet')

    updates = {'stop_trigger': (args.epochs, 'epoch')}
    if args.small:
        updates['model'] = (SMALL_SEPFORMER if args.variant == 'sepformer'
                            else SMALL)
    if rest:
        # sacred-style overrides (... with model.separator.rnn_size=64)
        # are merged into the updates before get_config, so
        # finalize_dogmatic_config sees them (the dogmatic contract)
        from padertorch_tpu_torch.cli import parse_with_updates
        cli_updates, named = parse_with_updates(rest)
        assert not named, f'no named configs in this recipe: {named}'
        updates = nested_merge(updates, cli_updates)

    torch.manual_seed(0)
    config = get_trainer_config(
        storage_dir, variant=args.variant, loss=args.loss, updates=updates)
    dump_config({'trainer': config}, storage_dir / 'config.json')
    trainer = Trainer.from_config(config)
    if args.flash:
        set_attention_backend(trainer.model, True)
    trainer.to(args.device)
    print(f'device: {args.device}')

    n_train = args.num_examples or max(32, 4 * args.batch_size)
    train_ds = data.synthetic_database(num_examples=n_train)
    dev_ds = data.synthetic_database(
        num_examples=max(8, 2 * args.batch_size), seed=1)

    seg = min(args.segment_length, 8000 if args.synthetic else 10 ** 9)
    train = data.prepare_dataset(
        train_ds, batch_size=args.batch_size, segment_length=seg)
    dev = data.prepare_dataset(
        dev_ds, batch_size=args.batch_size, segment_length=seg,
        shuffle=False, prefetch=False)
    trainer.test_run(
        data.prepare_dataset(train_ds, batch_size=args.batch_size,
                             segment_length=seg, shuffle=False,
                             prefetch=False),
        dev)
    trainer.register_validation_hook(dev, metric='si-sdr')
    trainer.train(train)
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
