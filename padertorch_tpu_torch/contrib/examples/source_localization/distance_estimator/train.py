"""Source distance estimation from STFT features (CRNN regression).

Counterpart of ``padertorch_tpu/contrib/examples/source_localization/
distance_estimator/train.py`` (reference
``contrib/examples/source_localization/distance_estimator/train.py``):
``CNN2d`` over a configurable feature combination (``stft``/``mag``/
``ild``/``ipd``/``diffuseness``, see ``data.py``), then a one-direction
``GRU`` of 64 units over the frames and a masked mean, predicting the
source distance; reported as mae/rmse/accuracy on quantized distance
classes.  It runs ``test_run``, trains, and leaves a storage dir
(``config.json``, ``feature.json``, ``checkpoints/``, an event file, a
``Makefile``) that the ``evaluate.py`` of this package and of the JAX
package both load.  On the card the GRU runs the ``gru_cell_scan``
kernels (lean forward in validation, training forward and backward in a
step); the convolutions are torch's.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.source_localization.distance_estimator.train \
        --storage_root /tmp/dist --synthetic --epochs 3 --feature "mag ild ipd"
Run on the CPU: add ``--device cpu``.
"""
import argparse
import json
from pathlib import Path

import torch

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.contrib.examples._makefile import (
    evaluate_args_of, write_recipe_makefile)
from padertorch_tpu_torch.contrib.je.modules.conv import CNN2d
from padertorch_tpu_torch.contrib.je.modules.reduce import Mean
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.modules.recurrent import GRU
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer
from padertorch_tpu_torch.utils.nested import nested_merge

from . import data
from .data import synthetic_database  # noqa: F401  (as the JAX module)

QUANT_STEP = 0.25
D_MIN = 0.5


class DistanceEstimator(Model):
    """CNN2d + GRU regression head on (B, C, F, T) acoustic features."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['cnn'] = {
            'factory': CNN2d,
            'in_channels': 4,  # default feature set 'mag ild ipd'
            'out_channels': [16, 32],
            'kernel_size': 3,
            'pool_size': [2, 2],
            'norm': 'batch',
        }

    def __init__(self, cnn, num_freq_bins=data.F, hidden_size=64,
                 quant_step=QUANT_STEP, d_min=D_MIN):
        super().__init__()
        self.cnn = cnn
        self.quant_step = quant_step
        self.d_min = d_min
        freq_after = num_freq_bins
        for _ in range(2):  # VALID max-pool k=2, s=2 per CNN layer
            freq_after = (freq_after - 2) // 2 + 1
        self.gru = GRU(cnn.out_channels * freq_after, hidden_size)
        self.pool = Mean(axis=1)
        self.head = nn.Linear(hidden_size, 1)

    def forward(self, inputs):
        h, seq_len = self.cnn(inputs['features'],
                              inputs.get('num_frames'))
        b, c, m, t = h.shape
        h = h.permute(0, 3, 1, 2).reshape(b, t, c * m)
        h, _ = self.gru(h, seq_lens=seq_len)
        h = self.pool(h, seq_len)
        return self.head(h)[:, 0]

    def review(self, inputs, outputs):
        target = inputs['distance']
        err = outputs - target
        mse = torch.mean(err ** 2)
        est_cls = torch.round((outputs - self.d_min) / self.quant_step)
        target_cls = torch.round((target - self.d_min) / self.quant_step)
        return {
            'loss': mse,
            'scalars': {
                'mae': torch.mean(torch.abs(err)),
                'rmse': torch.sqrt(mse),
                'accuracy': torch.mean((est_cls == target_cls).float()),
            },
        }


def get_trainer_config(storage_dir, num_channels, num_freq_bins, epochs=20,
                       updates=None):
    return Trainer.get_config(nested_merge({
        'model': {
            'factory': DistanceEstimator,
            'cnn': {'in_channels': num_channels},
            'num_freq_bins': num_freq_bins,
        },
        'optimizer': {'factory': Adam, 'gradient_clipping': 10.0,
                      'lr': 1e-3},
        'storage_dir': str(storage_dir),
        'stop_trigger': (epochs, 'epoch'),
    }, updates or {}))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--storage_root', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--feature', default='mag ild ipd',
                        help='space-separated combination of '
                             f'{data.ALLOWED_FEATURES}')
    parser.add_argument('--epochs', type=int, default=20)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    if args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(Path(args.storage_root) / 'distance')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('distance_estimator')

    extractor = data.FeatureExtraction(feature=args.feature)

    torch.manual_seed(0)
    config = get_trainer_config(
        storage_dir, extractor.num_channels, extractor.num_frequency_bins,
        args.epochs)
    dump_config({'trainer': config}, storage_dir / 'config.json')
    (Path(storage_dir) / 'feature.json').write_text(
        json.dumps({'feature': args.feature}))
    write_recipe_makefile(
        storage_dir,
        'padertorch_tpu_torch.contrib.examples.source_localization'
        '.distance_estimator.train',
        evaluate_module='padertorch_tpu_torch.contrib.examples'
                        '.source_localization.distance_estimator.evaluate',
        evaluate_args=evaluate_args_of(args))
    trainer = Trainer.from_config(config)
    trainer.to(args.device)
    print(f'device: {args.device}')

    train_ds = data.synthetic_database(num_examples=48)
    dev_ds = data.synthetic_database(
        num_examples=2 * args.batch_size, seed=1)
    train = data.prepare(train_ds, feature=args.feature,
                         batch_size=args.batch_size)
    dev = data.prepare(dev_ds, feature=args.feature,
                       batch_size=args.batch_size, shuffle=False)
    trainer.test_run(
        data.prepare(train_ds, feature=args.feature,
                     batch_size=args.batch_size, shuffle=False),
        dev)
    trainer.register_validation_hook(dev, metric='mae')
    trainer.train(train.prefetch(2, 4))
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
