"""Audio tagging (WALNet-style CNN on log-mel, multi-hot targets).

Counterpart of ``padertorch_tpu/contrib/examples/sound_recognition/
audio_tagging/train.py`` (reference
``contrib/examples/sound_recognition/audio_tagging/train.py``):
``NormalizedLogMelExtractor`` on host STFTs, a ``CNN2d`` stack with batch
norm, a masked mean over time and a linear head trained with binary cross
entropy; validation on the mean average precision.  It runs ``test_run``,
trains, and leaves a storage dir (``config.json``, ``checkpoints/``, an
event file, a ``Makefile``) that the ``evaluate.py`` of this package and of
the JAX package both load.  The CNN's convolutions are torch's (cuDNN on
the card), as they are XLA's in the JAX package.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.sound_recognition.audio_tagging.train \
        --storage_root /tmp/tagging --synthetic --epochs 2
On an AudioSet-style ``JsonDatabase`` (splits ``balanced_train``,
``validate`` and ``eval``; each example names its WAV file under
``audio_path`` and its labels under ``events``): replace ``--synthetic``
by ``--database db.json``.  Run on the CPU: add ``--device cpu``.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.contrib.examples._makefile import (
    evaluate_args_of, write_recipe_makefile)
from padertorch_tpu_torch.contrib.examples.speaker_classification \
    .supervised import data as spk_data
from padertorch_tpu_torch.contrib.je.modules.conv import CNN2d
from padertorch_tpu_torch.contrib.je.modules.features import (
    NormalizedLogMelExtractor)
from padertorch_tpu_torch.contrib.je.modules.reduce import Mean
from padertorch_tpu_torch.data import dataset as lazy
from padertorch_tpu_torch.data.utils import collate_fn, pad_batch
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer

NUM_EVENTS = 10


class WALNet(Model):
    """CNN over log-mel + sigmoid multi-label head."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['feature_extractor'] = {
            'factory': NormalizedLogMelExtractor,
            'sample_rate': 16000,
            'stft_size': 512,
            'number_of_filters': 64,
        }
        config['cnn'] = {
            'factory': CNN2d,
            'in_channels': 1,
            'out_channels': [16, 32, 32],
            'kernel_size': 3,
            'pool_size': [2, 2, 1],
            'norm': 'batch',
        }

    def __init__(self, feature_extractor, cnn, num_events=NUM_EVENTS):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.cnn = cnn
        self.pool = Mean(axis=-1)
        self.head = nn.Linear(cnn.out_channels * (64 // 4), num_events)

    def forward(self, inputs):
        x, seq_len = self.feature_extractor(
            inputs['stft'], seq_len=inputs.get('seq_len'))
        h, seq_len = self.cnn(x, seq_len)
        b, c, m, t = h.shape
        h = h.reshape(b, c * m, t)
        h = self.pool(h, seq_len)
        return self.head(h)

    def review(self, inputs, outputs):
        targets = inputs['events']
        bce = torch.mean(
            torch.clamp(outputs, min=0) - outputs * targets
            + torch.log1p(torch.exp(-torch.abs(outputs))))
        return {
            'loss': bce,
            'buffers': {
                'scores': torch.sigmoid(outputs).detach(),
                'targets': targets,
            },
        }

    def modify_summary(self, summary):
        from padertorch_tpu_torch.evaluation.multilabel import (
            mean_average_precision, mean_auc, lwlrap, fscore,
        )
        buffers = summary['buffers']
        if 'scores' in buffers:
            scores = np.concatenate(
                [np.asarray(s) for s in buffers.pop('scores')])
            targets = np.concatenate(
                [np.asarray(t) for t in buffers.pop('targets')])
            summary['scalars']['mAP'] = mean_average_precision(
                scores, targets)
            summary['scalars']['mAUC'] = mean_auc(scores, targets)
            summary['scalars']['lwlrap'] = lwlrap(scores, targets)
            summary['scalars']['mF1'] = fscore(scores, targets)
        return super().modify_summary(summary)


def synthetic_database(num_examples=64, num_samples=16000, seed=0):
    """Each event class adds a characteristic tone burst."""
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / 16000
    freqs = 200 * (1.5 ** np.arange(NUM_EVENTS))
    examples = {}
    for i in range(num_examples):
        active = rng.rand(NUM_EVENTS) < 0.3
        if not active.any():
            active[rng.randint(NUM_EVENTS)] = True
        audio = 0.02 * rng.randn(num_samples)
        for e in np.flatnonzero(active):
            audio += 0.3 * np.sin(2 * np.pi * freqs[e] * t)
        examples[f'clip_{i}'] = {
            'example_id': f'clip_{i}',
            'audio_data': audio.astype('float32'),
            'seq_len': num_samples,
            'events': active.astype('float32'),
        }
    return lazy.from_dict(examples)


def prepare(dataset, batch_size=8, shuffle=True):
    stft = spk_data.STFT(**spk_data.STFT_PARAMS)

    def finalize(ex):
        return {
            'example_id': ex['example_id'],
            'stft': ex['stft'][None].astype('float32'),
            'seq_len': ex['seq_len'],
            'events': ex['events'],
        }

    dataset = dataset.map(stft).map(finalize)
    if shuffle:
        dataset = dataset.shuffle()

    def post(batch):
        batch = collate_fn(batch)
        stft_arr, seq_len = pad_batch(batch['stft'], axis=1)
        return {
            'example_id': list(batch['example_id']),
            'stft': stft_arr,
            'seq_len': np.asarray(batch['seq_len'], 'int32'),
            'events': np.stack(batch['events']),
        }

    return dataset.batch(batch_size).map(post)


def get_trainer_config(storage_dir, num_events=NUM_EVENTS, epochs=20,
                       updates=None):
    from padertorch_tpu_torch.utils.nested import nested_merge
    return Trainer.get_config(nested_merge({
        'model': {'factory': WALNet, 'num_events': num_events},
        'optimizer': {'factory': Adam, 'gradient_clipping': 10.0,
                      'lr': 3e-4},
        'storage_dir': str(storage_dir),
        'stop_trigger': (epochs, 'epoch'),
    }, updates or {}))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--storage_root', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument(
        '--database', default=None,
        help='JsonDatabase path: train on real data via data.py '
             '(AudioSet-style splits balanced_train/validate/eval)')
    parser.add_argument('--training_set', default='balanced_train')
    parser.add_argument('--epochs', type=int, default=20)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    if args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(Path(args.storage_root) / 'tagging')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('audio_tagging')

    torch.manual_seed(0)
    num_events = NUM_EVENTS
    real_data = None
    if args.database is not None and not args.synthetic:
        from . import data as real
        train, dev, _test = real.get_datasets(
            args.database,
            audio_reader={'target_sample_rate': 16000},
            stft=dict(spk_data.STFT_PARAMS),
            batch_size=args.batch_size,
            storage_dir=storage_dir,
            num_workers=2,
            training_set=args.training_set,
        )
        # label count comes from the encoder persisted by get_datasets
        num_events = len(json.loads(
            (Path(storage_dir) / 'eventss.json').read_text()))
        real_data = (train, dev)

    config = get_trainer_config(storage_dir, num_events, args.epochs)
    dump_config({'trainer': config}, storage_dir / 'config.json')
    write_recipe_makefile(
        storage_dir,
        'padertorch_tpu_torch.contrib.examples.sound_recognition'
        '.audio_tagging.train',
        evaluate_module='padertorch_tpu_torch.contrib.examples'
                        '.sound_recognition.audio_tagging.evaluate',
        evaluate_args=evaluate_args_of(args))
    trainer = Trainer.from_config(config)
    trainer.to(args.device)
    print(f'device: {args.device}')

    if real_data is not None:
        train, dev = real_data
        trainer.test_run(train, dev)
        trainer.register_validation_hook(dev, metric='mAP',
                                         maximize=True)
        trainer.train(train)
    else:
        train_ds = synthetic_database(num_examples=48)
        dev_ds = synthetic_database(
            num_examples=2 * args.batch_size, seed=1)
        train = prepare(train_ds, args.batch_size)
        dev = prepare(dev_ds, args.batch_size, shuffle=False)
        trainer.test_run(
            prepare(train_ds, args.batch_size, shuffle=False), dev)
        trainer.register_validation_hook(dev, metric='mAP',
                                         maximize=True)
        trainer.train(train.prefetch(2, 4))
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
