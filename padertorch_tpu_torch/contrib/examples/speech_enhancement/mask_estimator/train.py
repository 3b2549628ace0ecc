"""Train the BLSTM mask estimator for speech enhancement.

Counterpart of ``padertorch_tpu/contrib/examples/speech_enhancement/
mask_estimator/train.py`` (reference ``contrib/examples/
speech_enhancement/mask_estimator/train.py``): ``test_run`` first, then
train; ideal binary masks as targets.  The BLSTM (257 inputs, 2 x 256
units at the default ``--num_units 1024``) runs the ``lstm_cell_scan``
kernels on the card.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.speech_enhancement.mask_estimator.train \
        --storage_root /tmp/maskest --synthetic --epochs 2
Run on the CPU: add ``--device cpu`` (and a small ``--num_units``).
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.data import dataset as lazy
from padertorch_tpu_torch.data.utils import collate_fn, pad_batch
from padertorch_tpu_torch.contrib.examples._makefile import (
    evaluate_args_of, write_recipe_makefile)
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.models.mask_estimator import SimpleMaskEstimator
from padertorch_tpu_torch.ops._stft import HostSTFT as STFT
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer

STFT_SIZE = 512
STFT_SHIFT = 128
F = STFT_SIZE // 2 + 1

_stft = STFT(STFT_SIZE, STFT_SHIFT, fading='full',
             complex_representation='complex', dtype='float32')


def synthetic_database(num_examples=16, num_samples=16000, seed=0):
    """Speech-shaped tone + white noise mixtures with ideal masks."""
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / 8000
    examples = {}
    for i in range(num_examples):
        f0 = rng.uniform(100, 800)
        speech = np.sin(2 * np.pi * f0 * t) * (
            1 + np.sin(2 * np.pi * rng.uniform(1, 3) * t)) / 2
        noise = 0.3 * rng.randn(num_samples)
        examples[f'ex_{i}'] = {
            'example_id': f'ex_{i}',
            'speech': speech.astype('float32'),
            'noise': noise.astype('float32'),
        }
    return lazy.from_dict(examples)


def transform(example):
    speech = np.asarray(_stft(example['speech']))
    noise = np.asarray(_stft(example['noise']))
    observation = speech + noise
    speech_mask = (np.abs(speech) > np.abs(noise)).astype('float32')
    return {
        'example_id': example['example_id'],
        'observation_abs': np.abs(observation).astype('float32'),
        'speech_mask_target': speech_mask,
        'noise_mask_target': 1.0 - speech_mask,
        'num_frames': observation.shape[0],
    }


def post_batch(batch):
    batch = collate_fn(batch)
    obs, num_frames = pad_batch(batch['observation_abs'], axis=0)
    speech_mask, _ = pad_batch(batch['speech_mask_target'], axis=0)
    noise_mask, _ = pad_batch(batch['noise_mask_target'], axis=0)
    return {
        'example_id': list(batch['example_id']),
        'observation_abs': obs,
        'speech_mask_target': speech_mask,
        'noise_mask_target': noise_mask,
        'num_frames': np.asarray(num_frames, dtype='int32'),
    }


def prepare_dataset(dataset, batch_size=4, shuffle=True):
    if shuffle:
        dataset = dataset.shuffle()
    return dataset.map(transform).batch(batch_size).map(post_batch)


def get_trainer_config(storage_dir, num_units=1024, epochs=20):
    return Trainer.get_config({
        'model': {
            'factory': SimpleMaskEstimator,
            'num_features': F,
            'num_units': num_units,
        },
        'optimizer': {'factory': Adam, 'gradient_clipping': 10.0},
        'storage_dir': str(storage_dir),
        'stop_trigger': (epochs, 'epoch'),
    })


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--storage_root', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--epochs', type=int, default=20)
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--num_units', type=int, default=1024)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    if args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(
            Path(args.storage_root) / 'mask_estimator')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('mask_estimator')

    torch.manual_seed(0)
    config = get_trainer_config(storage_dir, args.num_units, args.epochs)
    dump_config({'trainer': config}, storage_dir / 'config.json')
    write_recipe_makefile(
        storage_dir,
        'padertorch_tpu_torch.contrib.examples.speech_enhancement'
        '.mask_estimator.train',
        evaluate_module='padertorch_tpu_torch.contrib.examples'
                        '.speech_enhancement.mask_estimator.evaluate',
        evaluate_args=evaluate_args_of(args))
    trainer = Trainer.from_config(config)
    trainer.to(args.device)
    print(f'device: {args.device}')

    train_ds = synthetic_database(num_examples=16)
    dev_ds = synthetic_database(num_examples=2 * args.batch_size, seed=1)
    train = prepare_dataset(train_ds, args.batch_size)
    dev = prepare_dataset(dev_ds, args.batch_size, shuffle=False)
    trainer.test_run(
        prepare_dataset(train_ds, args.batch_size, shuffle=False), dev)
    trainer.register_validation_hook(dev)
    trainer.train(train.prefetch(2, 4))
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
