"""Train the supervised speaker classifier.

Counterpart of ``padertorch_tpu/contrib/examples/speaker_classification/
supervised/train.py`` (reference
``contrib/examples/speaker_classification/supervised/train.py``).  It runs
``test_run``, registers the validation hook on the accuracy, trains, and
leaves a storage dir (with a ``Makefile``) that the ``evaluate.py`` of this
package and of the JAX package both load.

Run on the card (the default device; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.speaker_classification.supervised.train \
        --storage_root /tmp/spk --synthetic --epochs 3 --on_device_features
On a LibriSpeech-style ``JsonDatabase`` (splits ``train_clean_100`` and
``dev_clean``; each example names its WAV file under ``audio_path`` and its
``speaker_id``): replace ``--synthetic`` by ``--database db.json``.
Run on the CPU: add ``--device cpu``.  ``--precision bfloat16`` trains
under the trainer's bf16 policy (bf16 casts of float32 masters), and
``--compute_dtype bfloat16`` gives the GRU bf16 products and streams
(``set_rnn_backend``; on the card the bf16 GRU kernels).
"""
import argparse
from pathlib import Path

import torch

from padertorch_tpu_torch.contrib.examples._makefile import (
    evaluate_args_of, write_recipe_makefile)
from padertorch_tpu_torch.contrib.je.modules.features import (
    FusedAudioLogMelExtractor)
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.modules.recurrent import set_rnn_backend
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer
from padertorch_tpu_torch.utils.nested import nested_merge

from . import data
from .model import SpeakerClf


def get_trainer_config(storage_dir, num_speakers, on_device_features=False,
                       updates=None, precision=None):
    """The recipe's trainer config: its small classifier ((16, 32) CNN
    channels, 64 GRU units; ``updates`` overrides), with the host STFT
    front end or, with ``on_device_features``, the fused one;
    ``precision`` is the trainer's (None, or 'bfloat16' for the bf16
    policy), as the JAX ``Trainer`` takes it from its config."""
    model = {
        'factory': SpeakerClf,
        'num_speakers': num_speakers,
        'cnn_channels': (16, 32),
        'hidden_size': 64,
    }
    if on_device_features:
        model['feature_extractor'] = {
            'factory': FusedAudioLogMelExtractor,
            'sample_rate': data.SAMPLE_RATE,
            'stft_size': 512,
            'shift': 128,
            'number_of_filters': 64,
        }
    return Trainer.get_config(nested_merge({
        'model': model,
        'optimizer': {'factory': Adam, 'gradient_clipping': 10.0,
                      'lr': 3e-4},
        'storage_dir': str(storage_dir),
        'summary_trigger': (1, 'epoch'),
        'checkpoint_trigger': (1, 'epoch'),
        'precision': precision,
    }, updates or {}))


def synthetic_split(batch_size):
    """(train, dev) of the synthetic speakers: enough utterances that the
    dev split yields the 2+ validation batches ``test_run`` needs at any
    batch size; every 5th example goes to dev."""
    full = data.synthetic_database(
        per_speaker=max(12, (10 * batch_size) // 8))
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
    parser.add_argument('--num_speakers', type=int, default=None)
    parser.add_argument(
        '--on_device_features', action='store_true',
        help='compute the log-mel front end inside the step (the fused '
             'kernel on the card) from raw audio, instead of host STFTs '
             'in the data pipeline')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--precision', default=None, choices=['bfloat16'],
                        help="the trainer's mixed-precision policy")
    parser.add_argument('--compute_dtype', default=None,
                        choices=['bfloat16'],
                        help="the GRU's products and streams")
    args = parser.parse_args()

    if args.storage_root:
        from padertorch_tpu_torch.io import get_new_subdir
        storage_dir = get_new_subdir(
            Path(args.storage_root) / 'speaker_clf')
    else:
        from padertorch_tpu_torch.io import get_new_storage_dir
        storage_dir = get_new_storage_dir('speaker_clf')

    if args.synthetic or args.database is None:
        train_ds, dev_ds = synthetic_split(args.batch_size)
    else:
        db = JsonDatabase(args.database)
        train_ds = db.get_dataset('train_clean_100')
        dev_ds = db.get_dataset('dev_clean')
    # the labels come from the JSON alone; the audio is read afterwards
    label_encoder = data.get_label_encoder(storage_dir, train_ds)
    train_ds = train_ds.map(data.read_audio)
    dev_ds = dev_ds.map(data.read_audio)
    num_speakers = args.num_speakers or len(label_encoder.label_mapping)

    torch.manual_seed(0)
    config = get_trainer_config(
        storage_dir, num_speakers, args.on_device_features,
        updates={'stop_trigger': (args.epochs, 'epoch')},
        precision=args.precision)
    dump_config({'trainer': config}, storage_dir / 'config.json')
    write_recipe_makefile(
        storage_dir,
        'padertorch_tpu_torch.contrib.examples.speaker_classification'
        '.supervised.train',
        evaluate_module='padertorch_tpu_torch.contrib.examples'
                        '.speaker_classification.supervised.evaluate',
        evaluate_args=evaluate_args_of(args))
    trainer = Trainer.from_config(config)
    trainer.to(args.device)
    if args.compute_dtype:
        set_rnn_backend(trainer.model, 'pallas',
                        compute_dtype=args.compute_dtype)
    print(f'device: {args.device}')

    prepare = (data.prepare_dataset_audio if args.on_device_features
               else data.prepare_dataset)
    train = prepare(train_ds, label_encoder, batch_size=args.batch_size)
    dev = prepare(dev_ds, label_encoder, batch_size=args.batch_size,
                  shuffle=False, prefetch=False)
    trainer.test_run(
        prepare(train_ds, label_encoder, batch_size=args.batch_size,
                shuffle=False, prefetch=False),
        dev)
    trainer.register_validation_hook(dev, metric='accuracy', maximize=True)
    trainer.train(train)
    print(f'Finished. storage_dir={storage_dir}')


if __name__ == '__main__':
    main()
