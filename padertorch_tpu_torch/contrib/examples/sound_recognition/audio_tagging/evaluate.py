"""Evaluate the audio tagger: mAP / mAUC / lwlrap / mF1 on an eval split.

Counterpart of ``padertorch_tpu/contrib/examples/sound_recognition/
audio_tagging/evaluate.py`` (reference
``contrib/examples/sound_recognition/audio_tagging/evaluate.py:177``):
batched inference on the model's device collecting per-clip scores and
multi-hot targets, then the metrics over the full score matrix
(``evaluation/multilabel.py``).  It loads the ``config.json`` and
checkpoint of a training run of either package.

Run (on the card, the default; without one it fails), after
``train.py --synthetic``:
    python -m padertorch_tpu_torch.contrib.examples.sound_recognition.audio_tagging.evaluate \
        --model_path /path/to/storage_dir --synthetic
After a training on a ``JsonDatabase``: ``--database db.json --dataset
eval`` reads that split's WAV files through ``data.prepare_dataset`` with
the event map the training stored (``eventss.json``).  Run on the CPU: add
``--device cpu``.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.evaluation import (
    split_managed, gather_merged, is_master,
)
from padertorch_tpu_torch.evaluation.multilabel import (
    mean_average_precision, mean_auc, lwlrap, fscore,
)

from .train import WALNet, synthetic_database, prepare


def real_dataset(database, dataset_name, model_path, batch_size):
    """A split of a ``JsonDatabase`` through the recipe's real-data
    pipeline (no augmentation, no prefetch threads), its events encoded
    with the map stored in ``model_path``."""
    from padertorch_tpu_torch.contrib.examples.speaker_classification \
        .supervised import data as spk_data
    from padertorch_tpu_torch.contrib.je.data.transforms import (
        MultiHotEncoder)
    from padertorch_tpu_torch.data.database import JsonDatabase
    from . import data as real
    encoder = MultiHotEncoder(label_key='events', storage_dir=model_path)
    encoder.initialize_labels()
    return real.prepare_dataset(
        JsonDatabase(database).get_dataset(dataset_name),
        audio_reader={'target_sample_rate': 16000},
        stft=dict(spk_data.STFT_PARAMS), event_encoder=encoder,
        num_workers=0, batch_size=batch_size, max_padding_rate=.05)


def score_batch(model, batch):
    """One request: {example_id: {scores, targets}} of a batch."""
    with torch.no_grad():
        logits = model(model.example_to_device(batch)).float().cpu().numpy()
    scores = 1.0 / (1.0 + np.exp(-logits))
    return {
        example_id: {'scores': score.tolist(), 'targets': target.tolist()}
        for example_id, score, target in zip(
            batch['example_id'], scores, np.asarray(batch['events']))
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--database', default=None)
    parser.add_argument('--dataset', default='eval')
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--checkpoint', default='ckpt_best_mAP.ptt')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    try:
        model = WALNet.from_storage_dir(
            model_path, checkpoint_name=args.checkpoint)
    except FileNotFoundError:
        model = WALNet.from_storage_dir(
            model_path, checkpoint_name='ckpt_latest.ptt')
    model = model.to(args.device).eval()
    print(f'device: {args.device}')

    if args.synthetic or args.database is None:
        # eval split: a synthetic set with a held-out seed
        dataset = prepare(
            synthetic_database(num_examples=32, seed=7),
            batch_size=args.batch_size, shuffle=False)
    else:
        dataset = real_dataset(args.database, args.dataset, model_path,
                               args.batch_size)

    results = {}
    for batch in split_managed(dataset, progress_bar=True):
        results.update(score_batch(model, batch))

    merged = gather_merged(results)
    if is_master():
        out_dir = model_path / 'eval'
        out_dir.mkdir(exist_ok=True)
        scores = np.asarray([v['scores'] for v in merged.values()])
        targets = np.asarray([v['targets'] for v in merged.values()])
        summary = {
            'mAP': float(mean_average_precision(scores, targets)),
            'mAUC': float(mean_auc(scores, targets)),
            'lwlrap': float(lwlrap(scores, targets)),
            'mF1': float(fscore(scores, targets)),
            'num_examples': len(merged),
        }
        (out_dir / 'scores.json').write_text(json.dumps(merged))
        (out_dir / 'means.json').write_text(json.dumps(summary, indent=2))
        print(json.dumps(summary, indent=2))


if __name__ == '__main__':
    main()
