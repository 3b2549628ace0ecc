"""Evaluate the supervised speaker classifier: accuracy over an eval split.

Counterpart of ``padertorch_tpu/contrib/examples/speaker_classification/
supervised/evaluate.py`` (reference
``contrib/examples/speaker_classification/supervised/evaluate.py``):
batched inference on the model's device, per-example hit/miss bookkeeping,
accuracy on the master, ``misclassified.json`` with predicted/true labels
and confidences.  It loads the ``config.json`` and checkpoint of a training
run of either package, with either front end.

Run (on the card, the default; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.speaker_classification.supervised.evaluate \
        --model_path /path/to/storage_dir --synthetic
On a LibriSpeech-style ``JsonDatabase``: ``--database db.json --dataset
test_clean`` (WAV files under ``audio_path``, labels under ``speaker_id``).
Run on the CPU: add ``--device cpu``.  ``--compute_dtype bfloat16`` serves
with the GRU's bf16 products and streams (``set_rnn_backend``; on the card
the lean bf16 GRU kernel).
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.contrib.je.modules.features import (
    FusedAudioLogMelExtractor)
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.evaluation import (
    split_managed, gather_merged, is_master,
)
from padertorch_tpu_torch.modules.recurrent import set_rnn_backend

from . import data
from .model import SpeakerClf


def evaluate_batch(model, batch):
    """One request: the batch through the model on its device; returns
    {example_id: {hit, true_label, predicted_label, confidence}}."""
    with torch.no_grad():
        logits = model(model.example_to_device(batch)).float().cpu().numpy()
    predictions = logits.argmax(-1)
    exp = np.exp(logits - logits.max(-1, keepdims=True))
    confidences = (exp / exp.sum(-1, keepdims=True)).max(-1)
    labels = np.asarray(batch['speaker_id'])
    return {
        example_id: {
            'hit': bool(label == pred),
            'true_label': int(label),
            'predicted_label': int(pred),
            'confidence': float(conf),
        }
        for example_id, label, pred, conf in zip(
            batch['example_id'], labels, predictions, confidences)
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--dataset', default='test_clean')
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--checkpoint', default='ckpt_best_accuracy.ptt')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--compute_dtype', default=None,
                        choices=['bfloat16'],
                        help="the GRU's products and streams")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    try:
        model = SpeakerClf.from_storage_dir(
            model_path, checkpoint_name=args.checkpoint)
    except FileNotFoundError:
        model = SpeakerClf.from_storage_dir(
            model_path, checkpoint_name='ckpt_latest.ptt')
    model = model.to(args.device).eval()
    if args.compute_dtype:
        set_rnn_backend(model, 'pallas', compute_dtype=args.compute_dtype)
    print(f'device: {args.device}')

    if args.synthetic or args.database is None:
        full = data.synthetic_database()
        dataset = full[[i for i in range(len(full)) if i % 5 == 0]]
    else:
        dataset = JsonDatabase(args.database).get_dataset(args.dataset)

    label_encoder = data.get_label_encoder(model_path, dataset)
    dataset = dataset.map(data.read_audio)
    if isinstance(model.feature_extractor, FusedAudioLogMelExtractor):
        # trained with --on_device_features: ship raw audio
        prepare = data.prepare_dataset_audio
    else:
        prepare = data.prepare_dataset
    dataset = prepare(dataset, label_encoder, batch_size=args.batch_size,
                      shuffle=False, prefetch=False)

    results = {}
    for batch in split_managed(dataset, progress_bar=True):
        results.update(evaluate_batch(model, batch))

    merged = gather_merged(results)
    if is_master():
        out_dir = model_path / 'eval'
        out_dir.mkdir(exist_ok=True)
        hits = [v['hit'] for v in merged.values()]
        inverse = label_encoder.inverse_label_mapping
        misclassified = {
            k: {**v,
                'true_label': inverse.get(v['true_label'], v['true_label']),
                'predicted_label': inverse.get(
                    v['predicted_label'], v['predicted_label'])}
            for k, v in merged.items() if not v['hit']
        }
        summary = {
            'accuracy': float(np.mean(hits)),
            'num_examples': len(hits),
            'num_misclassified': len(misclassified),
        }
        (out_dir / 'misclassified.json').write_text(
            json.dumps(misclassified, indent=2))
        (out_dir / 'means.json').write_text(json.dumps(summary, indent=2))
        print(json.dumps(summary, indent=2))


if __name__ == '__main__':
    main()
