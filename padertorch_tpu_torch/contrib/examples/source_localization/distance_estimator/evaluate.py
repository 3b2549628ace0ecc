"""Evaluate the distance estimator: mae / rmse / accuracy / pseudo-accuracy.

Counterpart of ``padertorch_tpu/contrib/examples/source_localization/
distance_estimator/evaluate.py`` (reference
``contrib/examples/source_localization/distance_estimator/evaluate.py``):
per-example distance predictions on the model's device, quantized-class
accuracy, and pseudo-accuracy (prediction within +-1 class of the target),
dumped as ``evaluation_result.json``.  It loads the ``config.json`` and
checkpoint of a training run of either package.

Run (on the card, the default; without one it fails), after
``train.py --synthetic``:
    python -m padertorch_tpu_torch.contrib.examples.source_localization.distance_estimator.evaluate \
        --model_path /path/to/storage_dir --synthetic
Run on the CPU: add ``--device cpu``.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.evaluation import (
    split_managed, gather_merged, is_master,
)

from . import data
from .train import DistanceEstimator, QUANT_STEP, D_MIN


def get_pseudo_acc(summary):
    """Per-example +-1-class pseudo-accuracy from a summary dict with
    ``target``/``est_cls`` arrays (reference ``evaluate.py:74`` — there
    it pops both keys from the summary; same here).

    >>> get_pseudo_acc({'target': [3, 4, 7], 'est_cls': [3, 5, 1]})
    array([ True,  True, False])
    """
    target = np.asarray(summary.pop('target'))
    est_cls = np.asarray(summary.pop('est_cls'))
    return (
        (est_cls == target)
        | (est_cls == target - 1)
        | (est_cls == target + 1)
    )


def evaluate_batch(model, batch):
    """One request: {example_id: {estimate, target, est_cls, target_cls}}
    of a batch, the model on its device."""
    with torch.no_grad():
        estimates = model(model.example_to_device(batch)).float().cpu()
    results = {}
    for example_id, est, target, label in zip(
            batch['example_id'], estimates.numpy(),
            np.asarray(batch['distance']), np.asarray(batch['label'])):
        results[example_id] = {
            'estimate': float(est),
            'target': float(target),
            'est_cls': int(round((float(est) - D_MIN) / QUANT_STEP)),
            'target_cls': int(label),
        }
    return results


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--feature', default=None,
                        help='defaults to the feature set recorded at '
                             'training time (feature.json)')
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--checkpoint', default='ckpt_best_mae.ptt')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    feature = args.feature
    if feature is None:
        feature_file = model_path / 'feature.json'
        feature = json.loads(feature_file.read_text())['feature'] \
            if feature_file.exists() else 'mag ild ipd'

    try:
        model = DistanceEstimator.from_storage_dir(
            model_path, checkpoint_name=args.checkpoint)
    except FileNotFoundError:
        model = DistanceEstimator.from_storage_dir(
            model_path, checkpoint_name='ckpt_latest.ptt')
    model = model.to(args.device).eval()
    print(f'device: {args.device}')

    dataset = data.prepare(
        data.synthetic_database(num_examples=32, seed=7),
        feature=feature, batch_size=args.batch_size, shuffle=False,
        quant_step=QUANT_STEP, d_min=D_MIN)

    results = {}
    for batch in split_managed(dataset, progress_bar=True):
        results.update(evaluate_batch(model, batch))

    merged = gather_merged(results)
    if is_master():
        est = np.asarray([v['estimate'] for v in merged.values()])
        target = np.asarray([v['target'] for v in merged.values()])
        est_cls = np.asarray([v['est_cls'] for v in merged.values()])
        target_cls = np.asarray([v['target_cls'] for v in merged.values()])
        err = est - target
        summary = {
            'feature': feature,
            'mae': float(np.abs(err).mean()),
            'rmse': float(np.sqrt((err ** 2).mean())),
            'accuracy': float((est_cls == target_cls).mean()),
            'pseudo_accuracy': float(
                (np.abs(est_cls - target_cls) <= 1).mean()),
            'num_examples': len(merged),
        }
        out_dir = model_path / 'eval'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'evaluation_result.json').write_text(
            json.dumps({'summary': summary, 'examples': merged}, indent=2))
        print(json.dumps(summary, indent=2))


if __name__ == '__main__':
    main()
