"""Evaluate a trained OR-PIT model (recursive separation).

Counterpart of ``padertorch_tpu/contrib/examples/source_separation/or_pit/
evaluate.py`` (reference ``or_pit/evaluate.py``).  ``OneAndRestPIT
.separate`` unrolls the one-and-rest recursion to the requested speaker
count on the model's device, then SI-SDR and BSS-eval improvements are
scored per example on the host (PIT-resolved by the metrics).

Run (on the card, the default; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.source_separation.or_pit.evaluate \
        --model_path <storage_dir> --synthetic
Run on the CPU: add ``--device cpu``.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.models.or_pit import OneAndRestPIT
from padertorch_tpu_torch.evaluation import (
    InputMetrics, OutputMetrics, split_managed, gather_merged, is_master,
)
from padertorch_tpu_torch.contrib.neumann.evaluation import compute_means

from ..tasnet import data


def evaluate_example(model, example, num_speakers=2):
    """One request: the recursion on the model's device, metrics on the
    host (numpy out)."""
    batch = model.example_to_device(data.post_batch_transform([{
        'example_id': example['example_id'],
        'observation': example['observation'],
        'speech_source': example['speech_source'],
    }]))
    with torch.no_grad():
        estimates = model.separate(
            batch, num_speakers=num_speakers)[0].cpu().numpy()
    t = example['observation'].shape[-1]
    sources = np.asarray(example['speech_source'])[..., :t]
    input_metrics = InputMetrics(
        observation=example['observation'][:t],
        speech_source=sources).as_dict()
    output_metrics = OutputMetrics(
        speech_prediction=estimates[..., :t],
        speech_source=sources).as_dict()
    return example['example_id'], {
        **{f'input_{k}': v.tolist() for k, v in input_metrics.items()},
        **{f'output_{k}': v.tolist() for k, v in output_metrics.items()},
        **{f'improvement_{k}': float(
            (np.asarray(output_metrics[k])
             - np.asarray(input_metrics[k])).mean())
           for k in output_metrics},
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--database', default=None,
                        help='a WSJ0-2mix-style JsonDatabase (WAV files '
                             'under audio_path)')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--dataset', default='mix_2_spk_min_tt')
    parser.add_argument('--num_speakers', type=int, default=2)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    model = OneAndRestPIT.from_storage_dir(
        model_path, checkpoint_name='ckpt_best_loss.ptt')
    model = model.to(args.device).eval()
    print(f'device: {args.device}')

    if args.synthetic or args.database is None:
        dataset = data.synthetic_database(num_examples=8, seed=2)
    else:
        dataset = JsonDatabase(args.database).get_dataset(
            args.dataset).map(data.read_audio)

    results = {}
    for example in split_managed(dataset, progress_bar=True):
        example_id, metrics = evaluate_example(
            model, example, num_speakers=args.num_speakers)
        results[example_id] = metrics

    results = gather_merged(results)
    if is_master():
        out_dir = model_path / 'eval'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'result.json').write_text(json.dumps(results, indent=2))
        means = compute_means(results)
        (out_dir / 'means.json').write_text(json.dumps(means, indent=2))
        print(json.dumps(means, indent=2))


if __name__ == '__main__':
    main()
