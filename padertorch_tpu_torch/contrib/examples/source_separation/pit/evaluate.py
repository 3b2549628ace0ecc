"""Evaluate a trained uPIT model: masking + iSTFT + SI-SDR/BSS-eval.

Counterpart of ``padertorch_tpu/contrib/examples/source_separation/pit/
evaluate.py`` (reference ``contrib/examples/source_separation/pit/
evaluate.py``).  It loads the ``config.json`` and checkpoint of a
training run of either package; on a CUDA device the BLSTM recurrence and
the fused mask + iSTFT run in the hand-written kernels.

Run (on the card, the default; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.source_separation.pit.evaluate \
        --model_path /path/to/storage_dir --synthetic
Run on the CPU: add ``--device cpu``.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.data.batch import example_to_device
from padertorch_tpu_torch.evaluation import (
    InputMetrics, OutputMetrics, split_managed, gather_merged, is_master,
)
from padertorch_tpu_torch.contrib.neumann.evaluation import compute_means
from padertorch_tpu_torch.ops._stft import HostSTFT as STFT

from . import data


def evaluate_example(model, stft, example):
    """One request: features on the host, masks on the model's device,
    fused mask + iSTFT there, metrics on the host (numpy out)."""
    device = next(model.parameters()).device
    features = data.pre_batch_transform(example)
    batch = example_to_device(data.post_batch_transform([features]), device)
    with torch.no_grad():
        mask = model(batch)[0].cpu().numpy()  # (T, K, F)
    obs_stft = np.asarray(stft(example['observation']))  # (T, F)
    estimates = np.asarray(stft.masked_inverse(
        obs_stft, mask.transpose(1, 0, 2), device=device))
    t = example['observation'].shape[-1]
    estimates = estimates[..., :t]
    sources = np.asarray(example['speech_source'])[..., :t]

    input_metrics = InputMetrics(
        observation=example['observation'][:t],
        speech_source=sources,
    ).as_dict()
    output_metrics = OutputMetrics(
        speech_prediction=estimates,
        speech_source=sources,
    ).as_dict()
    return example['example_id'], {
        **{f'input_{k}': v.tolist() for k, v in input_metrics.items()},
        **{f'output_{k}': v.tolist() for k, v in output_metrics.items()},
        **{
            f'improvement_{k}': (
                np.asarray(output_metrics[k])
                - np.asarray(input_metrics[k])).mean().tolist()
            for k in output_metrics
        },
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--database', default=None,
                        help='a WSJ0-2mix-style JsonDatabase (WAV files '
                             'under audio_path)')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--dataset', default='mix_2_spk_min_tt')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    model = PermutationInvariantTrainingModel.from_storage_dir(
        model_path, checkpoint_name='ckpt_best_loss.ptt')
    model = model.to(args.device).eval()
    print(f'device: {args.device}')

    stft = STFT(data.STFT_SIZE, data.STFT_SHIFT, fading='full',
                complex_representation='complex', dtype='float32')
    if args.synthetic or args.database is None:
        dataset = data.synthetic_database(num_examples=8, seed=2)
    else:
        dataset = JsonDatabase(args.database).get_dataset(
            args.dataset).map(data.read_audio)

    results = {}
    for example in split_managed(dataset, progress_bar=True):
        example_id, metrics = evaluate_example(model, stft, example)
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
