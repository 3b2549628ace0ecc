"""Evaluate the GAN vocoder: one-shot (non-autoregressive) synthesis.

Counterpart of ``padertorch_tpu/contrib/examples/audio_synthesis/
gan_vocoder/evaluate.py``: the generator synthesizes each utterance in one
feed-forward call; per utterance the multi-resolution STFT loss and the
RMSE, their global means, and WAV dumps of the best and worst utterances
(by STFT loss).  It loads the ``config.json`` and checkpoint of a training
run of either package.

Run (on the card, the default; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.audio_synthesis.gan_vocoder.evaluate \\
        --model_path /path/to/storage_dir --synthetic
On a LibriSpeech-style ``JsonDatabase``: ``--database db.json --dataset
test_clean`` (each example's WAV file under ``audio_path``).
Run on the CPU: add ``--device cpu``.
"""
import argparse
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.contrib.examples._audio import write_wav
from padertorch_tpu_torch.contrib.je.data.transforms import AudioReader
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.evaluation import (
    split_managed, gather_merged, is_master,
)
from padertorch_tpu_torch.ops.losses.stft import multi_resolution_stft_loss

from . import data
from .model import GANVocoder


def synthesize_example(model, example):
    """One utterance through the generator on the model's device; returns
    (example_id, metrics, audio)."""
    device = next(model.parameters()).device
    features = torch.from_numpy(
        np.asarray(example['features'])[None]).to(device)
    target = np.asarray(example['audio_data'])
    with torch.no_grad():
        estimate = model.generator(features)[0].cpu().numpy()
    t = min(estimate.shape[-1], target.shape[-1])
    estimate, target = estimate[:t], target[:t]
    err = float(((estimate - target) ** 2).sum())
    stft_loss = float(multi_resolution_stft_loss(
        torch.from_numpy(estimate[None]), torch.from_numpy(target[None])))
    return example['example_id'], {
        'squared_error': err,
        'num_samples': t,
        'rmse': float(np.sqrt(err / t)),
        'stft_loss': stft_loss,
    }, estimate


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--dataset', default='test_clean')
    parser.add_argument('--max_examples', type=int, default=None)
    parser.add_argument('--num_synthetic_examples', type=int, default=4)
    parser.add_argument('--synthetic_samples', type=int, default=4000)
    parser.add_argument('--num_audio_dumps', type=int, default=10)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    model = GANVocoder.from_storage_dir(
        model_path, checkpoint_name='ckpt_best_loss.ptt')
    model = model.to(args.device).eval()
    print(f'device: {args.device}')

    if args.synthetic or args.database is None:
        dataset = data.synthetic_database(
            num_examples=args.num_synthetic_examples,
            num_samples=args.synthetic_samples, seed=2)
    else:
        reader = AudioReader(target_sample_rate=data.SAMPLE_RATE)
        dataset = JsonDatabase(args.database).get_dataset(
            args.dataset).map(reader)
    if args.max_examples is not None:
        dataset = list(dataset)[:args.max_examples]

    # spill synthesized audio to disk: only num_audio_dumps best/worst
    # are kept
    spill_dir = Path(tempfile.mkdtemp(prefix='gan_vocoder_eval_'))
    try:
        results = {}
        for example in split_managed(dataset, progress_bar=True):
            example = data.extract_features(example)
            example_id, metrics, estimate = synthesize_example(
                model, example)
            results[example_id] = metrics
            np.save(spill_dir / f'{example_id}.npy',
                    estimate.astype('float32'))

        merged = gather_merged(results)
        if is_master():
            out_dir = model_path / 'eval'
            out_dir.mkdir(exist_ok=True)
            total_err = sum(m['squared_error'] for m in merged.values())
            total_t = sum(m['num_samples'] for m in merged.values())
            by_stft = sorted(merged.items(),
                             key=lambda kv: kv[1]['stft_loss'])
            summary = {
                'rmse': float(np.sqrt(total_err / total_t)),
                'stft_loss': float(np.mean(
                    [m['stft_loss'] for m in merged.values()])),
                'num_examples': len(merged),
                'num_samples': total_t,
            }
            (out_dir / 'stft_loss.json').write_text(json.dumps(
                [(k, v['stft_loss']) for k, v in by_stft], indent=2))
            (out_dir / 'means.json').write_text(
                json.dumps(summary, indent=2))
            audio_dir = out_dir / 'audio'
            audio_dir.mkdir(exist_ok=True)
            n = args.num_audio_dumps
            for example_id, _ in (by_stft[:n] + by_stft[-n:]):
                spilled = spill_dir / f'{example_id}.npy'
                if spilled.exists():
                    write_wav(audio_dir / f'{example_id}.wav',
                              np.load(spilled), data.SAMPLE_RATE)
            print(json.dumps(summary, indent=2))
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)


if __name__ == '__main__':
    main()
