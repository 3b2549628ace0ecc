"""Evaluate the WaveNet vocoder: autoregressive synthesis + RMSE.

Counterpart of ``padertorch_tpu/contrib/examples/audio_synthesis/wavenet/
evaluate.py`` (reference ``contrib/examples/audio_synthesis/wavenet/
evaluate.py``: nv_wavenet synthesis, per-utterance squared error, global
``rmse = sqrt(sum(err) / sum(T))``, rmse.json sorted best-first, wav dumps
for the 10 best/worst utterances).  This is the consumer of the fast
sampling path: on the card the model's ``synthesize`` runs the whole sample
loop in the hand-written kernel (``ops/kernels/wavenet.py``), on the CPU
the step-loop sampler.  It loads the ``config.json`` and checkpoint of a
training run of either package.

Run (on the card, the default; without one it fails):
    python -m padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet.evaluate \
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

from . import data
from .model import WaveNetVocoder


def synthesize_example(model, example, chunk_length, chunk_overlap,
                       parallel=False, generator=None):
    """AR synthesis for one example on the model's device; returns
    (example_id, metrics, audio)."""
    features = np.asarray(example['features'])[None]  # (1, M, frames)
    target = np.asarray(example['audio_data'])

    device = next(model.parameters()).device
    estimate = model.synthesize(
        torch.from_numpy(features).to(device), chunk_length=chunk_length,
        chunk_overlap=chunk_overlap, generator=generator,
        parallel=parallel)[0].cpu().numpy()
    # synthesis also reconstructs padded samples; they must be fewer than
    # one frame shift (the maximum pad width)
    n_extra = estimate.shape[-1] - target.shape[-1]
    if not -data.STFT_SHIFT < n_extra < data.STFT_SHIFT:
        raise ValueError(
            f'{estimate.shape[-1]} synthesized samples for a target of '
            f'{target.shape[-1]}: more than a frame shift apart')
    t = min(estimate.shape[-1], target.shape[-1])
    err = float(((estimate[:t] - target[:t]) ** 2).sum())
    return example['example_id'], {
        'squared_error': err,
        'num_samples': t,
        'rmse': float(np.sqrt(err / t)),
    }, estimate[:t]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--dataset', default='test_clean')
    parser.add_argument('--max_examples', type=int, default=None)
    parser.add_argument('--chunk_length', type=int, default=48_000)
    parser.add_argument('--chunk_overlap', type=int, default=16_000)
    parser.add_argument('--parallel', action='store_true',
                        help='batch-parallel chunked synthesis (all '
                             'chunks sample as one batch)')
    parser.add_argument('--num_synthetic_examples', type=int, default=4)
    parser.add_argument('--synthetic_samples', type=int, default=4000)
    parser.add_argument('--num_audio_dumps', type=int, default=10,
                        help='dump this many best + worst utterances as wav')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the sampling draws')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    model = WaveNetVocoder.from_storage_dir(
        model_path, checkpoint_name='ckpt_best_loss.ptt')
    model = model.to(args.device).eval()
    print(f'device: {args.device}')
    generator = torch.Generator().manual_seed(args.seed)

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
    # are kept, and long eval sets would otherwise accumulate GBs in RAM
    spill_dir = Path(tempfile.mkdtemp(prefix='wavenet_eval_'))
    try:
        results = {}
        for example in split_managed(dataset, progress_bar=True):
            example = data.extract_features(example)
            example_id, metrics, estimate = synthesize_example(
                model, example,
                chunk_length=args.chunk_length,
                chunk_overlap=args.chunk_overlap,
                parallel=args.parallel, generator=generator,
            )
            results[example_id] = metrics
            np.save(spill_dir / f'{example_id}.npy',
                    estimate.astype('float32'))

        merged = gather_merged(results)
        if is_master():
            out_dir = model_path / 'eval'
            out_dir.mkdir(exist_ok=True)
            total_err = sum(m['squared_error'] for m in merged.values())
            total_t = sum(m['num_samples'] for m in merged.values())
            global_rmse = float(np.sqrt(total_err / total_t))
            by_rmse = sorted(merged.items(), key=lambda kv: kv[1]['rmse'])
            (out_dir / 'rmse.json').write_text(json.dumps(
                [(k, v['rmse']) for k, v in by_rmse], indent=2))
            summary = {
                'rmse': global_rmse,
                'num_examples': len(merged),
                'num_samples': total_t,
            }
            (out_dir / 'means.json').write_text(
                json.dumps(summary, indent=2))

            # dump best/worst audio (only those synthesized on this rank)
            audio_dir = out_dir / 'audio'
            audio_dir.mkdir(exist_ok=True)
            n = args.num_audio_dumps
            for example_id, _ in (by_rmse[:n] + by_rmse[-n:]):
                spilled = spill_dir / f'{example_id}.npy'
                if spilled.exists():
                    write_wav(audio_dir / f'{example_id}.wav',
                              np.load(spilled), data.SAMPLE_RATE)
            print(json.dumps(summary, indent=2))
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)


if __name__ == '__main__':
    main()
