"""Evaluate the mask estimator: masking + beamforming + stoi/sdr.

Counterpart of ``padertorch_tpu/contrib/examples/speech_enhancement/
mask_estimator/evaluate.py`` (reference ``mask_estimator/evaluate.py:88``):
per-channel mask prediction on the model's device, channel-median masks,
PSD matrices, beamforming on the host (MVDR-Souden as the reference script
instantiates, GEV+BAN as its README headlines — selectable), and observed
/ masked / beamformed metric triples of stoi, si_sdr and sdr (BSS-eval).
The masked output goes through ``HostSTFT.masked_inverse``: on a CUDA
device the ``masked_istft`` kernel.

Run (on the card, the default; without one it fails), after
``train.py --synthetic``:
    python -m padertorch_tpu_torch.contrib.examples.speech_enhancement.mask_estimator.evaluate \
        --model_path /path/to/storage_dir --synthetic
On a CHiME-style ``JsonDatabase``: ``--database db.json --dataset
et05_simu`` (``read_audio``: the channels' WAV files under
``audio_path.observation``, the clean speech under
``audio_path.speech_source``).
Run on the CPU: add ``--device cpu``.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.contrib.je.data.transforms import AudioReader
from padertorch_tpu_torch.data.batch import example_to_device
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.evaluation import (
    split_managed, gather_merged, is_master, si_sdr, mir_eval_sdr, stoi,
)
from padertorch_tpu_torch.evaluation.beamforming import (
    get_power_spectral_density_matrix, get_gev_vector,
    get_mvdr_vector_souden, blind_analytic_normalization,
    apply_beamforming_vector,
)
from padertorch_tpu_torch.contrib.neumann.evaluation import compute_means
from padertorch_tpu_torch.models.mask_estimator import SimpleMaskEstimator

from . import train as train_mod

SAMPLE_RATE = 8000


def synthetic_multichannel_database(num_examples=4, num_channels=4,
                                    num_samples=16000, seed=2):
    """Multi-channel mixtures: per-channel delayed/attenuated speech +
    spatially-uncorrelated noise (a tiny CHiME et05_simu stand-in)."""
    from padertorch_tpu_torch.data import dataset as lazy
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / SAMPLE_RATE
    examples = {}
    for i in range(num_examples):
        f0 = rng.uniform(100, 800)
        speech = np.sin(2 * np.pi * f0 * t) * (
            1 + np.sin(2 * np.pi * rng.uniform(1, 3) * t)) / 2
        channels = []
        for c in range(num_channels):
            delay = rng.randint(0, 8)
            gain = rng.uniform(0.7, 1.0)
            ch = gain * np.roll(speech, delay)
            ch = ch + 0.3 * rng.randn(num_samples)
            channels.append(ch)
        examples[f'ex_{i}'] = {
            'example_id': f'ex_{i}',
            'observation': np.stack(channels).astype('float32'),
            'speech_source': speech.astype('float32'),
        }
    return lazy.from_dict(examples)


def read_audio(example):
    """A ``JsonDatabase`` example's WAV files read at the recipe's sample
    rate: ``audio_path.observation`` (one file a channel, as a list or a
    dict of channel names, or one multichannel file) into ``observation``
    (C, T) and ``audio_path.speech_source`` into ``speech_source`` (T,).
    An example that holds its signals already (the JAX recipe's
    ``--database`` schema) is returned as it is."""
    if 'audio_path' not in example:
        return example
    reader = AudioReader(target_sample_rate=SAMPLE_RATE)
    paths = example['audio_path']
    observation = paths['observation']
    if isinstance(observation, dict):
        observation = [observation[k] for k in sorted(observation)]
    if isinstance(observation, (list, tuple)):
        observation = np.stack([reader.read_file(p) for p in observation])
    else:
        observation = np.atleast_2d(reader.read_file(observation))
    source = reader.read_file(paths['speech_source'])
    if source.ndim == 2:
        source = source[0]
    return {'example_id': example['example_id'],
            'observation': observation, 'speech_source': source}


def beamform(Y, speech_mask, noise_mask, beamformer='mvdr_souden'):
    """(C, T, F) STFT + (T, F) channel-median masks -> (T, F) output.

    ``mvdr_souden`` is what the reference evaluate script instantiates
    (``mask_estimator/evaluate.py:132``, ``get_bf_vector('mvdr_souden')``);
    ``gev`` (+BAN) is the variant its README headlines.
    """
    target_psd = get_power_spectral_density_matrix(Y, speech_mask)
    noise_psd = get_power_spectral_density_matrix(Y, noise_mask)
    if beamformer == 'mvdr_souden':
        w = get_mvdr_vector_souden(target_psd, noise_psd)
    elif beamformer == 'gev':
        w = get_gev_vector(target_psd, noise_psd)
        w = blind_analytic_normalization(w, noise_psd)
    else:
        raise ValueError(f'unknown beamformer: {beamformer!r}')
    return apply_beamforming_vector(w, Y)


def evaluate_example(model, stft, example, beamformer='mvdr_souden'):
    """One request: the C channels' masks on the model's device (one row
    a channel), the first channel's masked signal through
    ``stft.masked_inverse`` there, beamforming and metrics on the host."""
    device = next(model.parameters()).device
    observation = np.asarray(example['observation'])   # (C, T_samples)
    source = np.asarray(example['speech_source'])      # (T_samples,)
    Y = np.asarray(stft(observation))                  # (C, T, F)
    batch = example_to_device({
        'observation_abs': np.abs(Y).astype('float32'),
        'num_frames': np.asarray([Y.shape[1]] * Y.shape[0], 'int32'),
    }, device)
    with torch.no_grad():
        out = model(batch)
    speech_mask = out['speech_mask_prediction'].cpu().numpy()  # (C, T, F)
    noise_mask = out['noise_mask_prediction'].cpu().numpy()

    t = observation.shape[-1]
    # masked: first channel, its own mask — fused mask + synthesis
    z_masked = np.asarray(stft.masked_inverse(
        Y[0], speech_mask[0], device=device))[..., :t]
    # beamformed: channel-median masks -> PSDs -> beamforming vector
    Z_bf = beamform(
        Y,
        np.median(speech_mask, axis=0),
        np.median(noise_mask, axis=0),
        beamformer=beamformer,
    )
    z_bf = np.asarray(stft.inverse(Z_bf))[..., :t]
    y0 = observation[0][:t]
    s = source[:t]

    def metric_triple(estimate):
        return {
            'stoi': float(stoi(s, estimate, sample_rate=SAMPLE_RATE)),
            'si_sdr': float(si_sdr(estimate, s)),
            'sdr': float(mir_eval_sdr(estimate[None], s[None])[0]),
        }

    return example['example_id'], {
        'observed': metric_triple(y0),
        'masked': metric_triple(z_masked[:t]),
        'beamformed': metric_triple(z_bf[:t]),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_path', required=True)
    parser.add_argument('--database', default=None)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--dataset', default='et05_simu')
    parser.add_argument('--checkpoint', default='ckpt_best_loss.ptt')
    parser.add_argument('--beamformer', default='mvdr_souden',
                        choices=('mvdr_souden', 'gev'))
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()

    model_path = Path(args.model_path)
    model = SimpleMaskEstimator.from_storage_dir(
        model_path, checkpoint_name=args.checkpoint)
    model = model.to(args.device).eval()
    print(f'device: {args.device}')

    stft = train_mod._stft
    if args.synthetic or args.database is None:
        dataset = synthetic_multichannel_database()
    else:
        dataset = JsonDatabase(args.database).get_dataset(
            args.dataset).map(read_audio)

    results = {}
    for example in split_managed(dataset, progress_bar=True):
        example_id, metrics = evaluate_example(
            model, stft, example, beamformer=args.beamformer)
        results[example_id] = metrics

    merged = gather_merged(results)
    if is_master():
        out_dir = model_path / 'eval'
        out_dir.mkdir(exist_ok=True)
        (out_dir / 'result.json').write_text(json.dumps(merged, indent=2))
        means = compute_means(merged)
        (out_dir / 'means.json').write_text(json.dumps(means, indent=2))
        print(json.dumps(means, indent=2))


if __name__ == '__main__':
    main()
