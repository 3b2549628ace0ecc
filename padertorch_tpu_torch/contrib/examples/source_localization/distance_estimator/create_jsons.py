"""Build database JSONs for the distance-estimator recipe.

Counterpart of ``padertorch_tpu/contrib/examples/source_localization/
distance_estimator/create_jsons.py`` (reference
``contrib/examples/source_localization/distance_estimator/create_jsons.py``),
copied: it indexes a RIR database (per-example source/node positions -> distance)
and a source-signal database (LibriSpeech there) into the JSON schema
``padertorch_tpu_torch.data.database.JsonDatabase`` consumes.

The script works on any local directory tree of wav files, and
``--synthetic OUT_DIR`` first materializes a tiny wav dataset to index
(used by the smoke test).

Run:
    python -m padertorch_tpu_torch.contrib.examples.source_localization.distance_estimator.create_jsons \
        --rir_path /data/rirs --out rirs.json
"""
import argparse
import json
import wave
from pathlib import Path

import numpy as np

from padertorch_tpu_torch.contrib.examples._audio import write_wav as _write_wav


def audio_length(path):
    """Number of samples of a wav file (stdlib; no soundfile needed)."""
    with wave.open(str(path), 'rb') as fh:
        return fh.getnframes()


def index_rir_database(rir_path):
    """Scan a RIR database tree: one example per scene directory that
    contains wavs + a ``positions.json`` with source/node positions."""
    rir_path = Path(rir_path)
    examples = {}
    for scene in sorted(p for p in rir_path.iterdir() if p.is_dir()):
        wavs = sorted(scene.glob('*.wav'))
        if not wavs:
            continue
        example = {
            'audio_path': {'rir': [str(w) for w in wavs]},
            'num_samples': audio_length(wavs[0]),
        }
        positions_file = scene / 'positions.json'
        if positions_file.exists():
            positions = json.loads(positions_file.read_text())
            example.update(positions)
            if ('source_position' in positions
                    and 'node_position' in positions):
                source = np.asarray(positions['source_position'], float)
                node = np.asarray(positions['node_position'], float)
                example['distance'] = float(
                    np.sqrt(((source - node) ** 2).sum()))
        examples[scene.name] = example
    return examples


def index_signal_database(signal_path, vad_json_path=None):
    """Scan a flat/nested tree of source-signal wavs; optionally attach
    VAD segments from an external JSON keyed by example id."""
    signal_path = Path(signal_path)
    vad = {}
    if vad_json_path:
        vad = json.loads(Path(vad_json_path).read_text())
    examples = {}
    for wav in sorted(signal_path.rglob('*.wav')):
        example_id = wav.stem
        examples[example_id] = {
            'audio_path': {'speech_source': str(wav)},
            'num_samples': audio_length(wav),
            **({'activity': vad[example_id]} if example_id in vad else {}),
        }
    return examples


def make_synthetic_tree(out_dir, num_scenes=3, num_signals=4,
                        sample_rate=16000, seed=0):
    """Materialize a tiny on-disk dataset (scenes with RIR wavs and
    positions.json + source wavs) so the indexing path is testable."""
    rng = np.random.RandomState(seed)
    out_dir = Path(out_dir)
    rir_dir = out_dir / 'rirs'
    sig_dir = out_dir / 'signals'
    for i in range(num_scenes):
        scene = rir_dir / f'scene_{i}'
        scene.mkdir(parents=True, exist_ok=True)
        for c in range(2):
            _write_wav(scene / f'ch{c}.wav',
                       rng.randn(800) * np.exp(-np.arange(800) / 200.0),
                       sample_rate)
        (scene / 'positions.json').write_text(json.dumps({
            'source_position': rng.uniform(0, 3, 3).tolist(),
            'node_position': rng.uniform(0, 3, 3).tolist(),
        }))
    sig_dir.mkdir(parents=True, exist_ok=True)
    for i in range(num_signals):
        _write_wav(sig_dir / f'utt_{i}.wav',
                   0.5 * np.sin(2 * np.pi * 220 * (1 + i)
                                * np.arange(8000) / sample_rate),
                   sample_rate)
    return rir_dir, sig_dir


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--rir_path', default=None)
    parser.add_argument('--signal_path', default=None)
    parser.add_argument('--vad_json_path', default=None)
    parser.add_argument('--out', default='distance_estimator.json')
    parser.add_argument('--synthetic', default=None, metavar='OUT_DIR',
                        help='materialize + index a tiny synthetic tree')
    args = parser.parse_args()

    if args.synthetic:
        rir_path, signal_path = make_synthetic_tree(args.synthetic)
    else:
        rir_path, signal_path = args.rir_path, args.signal_path
        assert rir_path or signal_path, (
            'specify --rir_path and/or --signal_path (or --synthetic)')

    database = {'datasets': {}}
    if rir_path:
        database['datasets']['rirs'] = index_rir_database(rir_path)
    if signal_path:
        database['datasets']['source_signals'] = index_signal_database(
            signal_path, args.vad_json_path)
    Path(args.out).write_text(json.dumps(database, indent=2))
    counts = {name: len(examples)
              for name, examples in database['datasets'].items()}
    print(f'Wrote {args.out}: {counts}')


if __name__ == '__main__':
    main()
