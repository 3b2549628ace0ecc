"""The port imports neither JAX nor ``padertorch_tpu``, and a run on the
CPU launches no kernel (both kernels' launch counts stay 0)."""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
import padertorch_tpu_torch
from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data, evaluate)
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.ops._stft import HostSTFT
from padertorch_tpu_torch.ops.kernels.lstm import lstm_cell_scan
from padertorch_tpu_torch.ops.kernels.masked_istft import masked_istft

torch.manual_seed(0)
model = PermutationInvariantTrainingModel(
    F=257, recurrent_layers=1, units=8, K=2).eval()
stft = HostSTFT(512, 128, fading='full', complex_representation='complex')
example = next(iter(data.synthetic_database(num_examples=1,
                                             num_samples=2000)))
_, metrics = evaluate.evaluate_example(model, stft, example)
print(json.dumps({
    'modules': sorted(sys.modules),
    'launches': [lstm_cell_scan.launches, masked_istft.launches],
    'finite': bool(np.isfinite(metrics['output_si_sdr']).all()),
}))
'''


def test_port_imports_no_jax_and_launches_nothing_on_cpu():
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    forbidden = [m for m in out['modules']
                 if m in ('jax', 'padertorch_tpu')
                 or m.startswith(('jax.', 'jaxlib', 'padertorch_tpu.'))]
    assert forbidden == []
    assert 'padertorch_tpu_torch' in out['modules']
    assert out['launches'] == [0, 0]
    assert out['finite']
