"""The port imports neither JAX nor ``padertorch_tpu``, nor
``tensorboardX``, ``optax`` or ``matplotlib``, and a run on the CPU
launches no kernel (all kernels' launch counts stay 0): one served request
and one training step through the trainer, its hooks, the optimizer and
the event writer, for the uPIT model and for the DPRNN-TasNet (with GRU
chunk RNNs, through its recipe's own entry points)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import json, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
import padertorch_tpu_torch
from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data, evaluate, train)
from padertorch_tpu_torch.summary.writer import SummaryWriter
from padertorch_tpu_torch.summary import tfevents
from padertorch_tpu_torch.train import hooks, optimizer, trainer, trigger
from padertorch_tpu_torch.train import runtime_tests
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.ops._stft import HostSTFT
from padertorch_tpu_torch.ops.kernels.lstm import lstm_cell_scan
from padertorch_tpu_torch.ops.kernels.masked_istft import masked_istft
from padertorch_tpu_torch.ops.kernels.gru import gru_cell_scan
from padertorch_tpu_torch.contrib.examples.source_separation.tasnet import (
    data as tas_data, evaluate as tas_evaluate, train as tas_train,
    model as tas_model, tas_coders)
from padertorch_tpu_torch.data import segment

torch.manual_seed(0)
model = PermutationInvariantTrainingModel(
    F=257, recurrent_layers=1, units=8, K=2).eval()
stft = HostSTFT(512, 128, fading='full', complex_representation='complex')
example = next(iter(data.synthetic_database(num_examples=1,
                                             num_samples=2000)))
_, metrics = evaluate.evaluate_example(model, stft, example)

with tempfile.TemporaryDirectory() as tmp:
    config = train.get_trainer_config(tmp, {
        'model': {'units': 8, 'recurrent_layers': 1},
        'stop_trigger': (1, 'iteration')})
    t = trainer.Trainer.from_config(config)
    batches = data.prepare_dataset(
        data.synthetic_database(num_examples=2, num_samples=2000),
        batch_size=2, shuffle=False, prefetch=False)
    t.train(batches)
    events = [f for f in t.storage_dir.iterdir() if 'tfevents' in f.name]
    scalars = tfevents.scalars_from_events(events[0])
    trained = (t.iteration, sorted(
        f.name for f in t.checkpoint_dir.iterdir()))
# the same for the DPRNN-TasNet with GRU chunk RNNs
with tempfile.TemporaryDirectory() as tmp:
    config = tas_train.get_trainer_config(tmp, updates={
        'model': {**tas_train.SMALL, 'separator': {
            **tas_train.SMALL['separator'], 'inter_chunk_type': 'bgru',
            'intra_chunk_type': 'bgru'}},
        'stop_trigger': (1, 'iteration')})
    t = trainer.Trainer.from_config(config)
    batches = tas_data.prepare_dataset(
        tas_data.synthetic_database(num_examples=2, num_samples=2000),
        batch_size=2, segment_length=1000, shuffle=False, prefetch=False)
    t.train(batches)
    events = [f for f in t.storage_dir.iterdir() if 'tfevents' in f.name]
    tas_scalars = tfevents.scalars_from_events(events[0])
    tas_trained = (t.iteration, type(
        t.model.separator.dprnn_blocks[0].intra_chunk_rnn.rnn).__name__)
    _, tas_metrics = tas_evaluate.evaluate_example(t.model.eval(), example)
print(json.dumps({
    'modules': sorted(sys.modules),
    'launches': [*lstm_cell_scan.launches.values(), masked_istft.launches,
                 *gru_cell_scan.launches.values()],
    'tas_finite': bool(np.isfinite(tas_metrics['output_si_sdr']).all()),
    'tas_trained': tas_trained,
    'tas_train_loss': tas_scalars['training/loss'],
    'finite': bool(np.isfinite(metrics['output_si_sdr']).all()),
    'trained': trained,
    'train_loss': scalars['training/loss'],
}))
'''


def test_port_imports_no_jax_and_launches_nothing_on_cpu():
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = ('jax', 'jaxlib', 'padertorch_tpu', 'tensorboardX', 'optax',
              'matplotlib')
    forbidden = [m for m in out['modules'] if m.split('.')[0] in banned]
    assert forbidden == []
    assert 'padertorch_tpu_torch.train.trainer' in out['modules']
    assert 'padertorch_tpu_torch.models.tasnet' in out['modules']
    assert out['launches'] == [0] * 7
    assert out['finite']
    assert out['trained'] == [
        1, ['ckpt_0.ptt', 'ckpt_1.ptt', 'ckpt_latest.ptt']]
    (step, loss), = out['train_loss']
    assert step == 1 and np.isfinite(loss)
    assert out['tas_finite']
    assert out['tas_trained'] == [1, 'GRU']
    (step, loss), = out['tas_train_loss']
    assert step == 1 and np.isfinite(loss)
