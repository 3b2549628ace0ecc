"""The port imports neither JAX nor ``padertorch_tpu``, nor
``tensorboardX``, ``optax`` or ``matplotlib``, and a run on the CPU
launches no kernel (all kernels' launch counts stay 0): one served request
and one training step through the trainer, its hooks, the optimizer and
the event writer, for the uPIT model, for the DPRNN-TasNet (with GRU
chunk RNNs) and for the SepFormer-TasNet with its attention forced onto the
fused backend (both through the tasnet recipe's own entry points)."""
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
from padertorch_tpu_torch.ops.kernels.attention import flash_attention
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    MultiheadAttention, set_attention_backend)
from padertorch_tpu_torch.modules import dual_path_transformer
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
# and for the SepFormer-TasNet, the fused attention backend forced
with tempfile.TemporaryDirectory() as tmp:
    config = tas_train.get_trainer_config(tmp, variant='sepformer', updates={
        'model': tas_train.SMALL_SEPFORMER,
        'stop_trigger': (1, 'iteration')})
    t = trainer.Trainer.from_config(config)
    set_attention_backend(t.model, True)
    t.train(batches)
    events = [f for f in t.storage_dir.iterdir() if 'tfevents' in f.name]
    sep_scalars = tfevents.scalars_from_events(events[0])
    sep_trained = (t.iteration, type(t.model.separator).__name__, sorted(
        {m.use_flash for m in t.model.modules()
         if isinstance(m, MultiheadAttention)}))
    _, sep_metrics = tas_evaluate.evaluate_example(t.model.eval(), example)
print(json.dumps({
    'modules': sorted(sys.modules),
    'launches': [*lstm_cell_scan.launches.values(), masked_istft.launches,
                 *gru_cell_scan.launches.values(),
                 *flash_attention.launches.values()],
    'sep_finite': bool(np.isfinite(sep_metrics['output_si_sdr']).all()),
    'sep_trained': sep_trained,
    'sep_train_loss': sep_scalars['training/loss'],
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
    assert 'padertorch_tpu_torch.modules.dual_path_transformer' in \
        out['modules']
    assert out['launches'] == [0] * 10
    assert out['finite']
    assert out['trained'] == [
        1, ['ckpt_0.ptt', 'ckpt_1.ptt', 'ckpt_latest.ptt']]
    (step, loss), = out['train_loss']
    assert step == 1 and np.isfinite(loss)
    assert out['tas_finite']
    assert out['tas_trained'] == [1, 'GRU']
    (step, loss), = out['tas_train_loss']
    assert step == 1 and np.isfinite(loss)
    assert out['sep_finite']
    assert out['sep_trained'] == [1, 'DualPathTransformer', [True]]
    (step, loss), = out['sep_train_loss']
    assert step == 1 and np.isfinite(loss)


VOCODER_AND_CLASSIFIER = r'''
import importlib, json, pkgutil, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
import padertorch_tpu_torch
# every module of the package imports, and none of them pulls JAX in
for info in pkgutil.walk_packages(padertorch_tpu_torch.__path__,
                                  'padertorch_tpu_torch.'):
    importlib.import_module(info.name)
from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet import (
    data as wn_data, evaluate as wn_evaluate, train as wn_train)
from padertorch_tpu_torch.contrib.examples.speaker_classification.supervised \
    import data as spk_data, evaluate as spk_evaluate, train as spk_train
from padertorch_tpu_torch.ops.kernels.gru import gru_cell_scan
from padertorch_tpu_torch.ops.kernels.logmel import fused_logmel
from padertorch_tpu_torch.ops.kernels.wavenet import wavenet_sample
from padertorch_tpu_torch.ops.kernels.int8_matmul import int8_matmul
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    TransformerDecoder, autoregressive_generate)
from padertorch_tpu_torch.quantize import quantize_module
from padertorch_tpu_torch.serve import ContinuousBatcher
from padertorch_tpu_torch.train import trainer

torch.manual_seed(0)
# the int8 decode path: a quantized decoder on the kernel route generates
# and serves one request
decoder = TransformerDecoder(d_model=32, num_layers=1, num_heads=4).eval()
quantize_module(decoder)
for m in decoder.modules():
    if hasattr(m, 'use_kernel'):
        m.use_kernel = True
emb, head = torch.nn.Embedding(11, 32), torch.nn.Linear(32, 11)
memory = torch.randn(1, 5, 32)
tokens, _ = autoregressive_generate(
    decoder, memory, embed=emb, logits_head=head, bos_id=0, max_len=4)
batcher = ContinuousBatcher(
    decoder, embed=emb, logits_head=head, num_slots=2, max_len=4,
    max_memory_len=5, d_memory=32, bos_id=0, eos_id=-1)
request = batcher.submit(memory[0])
decoded = [tokens[0].tolist(), batcher.run_until_done()[request]]
with tempfile.TemporaryDirectory() as tmp:
    config = wn_train.get_trainer_config(tmp, {
        'model': wn_train.SMALL, 'stop_trigger': (1, 'iteration')})
    t = trainer.Trainer.from_config(config)
    t.train(wn_data.prepare_dataset(
        wn_data.synthetic_database(num_examples=2, num_samples=2000),
        batch_size=2, segment_length=2000, shuffle=False, prefetch=False))
    example = wn_data.extract_features(next(iter(
        wn_data.synthetic_database(num_examples=1, num_samples=1000))))
    results = [wn_evaluate.synthesize_example(
        t.model.eval(), example, chunk_length=600, chunk_overlap=100,
        parallel=parallel, generator=torch.Generator().manual_seed(1))
        for parallel in (False, True)]
    wavenet = (t.iteration, [r[1]['num_samples'] for r in results],
               [bool(np.isfinite(r[1]['rmse'])) for r in results])
with tempfile.TemporaryDirectory() as tmp:
    train_ds, dev_ds = spk_train.synthetic_split(4)
    encoder = spk_data.get_label_encoder(tmp, train_ds)
    config = spk_train.get_trainer_config(
        tmp, 8, on_device_features=True,
        updates={'stop_trigger': (1, 'iteration')})
    t = trainer.Trainer.from_config(config)
    t.train(spk_data.prepare_dataset_audio(
        train_ds, encoder, batch_size=4, shuffle=False, prefetch=False))
    batch = next(iter(spk_data.prepare_dataset_audio(
        dev_ds, encoder, batch_size=4, shuffle=False, prefetch=False)))
    served = spk_evaluate.evaluate_batch(t.model.eval(), batch)
    speaker = (t.iteration, len(served),
               sorted({type(v['hit']).__name__ for v in served.values()}))
print(json.dumps({
    'modules': sorted(sys.modules),
    'launches': [wavenet_sample.launches, fused_logmel.launches,
                 *gru_cell_scan.launches.values(), int8_matmul.launches],
    'decoded': decoded, 'wavenet': wavenet, 'speaker': speaker}))
'''


def test_vocoder_and_classifier_paths_import_no_jax_and_launch_nothing():
    """Every module of the port imports without JAX; one training step and
    one served request of the WaveNet vocoder (sequential and parallel
    chunks) and of the speaker classifier with the on-device front end, and
    a quantized decoder's generation and one batched request, run on the
    CPU through the kernels' plain versions."""
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run(
        [sys.executable, '-c', VOCODER_AND_CLASSIFIER], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = ('jax', 'jaxlib', 'padertorch_tpu', 'tensorboardX', 'optax',
              'matplotlib', 'triton')
    assert [m for m in out['modules'] if m.split('.')[0] in banned] == []
    for name in ('modules.wavenet.wavenet', 'modules.normalization',
                 'contrib.je.modules.features', 'contrib.je.modules.reduce',
                 'contrib.je.data.transforms', 'ops.kernels.wavenet',
                 'ops.kernels.logmel', 'ops.mu_law',
                 'ops.losses.classification', 'quantize', 'serve', 'module',
                 'ops.kernels.int8_matmul', 'contrib.mk.modules.transformer'):
        assert f'padertorch_tpu_torch.{name}' in out['modules']
    assert out['launches'] == [0] * 6
    generated, served = out['decoded']
    assert served == generated and len(served) == 4
    assert out['wavenet'] == [1, [1000, 1000], [True, True]]
    assert out['speaker'] == [1, 4, ['bool']]


FLOAT32 = r'''
import json
import torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
import padertorch_tpu_torch.train.trainer
print(json.dumps([torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32]))
'''


def test_importing_any_module_of_the_port_turns_tf32_off():
    """Float32 is the package's decision, not a recipe's ``main``: whoever
    builds a ``Trainer`` or loads a storage dir gets float32 products and
    convolutions on the card."""
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run([sys.executable, '-c', FLOAT32], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [False, False]
