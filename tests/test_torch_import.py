"""The port imports neither JAX nor ``padertorch_tpu``, nor
``tensorboardX``, ``optax`` or ``matplotlib``, and a run on the CPU
launches no kernel (all kernels' launch counts stay 0): one served request
and one training step through the trainer, its hooks, the optimizer and
the event writer, for the uPIT model, for the DPRNN-TasNet (with GRU
chunk RNNs), for the SepFormer-TasNet with its attention forced onto the
fused backend and for the Conv-TasNet (all three through the tasnet
recipe's own entry points), for OR-PIT and the mask estimator (through
their recipes' entry points) and for the deep-clustering model."""
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
    # and served with bf16 GRUs, set as the JAX package's set_rnn_backend
    # sets them
    from padertorch_tpu_torch.modules.recurrent import set_rnn_backend
    set_rnn_backend(t.model, 'pallas', compute_dtype='bfloat16')
    _, tas_bf16_metrics = tas_evaluate.evaluate_example(t.model, example)
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
# the Conv-TasNet, OR-PIT, mask-estimator and deep-clustering paths: one
# training step and one served request each
from padertorch_tpu_torch.contrib.examples.source_separation.or_pit import (
    evaluate as orpit_evaluate, train as orpit_train)
from padertorch_tpu_torch.contrib.examples.speech_enhancement \
    .mask_estimator import evaluate as me_evaluate, train as me_train
from padertorch_tpu_torch.models.bss import DeepClusteringModel
slice_finite = {}
with tempfile.TemporaryDirectory() as tmp:
    config = tas_train.get_trainer_config(tmp, variant='convnet', updates={
        'model': {'encoder': {'feature_size': 16}, 'separator': {
            'input_size': 8, 'num_blocks': 2, 'num_repeats': 1,
            'hidden_channels': 8}},
        'stop_trigger': (1, 'iteration')})
    t = trainer.Trainer.from_config(config)
    t.train(batches)
    _, m = tas_evaluate.evaluate_example(t.model.eval(), example)
    slice_finite['convnet'] = bool(np.isfinite(m['output_si_sdr']).all())
with tempfile.TemporaryDirectory() as tmp:
    t = trainer.Trainer.from_config(orpit_train.get_trainer_config(tmp, {
        'model': orpit_train.SMALL, 'stop_trigger': (1, 'iteration')}))
    t.train(batches)
    _, m = orpit_evaluate.evaluate_example(t.model.eval(), example)
    slice_finite['or_pit'] = bool(np.isfinite(m['output_si_sdr']).all())
with tempfile.TemporaryDirectory() as tmp:
    config = me_train.get_trainer_config(tmp, num_units=8)
    config['stop_trigger'] = (1, 'iteration')
    t = trainer.Trainer.from_config(config)
    t.train(me_train.prepare_dataset(me_train.synthetic_database(
        num_examples=2, num_samples=4000), 2, shuffle=False))
    me_example = next(iter(me_evaluate.synthetic_multichannel_database(
        num_examples=1, num_samples=8000)))
    _, m = me_evaluate.evaluate_example(t.model.eval(), me_train._stft,
                                        me_example, beamformer='gev')
    slice_finite['mask_estimator'] = all(
        np.isfinite(v) for kind in m.values() for v in kind.values())
features = data.pre_batch_transform(example)
dc = DeepClusteringModel(F=257, units=8, E=4)
x_abs = torch.from_numpy(features['X_abs'])[None]
dc_batch = {'Y_abs': torch.from_numpy(features['Y_abs'])[None],
            'target_mask': (x_abs == x_abs.max(2, keepdim=True).values)
            .float()}
dc_loss = dc.review(dc_batch, dc(dc_batch))['losses']['dc_loss']
dc_loss.backward()
slice_finite['deep_clustering'] = bool(torch.isfinite(dc_loss))
print(json.dumps({
    'modules': sorted(sys.modules),
    'slice_finite': slice_finite,
    'launches': [*lstm_cell_scan.launches.values(), masked_istft.launches,
                 *gru_cell_scan.launches.values(),
                 *flash_attention.launches.values()],
    'sep_finite': bool(np.isfinite(sep_metrics['output_si_sdr']).all()),
    'sep_trained': sep_trained,
    'sep_train_loss': sep_scalars['training/loss'],
    'tas_finite': bool(np.isfinite(tas_metrics['output_si_sdr']).all()),
    'tas_bf16_finite': bool(
        np.isfinite(tas_bf16_metrics['output_si_sdr']).all()),
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
    assert 'padertorch_tpu_torch.modules.recurrent' in out['modules']
    for name in ('modules.convnet', 'models.or_pit', 'models.mask_estimator',
                 'modules.normalization', 'evaluation.stoi',
                 'evaluation.beamforming', 'ops.losses.regression',
                 'contrib.examples.source_separation.or_pit.train',
                 'contrib.examples.speech_enhancement.mask_estimator'
                 '.evaluate'):
        assert f'padertorch_tpu_torch.{name}' in out['modules'], name
    assert out['slice_finite'] == {'convnet': True, 'or_pit': True,
                                   'mask_estimator': True,
                                   'deep_clustering': True}
    assert out['launches'] == [0] * 19
    assert out['finite']
    assert out['trained'] == [
        1, ['ckpt_0.ptt', 'ckpt_1.ptt', 'ckpt_latest.ptt']]
    (step, loss), = out['train_loss']
    assert step == 1 and np.isfinite(loss)
    assert out['tas_finite'] and out['tas_bf16_finite']
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
    assert out['launches'] == [0] * 9
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


SPEECH_RECOGNITION = r'''
import json, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
from padertorch_tpu_torch.contrib.examples.speech_recognition.ctc import (
    data, evaluate, train)
from padertorch_tpu_torch.data.database import JsonDatabase
from padertorch_tpu_torch.evaluation import NGramLM
from padertorch_tpu_torch.ops.kernels.attention import flash_attention
from padertorch_tpu_torch.ops.kernels.lstm import lstm_cell_scan
from padertorch_tpu_torch.train import trainer

torch.manual_seed(0)
train_ds, _ = train.synthetic_split(6, 2)
batches = data.prepare_dataset(train_ds, batch_size=2, shuffle=False,
                               prefetch=False)
batch = next(iter(batches))
lm = NGramLM(order=2).fit([[1, 2, 3]])
heads = {}
for head in ('ctc', 'transducer', 'aed'):
    with tempfile.TemporaryDirectory() as tmp:
        config = train.get_trainer_config(
            tmp, head, d_model=16, num_layers=1, num_heads=2,
            kernel_size=5, causal=head == 'transducer',
            updates={'stop_trigger': (1, 'iteration')})
        t = trainer.Trainer.from_config(config)
        t.train(batches)
        model = t.model.eval()
        greedy = model.decode(batch)
        beam = model.decode(batch, beam_width=2,
                            **({'lm_fn': lm} if head == 'ctc' else {}))
        extra = True
        if head == 'transducer':
            t_in = int(batch['seq_len'][0]) // 8 * 8
            extra = isinstance(model.stream_decode(
                [batch['stft'][0, 0, s:s + 8] for s in range(0, t_in, 8)],
                max_frames=t_in), list)
        if head == 'aed':
            extra = {k: v['hypothesis']
                     for k, v in model.serve_decode(batch).items()} == {
                k: v['hypothesis'] for k, v in greedy.items()}
        heads[head] = [t.iteration, len(greedy), len(beam),
                       evaluate.summarize(greedy)['num_examples'], extra]
print(json.dumps({
    'modules': sorted(sys.modules),
    'launches': [*lstm_cell_scan.launches.values(),
                 *flash_attention.launches.values()],
    'heads': heads}))
'''


def test_speech_recognition_paths_import_no_jax_and_launch_nothing():
    """The speech-recognition slice: one training step of each head through
    the recipe's config, greedy and beam decoding (the CTC head with an
    n-gram LM), the transducer's ``stream_decode`` and the attention
    head's ``serve_decode``, on the CPU through the kernels' plain
    versions, with no JAX module imported."""
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run(
        [sys.executable, '-c', SPEECH_RECOGNITION], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = ('jax', 'jaxlib', 'padertorch_tpu', 'tensorboardX', 'optax',
              'matplotlib', 'triton')
    assert [m for m in out['modules'] if m.split('.')[0] in banned] == []
    for name in ('ops.losses.ctc', 'ops.losses.rnnt', 'modules.conformer',
                 'evaluation.ngram_lm', 'data.database',
                 'contrib.examples.speech_recognition',
                 'contrib.examples.speech_recognition.ctc',
                 'contrib.examples.speech_recognition.ctc.data',
                 'contrib.examples.speech_recognition.ctc.model',
                 'contrib.examples.speech_recognition.ctc.train',
                 'contrib.examples.speech_recognition.ctc.evaluate'):
        assert f'padertorch_tpu_torch.{name}' in out['modules'], name
    assert out['launches'] == [0] * 12
    assert out['heads'] == {head: [1, 2, 2, 2, True]
                            for head in ('ctc', 'transducer', 'aed')}


REAL_AUDIO = r'''
import json, sys, tempfile
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(2)
from padertorch_tpu_torch import native
from padertorch_tpu_torch.contrib.cb import io as cb_io
from padertorch_tpu_torch.contrib.examples import _makefile, _wav_databases
from padertorch_tpu_torch.contrib.examples.sound_recognition.audio_tagging \
    import data as tag_data, evaluate as tag_evaluate, train as tag_train
from padertorch_tpu_torch.contrib.examples.source_localization \
    .distance_estimator import (create_jsons, data as de_data,
                                evaluate as de_evaluate, model as de_model,
                                train as de_train)
from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data as pit_data)
from padertorch_tpu_torch.contrib.je.data import transforms
from padertorch_tpu_torch.contrib.je.modules import conv
from padertorch_tpu_torch.evaluation import multilabel
from padertorch_tpu_torch.ops.kernels.gru import gru_cell_scan
from padertorch_tpu_torch.train import trainer

torch.manual_seed(0)
out = {'native': native.NATIVE_AVAILABLE}
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    db = _wav_databases.write_audioset(tmp, examples_per_split=(4, 2, 2),
                                       min_samples=3000)
    splits = tag_data.get_datasets(
        db, audio_reader={'target_sample_rate': 16000},
        stft=dict(shift=160, size=512, window_length=400, pad=True,
                  fading=None),
        batch_size=2, storage_dir=tmp / 'tag', num_workers=0,
        max_padding_rate=0.5)
    config = tag_train.get_trainer_config(
        tmp / 'tag', num_events=4,
        updates={'model': {'cnn': {'out_channels': [4, 4, 4]}},
                 'stop_trigger': (1, 'iteration')})
    t = trainer.Trainer.from_config(config)
    t.train(splits[0])
    scores = tag_evaluate.score_batch(t.model.eval(), next(iter(splits[2])))
    out['tagging'] = [t.iteration, len(scores)]
    config = de_train.get_trainer_config(
        tmp / 'de', 4, 129, updates={
            'model': {'cnn': {'out_channels': [4, 4]}, 'hidden_size': 8},
            'stop_trigger': (1, 'iteration')})
    t = trainer.Trainer.from_config(config)
    batches = de_data.prepare(de_data.synthetic_database(4, 4000),
                              batch_size=2, shuffle=False)
    t.train(batches)
    served = de_evaluate.evaluate_batch(t.model.eval(), next(iter(batches)))
    out['distance'] = [t.iteration, len(served)]
    wsj = _wav_databases.write_wsj0_2mix(tmp, (2, 1, 1), min_samples=2000)
    from padertorch_tpu_torch.data.database import JsonDatabase
    example = next(iter(JsonDatabase(wsj).get_dataset(
        'mix_2_spk_min_tr').map(pit_data.read_audio)))
    out['read_audio'] = list(example['speech_source'].shape)
    _makefile.write_recipe_makefile(tmp, 'some.train', 'some.evaluate')
    out['makefile'] = (tmp / 'Makefile').exists()
print(json.dumps({'modules': sorted(sys.modules),
                  'launches': list(gru_cell_scan.launches.values()), **out}))
'''


def test_real_audio_paths_import_no_jax_and_launch_nothing():
    """The real-audio slice: the native data prep, the transforms, a WAV
    tree through the audio tagger's pipeline, one training step and one
    served batch of the audio tagger and of the distance estimator, the
    separation recipes' ``read_audio`` and a recipe Makefile, on the CPU
    with no JAX module imported and no kernel launched."""
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run(
        [sys.executable, '-c', REAL_AUDIO], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = ('jax', 'jaxlib', 'padertorch_tpu', 'tensorboardX', 'optax',
              'matplotlib', 'triton')
    assert [m for m in out['modules'] if m.split('.')[0] in banned] == []
    for name in ('native.dataprep', 'contrib.je.data.transforms',
                 'contrib.je.modules.conv', 'evaluation.multilabel',
                 'contrib.cb.io', 'contrib.examples._makefile',
                 'contrib.examples._wav_databases',
                 'contrib.examples.sound_recognition.audio_tagging.data',
                 'contrib.examples.source_localization.distance_estimator'
                 '.model',
                 'contrib.examples.source_localization.distance_estimator'
                 '.create_jsons'):
        assert f'padertorch_tpu_torch.{name}' in out['modules'], name
    assert out['native'] is True
    assert out['launches'] == [0] * len(out['launches'])
    assert out['tagging'] == [1, 2] and out['distance'] == [1, 2]
    assert out['read_audio'][0] == 2 and out['makefile']


SERVING = r'''
import json, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
from padertorch_tpu_torch import lora, serve
from padertorch_tpu_torch.ops import streaming
import padertorch_tpu_torch.ops.kernels
from padertorch_tpu_torch.ops.kernels import _build
from padertorch_tpu_torch.ops.kernels.lstm import lstm_cell_scan
from padertorch_tpu_torch.ops.kernels.masked_istft import masked_istft
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.modules.recurrent import StatefulLSTM

names = ('lstm_cell_scan', 'gru_cell_scan', 'flash_attention',
         'fused_logmel', 'masked_istft', 'int8_matmul')
has = torch._C._dispatch_has_kernel_for_dispatch_key
registered = {name: [has(f'ptt::{name}', key) for key in ('CPU', 'CUDA')]
              for name in names}
torch.manual_seed(0)
model = PermutationInvariantTrainingModel(
    F=9, recurrent_layers=1, units=8, K=2).eval()
lora.apply_lora(model, rank=2, targets=('linear1',))
lora.merge_lora(model)
with tempfile.TemporaryDirectory() as tmp:
    serve.dump_exported(model, {'Y_abs': np.ones((2, 5, 9), 'float32')},
                        tmp, dynamic_axes={'Y_abs': {0: 'b', 1: 't'}})
    served = serve.load_exported(tmp, device='cpu')(
        {'Y_abs': np.ones((3, 7, 9), 'float32')})
stft = streaming.STFT(32, 8, complex_representation='stacked')
analysis = streaming.StreamingSTFT(stft)
state = analysis.init_state((1,))
rnn = StatefulLSTM(17, 4)
with torch.no_grad():
    for start in range(0, 64, 16):
        state, frames = analysis.step(state, torch.ones(1, 16))
        rnn(frames[..., 0])
print(json.dumps({
    'modules': sorted(sys.modules), 'registered': registered,
    'served': list(served.shape), 'states': list(rnn.states[0].shape),
    'built': _build.load_library.cache_info().misses,
    'launches': [*lstm_cell_scan.launches.values(),
                 masked_istft.launches]}))
'''


def test_serving_paths_import_no_jax_and_build_nothing():
    """``serve``, ``lora``, ``ops/streaming`` and the operator
    registrations import without JAX; importing them registers the six
    ``ptt`` operators (a CPU and a CUDA kernel each) without building
    anything, and an exported, dumped and loaded separator with a merged
    adapter and a streamed ``StatefulLSTM`` run on the CPU launch
    nothing."""
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '2'}
    proc = subprocess.run([sys.executable, '-c', SERVING], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = ('jax', 'jaxlib', 'padertorch_tpu', 'tensorboardX', 'optax',
              'matplotlib', 'triton')
    assert [m for m in out['modules'] if m.split('.')[0] in banned] == []
    for name in ('serve', 'lora', 'ops.streaming', 'ops.kernels._ops'):
        assert f'padertorch_tpu_torch.{name}' in out['modules'], name
    assert out['registered'] == {name: [True, True] for name in (
        'lstm_cell_scan', 'gru_cell_scan', 'flash_attention',
        'fused_logmel', 'masked_istft', 'int8_matmul')}
    assert out['served'] == [3, 7, 2, 9] and out['states'] == [1, 1, 4]
    assert out['built'] == 0
    assert out['launches'] == [0] * len(out['launches'])
