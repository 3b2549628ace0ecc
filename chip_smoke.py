"""Drive the PyTorch port's paths once on one CUDA card: uPIT, DPRNN-TasNet
and SepFormer-TasNet separation, the WaveNet vocoder and the speaker
classifier with its on-device log-mel front end, each served and trained;
and the transformer decoder's int8 KV-cache decoding and continuous
batching, served.

    python3 chip_smoke.py [--profile]

Phases, one line each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is off for matmuls and convolutions (the package turns
   it off where it is imported).
2. build: the hand-written kernels built from ``padertorch_tpu_torch/csrc``
   (one nvcc per source, started together).
3. lstm_cell_scan kernel vs its plain version at the flagship shape
   (T=500, D*B=32 with ragged lengths in [250, 500], H=600, f32), and a
   control: the plain version with TF32 matmuls must fail the limit.  Also
   the yardsticks: one bidirectional ``torch.nn.LSTM`` layer (cuDNN) and
   the input projection alone at that shape.
4. masked_istft kernel vs its plain version at (K=2, T=127, F=257) and
   (B*K=32, T=500, F=257).
5. slice: the full-width uPIT model (F=257, 3x600 BLSTM, K=2) from seed 0
   on the card against the same model on the CPU; then the recipe's
   ``evaluate_example`` on the 8 mixtures of
   ``synthetic_database(num_examples=8, seed=2)`` as 8 requests, with the
   kernels' launch counts read around them; then one batched forward at
   B=16, T=500.
6. training kernels vs plain at the flagship shape: outputs and residuals
   of the training forward, ``dgates_x``/``dh0``/``dc0`` of the backward
   on the same residuals and random cotangents, and the whole
   ``autograd.Function`` (with ``dW_hh``) against autograd through the
   plain forward; a TF32 control must fail each limit.
7. the training path: the recipe's ``get_trainer_config`` at full width
   into a temporary storage dir, ``test_run``, then ``Trainer.train`` for
   3 epochs of 8 batches of 4 synthetic mixtures with a validation hook
   and checkpoints, the kernels' launch counts read around it; the first
   step's loss and gradient norm against the same step on the CPU; the
   storage dir loaded back and one request served from it; then one timed
   training step at the recipe's shape and at B=16, T=500, by stage.

8. gru_cell_scan kernels (lean forward, training forward, backward, and
   the ``autograd.Function``) vs their plain versions at the DPRNN's two
   shapes (T=100, D*B=520, H=128 without mask; T=65, D*B=800, H=128 with
   the chunk-length mask of a ragged batch) and at (T=500, D*B=32, H=600,
   ragged), and at the speaker classifier's two (one direction under a
   ragged frame mask: T=66, 8 rows, H=64 in the recipe's run; T=503, 16
   rows, H=256 at the class defaults), each with the TF32 control that must
   fail the limit, and one ``torch.nn.GRU`` layer (cuDNN) of the same sizes
   and directions as a yardstick.
9. the three LSTM kernels vs plain at the DPRNN's two shapes, timed, each
   with its TF32 control, the backward with the grid it took (unit slice,
   row ranges, rows per range, rows staged at once, K slices, blocks),
   beside one bidirectional ``torch.nn.LSTM`` layer (cuDNN) of the same
   sizes.
10. TasNet serving, for ``bgru`` and ``blstm`` chunk RNNs: the full-width
    model (256 filters of length 20, 64 -> 6 blocks of 128 units, K=100,
    hop 50, 2 speakers) on the card against the same model on the CPU;
    then the tasnet recipe's ``evaluate_example`` on the 8 mixtures as 8
    requests, with launch counts.
11. TasNet training, for ``bgru`` and ``blstm``: the tasnet recipe's
    ``get_trainer_config`` at full width, ``test_run``, a short
    ``Trainer.train`` with validation and checkpoints, launch counts; the
    first step against the CPU; every trained parameter's gradient finite
    and nonzero; the storage dir loaded back and one request served; then
    a timed step at B=4 x 32000 samples and at B=4 x 16000, by stage.

12. flash attention kernels (forward with and without the log-sum-exp,
    backward through the ``autograd.Function``) vs the plain masked-softmax
    version at the SepFormer's two shapes ((B*S, H, K, D) = (264, 8, 100,
    16) without padding and (B*K, H, S, D) = (400, 8, 66, 16) with ragged
    key lengths, one of 1 and one of 0), at (8, 12, 2048, 64) full, causal,
    windowed and causal with key padding, grouped-query (4, 8 over 2,
    1024, 64), Tq != Tk and a head size outside the template set; each
    timed beside the plain version, ``F.scaled_dot_product_attention``
    (float32, TF32 off) and its bound, with the kernel's share of it (the
    backward as the median of five windows after a warm-up, with the
    allocator's cache emptied); at each timed shape autograd through the
    plain version with TF32 products (on operands rounded to TF32) must
    fail the gradients' limit, which the kernels' 3xTF32 tensor-core
    products meet.  Then the dispatch table: one ``MultiheadAttention``
    forward and forward + backward on the fused and on the dense backend
    at (8, T, 12 x 64) for T = 512 ... 4096, full, causal and windowed,
    and at the SepFormer's two shapes; the table is printed beside what
    ``should_use_flash`` picks.
13. SepFormer-TasNet serving: the tasnet recipe's ``sepformer`` variant at
    full width (256 filters of length 20, 128 features, 4 blocks of 2 + 2
    transformer layers, 8 heads, K=100, hop 50) trained for 4 iterations
    into a storage dir, loaded back, the fused backend forced as the
    recipe's ``--flash`` does; the model on the card against the CPU; the
    8 mixtures as 8 requests with launch counts.
14. SepFormer-TasNet training: ``get_trainer_config(variant='sepformer')``
    at full width, the fused backend forced, ``test_run``, 16 iterations
    with validation and checkpoints, launch counts; the first step against
    the CPU; timed steps at B=4 x 32000 and B=4 x 16000 samples on the
    fused and on the dense backend.

15. wavenet_sample kernel vs its plain step loop at full width (16 layers,
    dilations 1 ... 128 twice, R=64, S=256, O=256; weights of the recipe's
    model from seed 0) at the shape of a parallel request of 1 s (5 chunks
    of 4200 steps as 5 rows): teacher-forced logits within the limit, with
    the TF32 control failing it; greedy and Gumbel-max indices under
    teacher forcing equal to the choice from the kernel's own logits and
    the plain version's draws, and equal to the plain version's but where
    its two best scores are closer than twice the limit; the free-running
    greedy loop equal to the plain one over 1000 steps of 2 rows; the
    sampled indices' log-likelihood against the softmax's entropy; one
    sampling row of 16000 steps (a sequential request) against the plain
    loop's sampling on its first 500; timed per step at 1, 5, 132 and 264
    rows.
16. fused_logmel kernel vs its plain version at (16, 64000) 512/128/64,
    at the classifier recipe's (8, 8000) 512/128/64, at the wavenet
    recipe's (2, 16000) 1024/200 with window 800 and at
    (3, 12345) 512/160 with window 400 (a hop that does not divide the
    window), with the TF32 control; timed beside the plain version and the
    composed module path (``STFT`` -> power -> filterbank -> log).
17. WaveNet serving: the recipe's full-width vocoder trained 4 iterations
    into a storage dir on the card, loaded back; teacher-forced logits of
    the card against the CPU, and the kernel's teacher-forced logits
    against the training graph's; greedy synthesis of 1000 samples on the
    card against the CPU's step loop; then the recipe's
    ``synthesize_example`` on utterances of 1 s as requests: 2 as one
    chunk, 1 in 5 sequential chunks, 4 with ``parallel`` chunks, launch
    counts read around them.
18. WaveNet training: the recipe's ``get_trainer_config`` at full width,
    ``test_run``, 8 iterations at 2 x 16000 samples with validation and
    checkpoints, the first step against the CPU, a timed step by stage.
19. speaker classifier with ``--on_device_features``: the recipe's own run
    (8 synthetic speakers, (16, 32) CNN channels, 64 GRU units, batches of
    8 x 8000 samples) with launch counts of fused_logmel and the GRU
    kernels, the first step against the CPU, the accuracy above chance;
    the storage dir loaded back and its dev batches served through
    ``evaluate_batch``, card against CPU; then a timed forward and
    training step at the class defaults (251 speakers, (32, 64) channels,
    256 GRU units) on 16 x 4 s of audio.

20. int8_matmul kernel vs its plain version (float32 within 1e-5 of the
    largest output, bf16 within one unit in the last place plus that)
    with and without bias, at M = 1, 8, 16, 32, 64, 128, 256 and the
    decoder's weights (1024, 1024), (1024, 4096), (4096, 1024), and at a
    ragged (1000, 1030); the composed route (``x @ (w_q * scale)`` in bf16)
    must fail the bf16 limit and plain with TF32 products the float32 one;
    timed beside plain, the composed route, ``torch.addmm`` on the weight
    dequantized to the activations' type and the bound (bf16 against the
    tensor cores' bf16 peak, float32 against the float32 peak), with the
    host's microseconds to enqueue one call; the contract's raises; in bf16
    every row of a batch of up to 256 equal to the row alone, bit for bit,
    and repeated calls and CUDA-graph replays equal; then the kernel and
    the composed route of ``QuantizedLinear`` by rows of x from 1 to 256
    (``INT8_KERNEL_MAX_ROWS`` comes from this table).
21. decoding at full width: bench.py's int8 decode model (TransformerDecoder
    d_model 1024, 12 layers, 16 heads, RoPE, pre-norm; a Linear(1024, 1024)
    head; weights from seed 0, the embedding table x 0.05 and 128 frames
    of memory from numpy seed 0): teacher-forced decode_step logits
    against one forward in float32 (which launches flash_attention); the
    int8 kernel route against the composed route on bf16 forward logits;
    ``autoregressive_generate`` of 128 greedy tokens at B=1 with the
    kernel's launches counted (12,440: 97 per token and 24 for the cross
    K/V), then us per token for float32, bf16, bf16 int8 composed and
    bf16 int8 kernel (best of 3 after a warm-up, host clock).
22. serving: a ``ContinuousBatcher`` of 8 slots on the bf16 int8 kernel
    decoder takes 16 requests (memory of 32 to 128 frames, 16 to 64 new
    tokens); requests per second, tokens per second, us per step, the
    kernel's launches; each request's tokens equal that request decoded
    alone, but at near ties of its logits.

The line before the last is a JSON object with each kernel's launches on
the main paths, the shape its numbers were taken at (``shape``; the other
shapes' are in the phases' own lines), its largest difference from the
plain version, its time,
the plain version's, the library call's where there is one, and the
least time the card could take (``bound_ms``: the larger of bytes over
3.35 TB/s and float32 operations over 67 TFLOP/s, or for int8_matmul's
bf16 products 989 TFLOP/s, NVIDIA's H100 SXM data sheet); the last line
is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero and prints no result; without
a CUDA card it fails at phase 1.  ``--profile`` adds a ``torch.profiler``
table of one training step per shape, and the card's busy time per token
of the B=1 decode (phase 21).
"""
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet import (
    data as wn_data, evaluate as wn_evaluate, train as wn_train)
from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet.model \
    import WaveNetVocoder
from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data as pit_data, train as pit_train)
from padertorch_tpu_torch.contrib.examples.source_separation.pit.evaluate \
    import evaluate_example
from padertorch_tpu_torch.contrib.examples.source_separation.tasnet import (
    data as tas_data, evaluate as tas_evaluate, train as tas_train)
from padertorch_tpu_torch.contrib.examples.speaker_classification \
    .supervised import (
        data as spk_data, evaluate as spk_evaluate, train as spk_train)
from padertorch_tpu_torch.contrib.examples.speaker_classification \
    .supervised.model import SpeakerClf
from padertorch_tpu_torch.contrib.je.modules.features import (
    FusedAudioLogMelExtractor)
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    MultiheadAttention, set_attention_backend)
from padertorch_tpu_torch.models.tasnet import TasNet
from padertorch_tpu_torch.modules.dual_path_transformer import (
    DualPathTransformer)
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.ops._stft import HostSTFT, STFT
from padertorch_tpu_torch.io import dump_config
from padertorch_tpu_torch.ops.kernels import _build
from padertorch_tpu_torch.ops.kernels import attention as attention_kernels
from padertorch_tpu_torch.ops.kernels import gru as gru_kernels
from padertorch_tpu_torch.ops.kernels import lstm as lstm_kernels
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_fwd_plain, flash_attention_plain,
    should_use_flash, tf32_round, visible_mask)
from padertorch_tpu_torch.ops.kernels.gru import (
    gru_cell_scan, gru_cell_scan_plain, gru_cell_scan_train_plain,
    gru_cell_scan_bwd_plain)
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_plain, lstm_cell_scan_train_plain,
    lstm_cell_scan_bwd_plain, recurrent_weight_grad)
from padertorch_tpu_torch.utils.nested import nested_merge
from padertorch_tpu_torch.ops.kernels.logmel import (
    LogMelFrontend, fused_logmel)
from padertorch_tpu_torch.ops.kernels.masked_istft import (
    masked_istft, masked_istft_plain)
from padertorch_tpu_torch.ops.kernels.wavenet import (
    _gumbel, wavenet_sample, wavenet_sample_plain, wavenet_uniform)
from padertorch_tpu_torch.train.hooks import Hook, ValidationHook
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    TransformerDecoder, autoregressive_generate)
from padertorch_tpu_torch.ops.kernels import int8_matmul as int8_kernels
from padertorch_tpu_torch.ops.kernels.int8_matmul import (
    int8_matmul, int8_matmul_plain)
from padertorch_tpu_torch.quantize import QuantizedLinear, quantize_module
from padertorch_tpu_torch.serve import ContinuousBatcher

# f32 sums in another order over 500 recurrent steps; about 20x the
# difference the card shows, and far below what a TF32 recurrent product
# gives (phase 3 measures that control and requires it to fail the limit)
LSTM_TOL = 1e-5
ISTFT_TOL = 1e-4   # f32 sums of 2 * 257 * 4 products per sample
MODEL_TOL = 1e-6   # masks after 3 BLSTM layers of 500 steps, card vs CPU
SI_SDR_TOL = 1e-2  # dB, card vs CPU on the same request
# backward kernel vs its plain version on the same residuals: the same f32
# arithmetic, the 4H-long sum in another order, carried over 500 steps;
# about 20x what the card shows, and a TF32 product fails it (phase 6)
LSTM_BWD_TOL = 1e-5
# the whole Function vs autograd through the plain forward, relative to
# each gradient's largest entry (dW_hh sums 16,000 products per entry):
# about 20x what the card shows; autograd through a TF32 forward fails it
LSTM_GRAD_RTOL = 5e-5
# first step's loss and gradient norm, card vs CPU, relative: f32 sums in
# another order (the card shows the same float32 values as the CPU)
STEP_RTOL = 1e-5

# GRU kernels: the LSTM kernels' limits (the same arithmetic with three
# gates), each with its TF32 control (phase 8)
GRU_TOL = 1e-5
GRU_BWD_TOL = 1e-5
GRU_GRAD_RTOL = 5e-5
# full-width TasNet `out` (separated signals of amplitude about 1 after
# twelve recurrences, layer norms and the decoder), card vs CPU
TASNET_TOL = 1e-4
# first TasNet step, card vs CPU: the loss is a mean of log10 ratios, the
# norm sums 2.6 M gradients through twelve recurrences' adjoints
TASNET_STEP_RTOL = 1e-4

# attention kernels vs the plain masked softmax: the same f32 arithmetic,
# the sum over keys in tiles of 64 with a running maximum (about 10x what
# the card shows); gradients relative to each gradient's largest entry, as
# the recurrences' Functions
ATTENTION_TOL = 1e-5
ATTENTION_GRAD_RTOL = 5e-5
# first SepFormer step, card vs CPU, relative
SEPFORMER_LOSS_RTOL = 1e-5
SEPFORMER_NORM_RTOL = 1e-4

# wavenet_sample vs its plain step loop, teacher-forced logits (of size
# about 7): the same f32 arithmetic, each product's sum in another order,
# through 16 gated layers; the JAX package's own limit for its kernel, about
# 6x what the card shows; the plain loop with TF32 products fails it
WAVENET_TOL = 2e-5
# full-width vocoder logits, card vs CPU, and sampler vs training graph
WAVENET_MODEL_TOL = 1e-4
# fused_logmel vs its plain version, on log-mel values between about -10
# and 10: f32 sums of 2 * 512 * 257 products in another order, about 10x
# what the card shows; the plain version with TF32 products fails it
LOGMEL_TOL = 1e-5
# the composed module path frames and multiplies in other code
LOGMEL_COMPOSED_TOL = 1e-4
# first training steps, card vs CPU, relative (loss, gradient norm)
WAVENET_STEP_RTOL = (1e-5, 1e-4)
SPEAKER_STEP_RTOL = (1e-5, 1e-4)
# speaker classifier logits, card vs CPU
SPEAKER_TOL = 1e-4
# int8_matmul vs its plain version: float32 sums of K products in another
# order, relative to the output's largest value; in bf16 both round one
# float32 sum, so one bf16 unit in the last place plus that float32 limit
# (the composed route, which rounds every scaled weight to bf16 first,
# must fail it)
INT8_TOL = 1e-5
INT8_BF16_ULPS = 1.0
# the B=1 decode of phase 21: teacher-forced decode_step logits against
# TransformerDecoder.forward (float32, relative to the largest logit), and
# the int8 kernel route against the composed route on bf16 forward logits
# (|diff| / (1 + |composed|), bench.py's limit: the two round differently)
DECODE_RTOL = 1e-4
INT8_ROUTES_RTOL = 0.05
# phase 22: batched against single decoding of a request, bf16 logits
# relative to the largest logit (attention sums over caches of another
# length); tokens may differ only where the two best logits are closer
SERVE_LOGIT_RTOL = 0.02

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM, float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM, bf16 on the tensor cores, dense
PEAK_TF32_FLOPS = 495e12     # H100 SXM, TF32 on the tensor cores, dense
# float32 products as three TF32 products each (hi*hi + hi*lo + lo*hi)
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_NAMES = {PEAK_F32_FLOPS: 'float32', PEAK_BF16_FLOPS: 'bf16 tensor cores',
              PEAK_3XTF32_FLOPS: '3xTF32 tensor cores'}


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, iters, warmup=1):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_median(fn, iters, windows=5, warmup=3):
    """Median of ``windows`` runs of :func:`cuda_ms` after a warm-up, and
    the window means themselves."""
    for _ in range(warmup):
        fn()
    means = sorted(cuda_ms(fn, iters, warmup=0) for _ in range(windows))
    return means[len(means) // 2], means


def graph_ms(fn, iters=50):
    """Mean milliseconds of ``fn`` on the card with no host work between
    calls: ``iters`` calls captured in one CUDA graph, replayed and timed
    by CUDA events.  For calls whose eager time is the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def max_rel_err(a, b):
    """Largest difference relative to each reference's largest entry."""
    return max(float((x - y).abs().max() / y.abs().max())
               for x, y in zip(a, b))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, flops, peak=PEAK_F32_FLOPS):
    """The least time the card could take for the work: each input read
    and each output written once at the memory's peak rate, or the
    operations at ``peak`` (the float32 peak unless the products run on
    the tensor cores), whichever is larger; ``peak`` names that rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return {'bound_ms': max(by_bytes, by_ops),
            'bound_by': 'bytes' if by_bytes >= by_ops else 'operations',
            'peak': PEAK_NAMES[peak]}


def lstm_flops(mask, hdim):
    """Operations the recurrence needs on these inputs: per valid (step,
    row) one (1, H) x (H, 4H) product (2 per multiply-add) and about 30
    for the cell; masked steps need none."""
    return float(mask.sum()) * (2 * hdim * 4 * hdim + 30 * hdim)


def gru_flops(valid_steps, hdim):
    """As ``lstm_flops`` with three gates: per valid (step, row) one
    (1, H) x (H, 3H) product and about 25 for the cell.  The backward
    kernel holds one product of the same size (``dgh @ W_hh^T``; ``dW_hh``
    is a product outside it)."""
    return float(valid_steps) * (2 * hdim * 3 * hdim + 25 * hdim)


def phase_device():
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    # float32 is the package's decision, made where it is imported
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail('importing padertorch_tpu_torch left TF32 on')
    print(f'phase 1 device: {torch.cuda.get_device_name(0)} x'
          f'{torch.cuda.device_count()}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, python {sys.version.split()[0]}')


def phase_build():
    start = time.perf_counter()
    _build.load_library()
    print(f'phase 2 build: kernels loaded in '
          f'{time.perf_counter() - start:.2f} s')


# the DPRNN's two recurrence shapes at B=4 x 32000 samples (3199 encoder
# frames, 65 chunks of 100 with hop 50), and the uPIT flagship's:
# (label, T, rows per direction, H, mask kind)
RECURRENCE_SHAPES = [
    ('intra T=100 D*B=520 H=128', 100, 260, 128, None),
    ('inter T=65 D*B=800 H=128', 65, 400, 128, 'chunks'),
    ('T=500 D*B=32 H=600', 500, 16, 600, 'ragged'),
]


# the speaker classifier's GRU: one direction, under the frame mask of a
# ragged batch; the recipe's run (8 x 8000 samples: 66 frames, 32 channels x
# 16 mel bands into 64 units) and the class defaults on 16 x 4 s (503
# frames, 64 x 16 into 256 units):
# (label, T, rows, H, mask kind, width of the layer's input)
CLASSIFIER_GRU_SHAPES = [
    ('classifier recipe T=66 D*B=8 H=64 one direction', 66, 8, 64, 'ragged',
     512),
    ('classifier defaults T=503 D*B=16 H=256 one direction', 503, 16, 256,
     'ragged', 1024),
]


def recurrence_mask(t_len, batch, kind, rng, directions=2):
    """(T, directions * batch) mask, the second direction's reversed in
    time, or None.  'chunks': the
    inter-chunk RNN's, every one of the K=100 positions of an example
    sharing its chunk count (4 examples of 2 to 4 s); 'ragged': lengths in
    [T/2, T]."""
    if kind is None:
        return None
    if kind == 'chunks':
        lens = np.repeat([t_len, t_len - 11, t_len - 20, t_len - 30],
                         batch // 4)
    else:
        lens = rng.randint(t_len // 2, t_len + 1, size=batch)
        lens[0] = t_len
    fwd = np.arange(t_len)[:, None] < lens[None, :]
    return np.concatenate([fwd, fwd[::-1]][:directions], axis=1).astype(
        'float32')


def recurrence_inputs(t_len, batch, hdim, kind, gates, seed=0, directions=2):
    """Kernel inputs and cotangents of a layer of ``directions`` directions
    with ``gates`` gate blocks (3: GRU, 4: LSTM)."""
    rng = np.random.RandomState(seed)
    bound = 1 / np.sqrt(hdim)
    mask = recurrence_mask(t_len, batch, kind, rng, directions)
    rows = directions * batch
    arrays = [rng.uniform(-1, 1, (t_len, rows, gates * hdim)),
              rng.uniform(-bound, bound, (directions, hdim, gates * hdim)),
              mask]
    arrays += [rng.uniform(-0.1, 0.1, (rows, hdim))
               for _ in range(gates - 2)]                  # h0 (, c0)
    cot = [rng.uniform(-1, 1, (t_len, rows, hdim))]
    cot += [rng.uniform(-1, 1, (rows, hdim)) for _ in range(gates - 2)]

    def put(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, 'float32')).cuda()

    return [put(a) for a in arrays], [put(a) for a in cot]


def phase_lstm():
    args, _ = recurrence_inputs(500, 16, 600, 'ragged', gates=4)
    got = lstm_cell_scan(*args)
    want = lstm_cell_scan_plain(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_err = max_err(lstm_cell_scan_plain(*args), want)
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = cuda_ms(lambda: lstm_cell_scan(*args), iters=20)
    plain_ms = cuda_ms(lambda: lstm_cell_scan_plain(*args), iters=3)
    library = cudnn_lstm_ms()
    gx, w, mask, h0, c0 = args
    limit = bound(nbytes(*args, *got), lstm_flops(mask, 600))
    print(f'phase 3 lstm_cell_scan T=500 D*B=32 H=600: max |kernel - plain| '
          f'{err:.3e} (tol {LSTM_TOL}), plain with TF32 vs f32 '
          f'{tf32_err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
          f'bound {limit["bound_ms"]:.3f} ms by {limit["bound_by"]}')
    print(f'phase 3 yardsticks at T=500 B=16 in=1200 H=600 f32: one '
          f'bidirectional torch.nn.LSTM layer (cuDNN; includes the input '
          f'projection, takes no mask) forward {library["fwd"]:.3f} ms '
          f'(no grad), {library["fwd_train"]:.3f} ms (grad mode), backward '
          f'{library["bwd"]:.3f} ms; the einsum input projection alone '
          f'{library["projection"]:.3f} ms')
    if not err <= LSTM_TOL:
        fail(f'lstm_cell_scan kernel disagrees with plain: {err}')
    if not tf32_err > LSTM_TOL:
        fail(f'the limit {LSTM_TOL} does not tell a TF32 recurrence from '
             f'f32: {tf32_err}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, **limit,
            'library_ms': library['fwd']}, library


def cudnn_layer_ms(layer_cls, t_len, batch, in_size, hdim, directions=2):
    """Yardstick, timed here and used nowhere in the port: one
    ``torch.nn.LSTM`` or ``torch.nn.GRU`` layer of ``directions`` directions
    (cuDNN; it includes the input projection and takes no mask), forward
    without and with grad mode, and backward."""
    torch.manual_seed(0)
    layer = layer_cls(in_size, hdim, bidirectional=directions == 2).cuda()
    x = torch.randn(t_len, batch, in_size, device='cuda')
    with torch.no_grad():
        fwd = cuda_ms(lambda: layer(x), iters=10, warmup=2)
    fwd_train = cuda_ms(lambda: layer(x), iters=10, warmup=2)
    out, _ = layer(x)
    d_out = torch.randn_like(out)
    bwd = cuda_ms(
        lambda: torch.autograd.grad(out, list(layer.parameters()), d_out,
                                    retain_graph=True), iters=10, warmup=2)
    return {'fwd': fwd, 'fwd_train': fwd_train, 'bwd': bwd}


def cudnn_lstm_ms(t_len=500, batch=16, in_size=1200, hdim=600):
    """The cuDNN yardstick at the flagship layer's shape, and the port's
    input projection (one einsum) alone."""
    times = cudnn_layer_ms(torch.nn.LSTM, t_len, batch, in_size, hdim)
    x = torch.randn(t_len, batch, in_size, device='cuda')
    x_pair = torch.stack([x, x.flip(0)])
    w_ih = torch.randn(2, 4 * hdim, in_size, device='cuda')
    times['projection'] = cuda_ms(
        lambda: torch.einsum('dtbf,dgf->tdbg', x_pair, w_ih), iters=10,
        warmup=2)
    return times


def istft_inputs(n_rows, frames, seed=0):
    rng = np.random.RandomState(seed)
    spec = rng.randn(frames, 257, 2).astype('float32') * 10
    mask = rng.uniform(0, 1, (n_rows, frames, 257)).astype('float32')
    return (torch.from_numpy(spec).cuda(), torch.from_numpy(mask).cuda())


def phase_istft():
    stft = STFT(pit_data.STFT_SIZE, pit_data.STFT_SHIFT, fading='full',
                complex_representation='stacked')
    results = {}
    for n_rows, frames in ((2, 127), (32, 500)):
        spec, mask = istft_inputs(n_rows, frames)
        got = masked_istft(spec, mask, stft=stft)
        want = masked_istft_plain(spec, mask, stft=stft)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f'masked_istft shape {tuple(got.shape)} != '
                 f'{tuple(want.shape)}')
        err = max_err([got], [want])
        ms = cuda_ms(lambda: masked_istft(spec, mask, stft=stft), iters=20)
        plain_ms = cuda_ms(
            lambda: masked_istft_plain(spec, mask, stft=stft), iters=20)
        # per row and frame 2 * F * size multiply-adds (two synthesis
        # matrices of (F, size), themselves an input of F * size * 2)
        size, n_bins = pit_data.STFT_SIZE, 257
        limit = bound(
            nbytes(spec, mask, got) + n_bins * size * 2 * 4,
            n_rows * frames * 2 * 2 * n_bins * size)
        print(f'phase 4 masked_istft ({n_rows}, {frames}, 257): max '
              f'|kernel - plain| {err:.3e} (tol {ISTFT_TOL}), kernel '
              f'{ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
              f'{limit["bound_ms"]:.4f} ms by {limit["bound_by"]}')
        if not err <= ISTFT_TOL:
            fail(f'masked_istft kernel disagrees with plain: {err}')
        results[(n_rows, frames)] = {
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, **limit,
            'library_ms': None}
    return results


def ragged_batch(batch, frames, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(frames // 2, frames + 1, size=batch)
    lens[0] = frames
    y = np.abs(rng.randn(batch, frames, 257)).astype('float32')
    y *= (np.arange(frames)[None, :, None] < lens[:, None, None])
    return {'Y_abs': torch.from_numpy(y),
            'num_frames': torch.from_numpy(lens.astype('int64'))}


def reset_launches():
    for wrapper in (lstm_cell_scan, gru_cell_scan, flash_attention):
        for name in wrapper.launches:
            wrapper.launches[name] = 0
    masked_istft.launches = 0
    wavenet_sample.launches = 0
    fused_logmel.launches = 0
    int8_matmul.launches = 0


def phase_slice():
    torch.manual_seed(0)
    model_cpu = PermutationInvariantTrainingModel(
        F=257, recurrent_layers=3, units=600, K=2).eval()
    model = copy.deepcopy(model_cpu).to('cuda')

    batch = ragged_batch(4, 500)
    with torch.no_grad():
        want = model_cpu(batch)
        got = model({k: v.cuda() for k, v in batch.items()}).cpu()
    err = float((got - want).abs().max())
    print(f'phase 5a full-width model B=4 T=500, card vs CPU: max |diff| '
          f'{err:.3e} (tol {MODEL_TOL})')
    if not err <= MODEL_TOL:
        fail(f'model masks on the card disagree with the CPU: {err}')

    stft = HostSTFT(pit_data.STFT_SIZE, pit_data.STFT_SHIFT, fading='full',
                    complex_representation='complex')
    examples = list(pit_data.synthetic_database(num_examples=8, seed=2))
    reset_launches()
    latencies, results = [], {}
    for example in examples:
        start = time.perf_counter()
        example_id, metrics = evaluate_example(model, stft, example)
        latencies.append((time.perf_counter() - start) * 1e3)
        results[example_id] = metrics
    launches = {'lstm_cell_scan': lstm_cell_scan.launches['fwd'],
                'masked_istft': masked_istft.launches}
    print(f'phase 5b served {len(results)} requests, latency ms '
          f'{[round(x, 3) for x in latencies]} (median '
          f'{np.median(latencies):.3f}), launches {launches}')
    if len(results) != 8:
        fail(f'{len(results)} of 8 requests served')
    for name, n in launches.items():
        if n == 0:
            fail(f'the main path never launched the {name} kernel')
    for example_id, metrics in results.items():
        values = np.asarray(metrics['output_si_sdr']
                            + metrics['output_mir_eval_sxr_sdr'])
        if values.shape != (4,) or not np.isfinite(values).all():
            fail(f'{example_id}: bad output metrics {metrics}')
    for example in examples[:2]:
        _, ref = evaluate_example(model_cpu, stft, example)
        diff = np.abs(np.subtract(
            ref['output_si_sdr'],
            results[example['example_id']]['output_si_sdr'])).max()
        print(f'phase 5c {example["example_id"]} SI-SDR card vs CPU: max '
              f'|diff| {diff:.3e} dB (tol {SI_SDR_TOL})')
        if not diff <= SI_SDR_TOL:
            fail(f'SI-SDR on the card disagrees with the CPU: {diff}')

    big = {k: v.cuda() for k, v in ragged_batch(16, 500, seed=1).items()}
    with torch.no_grad():
        ms = cuda_ms(lambda: model(big), iters=10, warmup=2)
    print(f'phase 5d batched forward B=16 T=500: {ms:.3f} ms')
    return launches


def phase_train_kernels(library):
    """Phase 6: the two training kernels and the Function around them."""
    args, _ = recurrence_inputs(500, 16, 600, 'ragged', gates=4)
    gx, w, mask, h0, c0 = args
    rng = np.random.RandomState(1)
    cot = [torch.from_numpy(rng.uniform(-1, 1, shape).astype('float32'))
           .cuda() for shape in ((500, 32, 600), (32, 600), (32, 600))]

    def fwd_train():
        return lstm_kernels._launch(gx, w, 2, mask, h0, c0, train=True)

    got = fwd_train()
    want = lstm_cell_scan_train_plain(*args)
    torch.cuda.synchronize()
    err_fwd = max_err(got, want)           # out, c_seq, gates, h_T, c_T
    out, c_seq, gates, _, _ = want

    def bwd():
        return lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask, *cot)

    got_bwd = bwd()
    want_bwd = lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot)
    torch.cuda.synchronize()
    err_bwd = max_err(got_bwd, want_bwd)   # dgates_x, dh0, dc0
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_fwd = max_err(lstm_cell_scan_train_plain(*args), want)
    tf32_bwd = max_err(
        lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot), want_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0, c0)]
        outs = fn(leaves[0], leaves[1], mask, leaves[2], leaves[3])
        if any(o.grad_fn is None for o in outs):
            fail('lstm_cell_scan under grad mode returned a tensor '
                 'without grad_fn')
        return torch.autograd.grad(outs, leaves, cot)

    got_grads = grads(lstm_cell_scan)      # dgates_x, dW_hh, dh0, dc0
    want_grads = grads(lstm_cell_scan_plain)
    torch.cuda.synchronize()
    err_fn = max_rel_err(got_grads, want_grads)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_fn = max_rel_err(grads(lstm_cell_scan_plain), want_grads)
    torch.backends.cuda.matmul.allow_tf32 = False

    times = {
        'fwd_train': cuda_ms(fwd_train, iters=20),
        'fwd_train_plain': cuda_ms(
            lambda: lstm_cell_scan_train_plain(*args), iters=3),
        'bwd': cuda_ms(bwd, iters=20),
        'bwd_plain': cuda_ms(
            lambda: lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot),
            iters=3),
        'dw': cuda_ms(
            lambda: recurrent_weight_grad(got_bwd[0], out, h0, mask, 2),
            iters=20),
    }
    flops = lstm_flops(mask, 600)
    limit_fwd = bound(nbytes(*args, *got), flops)
    limit_bwd = bound(nbytes(gates, c_seq, w, mask, *cot, *got_bwd), flops)
    print(f'phase 6 training forward T=500 D*B=32 H=600: max |kernel - '
          f'plain| {err_fwd:.3e} over out, c_seq, gates, h_T, c_T (tol '
          f'{LSTM_TOL}), plain with TF32 vs f32 {tf32_fwd:.3e}, kernel '
          f'{times["fwd_train"]:.3f} ms, plain '
          f'{times["fwd_train_plain"]:.3f} ms, bound '
          f'{limit_fwd["bound_ms"]:.3f} ms by {limit_fwd["bound_by"]}')
    print(f'phase 6 backward: max |kernel - plain| {err_bwd:.3e} over '
          f'dgates_x, dh0, dc0 (tol {LSTM_BWD_TOL}), plain with TF32 vs '
          f'f32 {tf32_bwd:.3e}, kernel {times["bwd"]:.3f} ms, plain '
          f'{times["bwd_plain"]:.3f} ms, bound '
          f'{limit_bwd["bound_ms"]:.3f} ms by {limit_bwd["bound_by"]}; '
          f'dW_hh product {times["dw"]:.3f} ms')
    print(f'phase 6 Function vs autograd through plain: max relative '
          f'difference {err_fn:.3e} over dgates_x, dW_hh, dh0, dc0 (tol '
          f'{LSTM_GRAD_RTOL}), autograd through plain with TF32 vs f32 '
          f'{tf32_fn:.3e}')
    if not err_fwd <= LSTM_TOL:
        fail(f'training forward kernel disagrees with plain: {err_fwd}')
    if not err_bwd <= LSTM_BWD_TOL:
        fail(f'backward kernel disagrees with plain: {err_bwd}')
    if not err_fn <= LSTM_GRAD_RTOL:
        fail(f'LSTMCellScan disagrees with autograd through the plain '
             f'forward: {err_fn}')
    if not (tf32_fwd > LSTM_TOL and tf32_bwd > LSTM_BWD_TOL
            and tf32_fn > LSTM_GRAD_RTOL):
        fail(f'the limits do not tell a TF32 product from f32: forward '
             f'{tf32_fwd}, backward {tf32_bwd}, Function {tf32_fn}')
    return {
        'fwd_train': {'max_abs_err': err_fwd, 'ms': times['fwd_train'],
                      'plain_ms': times['fwd_train_plain'], **limit_fwd,
                      'library_ms': library['fwd_train']},
        'bwd': {'max_abs_err': err_bwd, 'ms': times['bwd'],
                'plain_ms': times['bwd_plain'], **limit_bwd,
                'library_ms': library['bwd']},
    }, times


class Recorder(Hook):
    """Per iteration: the loss and the pre-clip gradient norm (kept on the
    card); at the first step, that every trained parameter got a finite
    gradient."""

    def __init__(self, nonzero=False):
        self.losses, self.norms = [], []
        self.nonzero = nonzero

    def post_step(self, trainer, example, model_output, review):
        self.losses.append(review['scalars']['loss'].detach())
        if len(self.losses) > 1:
            return
        for name, p in trainer.model.named_parameters():
            if not p.requires_grad:
                continue
            if p.grad is None or not bool(torch.isfinite(p.grad).all()):
                fail(f'{name} got no finite gradient on the card')
            if self.nonzero and not float(p.grad.abs().max()) > 0:
                fail(f'{name} got a zero gradient on the card')
            if p.device.type != 'cuda':
                fail(f'{name} is on {p.device}')

    def post_optimize(self, trainer, summary):
        self.norms.append(summary['scalars']['grad_norm'].detach())


def check_storage_dir(storage_dir, iterations, best):
    names = sorted(p.name for p in (storage_dir / 'checkpoints').iterdir())
    for ckpt in (f'ckpt_{iterations}.ptt', 'ckpt_latest.ptt', best,
                 'ckpt_ranking.json'):
        if ckpt not in names:
            fail(f'{ckpt} missing from {names}')
    if not any('tfevents' in p.name for p in storage_dir.iterdir()):
        fail('no event file in the storage dir')
    return names


def first_step_on_cpu(model_cpu, batch, tmp, clipping, loss_weights=None):
    """Loss and pre-clip gradient norm of one training step on the CPU."""
    cpu = Trainer(model_cpu.train(), Path(tmp) / 'cpu',
                  Adam(gradient_clipping=clipping), loss_weights=loss_weights)
    loss, _, _, _ = cpu.train_step(cpu.model, batch)
    loss.backward()
    return float(loss.detach()), float(cpu.optimizer.clip_grad())


def compare_first_step(label, losses, norms, loss_cpu, norm_cpu, rtol):
    rel_loss = abs(losses[0] - loss_cpu) / abs(loss_cpu)
    rel_norm = abs(norms[0] - norm_cpu) / norm_cpu
    print(f'phase {label} first step card vs CPU: loss {losses[0]:.9g} vs '
          f'{loss_cpu:.9g} (relative {rel_loss:.3e}, tol {rtol[0]}), '
          f'gradient norm {norms[0]:.9g} vs {norm_cpu:.9g} (relative '
          f'{rel_norm:.3e}, tol {rtol[1]})')
    if not (rel_loss <= rtol[0] and rel_norm <= rtol[1]):
        fail(f'phase {label}: the first training step on the card '
             f'disagrees with the CPU')


def train_batch(batch, frames, seed=0):
    """A ragged training batch at a chosen size (magnitudes as the
    recipe's features have them, random)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(frames // 2, frames + 1, size=batch)
    lens[0] = frames
    valid = np.arange(frames)[None, :, None, None] < lens[:, None, None, None]
    x = np.abs(rng.randn(batch, frames, 2, 257)).astype('float32') * valid
    return {
        'Y_abs': x.sum(2).astype('float32'),
        'X_abs': x.astype('float32'),
        'cos_phase_difference': rng.uniform(
            -1, 1, (batch, frames, 2, 257)).astype('float32'),
        'num_frames': lens.astype('int32'),
    }


def timed_step(trainer, batch, iters=5, loss_key='pit_mse_loss',
               wrapper=lstm_cell_scan, per_step=3):
    """One training step by stage (CUDA events; ms), and the whole step on
    the host clock ended by a synchronize.  ``wrapper`` is the recurrence
    the model runs, ``per_step`` its launches per step and kind (None: no
    count is checked); ``loss_key`` None takes the review's ``loss``."""
    model, optimizer = trainer.model, trainer.optimizer
    example = model.example_to_device(batch, 'cuda')
    stages = {}

    def stage(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        stages.setdefault(name, []).append((start, end))
        return out

    def step():
        out = stage('forward', lambda: model(example))
        review = stage('review', lambda: model.review(example, out))
        loss = review['loss'] if loss_key is None \
            else review['losses'][loss_key]
        stage('backward', loss.backward)
        stage('clip', optimizer.clip_grad)
        stage('adam', optimizer.optimizer.step)
        optimizer.zero_grad()

    model.train()
    optimizer.zero_grad()
    step()  # warm-up
    torch.cuda.synchronize()
    stages.clear()
    reset_launches()
    host = []
    for _ in range(iters):
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - start) * 1e3)
    launches = dict(wrapper.launches) if wrapper is not None else None
    if wrapper is not None and launches != {
            'fwd': 0, 'fwd_train': per_step * iters,
            'bwd': per_step * iters}:
        fail(f'a training step launches {per_step} fwd_train and '
             f'{per_step} bwd kernels, got {launches} in {iters} steps')
    out = {name: float(np.mean([a.elapsed_time(b) for a, b in events]))
           for name, events in stages.items()}
    out['device_sum'] = sum(out.values())
    out['host_step'] = float(np.median(host))
    return out


def profile_step(trainer, batch, label):
    """``--profile``: torch.profiler's kernel table for one step."""
    from torch.profiler import ProfilerActivity, profile
    example = trainer.model.example_to_device(batch, 'cuda')
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            loss, _, _ = trainer._loss_and_review(trainer.model, example)
            loss.backward()
            trainer.optimizer.step()
            trainer.optimizer.zero_grad()
        torch.cuda.synchronize()
    print(f'profile {label} (3 steps):')
    print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=25))


def phase_training(kernel_times, profile=False):
    """Phase 7: the recipe's trainer at full width on the card."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'pit' / '1'
        config = pit_train.get_trainer_config(storage_dir, {
            'stop_trigger': (3, 'epoch'),
            'summary_trigger': (8, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')

        train_ds = pit_data.synthetic_database(num_examples=32)
        dev_ds = pit_data.synthetic_database(num_examples=8, seed=1)
        train = pit_data.prepare_dataset(
            train_ds, batch_size=4, shuffle=False, prefetch=False)
        dev = pit_data.prepare_dataset(
            dev_ds, batch_size=4, shuffle=False, prefetch=False)

        start = time.perf_counter()
        trainer.test_run(train, dev)
        print(f'phase 7a test_run passed on the card in '
              f'{time.perf_counter() - start:.2f} s')

        recorder = Recorder()
        trainer.register_hook(recorder)
        trainer.register_validation_hook(dev)
        reset_launches()
        start = time.perf_counter()
        trainer.train(train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = dict(lstm_cell_scan.launches)
        iterations = trainer.iteration
        losses = [float(x) for x in recorder.losses]
        norms = [float(x) for x in recorder.norms]
        hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
        validations = 4  # iterations 0, 8, 16, 24; 2 batches each
        print(f'phase 7b trained {iterations} iterations in {seconds:.2f} s '
              f'(validations and checkpoints included), launches '
              f'{launches}; training loss first 8 mean '
              f'{np.mean(losses[:8]):.4f}, last 8 mean '
              f'{np.mean(losses[-8:]):.4f}; ranking {hook.ckpt_ranking}')
        if iterations != 24 or len(losses) != 24 or len(norms) != 24:
            fail(f'expected 24 iterations, got {iterations}')
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f'non-finite loss or gradient norm: {losses} {norms}')
        want = {'fwd': 3 * 2 * validations, 'fwd_train': 3 * iterations,
                'bwd': 3 * iterations}
        if launches != want:
            fail(f'launches {launches}, expected {want}: 3 fwd_train and 3 '
                 f'bwd per step, 3 fwd per validation batch')
        if not np.mean(losses[-8:]) < np.mean(losses[:8]):
            fail('the training loss did not fall')

        # the first step once more on the CPU, from the same weights
        batch = next(iter(train))
        compare_first_step(
            '7c', losses, norms,
            *first_step_on_cpu(model_cpu, batch, tmp, 10.0,
                               config['loss_weights']),
            (STEP_RTOL, STEP_RTOL))
        names = check_storage_dir(storage_dir, 24, 'ckpt_best_loss.ptt')
        loaded = PermutationInvariantTrainingModel.from_storage_dir(
            storage_dir).to('cuda').eval()
        stft = HostSTFT(pit_data.STFT_SIZE, pit_data.STFT_SHIFT,
                        fading='full', complex_representation='complex')
        example = next(iter(pit_data.synthetic_database(
            num_examples=1, seed=2)))
        _, metrics = evaluate_example(loaded, stft, example)
        if not np.isfinite(metrics['output_si_sdr']).all():
            fail(f'bad metrics from the trained model: {metrics}')
        print(f'phase 7d storage dir {names} loads; one request served '
              f'from it: SI-SDR {metrics["output_si_sdr"]}')

        for label, batch in (
                ('B=4 (recipe)', next(iter(train))),
                ('B=16 T=500', train_batch(16, 500))):
            t = timed_step(trainer, batch)
            n_frames = batch['Y_abs'].shape[1]
            print(f'phase 7e training step {label}, frames {n_frames}: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
            if profile:
                profile_step(trainer, batch, label)
        print(f'phase 7e kernels alone at T=500 D*B=32 (phase 6): 3 x '
              f'fwd_train {kernel_times["fwd_train"]:.3f} ms, 3 x bwd '
              f'{kernel_times["bwd"]:.3f} ms, 3 x dW_hh '
              f'{kernel_times["dw"]:.3f} ms')
    return launches


def with_tf32(fn):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_gru_kernels():
    """Phase 8: the three GRU kernels and the Function around them, at
    each of RECURRENCE_SHAPES (two directions) and of
    CLASSIFIER_GRU_SHAPES (one).  Returns {label: {kernel: row}}."""
    results = {}
    # (shape, directions, width of the layer's input: a DPRNN chunk RNN's
    # is 64, a uPIT layer's 1200)
    cases = [(shape, 2, 64 if shape[3] == 128 else 1200)
             for shape in RECURRENCE_SHAPES]
    cases += [(shape[:5], 1, shape[5]) for shape in CLASSIFIER_GRU_SHAPES]
    for (label, t_len, batch, hdim, kind), n_dir, in_size in cases:
        args, cot = recurrence_inputs(t_len, batch, hdim, kind, gates=3,
                                      directions=n_dir)
        gx, w, mask, h0 = args
        valid = t_len * n_dir * batch if mask is None else float(mask.sum())

        def fwd_train():
            return gru_kernels._launch(gx, w, n_dir, mask, h0, train=True)

        got = gru_cell_scan(*args)
        want = gru_cell_scan_plain(*args)
        got_train = fwd_train()
        want_train = gru_cell_scan_train_plain(*args)
        torch.cuda.synchronize()
        err = {'fwd': max_err(got, want),               # out, h_T
               # out, acts, gh_n, h_prev, h_T
               'fwd_train': max_err(got_train, want_train)}
        _, acts, gh_n, h_prev, _ = want_train

        def bwd():
            return gru_kernels._launch_bwd(acts, gh_n, h_prev, w, n_dir,
                                           mask, *cot)

        def bwd_plain():
            return gru_cell_scan_bwd_plain(acts, gh_n, h_prev, w, mask,
                                           *cot)

        got_bwd = bwd()
        want_bwd = bwd_plain()
        torch.cuda.synchronize()
        err['bwd'] = max_err(got_bwd, want_bwd)          # dgx, dgh, dh0

        def grads(fn):
            leaves = [a.clone().requires_grad_() for a in (gx, w, h0)]
            outs = fn(leaves[0], leaves[1], mask, leaves[2])
            if any(o.grad_fn is None for o in outs):
                fail('gru_cell_scan under grad mode returned a tensor '
                     'without grad_fn')
            return torch.autograd.grad(outs, leaves, cot)

        want_grads = grads(gru_cell_scan_plain)
        err_fn = max_rel_err(grads(gru_cell_scan), want_grads)
        tf32 = {
            'fwd': with_tf32(lambda: max_err(
                gru_cell_scan_plain(*args), want)),
            'fwd_train': with_tf32(lambda: max_err(
                gru_cell_scan_train_plain(*args), want_train)),
            'bwd': with_tf32(lambda: max_err(bwd_plain(), want_bwd)),
            'fn': with_tf32(lambda: max_rel_err(
                grads(gru_cell_scan_plain), want_grads)),
        }
        plain_iters = 2 if t_len > 100 else 3
        times = {
            'fwd': cuda_ms(lambda: gru_cell_scan(*args), iters=20),
            'fwd_train': cuda_ms(fwd_train, iters=20),
            'bwd': cuda_ms(bwd, iters=20),
            'fwd_plain': cuda_ms(lambda: gru_cell_scan_plain(*args),
                                 iters=plain_iters),
            'fwd_train_plain': cuda_ms(
                lambda: gru_cell_scan_train_plain(*args),
                iters=plain_iters),
            'bwd_plain': cuda_ms(bwd_plain, iters=plain_iters),
            'dw': cuda_ms(lambda: gru_kernels.recurrent_weight_grad(
                got_bwd[1], h_prev, n_dir), iters=20),
        }
        library = cudnn_layer_ms(torch.nn.GRU, t_len, batch, in_size, hdim,
                                 n_dir)
        flops = gru_flops(valid, hdim)
        limits = {
            'fwd': bound(nbytes(*args, *got), flops),
            'fwd_train': bound(nbytes(*args, *got_train), flops),
            'bwd': bound(nbytes(acts, gh_n, h_prev, w, mask, *cot,
                                *got_bwd), flops),
        }
        tols = {'fwd': GRU_TOL, 'fwd_train': GRU_TOL, 'bwd': GRU_BWD_TOL}
        for name in ('fwd', 'fwd_train', 'bwd'):
            print(f'phase 8 gru {name} {label}: max |kernel - plain| '
                  f'{err[name]:.3e} (tol {tols[name]}), plain with TF32 vs '
                  f'f32 {tf32[name]:.3e}, kernel {times[name]:.3f} ms, '
                  f'plain {times[name + "_plain"]:.3f} ms, bound '
                  f'{limits[name]["bound_ms"]:.4f} ms by '
                  f'{limits[name]["bound_by"]}, cuDNN nn.GRU layer '
                  f'{library[name]:.3f} ms')
            if not err[name] <= tols[name]:
                fail(f'gru {name} kernel disagrees with plain at {label}: '
                     f'{err[name]}')
            if not tf32[name] > tols[name]:
                fail(f'the limit {tols[name]} does not tell a TF32 product '
                     f'from f32 for gru {name} at {label}: {tf32[name]}')
        print(f'phase 8 GRUCellScan vs autograd through plain {label}: max '
              f'relative difference {err_fn:.3e} over dgates_x, dW_hh, dh0 '
              f'(tol {GRU_GRAD_RTOL}), with TF32 {tf32["fn"]:.3e}; dW_hh '
              f'product {times["dw"]:.3f} ms')
        if not err_fn <= GRU_GRAD_RTOL:
            fail(f'GRUCellScan disagrees with autograd through the plain '
                 f'forward at {label}: {err_fn}')
        if not tf32['fn'] > GRU_GRAD_RTOL:
            fail(f'the limit {GRU_GRAD_RTOL} does not tell TF32 from f32 '
                 f'for GRUCellScan at {label}: {tf32["fn"]}')
        results[label] = {
            name: {'shape': label, 'max_abs_err': err[name],
                   'ms': times[name], 'plain_ms': times[name + '_plain'],
                   **limits[name], 'library_ms': library[name]}
            for name in ('fwd', 'fwd_train', 'bwd')}
        results[label]['dw_ms'] = times['dw']
    return results


def phase_lstm_at_dprnn_shapes():
    """Phase 9: the three LSTM kernels at the DPRNN's two shapes, timed
    beside one bidirectional ``torch.nn.LSTM`` layer (cuDNN) of the same
    sizes (the chunk RNN's input of 64 features), each with its TF32
    control, the backward with the grid it took."""
    results = {}
    for label, t_len, batch, hdim, kind in RECURRENCE_SHAPES[:2]:
        args, cot = recurrence_inputs(t_len, batch, hdim, kind, gates=4)
        gx, w, mask, h0, c0 = args
        valid = t_len * 2 * batch if mask is None else float(mask.sum())

        def fwd_train():
            return lstm_kernels._launch(gx, w, 2, mask, h0, c0, train=True)

        got = lstm_cell_scan(*args)
        want = lstm_cell_scan_plain(*args)
        got_train = fwd_train()
        want_train = lstm_cell_scan_train_plain(*args)
        _, c_seq, gates, _, _ = want_train

        def bwd():
            return lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask, *cot)

        got_bwd = bwd()
        want_bwd = lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot)
        torch.cuda.synchronize()
        err = {'fwd': max_err(got, want),
               'fwd_train': max_err(got_train, want_train),
               'bwd': max_err(got_bwd, want_bwd)}
        tf32 = {'fwd': with_tf32(lambda: max_err(
                    lstm_cell_scan_plain(*args), want)),
                'fwd_train': with_tf32(lambda: max_err(
                    lstm_cell_scan_train_plain(*args), want_train)),
                'bwd': with_tf32(lambda: max_err(
                    lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot),
                    want_bwd))}
        grid = lstm_kernels.bwd_grid(2, batch, hdim)
        times = {'fwd': cuda_ms(lambda: lstm_cell_scan(*args), iters=10),
                 'fwd_train': cuda_ms(fwd_train, iters=10),
                 'bwd': cuda_ms(bwd, iters=10)}
        library = cudnn_layer_ms(torch.nn.LSTM, t_len, batch, 64, hdim)
        flops = valid * (2 * hdim * 4 * hdim + 30 * hdim)
        limits = {
            'fwd': bound(nbytes(*args, *got), flops),
            'fwd_train': bound(nbytes(*args, *got_train), flops),
            'bwd': bound(nbytes(gates, c_seq, w, mask, *cot, *got_bwd),
                         flops)}
        for name, tol in (('fwd', LSTM_TOL), ('fwd_train', LSTM_TOL),
                          ('bwd', LSTM_BWD_TOL)):
            shown = (' on the grid ' + ', '.join(
                f'{k} {v}' for k, v in grid.items()) if name == 'bwd' else '')
            print(f'phase 9 lstm {name} {label}: max |kernel - plain| '
                  f'{err[name]:.3e} (tol {tol}), plain with TF32 '
                  f'{tf32[name]:.3e}, kernel {times[name]:.3f} ms{shown}, '
                  f'bound {limits[name]["bound_ms"]:.4f} ms by '
                  f'{limits[name]["bound_by"]}')
            if not err[name] <= tol:
                fail(f'lstm {name} kernel disagrees with plain at {label}: '
                     f'{err[name]}')
            if not tf32[name] > tol:
                fail(f'the limit {tol} does not tell a TF32 recurrence from '
                     f'f32 at {label}: {tf32[name]}')
        print(f'phase 9 yardstick {label}: one bidirectional torch.nn.LSTM '
              f'layer (cuDNN; input 64, includes the input projection, '
              f'takes no mask) forward {library["fwd"]:.3f} ms (no grad), '
              f'{library["fwd_train"]:.3f} ms (grad mode), backward '
              f'{library["bwd"]:.3f} ms')
        results[label] = {**times,
                          'library': {k: round(v, 4)
                                      for k, v in library.items()},
                          'bwd_grid': grid}
    return results


# the inter-chunk attention's key lengths at B=4 x 32000 samples: the four
# examples' chunk counts, each repeated over the K=100 positions, and two
# rows cut to one key and to none
INTER_LENS = np.repeat([66, 55, 46, 36], 100)
INTER_LENS[-2:] = (1, 0)
# (label, B, H, Hkv, Tq, Tk, D, masks, timed); the first is the shape of
# the rows in the kernels' line, the third the table's (96, 2048, 64)
ATTENTION_CASES = [
    ('intra (264, 8, 100, 16)', 264, 8, 8, 100, 100, 16, {}, True),
    ('inter (400, 8, 66, 16) ragged', 400, 8, 8, 66, 66, 16,
     {'key_padding_lens': INTER_LENS}, True),
    ('(8, 12, 2048, 64) full', 8, 12, 12, 2048, 2048, 64, {}, True),
    ('(8, 12, 2048, 64) causal', 8, 12, 12, 2048, 2048, 64,
     {'causal': True}, True),
    ('(8, 12, 2048, 64) window (256, 256)', 8, 12, 12, 2048, 2048, 64,
     {'window': (256, 256)}, True),
    ('(8, 12, 2048, 64) causal, ragged', 8, 12, 12, 2048, 2048, 64,
     {'causal': True,
      'key_padding_lens': [2048, 1500, 1000, 777, 1, 0, 2000, 64]}, True),
    ('gqa (4, 8 over 2, 1024, 64)', 4, 8, 2, 1024, 1024, 64, {}, True),
    ('Tq 300, Tk 517 (2, 4, ., 64)', 2, 4, 4, 300, 517, 64, {}, False),
    ('D=24 (2, 4, 50, 24) window (7, 3)', 2, 4, 4, 50, 50, 24,
     {'window': (7, 3)}, False),
    ('D=128 gqa (2, 8 over 2, 130 x 77) ragged', 2, 8, 2, 130, 77, 128,
     {'key_padding_lens': [77, 50]}, False),
    # long sums at the widest head: dk, dv over 4096 queries (16384 with
    # the group's heads), on the tensor cores
    ('D=128 (2, 8, 4096, 128) full', 2, 8, 8, 4096, 4096, 128, {}, False),
    ('D=128 (2, 8, 4096, 128) causal', 2, 8, 8, 4096, 4096, 128,
     {'causal': True}, False),
    ('D=128 gqa (1, 8 over 2, 4096, 128)', 1, 8, 2, 4096, 4096, 128, {},
     False),
]


def attention_library(q, k, v, d_o, masks):
    """Yardstick, timed here and used nowhere in the port:
    ``F.scaled_dot_product_attention`` in float32 (TF32 is off) on the same
    inputs, forward and backward (ms).  It takes no key lengths, window or
    shared KV heads: those become a boolean mask and repeated heads, made
    outside the timed call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k, v = (x.repeat_interleave(group, dim=1) for x in (k, v))
    causal_only = set(masks) == {'causal'}
    mask = None
    if masks and not causal_only:
        lens = attention_kernels._lens_tensor(
            masks.get('key_padding_lens'), q.shape[0], q.device)
        mask = visible_mask(q.shape[2], k.shape[2], lens,
                            masks.get('causal', False), masks.get('window'),
                            q.device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def forward():
        return sdpa(*leaves, attn_mask=mask, is_causal=causal_only)

    with torch.no_grad():
        fwd = cuda_ms(forward, iters=5)
    out = forward()
    bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, d_o,
                                              retain_graph=True), iters=5)
    return fwd, bwd


def attention_case(label, b, h, h_kv, tq, tk, d, masks, timed):
    """One shape of phase 12: both kernels against the plain version, and
    (``timed``) their times, the plain version's, the library's and the
    bounds.  Returns {'fwd': row, 'bwd': row}."""
    rng = np.random.RandomState(0)
    q, k, v, d_o = (
        torch.tensor(rng.randn(*shape), dtype=torch.float32, device='cuda')
        for shape in ((b, h, tq, d), (b, h_kv, tk, d), (b, h_kv, tk, d),
                      (b, h, tq, d)))
    lens = attention_kernels._lens_tensor(
        masks.get('key_padding_lens'), b, q.device)
    with torch.no_grad():
        got = flash_attention(q, k, v, **masks)
        want, want_lse = flash_attention_fwd_plain(q, k, v, **masks)
    err = {'o': max_err([got], [want])}
    if d in attention_kernels.HEAD_SIZES:
        got_train = attention_kernels._launch_fwd(
            q, k, v, lens, masks.get('causal', False),
            *attention_kernels._norm_window(masks.get('window')),
            1.0 / np.sqrt(d), train=True)
        err['o, lse (training forward)'] = max_err(got_train,
                                                   (want, want_lse))

    def graph(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, **masks)
        if out.grad_fn is None:
            fail('flash_attention under grad mode returned a tensor '
                 'without grad_fn')
        return out, leaves

    def grads(fn):
        out, leaves = graph(fn)
        return torch.autograd.grad(out, leaves, d_o)

    got_grads, want_grads = grads(flash_attention), grads(
        flash_attention_plain)
    torch.cuda.synchronize()
    err['dq, dk, dv'] = max_err(got_grads, want_grads)
    rel = max_rel_err(got_grads, want_grads)
    # the control: autograd through plain with TF32 products must fail the
    # limit the kernels' 3xTF32 products meet.  cuBLAS keeps the small
    # batched products of the SepFormer shapes on its float32 path even
    # with TF32 allowed (the control read 0.0 at (400, 8, 66, 16)), so the
    # operands are rounded to TF32 as a TF32 product reads them, too
    def tf32_grads():
        leaves = [tf32_round(x).requires_grad_() for x in (q, k, v)]
        out = flash_attention_plain(*leaves, **masks)
        return torch.autograd.grad(out, leaves, tf32_round(d_o))

    tf32_rel = (with_tf32(lambda: max_rel_err(tf32_grads(), want_grads))
                if timed else None)
    same = all(torch.equal(x, y)
               for x, y in zip(got_grads, grads(flash_attention)))
    print(f'phase 12 attention {label}: max |kernel - plain| '
          + ', '.join(f'{k} {v:.3e}' for k, v in err.items())
          + f' (tol {ATTENTION_TOL} on o and lse); gradients relative '
          f'{rel:.3e} (tol {ATTENTION_GRAD_RTOL})'
          + ('' if tf32_rel is None else
             f', autograd through plain with TF32 (operands rounded to '
             f'TF32) {tf32_rel:.3e}')
          + f'; two backward runs the same bits: {same}')
    if not max(err['o'], err.get('o, lse (training forward)', 0.0)) \
            <= ATTENTION_TOL:
        fail(f'attention forward kernel disagrees with plain at {label}: '
             f'{err}')
    if not rel <= ATTENTION_GRAD_RTOL:
        fail(f'attention backward kernels disagree with autograd through '
             f'plain at {label}: {rel}')
    if tf32_rel is not None and not tf32_rel > ATTENTION_GRAD_RTOL:
        fail(f'the limit {ATTENTION_GRAD_RTOL} does not tell TF32 attention '
             f'gradients from f32 at {label}: {tf32_rel}')
    if not same:
        fail(f'two attention backward runs differ at {label}')
    if lens is not None:
        for row in torch.nonzero(lens == 0)[:, 0].tolist():
            if any(float(x[row].abs().max()) != 0.0
                   for x in (got, *got_grads)):
                fail(f'{label}: row {row} has no key but a nonzero output '
                     f'or gradient')
    if not timed:
        return None

    out, leaves = graph(flash_attention)
    out_plain, leaves_plain = graph(flash_attention_plain)
    with torch.no_grad():
        times = {
            'fwd': cuda_ms(lambda: flash_attention(q, k, v, **masks),
                           iters=10),
            'fwd_plain': cuda_ms(
                lambda: flash_attention_plain(q, k, v, **masks), iters=5),
        }
    times['fwd_train'] = cuda_ms(lambda: graph(flash_attention), iters=10)
    # the backward of small shapes read 0.31 to 0.94 ms in single windows
    # of 10 after the large allocations of the earlier phases: the median
    # of 5 windows after a warm-up, with the allocator's cache emptied
    torch.cuda.empty_cache()
    times['bwd'], bwd_windows = cuda_ms_median(
        lambda: torch.autograd.grad(out, leaves, d_o, retain_graph=True),
        iters=10)
    # the two backward kernels alone, on the card's clock: whether the
    # spread of the eager windows is the kernels' or the host's
    bwd_args = (q, k, v, lens, d_o, got_train[1], (d_o * want).sum(-1),
                masks.get('causal', False),
                *attention_kernels._norm_window(masks.get('window')),
                1.0 / np.sqrt(d))
    bwd_kernels = graph_ms(lambda: attention_kernels._launch_bwd(*bwd_args),
                           iters=10)
    times['bwd_plain'] = cuda_ms(lambda: torch.autograd.grad(
        out_plain, leaves_plain, d_o, retain_graph=True), iters=5)
    del out_plain, leaves_plain
    times['fwd_library'], times['bwd_library'] = attention_library(
        q, k, v, d_o, masks)
    # the work these inputs need: the visible (query, key) pairs, each two
    # products of D in the forward (q k^T, p v) and five in the backward;
    # the forward runs on the CUDA cores, the backward's products on the
    # tensor cores as 3xTF32
    visible = visible_mask(tq, tk, lens, masks.get('causal', False),
                           masks.get('window'), q.device)
    pairs = float(visible.sum()) * h * (b // visible.shape[0])
    limits = {
        'fwd': bound(nbytes(q, k, v, lens, got), 4 * pairs * d),
        'bwd': bound(nbytes(q, k, v, lens, got, want_lse, d_o, *got_grads),
                     10 * pairs * d, PEAK_3XTF32_FLOPS)}
    for name in ('fwd', 'bwd'):
        print(f'phase 12 attention {name} {label}: kernel '
              f'{times[name]:.3f} ms'
              + (f' (keeping lse: {times["fwd_train"]:.3f} ms)'
                 if name == 'fwd' else ' (delta included; median of the '
                 'windows ' + ', '.join(f'{w:.3f}' for w in bwd_windows)
                 + f'; the two kernels alone {bwd_kernels:.3f} ms from a '
                 'CUDA graph)')
              + f', plain {times[name + "_plain"]:.3f} ms, '
              f'scaled_dot_product_attention '
              f'{times[name + "_library"]:.3f} ms, bound '
              f'{limits[name]["bound_ms"]:.4f} ms by '
              f'{limits[name]["bound_by"]} at the {limits[name]["peak"]} '
              f'peak (the kernel at '
              f'{limits[name]["bound_ms"] / times[name]:.1%} of it)')
    return {
        'fwd': {'max_abs_err': max(
            err['o'], err.get('o, lse (training forward)', 0.0)),
            'ms': times['fwd'], 'plain_ms': times['fwd_plain'],
            **limits['fwd'], 'library_ms': times['fwd_library']},
        'bwd': {'max_abs_err': err['dq, dk, dv'], 'ms': times['bwd'],
                'plain_ms': times['bwd_plain'], **limits['bwd'],
                'library_ms': times['bwd_library']}}


def attention_dispatch_table():
    """One ``MultiheadAttention`` (RoPE, float32) on the fused and on the
    dense backend, forward alone and forward + backward, beside what
    ``should_use_flash`` picks there."""
    shapes = [(8, t, 768, 12, masks, None)
              for t in (512, 1024, 2048, 4096)
              for masks in ({}, {'causal': True},
                            {'attn_window': (256, 256)})]
    shapes += [(264, 100, 128, 8, {}, None),
               (400, 66, 128, 8, {}, INTER_LENS)]
    for batch, t_len, d_model, heads, masks, lens in shapes:
        torch.manual_seed(0)
        mha = MultiheadAttention(d_model, heads, use_rope=True).cuda()
        x = torch.randn((batch, t_len, d_model), device='cuda',
                        requires_grad=True)
        d_out = torch.randn_like(x)
        kwargs = dict(masks)
        if lens is not None:
            kwargs['key_padding_lens'] = torch.from_numpy(lens).cuda()
        leaves = [x, *mha.parameters()]
        iters = 3 if t_len >= 2048 else 10
        ms = {}
        for use_flash in (True, False):
            set_attention_backend(mha, use_flash)
            with torch.no_grad():
                ms[use_flash, 'forward'] = cuda_ms(
                    lambda: mha(x, **kwargs), iters=iters)
            ms[use_flash, 'training'] = cuda_ms(
                lambda: torch.autograd.grad(mha(x, **kwargs), leaves, d_out),
                iters=iters)
        picks = {
            mode: should_use_flash(
                t_len, causal=masks.get('causal', False),
                window=masks.get('attn_window'),
                training=mode == 'training')
            for mode in ('forward', 'training')}
        print(f'phase 12 dispatch (B, T, H x D) = ({batch}, {t_len}, '
              f'{heads} x {d_model // heads}) {masks or "full"}'
              f'{"" if lens is None else " ragged"}: '
              + '; '.join(
                  f'{mode} fused {ms[True, mode]:.3f} ms, dense '
                  f'{ms[False, mode]:.3f} ms, auto picks '
                  f'{"fused" if picks[mode] else "dense"}'
                  for mode in ('forward', 'training')))


def phase_attention_kernels():
    """Phase 12: the two attention kernels at ATTENTION_CASES, then the
    dispatch table.  Returns {label: {'fwd': row, 'bwd': row}}."""
    results = {}
    for label, *shape, masks, timed in ATTENTION_CASES:
        rows = attention_case(label, *shape, masks, timed)
        torch.cuda.empty_cache()
        if rows is not None:
            results[label] = rows
    attention_dispatch_table()
    torch.cuda.empty_cache()
    return results


def tasnet_updates(rnn_type, extra=None):
    """The config update that chooses the chunk RNNs, as the recipe's
    users write it."""
    return nested_merge({'model': {'separator': {
        'inter_chunk_type': rnn_type, 'intra_chunk_type': rnn_type}}},
        extra or {})


def tasnet_batch(batch, samples, seed=0):
    """A ragged batch of random two-speaker mixtures."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(samples // 2, samples + 1, size=batch)
    lens[0] = samples
    valid = np.arange(samples)[None, :] < lens[:, None]
    s = (rng.randn(batch, 2, samples) * 0.3 * valid[:, None]).astype(
        'float32')
    return {'y': s.sum(1), 's': s, 'num_samples': lens.astype('int32')}


def recurrence_of(rnn_type):
    return gru_cell_scan if rnn_type == 'bgru' else lstm_cell_scan


def serve_tasnet_requests(label, model, model_cpu, wrapper, per_request):
    """The tasnet recipe's ``evaluate_example`` on the 8 synthetic mixtures
    as 8 requests; ``wrapper`` is the kernel wrapper the model runs,
    ``per_request`` its lean forward launches per request.  Returns the
    count of those launches."""
    examples = list(tas_data.synthetic_database(num_examples=8, seed=2))
    reset_launches()
    latencies, results = [], {}
    for example in examples:
        start = time.perf_counter()
        example_id, metrics = tas_evaluate.evaluate_example(model, example)
        latencies.append((time.perf_counter() - start) * 1e3)
        results[example_id] = metrics
    launches = dict(wrapper.launches)
    with torch.no_grad():
        request = model.example_to_device(tas_data.post_batch_transform(
            [examples[0]]))
        forward_ms = cuda_ms(lambda: model(request), iters=5, warmup=2)
    print(f'phase {label} served {len(results)} requests, latency ms '
          f'{[round(x, 3) for x in latencies]} (median '
          f'{np.median(latencies):.3f}), launches {launches}; model forward '
          f'of one request ({examples[0]["observation"].shape[-1]} samples) '
          f'{forward_ms:.3f} ms')
    if launches != {'fwd': per_request * 8, 'fwd_train': 0, 'bwd': 0}:
        fail(f'8 requests launch {per_request} lean forward kernels each, '
             f'got {launches}')
    for example_id, metrics in results.items():
        values = np.asarray(metrics['output_si_sdr']
                            + metrics['output_mir_eval_sxr_sdr'])
        if values.shape != (4,) or not np.isfinite(values).all():
            fail(f'{example_id}: bad output metrics {metrics}')
    _, ref = tas_evaluate.evaluate_example(model_cpu, examples[0])
    diff = np.abs(np.subtract(
        ref['output_si_sdr'],
        results[examples[0]['example_id']]['output_si_sdr'])).max()
    print(f'phase {label} {examples[0]["example_id"]} SI-SDR card vs CPU: '
          f'max |diff| {diff:.3e} dB (tol {SI_SDR_TOL})')
    if not diff <= SI_SDR_TOL:
        fail(f'TasNet SI-SDR on the card disagrees with the CPU: {diff}')
    return launches['fwd']


def compare_tasnet_with_cpu(label, model, model_cpu):
    """``out`` of a ragged batch of 4 x 16000 samples, card against CPU."""
    batch = tasnet_batch(4, 16000)
    with torch.no_grad():
        want = model_cpu(model_cpu.example_to_device(batch))['out']
        got = model(model.example_to_device(batch))['out'].cpu()
    err = float((got - want).abs().max())
    print(f'phase {label} full-width TasNet B=4 x 16000 samples, card vs '
          f'CPU: max |diff| of out {err:.3e} (tol {TASNET_TOL}, peak '
          f'{float(want.abs().max()):.3f})')
    if got.shape != (4, 2, 16000) or not err <= TASNET_TOL:
        fail(f'TasNet on the card disagrees with the CPU: {err}')


def phase_tasnet_serving(rnn_type):
    """Phase 10: the full-width DPRNN-TasNet serving path."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        config = tas_train.get_trainer_config(
            tmp, updates=tasnet_updates(rnn_type))
        model_cpu = Trainer.from_config(config).model.eval()
    width = (model_cpu.encoder.feature_size,
             model_cpu.separator.input_size,
             len(model_cpu.separator.dprnn_blocks),
             model_cpu.separator.dprnn_blocks[0].intra_chunk_rnn.rnn
             .hidden_size)
    if width != (256, 64, 6, 128):
        fail(f'not the full-width DPRNN-TasNet: {width}')
    model = copy.deepcopy(model_cpu).to('cuda')
    compare_tasnet_with_cpu(f'10a {rnn_type}', model, model_cpu)
    return serve_tasnet_requests(f'10b {rnn_type}', model, model_cpu,
                                 recurrence_of(rnn_type), 12)


def sepformer_width(model):
    separator = model.separator
    block = separator.dpt_blocks[0]
    layer = block.intra_chunk.layers[0]
    return (model.encoder.feature_size, separator.input_size,
            separator.window_size, separator.hop_size,
            len(separator.dpt_blocks), len(block.intra_chunk.layers),
            len(block.inter_chunk.layers), layer.self_attn.num_heads,
            layer.self_attn.d_head, layer.ffn.lin1.out_features)


SEPFORMER_WIDTH = (256, 128, 100, 50, 4, 2, 2, 8, 16, 512)


def phase_sepformer_serving():
    """Phase 13: the full-width SepFormer-TasNet serving path, from a
    storage dir the recipe's trainer wrote on the card."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'tasnet' / '1'
        config = tas_train.get_trainer_config(
            storage_dir, variant='sepformer', updates={
                'stop_trigger': (1, 'epoch'),
                'summary_trigger': (4, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        set_attention_backend(trainer.model, True)   # the recipe's --flash
        trainer.to('cuda')
        train, dev = (tas_data.prepare_dataset(
            tas_data.synthetic_database(num_examples=n, seed=seed),
            batch_size=4, segment_length=8000, shuffle=False, prefetch=False)
            for n, seed in ((16, 0), (8, 1)))
        trainer.register_validation_hook(dev, metric='si-sdr')
        trainer.train(train)
        model_cpu = TasNet.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_si-sdr.ptt').eval()
        print(f'phase 13a storage dir written by {trainer.iteration} '
              f'iterations of the sepformer recipe on the card and loaded '
              f'back')
    if not isinstance(model_cpu.separator, DualPathTransformer) \
            or sepformer_width(model_cpu) != SEPFORMER_WIDTH:
        fail(f'not the full-width SepFormer-TasNet: '
             f'{sepformer_width(model_cpu)}')
    model = set_attention_backend(copy.deepcopy(model_cpu), True).to('cuda')
    # on the CPU 'auto' is the dense backend: the card's kernels are held
    # against other code, not against their own plain version
    compare_tasnet_with_cpu('13b sepformer', model, model_cpu)
    return serve_tasnet_requests('13c sepformer', model, model_cpu,
                                 flash_attention, 16)


# the TasNet training paths of phases 11 and 14: the recipe's variant and
# config update, what the model is switched to after it is built, the
# kernel wrapper it runs and its launches per step, the limits of the first
# step against the CPU (loss, gradient norm; relative), and whether every
# gradient must be nonzero (a key bias has a zero gradient in exact
# arithmetic: a softmax does not see a shift of all its logits)
TASNET_TRAINING = {
    'bgru': dict(phase=11, variant='dprnn', wrapper=gru_cell_scan,
                 per_step=12, rtol=(TASNET_STEP_RTOL, TASNET_STEP_RTOL),
                 nonzero=True),
    'blstm': dict(phase=11, variant='dprnn', wrapper=lstm_cell_scan,
                  per_step=12, rtol=(TASNET_STEP_RTOL, TASNET_STEP_RTOL),
                  nonzero=True),
    'sepformer': dict(phase=14, variant='sepformer', wrapper=flash_attention,
                      per_step=16,
                      rtol=(SEPFORMER_LOSS_RTOL, SEPFORMER_NORM_RTOL),
                      nonzero=False),
}


def phase_tasnet_training(name, profile=False):
    """Phases 11 and 14: the tasnet recipe's trainer at full width on the
    card, for one of TASNET_TRAINING."""
    path = TASNET_TRAINING[name]
    phase, wrapper, per_step = path['phase'], path['wrapper'], path['per_step']
    sepformer = path['variant'] == 'sepformer'
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'tasnet' / '1'
        updates = {'stop_trigger': (2, 'epoch'),
                   'summary_trigger': (8, 'iteration')}
        config = tas_train.get_trainer_config(
            storage_dir, variant=path['variant'],
            updates=updates if sepformer else tasnet_updates(name, updates))
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        if sepformer:
            if sepformer_width(trainer.model) != SEPFORMER_WIDTH:
                fail(f'not the full-width SepFormer-TasNet: '
                     f'{sepformer_width(trainer.model)}')
            set_attention_backend(trainer.model, True)  # the recipe's --flash
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')

        # the recipe's --synthetic data: segments of 8000 samples
        train_ds = tas_data.synthetic_database(num_examples=32)
        dev_ds = tas_data.synthetic_database(num_examples=8, seed=1)
        train = tas_data.prepare_dataset(
            train_ds, batch_size=4, segment_length=8000, shuffle=False,
            prefetch=False)
        dev = tas_data.prepare_dataset(
            dev_ds, batch_size=4, segment_length=8000, shuffle=False,
            prefetch=False)
        n_dev = len(list(dev))

        start = time.perf_counter()
        trainer.test_run(train, dev)
        print(f'phase {phase}a {name} test_run passed on the card in '
              f'{time.perf_counter() - start:.2f} s')

        recorder = Recorder(nonzero=path['nonzero'])
        trainer.register_hook(recorder)
        trainer.register_validation_hook(dev, metric='si-sdr')
        reset_launches()
        start = time.perf_counter()
        trainer.train(train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = dict(wrapper.launches)
        iterations = trainer.iteration
        losses = [float(x) for x in recorder.losses]
        norms = [float(x) for x in recorder.norms]
        hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
        half = iterations // 2
        print(f'phase {phase}b {name} trained {iterations} iterations in '
              f'{seconds:.2f} s (validations and checkpoints included), '
              f'launches {launches}; training loss first half mean '
              f'{np.mean(losses[:half]):.4f}, second half mean '
              f'{np.mean(losses[half:]):.4f}; ranking {hook.ckpt_ranking}')
        if iterations < 8 or len(losses) != iterations:
            fail(f'expected at least 8 iterations, got {iterations}')
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f'non-finite loss or gradient norm: {losses} {norms}')
        validations = trainer.epoch + 1  # at iteration 0 and every epoch
        want = {'fwd': per_step * n_dev * validations,
                'fwd_train': per_step * iterations,
                'bwd': per_step * iterations}
        if launches != want or validations != 3:
            fail(f'launches {launches}, expected {want}: {per_step} '
                 f'fwd_train and {per_step} bwd per step, {per_step} fwd '
                 f'per validation batch ({n_dev} batches, {validations} '
                 f'validations)')
        if not np.mean(losses[half:]) < np.mean(losses[:half]):
            fail('the training loss did not fall')

        # the first step once more on the CPU, from the same weights (the
        # SepFormer's forced backend is there the kernels' plain version)
        batch = next(iter(train))
        compare_first_step(
            f'{phase}c {name}', losses, norms,
            *first_step_on_cpu(model_cpu, batch, tmp, 5.0,
                               config['loss_weights']),
            path['rtol'])
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_si-sdr.ptt')
        loaded = TasNet.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_si-sdr.ptt').to(
                'cuda').eval()
        example = next(iter(tas_data.synthetic_database(
            num_examples=1, seed=2)))
        _, metrics = tas_evaluate.evaluate_example(loaded, example)
        if not np.isfinite(metrics['output_si_sdr']).all():
            fail(f'bad metrics from the trained model: {metrics}')
        print(f'phase {phase}d {name} storage dir {names} loads; one request '
              f'served from it: SI-SDR {metrics["output_si_sdr"]}')

        for samples in (32000, 16000):
            batch = tasnet_batch(4, samples, seed=1)
            t = timed_step(trainer, batch, loss_key='si-sdr',
                           wrapper=wrapper, per_step=per_step)
            print(f'phase {phase}e {name} training step B=4 x {samples} '
                  f'samples: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
            if profile:
                profile_step(trainer, batch, f'{name} B=4 x {samples}')
            if not sepformer:
                continue
            set_attention_backend(trainer.model, False)
            t = timed_step(trainer, batch, loss_key='si-sdr',
                           wrapper=wrapper, per_step=0)
            set_attention_backend(trainer.model, True)
            print(f'phase {phase}e {name} the same step on the dense '
                  f'attention backend: '
                  + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))
    return launches


def wavenet_flops(t_len, batch, n_layers, r, s_dim, o_dim):
    """Operations of the sample loop: per row and step the two products of
    each dilated layer (R x 2R each), its skip product (R x S), the
    residual products (R x R, all layers but the last) and the two output
    products, 2 per multiply-add."""
    per_step = 2 * (n_layers * (2 * r * 2 * r + r * s_dim)
                    + (n_layers - 1) * r * r + s_dim * o_dim + o_dim * o_dim)
    return t_len * batch * per_step


def full_width_wavenet():
    """The wavenet recipe's model from seed 0 (its config's defaults)."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        model = Trainer.from_config(wn_train.get_trainer_config(tmp)).model
    check_wavenet_width(model)
    return model


def check_wavenet_width(model):
    net = model.wavenet
    width = (net.upsample.in_channels, net.upsamp_window, net.upsamp_stride,
             net.n_layers, tuple(net.dilations), net.n_residual_channels,
             net.skip_layers[0].conv.out_channels, net.n_out_channels,
             net.embed.num_embeddings)
    want = (80, 800, 200, 16, (1, 2, 4, 8, 16, 32, 64, 128) * 2, 64, 256,
            256, 256)
    if width != want:
        fail(f'not the full-width WaveNet: {width}')


def near_ties(scores, limit):
    """Where the two best of ``scores`` (..., O) are closer than ``limit``:
    there a difference within the kernels' limit may change the choice."""
    top = scores.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) < limit


def phase_wavenet_kernel():
    """Phase 15: wavenet_sample against its plain step loop at full width.
    Returns the kernel's row."""
    net = full_width_wavenet().wavenet.to('cuda')
    w = net.sampler_weights()
    dil = tuple(net.dilations)
    n_layers, r = net.n_layers, net.n_residual_channels
    s_dim, o_dim = w['w_skip'].shape[-1], net.n_out_channels
    rng = np.random.RandomState(0)

    def conditioning(t_len, batch):
        # of the size the cond layer gives log-mel features (about 1)
        return torch.from_numpy(rng.randn(
            t_len, batch, n_layers, 2 * r).astype('float32')).cuda()

    # a parallel request of 1 s: 5 chunks of 4200 steps as 5 rows
    t_len, batch = 4200, 5
    cond = conditioning(t_len, batch)
    forced = torch.from_numpy(rng.randint(
        0, o_dim, (t_len, batch)).astype('int32')).cuda()
    got_i, got_l = wavenet_sample(cond, w, dil, forced_input=forced,
                                  return_logits=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want_i, want_l = wavenet_sample_plain(cond, w, dil, forced_input=forced,
                                          return_logits=True)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((got_l - want_l).abs().max())
    _, tf32_l = with_tf32(lambda: wavenet_sample_plain(
        cond[:500], w, dil, forced_input=forced[:500], return_logits=True))
    tf32_err = float((tf32_l - want_l[:500]).abs().max())
    print(f'phase 15a wavenet_sample T={t_len} B={batch} L={n_layers} R={r} '
          f'S={s_dim} O={o_dim}, teacher-forced: max |diff| of logits vs '
          f'plain {err:.3e} (tol {WAVENET_TOL}, largest logit '
          f'{float(want_l.abs().max()):.2f}); control, plain with TF32 '
          f'products over 500 steps: {tf32_err:.3e}')
    if not err <= WAVENET_TOL:
        fail(f'wavenet_sample disagrees with its plain version: {err}')
    if not tf32_err > WAVENET_TOL:
        fail('the TF32 control passes the limit: the limit is too loose')
    # the greedy choice: the lowest index of the kernel's own best logit,
    # and the plain version's but at near ties
    if not bool((got_i.long() == got_l.argmax(-1)).all()):
        fail('greedy indices are not the argmax of the kernel\'s logits')
    differ = (got_i != want_i) & ~near_ties(want_l, 2 * WAVENET_TOL)
    # Gumbel-max on the same counters
    seed = 7
    sam_i, sam_l = wavenet_sample(cond, w, dil, forced_input=forced,
                                  return_logits=True, sample=True, seed=seed)
    noise = _gumbel(wavenet_uniform(seed, torch.arange(t_len), batch, o_dim,
                                    device='cuda'))
    own = (sam_l + noise).argmax(-1)
    # what the plain loop draws under teacher forcing (phase 15d holds the
    # plain loop's own sampling against the kernel's)
    plain_sam = (want_l + noise).argmax(-1)
    sam_differ = (sam_i != plain_sam) & ~near_ties(want_l + noise,
                                                   2 * WAVENET_TOL)
    print(f'phase 15b teacher-forced choices over {t_len * batch} steps: '
          f'greedy differs from plain at {int((got_i != want_i).sum())} '
          f'(none away from a near tie: {not bool(differ.any())}); '
          f'Gumbel-max from the kernel\'s own logits and the plain '
          f'generator\'s draws: equal {bool((sam_i.long() == own).all())}, '
          f'differs from plain at {int((sam_i != plain_sam).sum())}')
    if bool(differ.any()) or bool(sam_differ.any()):
        fail('wavenet_sample chooses another index than its plain version')
    if not bool((sam_i.long() == own).all()) \
            or not torch.equal(sam_l, got_l):
        fail('the kernel\'s draws are not the plain generator\'s')
    # sampled indices follow the softmax: the log-likelihood of the choices
    # against its expectation, minus the entropy, in standard deviations
    logp = torch.log_softmax(sam_l.double(), -1)
    p = logp.exp()
    chosen = logp.gather(-1, sam_i.long()[..., None])[..., 0]
    mean = (p * logp).sum(-1)
    var = (p * logp ** 2).sum(-1) - mean ** 2
    z = float((chosen - mean).sum() / var.sum().sqrt())
    print(f'phase 15c {t_len * batch} sampled indices against their '
          f'softmax: log-likelihood {float(chosen.sum()):.1f}, expected '
          f'{float(mean.sum()):.1f}, z = {z:.2f} (limit 5), '
          f'{len(torch.unique(sam_i))} distinct indices')
    if not abs(z) < 5:
        fail(f'sampled indices do not follow the softmax: z = {z}')

    # the free-running greedy loop, 1000 steps of 2 rows
    free_cond = conditioning(1000, 2)
    free_i = wavenet_sample(free_cond, w, dil)
    plain_i, plain_l = wavenet_sample_plain(free_cond, w, dil,
                                            return_logits=True)
    mismatch = (free_i != plain_i).any(1).nonzero()
    first = int(mismatch[0]) if len(mismatch) else None
    print(f'phase 15d free-running greedy, T=1000 B=2: equal to plain '
          f'{first is None}'
          + ('' if first is None else f' (first difference at step {first})'))
    if first is not None and not bool(near_ties(
            plain_l[first], 2 * WAVENET_TOL).any()):
        fail(f'the greedy loop leaves its plain version at step {first}')
    # a sequential request: one row of 16000 steps; its first 500 steps
    # against the plain loop
    one_cond = conditioning(16000, 1)
    one_i = wavenet_sample(one_cond, w, dil, sample=True, seed=3)
    head = wavenet_sample_plain(one_cond[:500], w, dil, sample=True, seed=3)
    if not torch.equal(one_i[:500], head):
        fail('one row of 16000 steps leaves the plain loop in its first 500')

    ms = cuda_ms(lambda: wavenet_sample(cond, w, dil, sample=True),
                 iters=2)
    one_ms = cuda_ms(lambda: wavenet_sample(one_cond, w, dil, sample=True),
                     iters=1)
    print(f'phase 15e wavenet_sample T={t_len} B={batch}: {ms:.1f} ms '
          f'({ms / t_len * 1e3:.1f} us per step, '
          f'{t_len * batch / ms / 16:.2f} x real time at 16 kHz), plain '
          f'{plain_ms:.0f} ms ({plain_ms / t_len * 1e3:.0f} us per step); '
          f'T=16000 B=1: {one_ms:.1f} ms ({one_ms / 16:.1f} us per sample, '
          f'{16000 / one_ms / 16:.2f} x real time)')
    for rows in (132, 264):
        many = conditioning(1000, rows)
        t = cuda_ms(lambda: wavenet_sample(many, w, dil, sample=True),
                    iters=1)
        print(f'phase 15e wavenet_sample T=1000 B={rows}: {t:.1f} ms '
              f'({t:.1f} us per step, {rows * 1e3 / t / 16:.1f} x real '
              f'time over the rows)')
        del many
    # each input read once (weights once for the whole call), the indices
    # written; the floor of a sequential chain is the latency of a step,
    # which this bound does not see
    return {'shape': f'T={t_len} B={batch} L={n_layers} R={r} S={s_dim} '
                     f'O={o_dim}',
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'library_ms': None,
            **bound(nbytes(cond, *w.values()) + 4 * t_len * batch,
                    wavenet_flops(t_len, batch, n_layers, r, s_dim, o_dim))}


# (label, batch, samples, size, shift, window_length, n_mels)
LOGMEL_SHAPES = [
    ('16 x 4 s 512/128/64', 16, 64000, 512, 128, None, 64),
    ('classifier recipe 8 x 8000 512/128/64', 8, 8000, 512, 128, None, 64),
    ('wavenet recipe 1024/200/800/80', 2, 16000, 1024, 200, 800, 80),
    ('hop 160, window 400', 3, 12345, 512, 160, 400, 40),
]


def phase_logmel_kernel():
    """Phase 16: fused_logmel against its plain version and the composed
    module path.  Returns the kernel's row at the first of LOGMEL_SHAPES."""
    rows = []
    rng = np.random.RandomState(0)
    for label, batch, samples, size, shift, window_length, n_mels in \
            LOGMEL_SHAPES:
        frontend = LogMelFrontend(size=size, shift=shift,
                                  window_length=window_length, n_mels=n_mels)
        x = torch.from_numpy(
            rng.randn(batch, samples).astype('float32') * 0.1).cuda()
        got = frontend(x)
        want = frontend.plain(x)
        err = float((got - want).abs().max())
        tf32_err = float((with_tf32(lambda: frontend.plain(x))
                          - want).abs().max())
        stft = STFT(size, shift, window_length=window_length,
                    window='blackman', fading='full',
                    complex_representation='stacked', dtype='float32')
        fbanks = frontend.bases_on('cuda')[2]

        def composed():
            spec = stft(x)
            power = spec[..., 0] ** 2 + spec[..., 1] ** 2
            return torch.log(power @ fbanks + 1e-12)

        composed_err = float((got - composed()).abs().max())
        ms = cuda_ms(lambda: frontend(x), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: frontend.plain(x), iters=20, warmup=3)
        composed_ms = cuda_ms(composed, iters=20, warmup=3)
        frames = got.shape[1]
        f_bins = size // 2 + 1
        length = window_length or size
        flops = batch * frames * 2 * (2 * length * f_bins + f_bins * n_mels)
        row = {'shape': label, 'max_abs_err': err, 'ms': ms,
               'plain_ms': plain_ms, 'library_ms': None,
               **bound(nbytes(x, got, *frontend.bases_on('cuda')[:3]), flops)}
        rows.append(row)
        print(f'phase 16 fused_logmel {label}: ({batch}, {samples}) -> '
              f'{tuple(got.shape)}, max |diff| vs plain {err:.3e} (tol '
              f'{LOGMEL_TOL}; values {float(want.min()):.1f} ... '
              f'{float(want.max()):.1f}), control plain with TF32 '
              f'{tf32_err:.3e}, vs the composed module path '
              f'{composed_err:.3e} (tol {LOGMEL_COMPOSED_TOL}); kernel '
              f'{ms:.3f} ms, plain {plain_ms:.3f} ms, composed '
              f'{composed_ms:.3f} ms, bound {row["bound_ms"]:.4f} ms by '
              f'{row["bound_by"]}')
        if got.shape != want.shape or not err <= LOGMEL_TOL:
            fail(f'fused_logmel disagrees with its plain version: {err}')
        if not tf32_err > LOGMEL_TOL:
            fail('the TF32 control passes the limit: the limit is too loose')
        if not composed_err <= LOGMEL_COMPOSED_TOL:
            fail(f'fused_logmel disagrees with the composed path: '
                 f'{composed_err}')
    return rows[0]


def wavenet_datasets(n_train, n_dev):
    """The wavenet recipe's --synthetic data: 1 s segments, batches of 2."""
    return (wn_data.prepare_dataset(
        wn_data.synthetic_database(num_examples=n, seed=seed), batch_size=2,
        segment_length=16000, shuffle=False, prefetch=False)
        for n, seed in ((n_train, 0), (n_dev, 1)))


def phase_wavenet_serving():
    """Phase 17: the full-width vocoder served from a storage dir the
    recipe's trainer wrote on the card.  Returns wavenet_sample's launches
    over the requests."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'wavenet' / '1'
        config = wn_train.get_trainer_config(storage_dir, {
            'stop_trigger': (2, 'epoch'),
            'summary_trigger': (2, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        trainer.to('cuda')
        train, dev = wavenet_datasets(4, 4)
        trainer.register_validation_hook(dev)
        trainer.train(train)
        model_cpu = WaveNetVocoder.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_loss.ptt').eval()
        print(f'phase 17a storage dir written by {trainer.iteration} '
              f'iterations of the wavenet recipe on the card and loaded '
              f'back')
        batch = next(iter(dev))
    check_wavenet_width(model_cpu)
    model = copy.deepcopy(model_cpu).to('cuda')
    net = model.wavenet

    with torch.no_grad():
        want = model_cpu(model_cpu.example_to_device(batch))
        example = model.example_to_device(batch)
        got = model(example)
        err = float((got['logits'].cpu() - want['logits']).abs().max())
        # the sampler under teacher forcing gives the training graph's
        # logits: position t of the graph is step t of the loop
        crop = 2000
        cond = net.get_cond_input(example['features'])
        cond = cond.reshape(cond.shape[0], net.n_layers, -1,
                            cond.shape[-1])[..., :crop]
        quantized = got['quantized'][:, :crop]
        forced = torch.cat([torch.full_like(quantized[:, :1], 128),
                            quantized[:, :-1]], dim=1)
        reset_launches()
        _, loop_logits = net.sample_kernel(
            cond, sample=False, forced_input=forced, return_logits=True)
        loop_err = float((loop_logits[..., 1:]
                          - got['logits'][..., 1:crop]).abs().max())
    print(f'phase 17b full-width vocoder on {tuple(batch["audio_data"].shape)}'
          f' audio, card vs CPU: max |diff| of logits {err:.3e}, equal '
          f'targets {torch.equal(got["quantized"].cpu(), want["quantized"])}; '
          f'the kernel under teacher forcing vs the training graph over '
          f'{crop} steps: {loop_err:.3e} (tol {WAVENET_MODEL_TOL}, largest '
          f'logit {float(want["logits"].abs().max()):.2f})')
    if got['logits'].shape != (2, 256, 16000) \
            or not torch.equal(got['quantized'].cpu(), want['quantized']) \
            or not err <= WAVENET_MODEL_TOL \
            or not loop_err <= WAVENET_MODEL_TOL \
            or wavenet_sample.launches != 1:
        fail('the vocoder on the card disagrees with the CPU or with its '
             'own training graph')

    # greedy synthesis of 1000 samples: the kernel against the CPU's loop
    features = torch.from_numpy(batch['features'][:1, :, :8])
    start = time.perf_counter()
    want_audio = model_cpu.wavenet.infer(features, sample=False)
    cpu_s = time.perf_counter() - start
    got_audio = net.infer(features.cuda(), sample=False).cpu()
    # neighbouring mu-law levels are at least 1.7e-4 apart
    same = float(((got_audio - want_audio).abs() <= 1e-5).float().mean())
    print(f'phase 17c greedy synthesis of {want_audio.shape[-1]} samples: '
          f'the card\'s kernel gives the CPU step loop\'s audio at '
          f'{same * 100:.1f} % of the samples (the CPU loop took '
          f'{cpu_s:.2f} s)')
    if got_audio.shape != (1, 1000) or same != 1.0:
        fail('greedy synthesis on the card leaves the CPU\'s')

    # requests of 1 s through the recipe's synthesize_example
    examples = [wn_data.extract_features(e) for e in wn_data.
                synthetic_database(num_examples=4, num_samples=16000, seed=2)]
    generator = torch.Generator().manual_seed(0)
    modes = (('one chunk', dict(chunk_length=48000, chunk_overlap=16000),
              examples[:2], 1),
             ('5 sequential chunks of 4200',
              dict(chunk_length=4000, chunk_overlap=1000), examples[:1], 5),
             ('5 parallel chunks of 4200',
              dict(chunk_length=4000, chunk_overlap=1000, parallel=True),
              examples, 1))
    total = 0
    for label, kwargs, requests, per_request in modes:
        reset_launches()
        latencies = []
        for example in requests:
            start = time.perf_counter()
            example_id, metrics, audio = wn_evaluate.synthesize_example(
                model, example, generator=generator, **kwargs)
            latencies.append(time.perf_counter() - start)
            if audio.shape != (16000,) or not np.isfinite(audio).all() \
                    or np.abs(audio).max() > 1 or len(np.unique(audio)) < 16 \
                    or not 0 < metrics['rmse'] < 2 \
                    or metrics['num_samples'] != 16000:
                fail(f'{example_id}: bad synthesis {metrics}')
        launches = wavenet_sample.launches
        total += launches
        median = float(np.median(latencies))
        print(f'phase 17d {len(requests)} requests of 1 s, {label}: latency '
              f's {[round(x, 4) for x in latencies]} (median {median:.4f}: '
              f'{median / 16000 * 1e6:.1f} us per sample, '
              f'{1 / median:.2f} x real time), launches {launches}, rmse '
              f'{metrics["rmse"]:.3f}')
        if launches != per_request * len(requests):
            fail(f'{label}: {per_request} launches per request expected, '
                 f'got {launches} for {len(requests)} requests')
    return total


def phase_wavenet_training():
    """Phase 18: the wavenet recipe's trainer at full width on the card."""
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'wavenet' / '1'
        config = wn_train.get_trainer_config(storage_dir, {
            'stop_trigger': (2, 'epoch'),
            'summary_trigger': (4, 'iteration')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        check_wavenet_width(trainer.model)
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')
        train, dev = wavenet_datasets(8, 4)

        start = time.perf_counter()
        trainer.test_run(train, dev)
        print(f'phase 18a wavenet test_run passed on the card in '
              f'{time.perf_counter() - start:.2f} s')
        recorder = Recorder(nonzero=True)
        trainer.register_hook(recorder)
        trainer.register_validation_hook(dev)
        start = time.perf_counter()
        trainer.train(train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        iterations = trainer.iteration
        losses = [float(x) for x in recorder.losses]
        norms = [float(x) for x in recorder.norms]
        hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
        half = iterations // 2
        print(f'phase 18b wavenet trained {iterations} iterations of 2 x '
              f'16000 samples in {seconds:.2f} s (validations and '
              f'checkpoints included); training loss first half mean '
              f'{np.mean(losses[:half]):.4f}, second half mean '
              f'{np.mean(losses[half:]):.4f}; ranking {hook.ckpt_ranking}')
        if iterations != 8 or len(losses) != 8 or len(norms) != 8:
            fail(f'expected 8 iterations, got {iterations}')
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f'non-finite loss or gradient norm: {losses} {norms}')
        if not np.mean(losses[half:]) < np.mean(losses[:half]):
            fail('the wavenet training loss did not fall')
        batch = next(iter(train))
        compare_first_step(
            '18c wavenet', losses, norms,
            *first_step_on_cpu(model_cpu, batch, tmp, 10.0),
            WAVENET_STEP_RTOL)
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_loss.ptt')
        loaded = WaveNetVocoder.from_storage_dir(storage_dir).to('cuda').eval()
        example = wn_data.extract_features(next(iter(
            wn_data.synthetic_database(num_examples=1, num_samples=4000,
                                       seed=2))))
        _, metrics, _ = wn_evaluate.synthesize_example(
            loaded, example, chunk_length=48000, chunk_overlap=16000)
        if not np.isfinite(metrics['rmse']):
            fail(f'bad metrics from the trained vocoder: {metrics}')
        print(f'phase 18d storage dir {names} loads; one request of 0.25 s '
              f'served from it: rmse {metrics["rmse"]:.3f}')
        t = timed_step(trainer, batch, loss_key=None, wrapper=None)
        print('phase 18e wavenet training step B=2 x 16000 samples: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items()))


def speaker_batch(batch, samples, num_speakers, seed=0):
    """A ragged batch of raw audio with random labels."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(samples // 2, samples + 1, size=batch)
    lens[0] = samples
    valid = np.arange(samples)[None, :] < lens[:, None]
    return {'audio_data': (rng.randn(batch, samples) * 0.1 * valid).astype(
                'float32'),
            'seq_len': lens.astype('int32'),
            'speaker_id': rng.randint(0, num_speakers, batch).astype('int32')}


def phase_speaker_clf():
    """Phase 19: the speaker-classification recipe with the on-device front
    end, trained and served on the card.  Returns the launches of
    fused_logmel and of the GRU kernels over the run, the requests and the
    full-width forwards and steps."""
    torch.manual_seed(0)
    epochs = 10
    with tempfile.TemporaryDirectory() as tmp:
        storage_dir = Path(tmp) / 'speaker_clf' / '1'
        storage_dir.mkdir(parents=True)
        train_ds, dev_ds = spk_train.synthetic_split(8)
        # the recipe shuffles its training set; here in a fixed order
        train_ds = train_ds[[int(i) for i in np.random.RandomState(
            0).permutation(len(train_ds))]]
        encoder = spk_data.get_label_encoder(storage_dir, train_ds)
        config = spk_train.get_trainer_config(
            storage_dir, len(encoder.label_mapping), on_device_features=True,
            updates={'stop_trigger': (epochs, 'epoch')})
        dump_config({'trainer': config}, storage_dir / 'config.json')
        trainer = Trainer.from_config(config)
        model_cpu = copy.deepcopy(trainer.model)
        trainer.to('cuda')
        train, dev = (spk_data.prepare_dataset_audio(
            ds, encoder, batch_size=8, shuffle=False, prefetch=False)
            for ds in (train_ds, dev_ds))
        n_train, n_dev = len(list(train)), len(list(dev))

        start = time.perf_counter()
        trainer.test_run(train, dev)
        print(f'phase 19a speaker classifier test_run passed on the card in '
              f'{time.perf_counter() - start:.2f} s')
        recorder = Recorder(nonzero=True)
        trainer.register_hook(recorder)
        trainer.register_validation_hook(dev, metric='accuracy',
                                         maximize=True)
        reset_launches()
        start = time.perf_counter()
        trainer.train(train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {'fused_logmel': fused_logmel.launches,
                    **gru_cell_scan.launches}
        iterations = trainer.iteration
        losses = [float(x) for x in recorder.losses]
        norms = [float(x) for x in recorder.norms]
        hook, = [h for h in trainer.hooks if isinstance(h, ValidationHook)]
        best = max(value for _, value in hook.ckpt_ranking)
        half = iterations // 2
        print(f'phase 19b speaker classifier trained {iterations} iterations '
              f'of 8 x 8000 samples in {seconds:.2f} s (validations and '
              f'checkpoints included), launches {launches}; training loss '
              f'first half mean {np.mean(losses[:half]):.4f}, second half '
              f'mean {np.mean(losses[half:]):.4f}; best validation accuracy '
              f'{best:.3f} (chance 0.125)')
        validations = epochs + 1
        want = {'fused_logmel': iterations + n_dev * validations,
                'fwd': n_dev * validations, 'fwd_train': iterations,
                'bwd': iterations}
        if iterations != epochs * n_train or launches != want:
            fail(f'launches {launches}, expected {want}: per step one '
                 f'fused_logmel, one GRU fwd_train and one bwd; per '
                 f'validation batch one fused_logmel and one GRU fwd')
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f'non-finite loss or gradient norm: {losses} {norms}')
        if not np.mean(losses[half:]) < np.mean(losses[:half]):
            fail('the speaker classifier\'s training loss did not fall')
        # between two readings of this run on an H100: 0.583 as it stands,
        # and exactly 0.25 when the training set was left unshuffled (one
        # speaker per batch), where the classifier learns nothing that
        # carries over to the dev set although its loss falls
        if not best >= 0.4:
            fail(f'validation accuracy {best} is no better than a '
                 f'classifier that learned nothing (0.25)')
        batch = next(iter(train))
        compare_first_step(
            '19c speaker classifier', losses, norms,
            *first_step_on_cpu(model_cpu, batch, tmp, 10.0),
            SPEAKER_STEP_RTOL)
        names = check_storage_dir(storage_dir, iterations,
                                  'ckpt_best_accuracy.ptt')

        # serving: the storage dir loaded back, its dev batches as requests
        loaded_cpu = SpeakerClf.from_storage_dir(
            storage_dir, checkpoint_name='ckpt_best_accuracy.ptt').eval()
        loaded = copy.deepcopy(loaded_cpu).to('cuda')
        reset_launches()
        results, latencies = {}, []
        for request in dev:
            start = time.perf_counter()
            results.update(spk_evaluate.evaluate_batch(loaded, request))
            latencies.append((time.perf_counter() - start) * 1e3)
        served = {'fused_logmel': fused_logmel.launches,
                  **gru_cell_scan.launches}
        reference = spk_evaluate.evaluate_batch(loaded_cpu, next(iter(dev)))
        diff = max(abs(results[k]['confidence'] - v['confidence'])
                   for k, v in reference.items())
        same = all(results[k]['predicted_label'] == v['predicted_label']
                   for k, v in reference.items())
        accuracy = float(np.mean([v['hit'] for v in results.values()]))
        print(f'phase 19d storage dir {names} loads; {n_dev} requests of up '
              f'to 8 x 8000 samples: latency ms '
              f'{[round(x, 3) for x in latencies]}, launches {served}, '
              f'accuracy {accuracy:.3f} over {len(results)} utterances; card '
              f'vs CPU on the first request: same labels {same}, max |diff| '
              f'of confidence {diff:.3e} (tol {SPEAKER_TOL})')
        if served != {'fused_logmel': n_dev, 'fwd': n_dev, 'fwd_train': 0,
                      'bwd': 0} or len(results) != len(dev_ds):
            fail(f'{n_dev} requests launch one fused_logmel and one GRU '
                 f'forward each, got {served}')
        if not same or not diff <= SPEAKER_TOL:
            fail('the speaker classifier on the card disagrees with the CPU')

        # the class defaults on 16 x 4 s of audio
        torch.manual_seed(0)
        full = Trainer(
            SpeakerClf(FusedAudioLogMelExtractor(16000, 512, 128, 64)),
            Path(tmp) / 'full', Adam(gradient_clipping=10.0, lr=3e-4))
        model = full.model
        width = (model.head.out_features, model.cnn[0].out_channels,
                 model.cnn[2].out_channels, model.gru.hidden_size,
                 model.gru.input_size)
        if width != (251, 32, 64, 256, 1024):
            fail(f'not the full-width speaker classifier: {width}')
        full_cpu = copy.deepcopy(model).eval()
        full.to('cuda')
        batch = speaker_batch(16, 64000, 251)

        def counts():
            return {'fused_logmel': fused_logmel.launches,
                    **gru_cell_scan.launches}

        reset_launches()
        with torch.no_grad():
            model.eval()
            example = model.example_to_device(batch)
            got = model(example).cpu()
            want = full_cpu(full_cpu.example_to_device(batch))
            err = float((got - want).abs().max())
            forward_ms = cuda_ms(lambda: model(example), iters=5, warmup=2)
            front_ms = cuda_ms(lambda: model.feature_extractor(
                example['audio_data'], seq_len=example['seq_len']),
                iters=5, warmup=2)
        full_forward = counts()
        print(f'phase 19e full-width speaker classifier (251 speakers, '
              f'(32, 64) channels, 256 GRU units) on 16 x 64000 samples: '
              f'logits {tuple(got.shape)}, card vs CPU max |diff| {err:.3e} '
              f'(tol {SPEAKER_TOL}); forward {forward_ms:.3f} ms, of it the '
              f'front end with its normalization {front_ms:.3f} ms; '
              f'launches {full_forward}')
        if full_forward != {'fused_logmel': 15, 'fwd': 8, 'fwd_train': 0,
                            'bwd': 0}:
            fail(f'8 forwards and 7 front ends alone launch 15 fused_logmel '
                 f'and 8 GRU forwards, got {full_forward}')
        if got.shape != (16, 251) or not err <= SPEAKER_TOL:
            fail(f'the full-width speaker classifier on the card disagrees '
                 f'with the CPU: {err}')
        t = timed_step(full, batch, loss_key=None, wrapper=gru_cell_scan,
                       per_step=1)
        full_step = counts()     # of the 5 timed steps
        print('phase 19e full-width training step 16 x 64000 samples: '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in t.items())
              + f'; launches {full_step}')
    return {name: launches[name] + served[name] + full_forward[name]
            + full_step[name] for name in launches}


# the decoder of bench.py's int8 decode benchmark (its bench_int8_decode)
DECODER = dict(d_model=1024, num_layers=12, num_heads=16)
VOCAB, MEMORY_FRAMES, NEW_TOKENS = 1024, 128, 128
INT8_WEIGHTS = [(1024, 1024), (1024, 4096), (4096, 1024)]
INT8_ROWS = (1, 8, 16, 32, 64, 128, 256)
INT8_ROW_SHAPE = (1, 1024, 4096, torch.bfloat16)   # the kernels line's row


def int8_inputs(m, k, n, dtype, seed=0):
    """Activations, int8 weights and scales of a Linear(k, n) (outputs of
    about 1), and a bias."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(m, k), dtype=dtype, device='cuda')
    w_q = torch.tensor(rng.randint(-127, 128, (k, n)), dtype=torch.int8,
                       device='cuda')
    scale = torch.tensor((rng.rand(n) * 0.5 + 0.75) / (127 * np.sqrt(k)),
                         dtype=torch.float32, device='cuda')
    bias = torch.tensor(rng.randn(n), dtype=torch.float32, device='cuda')
    return x, w_q, scale, bias


def bf16_ulps(got, want):
    """Largest |got - want| in units of one bf16 unit in the last place of
    want plus the float32 limit of the sums' order (INT8_TOL of the largest
    output: an output near zero is a float32 sum with cancellation)."""
    mag = want.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    limit = ulp + INT8_TOL * float(mag.max())
    return float(((got.float() - want.float()).abs() / limit).max())


def composed_route(x, w_q, scale, bias):
    """QuantizedLinear's composed route: the weight scaled in x's type."""
    y = x @ (w_q.to(x.dtype) * scale.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


def int8_case(m, k, n, dtype):
    """Kernel against plain (with and without bias) at one shape; the
    composed route as the control.  Returns the row of numbers."""
    x, w_q, scale, bias = int8_inputs(m, k, n, dtype)
    err = {}
    for b in (bias, None):
        got = int8_matmul(x, w_q, scale, b)
        want = int8_matmul_plain(x, w_q, scale, b)
        control = composed_route(x, w_q, scale, b)
        torch.cuda.synchronize()
        key = 'bias' if b is not None else 'no bias'
        if dtype == torch.float32:
            err[key] = (max_rel_err([got], [want]),
                        float((got - want).abs().max()))
        else:
            err[key] = (bf16_ulps(got, want),
                        float((got.float() - want.float()).abs().max()))
            err[key + ', composed route'] = (bf16_ulps(control, want), None)
    limit = INT8_TOL if dtype == torch.float32 else INT8_BF16_ULPS
    for key, (e, _) in err.items():
        if 'composed' in key:
            if not e > limit:
                fail(f'int8_matmul at ({m}, {k}, {n}) bf16: the composed '
                     f'route passes the limit ({e} ulps): the limit does not '
                     f'tell the two rounding routes apart')
        elif not e <= limit:
            fail(f'int8_matmul kernel disagrees with plain at ({m}, {k}, {n}) '
                 f'{dtype}, {key}: {e}')
    w_deq = w_q.to(dtype) * scale.to(dtype)
    bias_x = bias.to(dtype)
    routes = {
        '': lambda: int8_matmul(x, w_q, scale, bias),
        'plain_': lambda: int8_matmul_plain(x, w_q, scale, bias),
        'composed_': lambda: composed_route(x, w_q, scale, bias),
        'library_': lambda: torch.addmm(bias_x, x, w_deq),
    }
    # a call's device time from CUDA-graph replays (the kernels line), its
    # eager time, which at these sizes is the host's, and the host's own
    # time to enqueue one call
    times = {}
    for key, fn in routes.items():
        times[key + 'ms'] = graph_ms(fn)
        times[key + 'eager_ms'] = cuda_ms(fn, iters=50, warmup=2)
        times[key + 'host_us'] = host_us(fn)
    out_bytes = m * n * x.element_size()
    # bf16 products are exact on the tensor cores (int8 weights widen to
    # bf16 exactly, sums in float32): their peak bounds the operations
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    limits = bound(nbytes(x, w_q, scale, bias) + out_bytes, 2.0 * m * k * n,
                   peak)
    return {'err': err, 'max_abs_err': err['bias'][1], **times, **limits}


def host_us(fn, calls=100):
    """Microseconds of host time to enqueue one call (the card is left to
    catch up afterwards)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def int8_batch_bits():
    """bf16: every row of a batch of 1 ... 256 equals the row alone, bit
    for bit, at the decoder's shapes; two calls in a row and calls replayed
    from a CUDA graph give the same bits (the per-tile counters are back at
    0 after every launch)."""
    checked = 0
    for k, n in INT8_WEIGHTS:
        x, w_q, scale, bias = int8_inputs(256, k, n, torch.bfloat16)
        full = int8_matmul(x, w_q, scale, bias)
        for m in (1, 2, 3, 8, 16, 31, 32, 64, 100, 128, 255):
            if not torch.equal(int8_matmul(x[:m], w_q, scale, bias),
                               full[:m]):
                fail(f'int8_matmul ({k}, {n}) bf16: the first {m} rows of '
                     f'a batch of 256 differ from the same rows alone')
            checked += 1
        for i in (0, 97, 255):
            if not torch.equal(int8_matmul(x[i:i + 1], w_q, scale, bias)[0],
                               full[i]):
                fail(f'int8_matmul ({k}, {n}) bf16: row {i} of a batch of '
                     f'256 differs from the row alone')
            checked += 1
        if not torch.equal(int8_matmul(x, w_q, scale, bias), full):
            fail(f'int8_matmul ({k}, {n}) bf16: two calls differ')
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            int8_matmul(x[:8], w_q, scale, bias)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = [int8_matmul(x[:m], w_q, scale, bias)
                        for m in (8, 128, 8)]
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(out, full[:out.shape[0]]) for out in replayed):
            fail(f'int8_matmul ({k}, {n}) bf16: calls replayed from a CUDA '
                 f'graph differ from eager ones')
        if not torch.equal(int8_matmul(x, w_q, scale, bias), full):
            fail(f'int8_matmul ({k}, {n}) bf16: a call after the graph '
                 f'differs')
        del graph
    print(f'phase 20 int8_matmul bf16: {checked} batches and rows equal to '
          f'the same rows of a batch of 256 bit for bit at the three '
          f'decoder shapes; repeated calls and CUDA-graph replays equal')


def int8_dispatch_rows():
    """The kernel route against the composed route of QuantizedLinear
    (bf16) by rows of x: where the kernel stops winning sets
    INT8_KERNEL_MAX_ROWS."""
    wins = {}
    for k, n in INT8_WEIGHTS:
        torch.manual_seed(0)
        layer = QuantizedLinear.from_linear(
            torch.nn.Linear(k, n).to('cuda', torch.bfloat16))
        cells = []
        for m in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            x = torch.randn((m, k), device='cuda', dtype=torch.bfloat16)
            ms = {}
            for route in (True, False):
                layer.use_kernel = route
                with torch.no_grad():
                    ms[route] = graph_ms(lambda: layer(x))
            wins.setdefault(m, []).append(ms[True] <= ms[False])
            cells.append(f'{m}: {ms[True]:.4f} / {ms[False]:.4f}')
        print(f'phase 20 dispatch ({k}, {n}) bf16, device ms (CUDA graph) '
              f'kernel / composed by rows: ' + ', '.join(cells))
    measured = 0
    for m in sorted(wins):
        if not all(wins[m]):
            break
        measured = m
    print(f'phase 20 dispatch: the kernel wins at every shape up to '
          f'{measured} rows; INT8_KERNEL_MAX_ROWS is '
          f'{int8_kernels.INT8_KERNEL_MAX_ROWS}')


def phase_int8_kernel():
    """Phase 20: int8_matmul against its plain version at the decoder's
    shapes, timed beside plain, the composed route, cuBLAS on the
    dequantized weight and the bound; the TF32 control; the dispatch rows.
    Returns the kernel's row at INT8_ROW_SHAPE."""
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for k, n in INT8_WEIGHTS + [(1000, 1030)]:
            for m in INT8_ROWS if (k, n) != (1000, 1030) else (1, 8, 37, 70):
                r = int8_case(m, k, n, dtype)
                name = 'f32' if dtype == torch.float32 else 'bf16'
                print(f'phase 20 int8_matmul M={m} K={k} N={n} {name}: '
                      + ', '.join(f'{key} {e:.3g}' for key, (e, _) in
                                  r['err'].items())
                      + (' (relative, tol 1e-5)' if name == 'f32' else
                         ' (ulps, tol 1)')
                      + f'; device ms (CUDA graph; eager in brackets) '
                      f'kernel {r["ms"]:.4f} ({r["eager_ms"]:.4f}), plain '
                      f'{r["plain_ms"]:.4f} ({r["plain_eager_ms"]:.4f}), '
                      f'composed {r["composed_ms"]:.4f} '
                      f'({r["composed_eager_ms"]:.4f}), addmm on the '
                      f'dequantized {name} weight {r["library_ms"]:.4f} '
                      f'({r["library_eager_ms"]:.4f}), bound '
                      f'{r["bound_ms"]:.5f} ms by {r["bound_by"]} '
                      f'({r["peak"]} peak); host us per eager call kernel '
                      f'{r["host_us"]:.1f}, addmm {r["library_host_us"]:.1f}')
                if (m, k, n, dtype) == INT8_ROW_SHAPE:
                    row = {key: r[key] for key in (
                        'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                        'bound_by', 'peak', 'library_ms')}
                torch.cuda.empty_cache()
    x, w_q, scale, bias = int8_inputs(32, 1024, 1024, torch.float32)
    want = int8_matmul_plain(x, w_q, scale, bias)
    tf32 = max_rel_err([with_tf32(lambda: int8_matmul_plain(
        x, w_q, scale, bias))], [want])
    print(f'phase 20 control, plain with TF32 products at M=32 K=N=1024: '
          f'{tf32:.3e} relative')
    if not tf32 > INT8_TOL:
        fail('the TF32 control passes the int8_matmul limit')
    for bad, what in (
            (lambda: int8_matmul(x.half(), w_q, scale), 'a float16 x'),
            (lambda: int8_matmul(x.clone().requires_grad_(), w_q, scale),
             'an x that requires a gradient'),
            (lambda: int8_matmul(x, w_q.cpu(), scale), 'a weight on the CPU'),
            (lambda: int8_matmul(x[:, :1000], w_q, scale), 'a K mismatch')):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        fail(f'int8_matmul took {what}')
    int8_batch_bits()
    int8_dispatch_rows()
    return row


def full_width_decoder():
    """bench.py's int8 decode model from seed 0: the decoder, its head,
    and (numpy seed 0) the embedding table x 0.05 and 128 frames of
    memory, all float32 on the card."""
    torch.manual_seed(0)
    dec = TransformerDecoder(**DECODER).eval()
    head = torch.nn.Linear(DECODER['d_model'], VOCAB).eval()
    n_params = sum(p.numel() for p in (*dec.parameters(), *head.parameters()))
    rng = np.random.RandomState(0)
    emb = torch.tensor(rng.randn(VOCAB, DECODER['d_model']) * 0.05,
                       dtype=torch.float32)
    memory = torch.tensor(
        rng.randn(1, MEMORY_FRAMES, DECODER['d_model']), dtype=torch.float32)
    return dec.cuda(), head.cuda(), emb.cuda(), memory.cuda(), n_params


def set_int8_route(modules, use_kernel):
    for module in modules:
        for m in module.modules():
            if isinstance(m, QuantizedLinear):
                m.use_kernel = use_kernel


def generate(dec, head, emb, memory, max_len=NEW_TOKENS, **kwargs):
    return autoregressive_generate(
        dec, memory, embed=lambda t: emb[t], logits_head=head, bos_id=0,
        max_len=max_len, **kwargs)


def us_per_token(dec, head, emb, memory):
    """Best of 3 generations of NEW_TOKENS after a warm-up, host clock
    ended by a synchronize; and the last generation's tokens."""
    generate(dec, head, emb, memory)
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(3):
        start = time.perf_counter()
        tokens, _ = generate(dec, head, emb, memory)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - start)
    return best / NEW_TOKENS * 1e6, tokens


def profile_decode(settings, n_tokens=32):
    """``--profile``: the card's busy time per token of the B=1 decode
    (torch.profiler, the device's kernel events) against the host clock of
    the same generation under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, (d, h, e, mem) in settings.items():
        generate(d, h, e, mem, max_len=n_tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            generate(d, h, e, mem, max_len=n_tokens)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
        busy = sum(ev.self_device_time_total for ev in kernels) / 1e3
        int8 = sum(ev.self_device_time_total for ev in kernels
                   if 'int8_matmul' in ev.key) / 1e3
        launches = sum(ev.count for ev in kernels)
        print(f'phase 21 profile {name}, {n_tokens} tokens: '
              f'{wall_ms / n_tokens:.1f} ms per token under the profiler, '
              f'card busy {busy / n_tokens * 1e3:.1f} us per token '
              f'({busy / wall_ms:.1%}), {launches / n_tokens:.0f} kernels '
              f'per token, int8_matmul {int8 / n_tokens * 1e3:.1f} us')
        print(prof.key_averages().table(sort_by='self_device_time_total',
                                        row_limit=8))


def phase_decode(profile=False):
    """Phase 21: bench.py's int8 decode at full width, B=1, 128 greedy
    tokens, in four settings; decode against forward in float32; the int8
    kernel route against the composed route on bf16 forward logits; the
    kernel's launches in one generation; with ``profile`` the card's busy
    time per token.  Returns (launches, modules)."""
    dec, head, emb, memory, n_params = full_width_decoder()
    d_model = DECODER['d_model']
    # float32: teacher-forced decode_step logits against one forward (its
    # causal self-attention on the flash_attention kernel)
    with torch.no_grad():
        tokens, _ = generate(dec, head, emb, memory)
        inputs = torch.cat([torch.zeros_like(tokens[:, :1]),
                            tokens[:, :-1]], 1).long()
        x = emb[inputs]
        before = flash_attention.launches['fwd']
        want = head(dec(x, memory))
        fwd_launches = flash_attention.launches['fwd'] - before
        cache = dec.init_cache(memory, NEW_TOKENS)
        got = torch.cat([head(dec.decode_step(x[:, t:t + 1], cache, t)[0])
                         for t in range(NEW_TOKENS)], 1)
    err = max_rel_err([got], [want])
    print(f'phase 21 full-width decoder ({n_params} parameters, d_model '
          f'{d_model}, 12 layers, 16 heads, vocabulary {VOCAB}, memory '
          f'{MEMORY_FRAMES} frames), float32: teacher-forced decode_step '
          f'logits vs forward over {NEW_TOKENS} positions {err:.3e} relative '
          f'(tol {DECODE_RTOL}); the forward launched flash_attention '
          f'{fwd_launches} times')
    if not err <= DECODE_RTOL:
        fail(f'decode_step disagrees with the forward: {err}')
    if fwd_launches < DECODER['num_layers']:
        fail(f'the float32 forward launched flash_attention {fwd_launches} '
             f'times, less than once per layer')
    del got, want, cache
    settings = {'f32 plain': (dec, head, emb, memory)}
    dec16 = copy.deepcopy(dec).to(torch.bfloat16)
    head16 = copy.deepcopy(head).to(torch.bfloat16)
    emb16, memory16 = emb.to(torch.bfloat16), memory.to(torch.bfloat16)
    settings['bf16 plain'] = (dec16, head16, emb16, memory16)
    q_dec = copy.deepcopy(dec16)
    quantize_module(q_dec)
    q_head = QuantizedLinear.from_linear(head16)
    settings['bf16 int8 composed'] = settings['bf16 int8 kernel'] = (
        q_dec, q_head, emb16, memory16)
    # the kernel route against the composed route on forward logits
    xs = torch.tensor(np.random.RandomState(0).randn(1, 4, d_model) * 0.05,
                      dtype=torch.bfloat16, device='cuda')
    logits = {}
    with torch.no_grad():
        for route in (True, False):
            set_int8_route((q_dec, q_head), route)
            logits[route] = q_head(q_dec(xs, memory16)).float()
    parity = float(((logits[True] - logits[False]).abs()
                    / (1 + logits[False].abs())).max())
    print(f'phase 21 int8 kernel vs composed route, bf16 forward logits: '
          f'{parity:.3e} (tol {INT8_ROUTES_RTOL})')
    if not parity < INT8_ROUTES_RTOL:
        fail(f'the int8 kernel route disagrees with the composed route: '
             f'{parity}')
    # the main path: one generation on the kernel, its launches counted
    set_int8_route((q_dec, q_head), True)
    reset_launches()
    with torch.no_grad():
        kernel_tokens, _ = generate(q_dec, q_head, emb16, memory16)
        torch.cuda.synchronize()
    launches = int8_matmul.launches
    want_launches = (2 * DECODER['num_layers']
                     + NEW_TOKENS * (8 * DECODER['num_layers'] + 1))
    print(f'phase 21 int8 kernel decode: {launches} int8_matmul launches '
          f'(expected {want_launches}: 24 cross K/V projections of 128 rows, '
          f'then 97 per token)')
    if launches != want_launches:
        fail(f'the kernel decode launched int8_matmul {launches} times')
    results, tokens = {}, {}
    for name, (d, h, e, mem) in settings.items():
        if name.startswith('bf16 int8'):
            set_int8_route((d, h), name.endswith('kernel'))
        results[name], tokens[name] = us_per_token(d, h, e, mem)
        if not bool(torch.isfinite(tokens[name].float()).all()):
            fail(f'{name}: generation is not finite')
        torch.cuda.empty_cache()
    if not torch.equal(tokens['bf16 int8 kernel'], kernel_tokens):
        fail('two kernel generations of the same request differ')
    same = float((tokens['bf16 int8 kernel']
                  == tokens['bf16 int8 composed']).float().mean())
    print('phase 21 B=1 greedy decode of 128 tokens, us per token (best of '
          '3, host clock): ' + ', '.join(
              f'{name} {us:.1f}' for name, us in results.items())
          + f'; kernel and composed routes pick the same token at '
          f'{same:.0%} of the positions (not a parity target)')
    set_int8_route((q_dec, q_head), True)
    if profile:
        profile_decode({name: settings[name]
                        for name in ('bf16 plain', 'bf16 int8 kernel')})
    del settings, dec, dec16, head16, tokens
    torch.cuda.empty_cache()
    return launches, (q_dec, q_head, emb16)


def phase_serving(models):
    """Phase 22: ContinuousBatcher at full width, bf16, int8 kernel, 8
    slots; 16 requests (memory of 32 to 128 frames, 16 to 64 new tokens)
    against each decoded alone.  Returns the kernel's launches."""
    q_dec, q_head, emb16 = models
    d_model = DECODER['d_model']
    rng = np.random.RandomState(1)
    requests = [(torch.tensor(rng.randn(int(s), d_model),
                              dtype=torch.bfloat16, device='cuda'), int(c))
                for s, c in zip(rng.randint(32, 129, 16),
                                rng.randint(16, 65, 16))]
    seen = {}
    batcher = None

    def recording_head(x):
        out = q_head(x)
        for slot, rid in enumerate(batcher._request):
            if rid is not None:
                seen.setdefault(rid, []).append(out[slot].float().cpu())
        return out

    def serve(head):
        nonlocal batcher
        batcher = ContinuousBatcher(
            q_dec, embed=lambda t: emb16[t], logits_head=head, num_slots=8,
            max_len=64, max_memory_len=MEMORY_FRAMES, d_memory=d_model,
            bos_id=0, eos_id=1, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        start = time.perf_counter()
        ids = [batcher.submit(mem, max_new_tokens=cap)
               for mem, cap in requests]
        steps = 0
        while batcher.pending or batcher.active.any():
            batcher.step()
            steps += 1
        torch.cuda.synchronize()
        return ids, dict(batcher.finished), steps, time.perf_counter() - start

    reset_launches()
    ids, outputs, steps, _ = serve(recording_head)
    launches = int8_matmul.launches
    _, _, steps2, seconds = serve(q_head)
    n_tokens = sum(len(outputs[rid]) for rid in ids)
    print(f'phase 22 served 16 requests in {steps2} steps of 8 slots: '
          f'{seconds:.3f} s, {16 / seconds:.2f} requests/s, '
          f'{n_tokens / seconds:.1f} tokens/s, '
          f'{seconds / steps2 * 1e6:.1f} us per step; int8_matmul launches '
          f'{launches} in the recorded run ({steps} steps)')
    if launches == 0:
        fail('the batcher never launched int8_matmul')
    worst, ties = 0.0, 0
    for rid, (mem, cap) in zip(ids, requests):
        alone = []

        def head_alone(x, alone=alone):
            out = q_head(x)
            alone.append(out[0].float().cpu())
            return out

        with torch.no_grad():
            tokens, lengths = generate(q_dec, head_alone, emb16, mem[None],
                                       max_len=cap, eos_id=1)
        want = tokens[0, :int(lengths[0])].tolist()
        got = outputs[rid]
        n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        scale = max(float(a.abs().max()) for a in alone)
        for a, b in zip(seen[rid][:n + 1], alone[:n + 1]):
            worst = max(worst, float((a - b).abs().max()) / scale)
        if got == want:
            continue
        if n >= len(alone) or not bool(near_ties(
                alone[n], 2 * SERVE_LOGIT_RTOL * scale)):
            fail(f'request {rid}: the batcher gives {got}, alone {want}, '
                 f'not at a near tie')
        ties += 1
    print(f'phase 22 each request against itself decoded alone: logits '
          f'{worst:.3e} relative (tol {SERVE_LOGIT_RTOL}), tokens equal but '
          f'at {ties} near ties')
    if not worst <= SERVE_LOGIT_RTOL:
        fail(f'batched logits disagree with single decoding: {worst}')
    return launches


def main():
    profile = '--profile' in sys.argv[1:]
    phase_device()
    phase_build()
    lstm, library = phase_lstm()
    istft = phase_istft()
    launches = phase_slice()
    train_kernels, kernel_times = phase_train_kernels(library)
    train_launches = phase_training(kernel_times, profile=profile)
    for name in ('fwd_train', 'bwd'):
        if train_launches[name] == 0:
            fail(f'the training path never launched the {name} kernel')
    gru = phase_gru_kernels()
    lstm_dprnn = phase_lstm_at_dprnn_shapes()
    served = {rnn_type: phase_tasnet_serving(rnn_type)
              for rnn_type in ('bgru', 'blstm')}
    trained = {rnn_type: phase_tasnet_training(rnn_type, profile=profile)
               for rnn_type in ('bgru', 'blstm')}
    attention = phase_attention_kernels()
    sepformer_served = phase_sepformer_serving()
    sepformer_trained = phase_tasnet_training('sepformer', profile=profile)
    wavenet = phase_wavenet_kernel()
    torch.cuda.empty_cache()
    logmel = phase_logmel_kernel()
    wavenet_launches = phase_wavenet_serving()
    phase_wavenet_training()
    torch.cuda.empty_cache()
    speaker = phase_speaker_clf()
    torch.cuda.empty_cache()
    int8_row = phase_int8_kernel()
    torch.cuda.empty_cache()
    int8_launches, decoder_models = phase_decode(profile=profile)
    serve_launches = phase_serving(decoder_models)
    del decoder_models
    torch.cuda.empty_cache()
    if wavenet_launches == 0:
        fail('the vocoder\'s requests never launched the wavenet_sample '
             'kernel')
    for name, n in speaker.items():
        if n == 0:
            fail(f'the speaker classifier\'s path never launched '
                 f'{name}')
    attention_launches = {
        'fwd': sepformer_served + sepformer_trained['fwd']
        + sepformer_trained['fwd_train'],
        'bwd': sepformer_trained['bwd']}
    for name, n in attention_launches.items():
        if n == 0:
            fail(f'the SepFormer paths never launched the attention {name} '
                 f'kernel')
    # the GRU kernels' launches: the TasNet paths with GRU chunk RNNs plus
    # the speaker classifier's
    gru_launches = {
        'fwd': served['bgru'] + trained['bgru']['fwd'] + speaker['fwd'],
        'fwd_train': trained['bgru']['fwd_train'] + speaker['fwd_train'],
        'bwd': trained['bgru']['bwd'] + speaker['bwd']}
    for name, n in gru_launches.items():
        if n == 0:
            fail(f'the TasNet paths never launched the gru {name} kernel')
    # the LSTM kernels' launches: the uPIT paths plus the TasNet paths
    # with LSTM chunk RNNs
    lstm_launches = {
        'fwd': launches['lstm_cell_scan'] + served['blstm']
        + trained['blstm']['fwd'],
        'fwd_train': train_launches['fwd_train']
        + trained['blstm']['fwd_train'],
        'bwd': train_launches['bwd'] + trained['blstm']['bwd']}
    print(f'launches on the main paths: lstm {lstm_launches} (uPIT serving '
          f'{launches["lstm_cell_scan"]}, uPIT training {train_launches}, '
          f'TasNet blstm serving {served["blstm"]}, training '
          f'{trained["blstm"]}); gru {gru_launches}; LSTM kernels at '
          f'DPRNN shapes (ms): {lstm_dprnn}; attention '
          f'{attention_launches} (SepFormer serving {sepformer_served} '
          f'lean forward, training {sepformer_trained}); wavenet_sample '
          f'{wavenet_launches} (the vocoder\'s requests); speaker '
          f'classifier {speaker}; int8_matmul {int8_launches} (one B=1 '
          f'decode of 128 tokens), {serve_launches} (16 batched requests)')
    # every row's numbers are those of its ``shape``: the GRU rows those of
    # the intra-chunk shape, which six of a TasNet's twelve chunk RNNs run
    # (phase 8 prints the rows of the other shapes, the classifier's two
    # among them); the LSTM rows those of the uPIT flagship layer
    gru_rows = gru[RECURRENCE_SHAPES[0][0]]
    flagship = 'T=500 D*B=32 H=600 ragged'
    print('gru kernels at the speaker classifier\'s shapes: ' + json.dumps(
        {shape[0]: gru[shape[0]] for shape in CLASSIFIER_GRU_SHAPES}))
    # the attention rows are those of the intra-chunk shape (8 of a
    # model's 16 layers); the forward row counts lean and training launches
    attention_rows = attention[ATTENTION_CASES[0][0]]
    kernels = [
        {'name': 'lstm_cell_scan', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:275',
         'launches': lstm_launches['fwd'], 'shape': flagship, **lstm},
        {'name': 'lstm_cell_scan_train', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:293',
         'launches': lstm_launches['fwd_train'], 'shape': flagship,
         **train_kernels['fwd_train']},
        {'name': 'lstm_cell_scan_bwd', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:339',
         'launches': lstm_launches['bwd'], 'shape': flagship,
         **train_kernels['bwd']},
        {'name': 'masked_istft', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/masked_istft.cu',
         'replaces': 'padertorch_tpu/ops/pallas/masked_istft.py:135',
         'launches': launches['masked_istft'],
         'shape': 'K=2 T=127 F=257', **istft[(2, 127)]},
        {'name': 'gru_cell_scan', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:182',
         'launches': gru_launches['fwd'], **gru_rows['fwd']},
        {'name': 'gru_cell_scan_train', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:198',
         'launches': gru_launches['fwd_train'], **gru_rows['fwd_train']},
        {'name': 'gru_cell_scan_bwd', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/gru_cell_scan_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/gru.py:259',
         'launches': gru_launches['bwd'], **gru_rows['bwd']},
        {'name': 'flash_attention', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/flash_attention.cu',
         'replaces': 'padertorch_tpu/ops/pallas/attention.py:328',
         'launches': attention_launches['fwd'],
         'shape': ATTENTION_CASES[0][0], **attention_rows['fwd']},
        {'name': 'flash_attention_bwd', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/flash_attention_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/attention.py:351',
         'launches': attention_launches['bwd'],
         'shape': ATTENTION_CASES[0][0], **attention_rows['bwd']},
        {'name': 'wavenet_sample', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/wavenet_sample.cu',
         'replaces': 'padertorch_tpu/ops/pallas/wavenet.py:192',
         'launches': wavenet_launches, **wavenet},
        {'name': 'fused_logmel', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/fused_logmel.cu',
         'replaces': 'padertorch_tpu/ops/pallas/logmel.py:78',
         'launches': speaker['fused_logmel'], **logmel},
        {'name': 'int8_matmul', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/int8_matmul.cu',
         'replaces': 'padertorch_tpu/ops/pallas/int8_matmul.py:85',
         'launches': int8_launches, 'shape': 'M=1 K=1024 N=4096 bf16',
         **int8_row},
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
