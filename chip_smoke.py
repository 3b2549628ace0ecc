"""Drive the PyTorch port's uPIT, DPRNN-TasNet and SepFormer-TasNet
separation and training paths once on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, one line each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
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
   ragged), each with the TF32 control that must fail the limit, and one
   bidirectional ``torch.nn.GRU`` layer (cuDNN) of the same sizes as a
   yardstick.
9. the three LSTM kernels vs plain at the DPRNN's two shapes, timed.
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
    (float32, TF32 off) and its bound.  Then the dispatch table: one
    ``MultiheadAttention`` forward and forward + backward on the fused and
    on the dense backend at (8, T, 12 x 64) for T = 512 ... 4096, full,
    causal and windowed, and at the SepFormer's two shapes; the table
    is printed beside what ``should_use_flash`` picks.
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

The line before the last is a JSON object with each kernel's launches on
the main paths, its largest difference from the plain version, its time,
the plain version's, the library call's where there is one, and the
least time the card could take (``bound_ms``: the larger of bytes over
3.35 TB/s and float32 operations over 67 TFLOP/s, NVIDIA's H100 SXM data
sheet); the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero and prints no result; without
a CUDA card it fails at phase 1.  ``--profile`` adds a ``torch.profiler``
table of one training step per shape.
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

from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data as pit_data, train as pit_train)
from padertorch_tpu_torch.contrib.examples.source_separation.pit.evaluate \
    import evaluate_example
from padertorch_tpu_torch.contrib.examples.source_separation.tasnet import (
    data as tas_data, evaluate as tas_evaluate, train as tas_train)
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
    should_use_flash, visible_mask)
from padertorch_tpu_torch.ops.kernels.gru import (
    gru_cell_scan, gru_cell_scan_plain, gru_cell_scan_train_plain,
    gru_cell_scan_bwd_plain)
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_plain, lstm_cell_scan_train_plain,
    lstm_cell_scan_bwd_plain, recurrent_weight_grad)
from padertorch_tpu_torch.utils.nested import nested_merge
from padertorch_tpu_torch.ops.kernels.masked_istft import (
    masked_istft, masked_istft_plain)
from padertorch_tpu_torch.train.hooks import Hook, ValidationHook
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.trainer import Trainer

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

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM, float32 outside the tensor cores


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


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def max_rel_err(a, b):
    """Largest difference relative to each reference's largest entry."""
    return max(float((x - y).abs().max() / y.abs().max())
               for x, y in zip(a, b))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, flops):
    """The least time the card could take for the work: each input read
    and each output written once at the memory's peak rate, or the
    operations at the float32 peak, whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return {'bound_ms': max(by_bytes, by_ops),
            'bound_by': 'bytes' if by_bytes >= by_ops else 'operations'}


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def recurrence_mask(t_len, batch, kind, rng):
    """(T, 2 * batch) mask of both directions, or None.  'chunks': the
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
    return np.concatenate([fwd, fwd[::-1]], axis=1).astype('float32')


def recurrence_inputs(t_len, batch, hdim, kind, gates, seed=0):
    """Kernel inputs and cotangents of a bidirectional layer with
    ``gates`` gate blocks (3: GRU, 4: LSTM)."""
    rng = np.random.RandomState(seed)
    bound = 1 / np.sqrt(hdim)
    mask = recurrence_mask(t_len, batch, kind, rng)
    rows = 2 * batch
    arrays = [rng.uniform(-1, 1, (t_len, rows, gates * hdim)),
              rng.uniform(-bound, bound, (2, hdim, gates * hdim)), mask]
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


def cudnn_layer_ms(layer_cls, t_len, batch, in_size, hdim):
    """Yardstick, timed here and used nowhere in the port: one
    bidirectional ``torch.nn.LSTM`` or ``torch.nn.GRU`` layer (cuDNN; it
    includes the input projection and takes no mask), forward without and
    with grad mode, and backward."""
    torch.manual_seed(0)
    layer = layer_cls(in_size, hdim, bidirectional=True).cuda()
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
    the model runs, ``per_step`` its launches per step and kind."""
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
        loss = review['losses'][loss_key]
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
    launches = dict(wrapper.launches)
    if launches != {'fwd': 0, 'fwd_train': per_step * iters,
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
        cpu = Trainer(model_cpu.train(), Path(tmp) / 'cpu',
                      Adam(gradient_clipping=10.0),
                      loss_weights=config['loss_weights'])
        loss_cpu, _, _, _ = cpu.train_step(cpu.model, batch)
        loss_cpu.backward()
        loss_cpu = float(loss_cpu.detach())
        norm_cpu = float(cpu.optimizer.clip_grad())
        rel_loss = abs(losses[0] - loss_cpu) / abs(loss_cpu)
        rel_norm = abs(norms[0] - norm_cpu) / norm_cpu
        print(f'phase 7c first step card vs CPU: loss {losses[0]:.9g} vs '
              f'{loss_cpu:.9g} (relative {rel_loss:.3e}), gradient '
              f'norm {norms[0]:.9g} vs {norm_cpu:.9g} (relative '
              f'{rel_norm:.3e}); tol {STEP_RTOL}')
        if not (rel_loss <= STEP_RTOL and rel_norm <= STEP_RTOL):
            fail('the first training step on the card disagrees with the '
                 'CPU')

        ckpt_dir = storage_dir / 'checkpoints'
        names = sorted(p.name for p in ckpt_dir.iterdir())
        for name in ('ckpt_24.ptt', 'ckpt_latest.ptt', 'ckpt_best_loss.ptt',
                     'ckpt_ranking.json'):
            if name not in names:
                fail(f'{name} missing from {names}')
        if not any('tfevents' in p.name for p in storage_dir.iterdir()):
            fail('no event file in the storage dir')
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
    each of RECURRENCE_SHAPES.  Returns {label: {kernel: row}}."""
    results = {}
    for label, t_len, batch, hdim, kind in RECURRENCE_SHAPES:
        args, cot = recurrence_inputs(t_len, batch, hdim, kind, gates=3)
        gx, w, mask, h0 = args
        valid = t_len * 2 * batch if mask is None else float(mask.sum())

        def fwd_train():
            return gru_kernels._launch(gx, w, 2, mask, h0, train=True)

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
            return gru_kernels._launch_bwd(acts, gh_n, h_prev, w, 2, mask,
                                           *cot)

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
                got_bwd[1], h_prev, 2), iters=20),
        }
        # the input of a DPRNN chunk RNN is 64 wide, of the uPIT layers 1200
        library = cudnn_layer_ms(torch.nn.GRU, t_len, batch,
                                 64 if hdim == 128 else 1200, hdim)
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
            name: {'max_abs_err': err[name], 'ms': times[name],
                   'plain_ms': times[name + '_plain'], **limits[name],
                   'library_ms': library[name]}
            for name in ('fwd', 'fwd_train', 'bwd')}
        results[label]['dw_ms'] = times['dw']
    return results


def phase_lstm_at_dprnn_shapes():
    """Phase 9: the three LSTM kernels at the DPRNN's two shapes."""
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
        times = {'fwd': cuda_ms(lambda: lstm_cell_scan(*args), iters=10),
                 'fwd_train': cuda_ms(fwd_train, iters=10),
                 'bwd': cuda_ms(bwd, iters=10)}
        flops = valid * (2 * hdim * 4 * hdim + 30 * hdim)
        limits = {
            'fwd': bound(nbytes(*args, *got), flops),
            'fwd_train': bound(nbytes(*args, *got_train), flops),
            'bwd': bound(nbytes(gates, c_seq, w, mask, *cot, *got_bwd),
                         flops)}
        for name, tol in (('fwd', LSTM_TOL), ('fwd_train', LSTM_TOL),
                          ('bwd', LSTM_BWD_TOL)):
            print(f'phase 9 lstm {name} {label}: max |kernel - plain| '
                  f'{err[name]:.3e} (tol {tol}), kernel '
                  f'{times[name]:.3f} ms, bound '
                  f'{limits[name]["bound_ms"]:.4f} ms by '
                  f'{limits[name]["bound_by"]}')
            if not err[name] <= tol:
                fail(f'lstm {name} kernel disagrees with plain at {label}: '
                     f'{err[name]}')
        results[label] = times
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
    same = all(torch.equal(x, y)
               for x, y in zip(got_grads, grads(flash_attention)))
    print(f'phase 12 attention {label}: max |kernel - plain| '
          + ', '.join(f'{k} {v:.3e}' for k, v in err.items())
          + f' (tol {ATTENTION_TOL} on o and lse); gradients relative '
          f'{rel:.3e} (tol {ATTENTION_GRAD_RTOL}); two backward runs the '
          f'same bits: {same}')
    if not max(err['o'], err.get('o, lse (training forward)', 0.0)) \
            <= ATTENTION_TOL:
        fail(f'attention forward kernel disagrees with plain at {label}: '
             f'{err}')
    if not rel <= ATTENTION_GRAD_RTOL:
        fail(f'attention backward kernels disagree with autograd through '
             f'plain at {label}: {rel}')
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
    times['bwd'] = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, d_o, retain_graph=True), iters=10)
    times['bwd_plain'] = cuda_ms(lambda: torch.autograd.grad(
        out_plain, leaves_plain, d_o, retain_graph=True), iters=5)
    del out_plain, leaves_plain
    times['fwd_library'], times['bwd_library'] = attention_library(
        q, k, v, d_o, masks)
    # the work these inputs need: the visible (query, key) pairs, each two
    # products of D in the forward (q k^T, p v) and five in the backward
    visible = visible_mask(tq, tk, lens, masks.get('causal', False),
                           masks.get('window'), q.device)
    pairs = float(visible.sum()) * h * (b // visible.shape[0])
    limits = {
        'fwd': bound(nbytes(q, k, v, lens, got), 4 * pairs * d),
        'bwd': bound(nbytes(q, k, v, lens, got, want_lse, d_o, *got_grads),
                     10 * pairs * d)}
    for name in ('fwd', 'bwd'):
        print(f'phase 12 attention {name} {label}: kernel '
              f'{times[name]:.3f} ms'
              + (f' (keeping lse: {times["fwd_train"]:.3f} ms)'
                 if name == 'fwd' else ' (delta included)')
              + f', plain {times[name + "_plain"]:.3f} ms, '
              f'scaled_dot_product_attention '
              f'{times[name + "_library"]:.3f} ms, bound '
              f'{limits[name]["bound_ms"]:.4f} ms by '
              f'{limits[name]["bound_by"]}')
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
        cpu = Trainer(model_cpu.train(), Path(tmp) / 'cpu',
                      Adam(gradient_clipping=5.0),
                      loss_weights=config['loss_weights'])
        loss_cpu, _, _, _ = cpu.train_step(cpu.model, batch)
        loss_cpu.backward()
        loss_cpu = float(loss_cpu.detach())
        norm_cpu = float(cpu.optimizer.clip_grad())
        rel_loss = abs(losses[0] - loss_cpu) / abs(loss_cpu)
        rel_norm = abs(norms[0] - norm_cpu) / norm_cpu
        loss_rtol, norm_rtol = path['rtol']
        print(f'phase {phase}c {name} first step card vs CPU: loss '
              f'{losses[0]:.9g} vs {loss_cpu:.9g} (relative '
              f'{rel_loss:.3e}, tol {loss_rtol}), gradient norm '
              f'{norms[0]:.9g} vs {norm_cpu:.9g} (relative {rel_norm:.3e}, '
              f'tol {norm_rtol})')
        if not (rel_loss <= loss_rtol and rel_norm <= norm_rtol):
            fail(f'the first {name} TasNet training step on the card '
                 f'disagrees with the CPU')

        ckpt_dir = storage_dir / 'checkpoints'
        names = sorted(p.name for p in ckpt_dir.iterdir())
        for ckpt in (f'ckpt_{iterations}.ptt', 'ckpt_latest.ptt',
                     'ckpt_best_si-sdr.ptt', 'ckpt_ranking.json'):
            if ckpt not in names:
                fail(f'{ckpt} missing from {names}')
        if not any('tfevents' in p.name for p in storage_dir.iterdir()):
            fail('no event file in the storage dir')
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
    attention_launches = {
        'fwd': sepformer_served + sepformer_trained['fwd']
        + sepformer_trained['fwd_train'],
        'bwd': sepformer_trained['bwd']}
    for name, n in attention_launches.items():
        if n == 0:
            fail(f'the SepFormer paths never launched the attention {name} '
                 f'kernel')
    gru_launches = {'fwd': served['bgru'] + trained['bgru']['fwd'],
                    'fwd_train': trained['bgru']['fwd_train'],
                    'bwd': trained['bgru']['bwd']}
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
          f'lean forward, training {sepformer_trained})')
    # the GRU rows are those of the intra-chunk shape, which six of a
    # model's twelve chunk RNNs run
    gru_rows = gru[RECURRENCE_SHAPES[0][0]]
    # the attention rows are those of the intra-chunk shape (8 of a
    # model's 16 layers); the forward row counts lean and training launches
    attention_rows = attention[ATTENTION_CASES[0][0]]
    kernels = [
        {'name': 'lstm_cell_scan', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:275',
         'launches': lstm_launches['fwd'], **lstm},
        {'name': 'lstm_cell_scan_train', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:293',
         'launches': lstm_launches['fwd_train'],
         **train_kernels['fwd_train']},
        {'name': 'lstm_cell_scan_bwd', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:339',
         'launches': lstm_launches['bwd'], **train_kernels['bwd']},
        {'name': 'masked_istft', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/masked_istft.cu',
         'replaces': 'padertorch_tpu/ops/pallas/masked_istft.py:135',
         'launches': launches['masked_istft'], **istft[(2, 127)]},
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
         'launches': attention_launches['fwd'], **attention_rows['fwd']},
        {'name': 'flash_attention_bwd', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/flash_attention_bwd.cu',
         'replaces': 'padertorch_tpu/ops/pallas/attention.py:351',
         'launches': attention_launches['bwd'], **attention_rows['bwd']},
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
