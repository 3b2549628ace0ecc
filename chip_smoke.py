"""Drive the PyTorch port's uPIT separation path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build: both hand-written kernels built from ``padertorch_tpu_torch/csrc``.
3. lstm_cell_scan kernel vs its plain version at the flagship shape
   (T=500, D*B=32 with ragged lengths in [250, 500], H=600, f32), and a
   control: the plain version with TF32 matmuls must fail the limit.
4. masked_istft kernel vs its plain version at (K=2, T=127, F=257) and
   (B*K=32, T=500, F=257).
5. slice: the full-width uPIT model (F=257, 3x600 BLSTM, K=2) from seed 0
   on the card against the same model on the CPU; then the recipe's
   ``evaluate_example`` on the 8 mixtures of
   ``synthetic_database(num_examples=8, seed=2)`` as 8 requests, with the
   kernels' launch counts read around them; then one batched forward at
   B=16, T=500.

The line before the last is a JSON object with each kernel's launches on
the main path, its largest difference from the plain version and both
times; the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero and prints no result; without
a CUDA card it fails at phase 1.
"""
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from padertorch_tpu_torch.contrib.examples.source_separation.pit import (
    data as pit_data)
from padertorch_tpu_torch.contrib.examples.source_separation.pit.evaluate \
    import evaluate_example
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.ops._stft import HostSTFT, STFT
from padertorch_tpu_torch.ops.kernels import _build
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_plain)
from padertorch_tpu_torch.ops.kernels.masked_istft import (
    masked_istft, masked_istft_plain)

# f32 sums in another order over 500 recurrent steps; about 20x the
# difference the card shows, and far below what a TF32 recurrent product
# gives (phase 3 measures that control and requires it to fail the limit)
LSTM_TOL = 1e-5
ISTFT_TOL = 1e-4   # f32 sums of 2 * 257 * 4 products per sample
MODEL_TOL = 1e-6   # masks after 3 BLSTM layers of 500 steps, card vs CPU
SI_SDR_TOL = 1e-2  # dB, card vs CPU on the same request


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


def lstm_inputs(device, t_len=500, batch=16, hdim=600, seed=0):
    """Flagship-shaped kernel inputs: both directions stacked (D*B rows),
    ragged lengths, suffix padding for the forward direction and prefix
    padding for the flipped backward direction."""
    rng = np.random.RandomState(seed)
    bound = 1 / np.sqrt(hdim)
    lens = rng.randint(t_len // 2, t_len + 1, size=batch)
    lens[0] = t_len
    fwd = np.arange(t_len)[:, None] < lens[None, :]
    mask = np.concatenate([fwd, fwd[::-1]], axis=1).astype('float32')
    arrays = [
        rng.uniform(-1, 1, (t_len, 2 * batch, 4 * hdim)),
        rng.uniform(-bound, bound, (2, hdim, 4 * hdim)),
        mask,
        rng.uniform(-0.1, 0.1, (2 * batch, hdim)),
        rng.uniform(-0.1, 0.1, (2 * batch, hdim)),
    ]
    return [torch.from_numpy(np.ascontiguousarray(a, 'float32')).to(device)
            for a in arrays]


def phase_lstm():
    args = lstm_inputs('cuda')
    got = lstm_cell_scan(*args)
    want = lstm_cell_scan_plain(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_err = max_err(lstm_cell_scan_plain(*args), want)
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = cuda_ms(lambda: lstm_cell_scan(*args), iters=20)
    plain_ms = cuda_ms(lambda: lstm_cell_scan_plain(*args), iters=3)
    print(f'phase 3 lstm_cell_scan T=500 D*B=32 H=600: max |kernel - plain| '
          f'{err:.3e} (tol {LSTM_TOL}), plain with TF32 vs f32 '
          f'{tf32_err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    if not err <= LSTM_TOL:
        fail(f'lstm_cell_scan kernel disagrees with plain: {err}')
    if not tf32_err > LSTM_TOL:
        fail(f'the limit {LSTM_TOL} does not tell a TF32 recurrence from '
             f'f32: {tf32_err}')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}


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
        print(f'phase 4 masked_istft ({n_rows}, {frames}, 257): max '
              f'|kernel - plain| {err:.3e} (tol {ISTFT_TOL}), kernel '
              f'{ms:.3f} ms, plain {plain_ms:.3f} ms')
        if not err <= ISTFT_TOL:
            fail(f'masked_istft kernel disagrees with plain: {err}')
        results[(n_rows, frames)] = {
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}
    return results


def ragged_batch(batch, frames, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(frames // 2, frames + 1, size=batch)
    lens[0] = frames
    y = np.abs(rng.randn(batch, frames, 257)).astype('float32')
    y *= (np.arange(frames)[None, :, None] < lens[:, None, None])
    return {'Y_abs': torch.from_numpy(y),
            'num_frames': torch.from_numpy(lens.astype('int64'))}


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
    lstm_cell_scan.launches = 0
    masked_istft.launches = 0
    latencies, results = [], {}
    for example in examples:
        start = time.perf_counter()
        example_id, metrics = evaluate_example(model, stft, example)
        latencies.append((time.perf_counter() - start) * 1e3)
        results[example_id] = metrics
    launches = {'lstm_cell_scan': lstm_cell_scan.launches,
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


def main():
    phase_device()
    phase_build()
    lstm = phase_lstm()
    istft = phase_istft()
    launches = phase_slice()
    kernels = [
        {'name': 'lstm_cell_scan', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/lstm_cell_scan.cu',
         'replaces': 'padertorch_tpu/ops/pallas/lstm.py:275',
         'launches': launches['lstm_cell_scan'], **lstm},
        {'name': 'masked_istft', 'route': 'cuda',
         'source': 'padertorch_tpu_torch/csrc/masked_istft.cu',
         'replaces': 'padertorch_tpu/ops/pallas/masked_istft.py:135',
         'launches': launches['masked_istft'], **istft[(2, 127)]},
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
