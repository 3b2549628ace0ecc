"""Split a step of the bf16 LSTM backward on the card into its parts: the
cell part (dz of the block's pairs, with the next step's loads), the grid
sync, the dz exchange (the step's dz rows staged from L2: on the ``mma``
route the slice of thread 0's warp, which stages its own; on the float32
FMA grid the block's, up to its barrier) and the product (with the
partial sums' reduction and, on the ``mma`` route, the wait for the other
warps), for the ``mma`` route and the float32 FMA grid it replaced.

    python3 lstm_bwd_probe.py

Builds ``padertorch_tpu_torch/csrc/lstm_cell_scan_bwd.cu`` with
``-DLSTM_BWD_PROBE`` (nvcc, into a temporary directory): ``clock64``
probes in thread 0 of block 0 sum the cycles of each part over a launch's
steps, and the build adds an entry that runs the bf16 variant on the
float32 FMA grid.  At the uPIT layer (T=500, 16 rows a direction, H=600,
ragged) and the DPRNN's intra (T=100, 260 rows, H=128) and inter (T=65,
400 rows, H=128, chunk mask) shapes it prints the card's name and power
limit, then for each route the kernel's ms a launch (CUDA events, the
median of 5 windows of 10 launches), its µs a step, and each part's cycles
a step with its share, which also splits the µs a step.  Block 0 is one
block of the grid: the sync part is its wait for the others.  No main
path runs this build.  Exits non-zero without a card or without nvcc.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

SOURCE = (Path(__file__).resolve().parent / 'padertorch_tpu_torch' / 'csrc'
          / 'lstm_cell_scan_bwd.cu')
PARTS = ('cell', 'sync', 'exchange', 'product')
# (label, T, rows per direction, H, mask)
SHAPES = [('uPIT T=500 D*B=32 H=600 ragged', 500, 16, 600, 'ragged'),
          ('DPRNN intra T=100 D*B=520 H=128', 100, 260, 128, None),
          ('DPRNN inter T=65 D*B=800 H=128', 65, 400, 128, 'chunks')]
ENTRIES = {'mma': 'lstm_cell_scan_bwd_bf16',
           'fma': 'lstm_cell_scan_bwd_bf16_fma'}


def build(tmp):
    lib = Path(tmp) / 'libprobe.so'
    subprocess.run(['/usr/local/cuda/bin/nvcc', '-gencode',
                    'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                    '-Xcompiler', '-fPIC', '-shared', '-DLSTM_BWD_PROBE',
                    '-o', str(lib), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ENTRIES.values():
        getattr(lib, name).argtypes = [p] * 11 + [i] * 5 + [p]
    lib.lstm_bwd_probe_take.argtypes = [p]
    return lib


def inputs(t_len, per_dir, hdim, kind):
    """The residuals of a bf16 layer (the plain training forward on the
    card) and cotangents, from seed 0, as phase 23 of chip_smoke.py."""
    from padertorch_tpu_torch.ops.kernels.lstm import (
        lstm_cell_scan_train_plain)
    rng = np.random.RandomState(0)
    rows = 2 * per_dir
    mask = None
    if kind == 'chunks':
        lens = np.repeat([t_len, t_len - 11, t_len - 20, t_len - 30],
                         per_dir // 4)
    elif kind == 'ragged':
        lens = rng.randint(t_len // 2, t_len + 1, size=per_dir)
        lens[0] = t_len
    if kind is not None:
        fwd = np.arange(t_len)[:, None] < lens[None, :]
        mask = np.concatenate([fwd, fwd[::-1]], 1).astype('float32')

    def put(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, 'float32')).cuda()

    gx = put(rng.uniform(-1, 1, (t_len, rows, 4 * hdim))).bfloat16()
    w = put(rng.uniform(-1, 1, (2, hdim, 4 * hdim)) / np.sqrt(hdim))
    h0, c0 = (put(rng.uniform(-0.1, 0.1, (rows, hdim))) for _ in range(2))
    _, c_seq, gates, _, _ = lstm_cell_scan_train_plain(
        gx, w, put(mask), h0, c0, 'bfloat16')
    d_out = put(rng.uniform(-1, 1, (t_len, rows, hdim))).bfloat16()
    dh_t, dc_t = (put(rng.uniform(-1, 1, (rows, hdim))) for _ in range(2))
    return gates, c_seq, w, put(mask), d_out, dh_t, dc_t


def run(lib, entry, args, t_len, per_dir, hdim):
    gates, c_seq, w, mask, d_out, dh_t, dc_t = args
    dgx = torch.empty_like(gates)
    dh0, dc0 = torch.empty_like(dh_t), torch.empty_like(dc_t)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = getattr(lib, entry)(
            gates.data_ptr(), c_seq.data_ptr(), w.data_ptr(), None,
            None if mask is None else mask.data_ptr(), d_out.data_ptr(),
            dh_t.data_ptr(), dc_t.data_ptr(), dgx.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), t_len, 2, per_dir, hdim,
            torch.cuda.current_device(), stream)
        if err != 0:
            raise RuntimeError(f'{entry} failed: CUDA error {err}')

    cycles = (ctypes.c_longlong * 4)()
    launch()
    lib.lstm_bwd_probe_take(ctypes.addressof(cycles))   # zeroes them
    launch()
    if lib.lstm_bwd_probe_take(ctypes.addressof(cycles)) != 0:
        raise RuntimeError('reading the probes failed')
    windows = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            launch()
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / 10)
    return float(np.median(windows)), [c / t_len for c in cycles]


def main():
    if not torch.cuda.is_available():
        sys.exit('lstm_bwd_probe.py needs a card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for label, t_len, per_dir, hdim, kind in SHAPES:
            args = inputs(t_len, per_dir, hdim, kind)
            for route, entry in ENTRIES.items():
                ms, per_step = run(lib, entry, args, t_len, per_dir, hdim)
                total = sum(per_step)
                us = ms * 1e3 / t_len
                print(f'{label}, {route}: {ms:.4f} ms, {us:.3f} us a step; '
                      + ', '.join(
                          f'{name} {c:.0f} cycles ({c / total:.1%}, '
                          f'{us * c / total:.3f} us)'
                          for name, c in zip(PARTS, per_step)), flush=True)
            spent = (ctypes.c_longlong * 4)()   # the timed launches' cycles
            lib.lstm_bwd_probe_take(ctypes.addressof(spent))


if __name__ == '__main__':
    main()
