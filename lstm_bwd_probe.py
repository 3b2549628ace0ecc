"""Split a step of the bf16 LSTM backward, or of the bf16 training
forward, on the card into its parts: the cell part (the backward's dz of
the block's pairs; the forward's sums of the partial products, the cell
and its stores; each with the next step's loads), the grid sync, the
exchange (the step's dz or h rows staged from L2: on the ``mma`` routes
the slice of thread 0's warp, which stages its own; on the FMA grid the
block's, up to its barrier) and the product (with the partial sums'
reduction in the backward and, on the ``mma`` routes, the wait for the
other warps), for the ``mma`` route and the FMA grid it replaced.

    python3 lstm_bwd_probe.py            # the backward
    python3 lstm_bwd_probe.py forward    # the training forward

Builds ``padertorch_tpu_torch/csrc/lstm_cell_scan_bwd.cu`` (or
``lstm_cell_scan.cu``) with ``-DLSTM_PROBE`` (nvcc, into a temporary
directory): ``clock64`` probes in thread 0 of block 0 sum the cycles of
each part over a launch's steps, and the build adds an entry that runs the
bf16 variant on the FMA grid (the route the ``mma`` route replaced, its
kernel as it was).  At the uPIT layer (T=500, 16 rows a direction, H=600,
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

CSRC = Path(__file__).resolve().parent / 'padertorch_tpu_torch' / 'csrc'
PARTS = ('cell', 'sync', 'exchange', 'product')
# (label, T, rows per direction, H, mask)
SHAPES = [('uPIT T=500 D*B=32 H=600 ragged', 500, 16, 600, 'ragged'),
          ('DPRNN intra T=100 D*B=520 H=128', 100, 260, 128, None),
          ('DPRNN inter T=65 D*B=800 H=128', 65, 400, 128, 'chunks')]
# per mode: the source, its entries by route, their pointer arguments, and
# the entry that reads the probes
MODES = {
    'backward': ('lstm_cell_scan_bwd.cu',
                 {'mma': 'lstm_cell_scan_bwd_bf16',
                  'fma': 'lstm_cell_scan_bwd_bf16_fma'}, 11,
                 'lstm_bwd_probe_take'),
    'forward': ('lstm_cell_scan.cu',
                {'mma': 'lstm_cell_scan_fwd_train_bf16',
                 'fma': 'lstm_cell_scan_fwd_train_bf16_fma'}, 12,
                'lstm_fwd_probe_take'),
}


def build(tmp, mode):
    source, entries, pointers, take = MODES[mode]
    lib = Path(tmp) / 'libprobe.so'
    subprocess.run(['/usr/local/cuda/bin/nvcc', '-gencode',
                    'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                    '-Xcompiler', '-fPIC', '-shared', '-DLSTM_PROBE',
                    '-o', str(lib), str(CSRC / source)], check=True)
    lib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in entries.values():
        getattr(lib, name).argtypes = [p] * pointers + [i] * 5 + [p]
    getattr(lib, take).argtypes = [p]
    return lib


def inputs(t_len, per_dir, hdim, kind):
    """The inputs of a bf16 layer and, for the backward, its residuals (the
    plain training forward on the card) and cotangents, from seed 0, as
    phase 23 of chip_smoke.py: (forward's, backward's)."""
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
    return ((gx, w, put(mask), h0, c0),
            (gates, c_seq, w, put(mask), d_out, dh_t, dc_t))


def pointers(mode, args, t_len, per_dir, hdim):
    """The entry's pointer arguments (outputs allocated here)."""
    def ptr(x):
        return None if x is None else x.data_ptr()

    if mode == 'forward':
        gx, w, mask, h0, c0 = args
        rows = 2 * per_dir
        out, c_seq = (torch.empty((t_len, rows, hdim), dtype=torch.bfloat16,
                                  device='cuda') for _ in range(2))
        gates = torch.empty_like(gx)
        h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
        hbuf = torch.empty((2, rows, hdim), device='cuda')
        keep = (out, c_seq, gates, h_t, c_t, hbuf)
        return keep, [ptr(x) for x in (gx, w, None, mask, h0, c0, *keep)]
    gates, c_seq, w, mask, d_out, dh_t, dc_t = args
    dgx = torch.empty_like(gates)
    dh0, dc0 = torch.empty_like(dh_t), torch.empty_like(dc_t)
    keep = (dgx, dh0, dc0)
    return keep, [ptr(x) for x in (gates, c_seq, w, None, mask, d_out, dh_t,
                                   dc_t, *keep)]


def run(lib, mode, entry, args, t_len, per_dir, hdim):
    stream = torch.cuda.current_stream().cuda_stream
    take = getattr(lib, MODES[mode][3])
    outputs, ptrs = pointers(mode, args, t_len, per_dir, hdim)

    def launch():
        err = getattr(lib, entry)(*ptrs, t_len, 2, per_dir, hdim,
                                  torch.cuda.current_device(), stream)
        if err != 0:
            raise RuntimeError(f'{entry} failed: CUDA error {err}')

    cycles = (ctypes.c_longlong * 4)()
    launch()
    take(ctypes.addressof(cycles))   # zeroes them
    launch()
    if take(ctypes.addressof(cycles)) != 0:
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
    del outputs
    return float(np.median(windows)), [c / t_len for c in cycles]


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else 'backward'
    if mode not in MODES:
        sys.exit(f'usage: lstm_bwd_probe.py [{" | ".join(MODES)}]')
    if not torch.cuda.is_available():
        sys.exit('lstm_bwd_probe.py needs a card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp, mode)
        take = getattr(lib, MODES[mode][3])
        for label, t_len, per_dir, hdim, kind in SHAPES:
            fwd_args, bwd_args = inputs(t_len, per_dir, hdim, kind)
            args = fwd_args if mode == 'forward' else bwd_args
            for route, entry in MODES[mode][1].items():
                ms, per_step = run(lib, mode, entry, args, t_len, per_dir,
                                   hdim)
                total = sum(per_step)
                us = ms * 1e3 / t_len
                print(f'{mode} {label}, {route}: {ms:.4f} ms, {us:.3f} us a '
                      f'step; '
                      + ', '.join(
                          f'{name} {c:.0f} cycles ({c / total:.1%}, '
                          f'{us * c / total:.3f} us)'
                          for name, c in zip(PARTS, per_step)), flush=True)
            spent = (ctypes.c_longlong * 4)()   # the timed launches' cycles
            take(ctypes.addressof(spent))


if __name__ == '__main__':
    main()
