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
    python3 lstm_bwd_probe.py gru-backward
    python3 lstm_bwd_probe.py gru-forward
    python3 lstm_bwd_probe.py gru-lean
    python3 lstm_bwd_probe.py gru-cluster
    python3 lstm_bwd_probe.py gru-registers

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

The GRU modes split a step of the bf16 GRU backward's (or training
forward's) ``mma`` route the same way, built with ``-DLSTM_PROBE`` from a
file that includes ``gru_cell_scan_bwd.cu`` (or ``gru_cell_scan.cu``) and
adds an entry that launches the route with the steps its inputs are
prefetched into L2 ahead of their use as an argument (``GRU_AHEAD`` here:
none, 1 and 2; the card's rule, ``gru_mma_ahead``, takes 2 where a
launch's streams outgrow L2): at the DPRNN's intra and inter shapes
(phase 28's, B=4 x 32000), the ``bgru`` step's (``compare_backward.py
bgru-step``, B=4 x 16000: T=100 and 132 rows a direction, T=33 and 400
rows) and the speaker classifier recipe's (T=66, 8 rows, H=64, one
direction).  A block runs all its steps alone, so the parts are the
product (block 0's warp 0: its ``mma`` chunk and partial-sum stores), the
two syncs (the wait for the block's other warps) and the cell (the
chunks' sums, the cell, its stores and the next step's loads); no
exchange.  ``gru-lean`` does the same for the lean bf16 forward on the
same route (no residual stores; its streams, gx and out, are 8H bytes a
row and step against the training forward's 18H, which the L2 rule
counts).

``gru-cluster`` splits a step of the lean bf16 forward's cluster route
(``gru_cell_scan_cluster.cu``, built the same way, launched on the card's
plan) at the speaker classifier's class defaults (T=503, 16 rows, H=256,
one direction), at H = 160 and 192 on the same rows, and at H = 256 on
2 x 40 rows: the product (block 0's warp 0), the block's one sync, the
cell (the chunks' sums, the cell, out, the next step's loads and the
sends of bf16(h_t) to the cluster's CTAs) and the exchange (the wait on
the block's mbarrier for every CTA's h_t).

``gru-registers`` compiles the three GRU sources of the bf16 forwards'
and backward's tensor-core routes with ``-Xptxas -v``, each from a file
that includes it (the ``mma`` sources adding the instantiation a tile of
one warp would need at H = 144: 9 k-steps of each gate forward, 27
backward), and prints each ``mma`` and cluster kernel's registers and
spills: the budget behind ``GRU_MMA_MAX_H`` and ``GRU_CLUSTER_KC``.
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


# the GRU modes: the source, its launcher (of the `mma` route, or of the
# cluster route) and the launcher's pointer arguments, the entry that reads
# the probes, and whether the launcher takes the steps ahead of the L2
# prefetches
GRU_MODES = {
    'gru-backward': ('gru_cell_scan_bwd.cu', 'launch_bwd_mma', 10,
                     'gru_bwd_probe_take', True),
    'gru-forward': ('gru_cell_scan.cu', 'launch_fwd_mma', 9,
                    'gru_fwd_probe_take', True),
    'gru-lean': ('gru_cell_scan.cu', 'launch_fwd_mma', 9,
                 'gru_fwd_probe_take', True),
    'gru-cluster': ('gru_cell_scan_cluster.cu', 'launch_fwd_cluster', 6,
                    'gru_cluster_probe_take', False),
}
GRU_AHEAD = (0, 1, 2)
# (label, T, rows per direction, H, mask, directions)
GRU_SHAPES = [('DPRNN intra T=100 D*B=520 H=128', 100, 260, 128, None, 2),
              ('DPRNN inter T=65 D*B=800 H=128', 65, 400, 128, 'chunks', 2),
              ('bgru step intra T=100 D*B=264 H=128', 100, 132, 128, None,
               2),
              ('bgru step inter T=33 D*B=800 H=128', 33, 400, 128, 'chunks',
               2),
              ('classifier recipe T=66 D*B=8 H=64 one direction', 66, 8, 64,
               'ragged', 1)]
GRU_CLUSTER_SHAPES = [
    ('classifier defaults T=503 D*B=16 H=256 one direction', 503, 16, 256,
     'ragged', 1),
    ('T=503 D*B=16 H=160 one direction', 503, 16, 160, 'ragged', 1),
    ('T=503 D*B=16 H=192 one direction', 503, 16, 192, 'ragged', 1),
    ('T=100 D*B=80 H=256', 100, 40, 256, 'ragged', 2)]
# the instantiations a tile of one warp would need at H = 144
GRU_WIDE = {
    'gru_cell_scan.cu': """template __global__ void gru_fwd_mma_kernel<true, 9>(
    const __nv_bfloat16*, const float*, const float*, const float*,
    __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*, float*,
    int, int, int, int, int, int, int, int, int);""",
    'gru_cell_scan_bwd.cu': """template __global__ void gru_bwd_mma_kernel<27>(
    const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
    const float*, const float*, const __nv_bfloat16*, const float*,
    __nv_bfloat16*, __nv_bfloat16*, float*, int, int, int, int, int, int,
    int, int, int);""",
    'gru_cell_scan_cluster.cu': '',
}


def gru_build(tmp, mode):
    """The probe build of ``mode``'s source: its launcher behind the entry
    ``gru_probe_mma(pointers, T, D, Bd, H, device, stream, ahead)``
    (``ahead`` unused by the cluster route's)."""
    source, launcher, pointers, take, with_ahead = GRU_MODES[mode]
    unit = Path(tmp) / 'probe.cu'
    unit.write_text(
        f'#include "{CSRC / source}"\n'
        f'extern "C" int gru_probe_mma(void* const* p, int T, int D, '
        f'int Bd, int H, int device, void* stream, int ahead) {{\n'
        f'    return {launcher}('
        + ', '.join(f'p[{i}]' for i in range(pointers))
        + ', T, D, Bd, H, device, stream'
        + (', ahead' if with_ahead else '') + ');\n}\n')
    path = Path(tmp) / 'libprobe.so'
    subprocess.run(
        ['/usr/local/cuda/bin/nvcc', '-gencode',
         'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-Xcompiler',
         '-fPIC', '-shared', '-DLSTM_PROBE', '-o', str(path), str(unit)],
        check=True)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_probe_mma.argtypes = [p] + [i] * 5 + [p, i]
    getattr(lib, take).argtypes = [p]
    return lib


def gru_pointers(mode, t_len, per_dir, hdim, kind, n_dir):
    """The entry's pointer arguments on a bf16 layer from seed 0 (as
    chip_smoke.py phase 28 makes it; the backward's residuals from the
    plain training forward), and the tensors they point into."""
    import chip_smoke
    from padertorch_tpu_torch.ops.kernels.gru import (
        gru_cell_scan_train_plain)
    args, cot = chip_smoke.recurrence_inputs(t_len, per_dir, hdim, kind,
                                             gates=3, directions=n_dir)
    gx, w, mask, h0 = args
    gx = gx.bfloat16()
    out, acts, gh_n, h_prev, h_t = gru_cell_scan_train_plain(
        gx, w, mask, h0, 'bfloat16')

    def ptr(x):
        return None if x is None else x.data_ptr()

    if mode == 'gru-forward':
        keep = [torch.empty_like(x) for x in (out, acts, gh_n, h_prev, h_t)]
        return keep, [ptr(x) for x in (gx, w, mask, h0, *keep)]
    if mode in ('gru-lean', 'gru-cluster'):
        keep = [torch.empty_like(out), torch.empty_like(h_t)]
        none = [None] * 3 if mode == 'gru-lean' else []
        return keep, [ptr(x) for x in (gx, w, mask, h0, keep[0], *none,
                                       keep[1])]
    keep = [torch.empty_like(acts), torch.empty_like(acts),
            torch.empty_like(cot[1])]
    d_out = cot[0].bfloat16()
    return [keep, d_out], [ptr(x) for x in (acts, gh_n, h_prev, w, mask,
                                            d_out, cot[1], *keep)]


def gru_main(mode):
    take, with_ahead = GRU_MODES[mode][3:]
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        lib = gru_build(tmp, mode)
        shapes = GRU_CLUSTER_SHAPES if mode == 'gru-cluster' else GRU_SHAPES
        for label, t_len, per_dir, hdim, kind, n_dir in shapes:
            keep, ptrs = gru_pointers(mode, t_len, per_dir, hdim, kind,
                                      n_dir)
            ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
            for ahead in GRU_AHEAD if with_ahead else (-1,):
                def launch():
                    err = lib.gru_probe_mma(
                        ptrs, t_len, n_dir, per_dir, hdim,
                        torch.cuda.current_device(), stream, ahead)
                    if err != 0:
                        raise RuntimeError(f'the {mode} launch failed: CUDA '
                                           f'error {err}')

                cycles = (ctypes.c_longlong * 4)()
                launch()
                getattr(lib, take)(ctypes.addressof(cycles))   # zeroes
                launch()
                if getattr(lib, take)(ctypes.addressof(cycles)) != 0:
                    raise RuntimeError('reading the probes failed')
                per_step = [c / t_len for c in cycles]
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
                getattr(lib, take)(ctypes.addressof(cycles))
                ms = float(np.median(windows))
                total = sum(per_step)
                us = ms * 1e3 / t_len
                prefetch = (f', L2 prefetch {ahead} ahead' if with_ahead
                            else '')
                print(f'{mode} {label}{prefetch}: {ms:.4f} ms, '
                      f'{us:.3f} us a step; '
                      + ', '.join(
                          f'{name} {c:.0f} cycles ({c / total:.1%}, '
                          f'{us * c / total:.3f} us)'
                          for name, c in zip(PARTS, per_step)
                          if not with_ahead or name != 'exchange'),
                      flush=True)
            del keep
            torch.cuda.empty_cache()


def gru_registers():
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for source, wide in GRU_WIDE.items():
            unit = Path(tmp) / f'wide_{source}'
            unit.write_text(f'#include "{CSRC / source}"\nnamespace {{\n'
                            f'{wide}\n}}\n')
            procs.append(subprocess.Popen(
                ['/usr/local/cuda/bin/nvcc', '-gencode',
                 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                 '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-c', '-o',
                 str(Path(tmp) / f'{source}.o'), str(unit)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for proc in procs:
            lines = proc.communicate()[0].splitlines()
            if proc.returncode != 0:
                sys.exit('\n'.join(lines[-40:]))
            for i, line in enumerate(lines):
                if 'Compiling entry' not in line or not (
                        'mma_kernel' in line or 'cluster_kernel' in line):
                    continue
                name = line.split("'")[1]
                name = name[name.index('gru_'):]
                name = name[:name.index('EEEv' if 'EEEv' in name else 'EPK')]
                info = [x.split(':', 1)[-1].strip() for x in lines[i + 1:i + 4]
                        if 'Used' in x or 'spill' in x]
                print(f'{name}: {"; ".join(info)}', flush=True)


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else 'backward'
    if mode == 'gru-registers':
        gru_registers()
        return
    if mode not in MODES and mode not in GRU_MODES:
        sys.exit(f'usage: lstm_bwd_probe.py '
                 f'[{" | ".join([*MODES, *GRU_MODES, "gru-registers"])}]')
    if not torch.cuda.is_available():
        sys.exit('lstm_bwd_probe.py needs a card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    if mode in GRU_MODES:
        gru_main(mode)
        return
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
