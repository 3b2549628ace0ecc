"""Build the hand-written CUDA kernels at first use and load them.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library lands in ``padertorch_tpu_torch/_build/<hash>/``, keyed by a
hash of the sources and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  The build runs in the first process
that asks for a kernel; concurrent builds each write a private file and
rename it into place.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ['load_library', 'check', 'stream_and_device']

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC')
_LIB_NAME = 'libptt_kernels.so'

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes does not cut them to 32 bits)
_SIGNATURES = {
    'lstm_cell_scan_fwd': (_P,) * 9 + (_I,) * 5 + (_P,),
    'lstm_cell_scan_fwd_train': (_P,) * 11 + (_I,) * 5 + (_P,),
    'lstm_cell_scan_bwd': (_P,) * 10 + (_I,) * 5 + (_P,),
    'lstm_cell_scan_bwd_grid': (_I,) * 4 + (_P,),
    'gru_cell_scan_fwd': (_P,) * 7 + (_I,) * 5 + (_P,),
    'gru_cell_scan_fwd_train': (_P,) * 10 + (_I,) * 5 + (_P,),
    'gru_cell_scan_bwd': (_P,) * 10 + (_I,) * 5 + (_P,),
    'masked_istft_fwd': (_P,) * 5 + (_I,) * 7 + (_P,),
    'flash_attention_fwd': (_P,) * 6 + (_I,) * 9 + (_F, _I, _P),
    'flash_attention_bwd': (_P,) * 10 + (_I,) * 9 + (_F, _I, _P),
    'wavenet_sample_fwd': (_P,) * 13 + (_I,) * 10 + (_P,),
    'wavenet_sample_smem_bytes': (_I,) * 5,
    'fused_logmel_fwd': (_P,) * 4 + (_I,) * 8 + (_F, _I, _P),
    'int8_matmul_fwd': (_P,) * 4 + (_I,) + (_P,) * 2 + (_I,) * 5 + (_P,),
    'int8_matmul_bf16_fwd': (_P,) * 4 + (_I,) + (_P,) * 3 + (_I,) * 5
                            + (_P,),
}


def _sources():
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def _nvcc():
    for candidate in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if candidate and (Path(candidate) / 'bin' / 'nvcc').exists():
            return str(Path(candidate) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin '
            'and PATH): the CUDA kernels cannot be built')
    return found


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f'tmp{os.getpid()}'
        nvcc = _nvcc()
        units = [src for src in _sources() if src.suffix == '.cu']
        objects = [out_dir / f'{src.stem}.{tag}.o' for src in units]
        compiles = [[nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
                    for src, obj in zip(units, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = out_dir / f'{_LIB_NAME}.{tag}'
        link = [nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp),
                *[str(obj) for obj in objects]]
        try:
            for cmd, proc, log in zip(compiles, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(
                        f'nvcc failed ({proc.returncode}):\n'
                        f'{" ".join(cmd)}\n{log}')
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f'nvcc failed ({proc.returncode}):\n{" ".join(link)}\n'
                    f'{proc.stdout}\n{proc.stderr}')
            os.replace(tmp, lib_path)
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f'{what} failed: CUDA error {err} ({msg})')


def stream_and_device(tensor):
    """(current stream handle, device index) for a CUDA tensor."""
    import torch
    index = tensor.get_device()
    return torch._C._cuda_getCurrentRawStream(index), index
