"""ctypes bindings for the native host-side data-prep kernels.

Counterpart of ``padertorch_tpu/native/dataprep.py``, with its own copy of
``_dataprep.cpp``.  The source is compiled with ``c++`` at first use into
``padertorch_tpu_torch/_build/`` (keyed by a hash of the source; a build
writes a private file and renames it into place, so concurrent processes
do not collide) and the wrappers take and return numpy arrays.  The build
runs at the first call or the first read of ``NATIVE_AVAILABLE``, not at
import.  Every function has a numpy fallback, so the package works
without a compiler; ``NATIVE_AVAILABLE`` tells which path is active.
ctypes calls release the GIL, so the prefetch threads convert audio in
parallel with Python-level work.  This is host code: the card never sees
it.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    'NATIVE_AVAILABLE',
    'pcm16_to_float32',
    'mu_law_encode',
    'mu_law_decode',
    'frame_signal',
]

_SRC = Path(__file__).parent / '_dataprep.cpp'
_BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
_FLAGS = ('-O3', '-shared', '-fPIC')

_lib = None
_load_failed = False
_lock = threading.Lock()    # prefetch threads may ask for the build at once


def _so_path():
    key = hashlib.sha256(_SRC.read_bytes() + ' '.join(_FLAGS).encode())
    return _BUILD_DIR / f'dataprep_{key.hexdigest()[:16]}.so'


def _build(so):
    so.parent.mkdir(parents=True, exist_ok=True)
    private = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    for cc in ('c++', 'g++', 'cc'):
        try:
            subprocess.run([cc, *_FLAGS, str(_SRC), '-o', str(private)],
                           check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            continue
        os.replace(private, so)
        return True
    return False


def _load():
    """The loaded library, or None where it cannot be built or loaded
    (tried once a process)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = _so_path()
        try:
            if not so.exists() and not _build(so):
                raise OSError(f'no C++ compiler built {_SRC}')
            lib = ctypes.CDLL(str(so))
        except OSError:
            _load_failed = True
            return None
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        p = ctypes.c_void_p
        lib.pcm16_to_float32.argtypes = [p, p, i64]
        lib.mu_law_encode_f32.argtypes = [p, p, i64, i32]
        lib.mu_law_decode_u8.argtypes = [p, p, i64, i32]
        lib.frame_signal_f32.argtypes = [p, p, i64, i64, i64]
        for fn in (lib.pcm16_to_float32, lib.mu_law_encode_f32,
                   lib.mu_law_decode_u8, lib.frame_signal_f32):
            fn.restype = None
        _lib = lib
        return lib


def __getattr__(name):
    if name == 'NATIVE_AVAILABLE':
        return _load() is not None
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def pcm16_to_float32(pcm):
    """int16 PCM -> float32 in [-1, 1].

    >>> out = pcm16_to_float32(np.array([0, 16384, -32768], np.int16))
    >>> out.round(2).tolist()
    [0.0, 0.5, -1.0]
    """
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    out = np.empty(pcm.shape, np.float32)
    lib = _load()
    if lib is None:
        return (pcm / 32768.0).astype(np.float32)
    lib.pcm16_to_float32(_ptr(pcm), _ptr(out), pcm.size)
    return out


def mu_law_encode(x, mu_quantization=256):
    """float32 [-1, 1] -> uint8 mu-law indices (native hot path).

    >>> mu_law_encode(np.array([-1.0, 0.0, 1.0], np.float32)).tolist()
    [0, 128, 255]
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    lib = _load()
    if lib is None:
        import torch
        from padertorch_tpu_torch.ops.mu_law import mu_law_encode as ref
        return ref(torch.from_numpy(x), mu_quantization).numpy().astype(
            np.uint8)
    out = np.empty(x.shape, np.uint8)
    lib.mu_law_encode_f32(_ptr(x), _ptr(out), x.size, mu_quantization)
    return out


def mu_law_decode(idx, mu_quantization=256):
    """uint8 mu-law indices -> float32 [-1, 1].

    >>> x = np.linspace(-1, 1, 11).astype(np.float32)
    >>> rt = mu_law_decode(mu_law_encode(x))
    >>> bool(np.abs(rt - x).max() < 0.02)
    True
    """
    idx = np.ascontiguousarray(idx, dtype=np.uint8)
    lib = _load()
    if lib is None:
        import torch
        from padertorch_tpu_torch.ops.mu_law import mu_law_decode as ref
        return ref(torch.from_numpy(idx.astype(np.int32)),
                   mu_quantization).numpy()
    out = np.empty(idx.shape, np.float32)
    lib.mu_law_decode_u8(_ptr(idx), _ptr(out), idx.size, mu_quantization)
    return out


def frame_signal(signal, length, shift):
    """1-D float32 signal -> (n_frames, length) overlapping frames.

    >>> frame_signal(np.arange(10, dtype=np.float32), 4, 2).shape
    (4, 4)
    """
    signal = np.ascontiguousarray(signal, dtype=np.float32)
    n = signal.shape[-1]
    n_frames = max(0, (n - length) // shift + 1)
    out = np.empty((n_frames, length), np.float32)
    lib = _load()
    if lib is None:
        for f in range(n_frames):
            out[f] = signal[f * shift:f * shift + length]
        return out
    lib.frame_signal_f32(_ptr(signal), _ptr(out), n_frames, length, shift)
    return out
