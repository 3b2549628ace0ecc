"""Pickle-free checkpoint serialization.

Copy of ``load_state``/``dump_state`` of ``padertorch_tpu/serialize.py``:
the same file format, so the port reads the checkpoints the JAX trainer
writes with numpy alone.  A ``torch.Tensor`` in a state is stored as its
numpy array (the JAX package stores a ``jax.Array`` the same way).

Replaces the reference's ``torch.save``/``torch.load`` (pickle-based) with a
zip of ``arrays.npz`` + a JSON structure descriptor — safe to load from
untrusted storage, fast for large arrays, and independent of class layouts
(the state is plain nested dicts/lists of arrays and scalars, like torch
state dicts).
"""
import io
import json
import zipfile
from pathlib import Path

import numpy as np
import torch

__all__ = ['dump_state', 'load_state']

_MAGIC = 'padertorch_tpu-state-v1'


def _encode(obj, arrays):
    if isinstance(obj, dict):
        return {
            'k': 'dict',
            'items': [[k, _encode(v, arrays)] for k, v in obj.items()],
        }
    if isinstance(obj, (list, tuple)):
        return {
            'k': 'list' if isinstance(obj, list) else 'tuple',
            'items': [_encode(v, arrays) for v in obj],
        }
    if isinstance(obj, np.generic):
        obj = obj.item()
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if hasattr(obj, 'shape') and hasattr(obj, 'dtype'):
        idx = len(arrays)
        arrays.append(np.asarray(obj))
        return {'k': 'array', 'i': idx}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {'k': 'json', 'v': obj}
    raise TypeError(
        f'Cannot serialize object of type {type(obj).__name__}: {obj!r}. '
        'Checkpoint states must be nested dicts/lists of arrays and '
        'JSON-serializable scalars.'
    )


def _decode(enc, arrays):
    kind = enc['k']
    if kind == 'dict':
        return {k: _decode(v, arrays) for k, v in enc['items']}
    if kind == 'list':
        return [_decode(v, arrays) for v in enc['items']]
    if kind == 'tuple':
        return tuple(_decode(v, arrays) for v in enc['items'])
    if kind == 'array':
        return arrays[f'a{enc["i"]}']
    if kind == 'json':
        return enc['v']
    raise ValueError(f'Unknown state entry kind {kind!r}')


def dump_state(state, path):
    """Write a nested state (dicts/lists of arrays + scalars) to ``path``.

    The write is atomic: a temp file is renamed into place, so a crash
    mid-checkpoint never corrupts an existing checkpoint.
    """
    path = Path(path)
    arrays = []
    structure = _encode(state, arrays)
    buf = io.BytesIO()
    np.savez(buf, **{f'a{i}': a for i, a in enumerate(arrays)})
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + '.tmp')
    with zipfile.ZipFile(tmp, 'w', zipfile.ZIP_STORED) as zf:
        zf.writestr('MAGIC', _MAGIC)
        zf.writestr('structure.json', json.dumps(structure))
        zf.writestr('arrays.npz', buf.getvalue())
    tmp.replace(path)
    return path


def load_state(path):
    """Load a state written by :func:`dump_state`.

    ``path`` may also be a file-like object (e.g. a ``BytesIO`` of
    broadcast checkpoint bytes in multi-process runs).
    """
    if not hasattr(path, 'read'):
        path = Path(path)
    with zipfile.ZipFile(path, 'r') as zf:
        magic = zf.read('MAGIC').decode()
        if magic != _MAGIC:
            raise ValueError(f'Not a padertorch_tpu state file: {path}')
        structure = json.loads(zf.read('structure.json'))
        with zf.open('arrays.npz') as f:
            arrays = np.load(io.BytesIO(f.read()))
            return _decode(structure, arrays)
