"""Nested container (dict/list/tuple/dataclass) utilities.

Copy of ``padertorch_tpu/utils/nested.py``.

TPU-native replacement for the small subset of ``paderbox.utils.nested`` that
the reference framework relies on (see reference ``padertorch/data/batch.py``,
``padertorch/configurable.py``).  Implemented from scratch for this framework;
works on arbitrary pytree-like nests without requiring jax.
"""
import dataclasses
import collections.abc

__all__ = [
    'flatten',
    'deflatten',
    'nested_merge',
    'nested_update',
    'nested_op',
    'nested_any',
    'get_by_path',
    'set_by_path',
]


def flatten(d, sep='.', *, _prefix=''):
    """Flatten a nested dict into a flat dict with joined keys.

    >>> flatten({'a': {'b': 1, 'c': {'d': 2}}, 'e': 3})
    {'a.b': 1, 'a.c.d': 2, 'e': 3}
    >>> flatten({'a': {}})
    {'a': {}}
    """
    out = {}
    for k, v in d.items():
        key = f'{_prefix}{sep}{k}' if _prefix else str(k)
        if isinstance(v, dict) and len(v) > 0:
            out.update(flatten(v, sep=sep, _prefix=key))
        else:
            out[key] = v
    return out


def deflatten(d, sep='.', maxdepth=-1):
    """Inverse of :func:`flatten`.

    >>> deflatten({'a.b': 1, 'a.c.d': 2, 'e': 3})
    {'a': {'b': 1, 'c': {'d': 2}}, 'e': 3}
    >>> deflatten({('a', 'b'): 1}, sep=None)
    {'a': {'b': 1}}
    """
    out = {}
    for key, v in d.items():
        if sep is None:
            parts = list(key) if isinstance(key, tuple) else [key]
        else:
            parts = key.split(sep, maxdepth) if isinstance(key, str) else [key]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(
                    f'Cannot deflatten {key!r}: {p!r} already holds a leaf.')
        node[parts[-1]] = v
    return out


def nested_merge(default, *updates, allow_update=True):
    """Merge nested dicts; later arguments win on conflicts.

    >>> nested_merge({'a': {'b': 1, 'c': 2}}, {'a': {'b': 3}})
    {'a': {'b': 3, 'c': 2}}
    """
    if not updates:
        return default
    result = default
    for update in updates:
        if isinstance(result, dict) and isinstance(update, dict):
            merged = dict(result)
            for k, v in update.items():
                if k in merged:
                    if not allow_update and not (
                            isinstance(merged[k], dict)
                            and isinstance(v, dict)):
                        raise ValueError(f'Conflict for key {k!r}')
                    merged[k] = nested_merge(
                        merged[k], v, allow_update=allow_update)
                else:
                    merged[k] = v
            result = merged
        else:
            result = update
    return result


def nested_update(target, update):
    """In-place nested update of ``target`` with ``update``.

    >>> d = {'a': {'b': 1}}
    >>> nested_update(d, {'a': {'c': 2}})
    >>> d
    {'a': {'b': 1, 'c': 2}}
    """
    for k, v in update.items():
        if (
                k in target
                and isinstance(target[k], dict)
                and isinstance(v, dict)
        ):
            nested_update(target[k], v)
        else:
            target[k] = v


def _is_leaf(obj, sequence_types, mapping_type):
    return not (
        isinstance(obj, mapping_type)
        or isinstance(obj, sequence_types)
        or dataclasses.is_dataclass(obj)
    )


def nested_op(
        func,
        arg1,
        *args,
        broadcast=False,
        handle_dataclass=True,
        keep_type=True,
        mapping_type=collections.abc.Mapping,
        sequence_type=(tuple, list),
):
    """Apply ``func`` to the leaves of parallel nested structures.

    Mirrors the behavior the reference relies on from
    ``paderbox.utils.nested.nested_op`` (used in ``data/batch.py``):
    recurses through dicts/lists/tuples/dataclasses of the first argument,
    zipping the remaining arguments.

    >>> nested_op(lambda a, b: a + b, {'x': [1, 2]}, {'x': [10, 20]})
    {'x': [11, 22]}
    >>> nested_op(lambda a, b: a + b, {'x': 1}, 2, broadcast=True)
    {'x': 3}
    """
    def recurse(a1, *rest):
        if isinstance(a1, mapping_type):
            out = {}
            for k in a1.keys():
                rest_k = [
                    r[k] if isinstance(r, mapping_type) or not broadcast
                    else r
                    for r in rest
                ]
                out[k] = recurse(a1[k], *rest_k)
            if keep_type and type(a1) is not dict:
                try:
                    return type(a1)(out)
                except TypeError:
                    return out
            return out
        if isinstance(a1, sequence_type):
            out = []
            for i, v in enumerate(a1):
                rest_i = [
                    r[i] if isinstance(r, sequence_type) or not broadcast
                    else r
                    for r in rest
                ]
                out.append(recurse(v, *rest_i))
            if keep_type:
                return type(a1)(out)
            return out
        if handle_dataclass and dataclasses.is_dataclass(a1) \
                and not isinstance(a1, type):
            kwargs = {}
            for f in dataclasses.fields(a1):
                rest_f = [
                    getattr(r, f.name)
                    if dataclasses.is_dataclass(r) or not broadcast else r
                    for r in rest
                ]
                kwargs[f.name] = recurse(getattr(a1, f.name), *rest_f)
            return type(a1)(**kwargs)
        return func(a1, *rest)

    return recurse(arg1, *args)


def nested_any(func, arg):
    """True if ``func`` is true for any leaf of the nest."""
    found = []

    def check(leaf):
        if func(leaf):
            found.append(True)
        return leaf

    nested_op(check, arg)
    return bool(found)


def get_by_path(d, path, sep='.'):
    """``get_by_path({'a': {'b': 1}}, 'a.b') == 1``"""
    if path in ('', None):
        return d
    node = d
    for p in (path.split(sep) if isinstance(path, str) else path):
        node = node[p]
    return node


def set_by_path(d, path, value, sep='.'):
    """Set a nested value by dotted path, creating intermediate dicts."""
    parts = path.split(sep) if isinstance(path, str) else list(path)
    node = d
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value
