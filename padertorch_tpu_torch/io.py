"""Experiment storage directories and config (de)serialization.

Copy of ``padertorch_tpu/io.py`` (reference ``padertorch/io.py``), without
its multi-process branch:
- ``get_new_storage_dir``: ``$STORAGE_ROOT/<experiment>/<index>`` creation,
  race-safe across processes via atomic ``mkdir``.
- ``dump_config`` / ``load_config``: a JSON/YAML round trip with
  factory-to-string conversion and stable key order.  A written config
  names the port's classes by their path in the JAX package
  (``padertorch_tpu.models...``), which both packages resolve (the port's
  ``import_class`` maps it back), so one ``config.json`` serves both.
"""
import json
import os
import re
from pathlib import Path

from padertorch_tpu_torch.configurable import recursive_class_to_str

__all__ = [
    'get_new_storage_dir',
    'get_new_subdir',
    'dump_config',
    'dumps_config',
    'load_config',
    'loads_config',
]


def get_new_subdir(
        basedir,
        *,
        id_naming='index',
        mkdir=True,
        prefix=None,
        suffix=None,
):
    """Create a new uniquely-numbered subdirectory of ``basedir``.

    Reference parity: ``paderbox.io.new_subdir.get_new_subdir`` as used by
    ``padertorch/io.py:8``.  ``id_naming='index'`` yields 1, 2, 3, ...;
    ``id_naming='time'`` yields a timestamp.  Creation is race-safe:
    ``Path.mkdir`` is atomic, on collision the next index is tried.
    """
    basedir = Path(basedir).expanduser().resolve()
    if mkdir:
        basedir.mkdir(parents=True, exist_ok=True)

    def candidates():
        if id_naming == 'index':
            existing = []
            for p in basedir.glob('*'):
                m = re.fullmatch(
                    rf'{re.escape(prefix or "")}(\d+){re.escape(suffix or "")}',
                    p.name)
                if m:
                    existing.append(int(m.group(1)))
            start = max(existing, default=0) + 1
            i = start
            while True:
                yield f'{prefix or ""}{i}{suffix or ""}'
                i += 1
        elif id_naming == 'time':
            import datetime
            i = 0
            while True:
                stamp = datetime.datetime.now().strftime(
                    '%Y-%m-%d-%H-%M-%S')
                yield f'{prefix or ""}{stamp}{"-" + str(i) if i else ""}' \
                      f'{suffix or ""}'
                i += 1
        else:
            raise ValueError(f'Unknown id_naming: {id_naming!r}')

    for name in candidates():
        path = basedir / name
        if not mkdir:
            if not path.exists():
                return path
            continue
        try:
            path.mkdir(parents=False, exist_ok=False)
            return path
        except FileExistsError:
            continue


def get_new_storage_dir(
        experiment_name,
        *,
        id_naming='index',
        mkdir=True,
        prefix=None,
        suffix=None,
):
    """``$STORAGE_ROOT/<experiment_name>/<new index>``.

    Reference parity: ``padertorch/io.py:8``. Requires the environment
    variable ``STORAGE_ROOT``.
    """
    if 'STORAGE_ROOT' not in os.environ:
        raise EnvironmentError(
            'You have to specify an STORAGE_ROOT environment variable, '
            'e.g. `export STORAGE_ROOT=/path/to/your/storage`.'
        )
    basedir = Path(os.environ['STORAGE_ROOT']) / experiment_name
    return get_new_subdir(
        basedir, id_naming=id_naming, mkdir=mkdir,
        prefix=prefix, suffix=suffix,
    )


def _shared_factory_names(config):
    """Factory paths under the port's package -> the JAX package's."""
    if isinstance(config, dict):
        return {
            k: 'padertorch_tpu.' + v[len('padertorch_tpu_torch.'):]
            if k in ('factory', 'partial') and isinstance(v, str)
            and v.startswith('padertorch_tpu_torch.')
            else _shared_factory_names(v)
            for k, v in config.items()
        }
    if isinstance(config, (list, tuple)):
        return type(config)(_shared_factory_names(v) for v in config)
    return config


def dumps_config(config, format='json'):
    """Serialize a config to a JSON (default) or YAML string."""
    config = _shared_factory_names(recursive_class_to_str(config))
    if format == 'json':
        return json.dumps(config, indent=2, sort_keys=False) + '\n'
    if format in ('yaml', 'yml'):
        import yaml
        return yaml.safe_dump(config, sort_keys=False)
    raise ValueError(f'Unknown config format: {format!r}')


def dump_config(config, path):
    """Write a config to ``path`` (format from suffix: .json/.yaml/.yml)."""
    path = Path(path)
    fmt = path.suffix.lstrip('.') or 'json'
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + '.tmp')
    tmp.write_text(dumps_config(config, format=fmt))
    tmp.replace(path)  # atomic on POSIX
    return path


def loads_config(text, format='json'):
    if format == 'json':
        return json.loads(text)
    if format in ('yaml', 'yml'):
        import yaml
        return yaml.safe_load(text)
    raise ValueError(f'Unknown config format: {format!r}')


def load_config(path):
    path = Path(path)
    fmt = path.suffix.lstrip('.') or 'json'
    return loads_config(path.read_text(), format=fmt)
