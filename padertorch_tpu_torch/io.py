"""Config (de)serialization.

Copy of the config half of ``padertorch_tpu/io.py`` (reference
``padertorch/io.py``): ``dump_config`` / ``load_config``, a JSON/YAML round
trip with factory-to-string conversion and stable key order.
"""
import json
from pathlib import Path

from padertorch_tpu_torch.configurable import recursive_class_to_str

__all__ = [
    'dump_config',
    'dumps_config',
    'load_config',
    'loads_config',
]


def dumps_config(config, format='json'):
    """Serialize a config to a JSON (default) or YAML string."""
    config = recursive_class_to_str(config)
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
