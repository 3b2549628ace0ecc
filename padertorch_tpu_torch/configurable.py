"""JSON-serializable nested configuration for modules and factories.

Copy of ``padertorch_tpu/configurable.py`` for the PyTorch port (the
reference's config system, ``padertorch/configurable.py``).  Two changes:
``import_class`` resolves a ``padertorch_tpu.`` path, as configs written
by the JAX package name their classes, to the port's counterpart at the
same path under ``padertorch_tpu_torch.``; and ``from_file`` reads the
file on the calling process only.  Same observable behavior:

- ``Configurable.get_config(updates)`` reads defaults from ``__init__``
  signatures, applies ``finalize_dogmatic_config`` with *dogmatic* (Sacred
  style) priority — user updates outrank values assigned inside
  ``finalize_dogmatic_config``, which outrank signature defaults — and
  returns a JSON-serializable dict with a ``'factory'`` key.
- ``Configurable.from_config(config)`` recursively instantiates nested
  ``'factory'`` entries; ``'partial'`` entries become ``functools.partial``.
- ``Configurable.from_file`` loads JSON/YAML configs (optionally from a
  nested ``in_config_path`` such as ``'trainer.model'``).

The implementation is new (three-layer lazy priority resolution instead of
the reference's NestedChainMap), but the contract matches the reference's
doctest suite, which is mirrored in ``tests/test_configurable.py``.

Example:

    >>> class DenseLayer(Configurable):
    ...     def __init__(self, in_units, out_units=3):
    ...         self.in_units = in_units
    ...         self.out_units = out_units
    >>> DenseLayer.get_config({'in_units': 5})  # doctest: +ELLIPSIS
    {'factory': '...DenseLayer', 'in_units': 5, 'out_units': 3}
"""
import builtins
import copy
import dataclasses
import difflib
import functools
import importlib
import inspect
import json
import sys
from pathlib import Path

__all__ = [
    'Configurable',
    'import_class',
    'class_to_str',
    'recursive_class_to_str',
    'config_to_instance',
    'fix_doctext_import_class',
    'NestedChainMap',
    'resolve_main_python_path',
    'get_module_name_from_file',
]


# Registry for callables that cannot be re-imported (classes defined in
# doctests, notebooks, or interactive sessions).  ``class_to_str`` registers
# such objects here; ``import_class`` consults it after real imports fail.
_UNIMPORTABLE_REGISTRY = {}


def fix_doctext_import_class(locals_dict):
    """Make classes defined in a doctest importable via ``import_class``.

    Kept for API parity with the reference (``configurable.py:743``).  In
    this implementation registration happens automatically inside
    ``class_to_str``, so this only has to fix the doctest module name.
    """
    # Classes defined in doctests inherit ``__name__`` of the doctest
    # globals; nothing else to do thanks to _UNIMPORTABLE_REGISTRY.
    del locals_dict


def resolve_main_python_path() -> str:
    """Return the importable module path of ``__main__``.

    Fixes ``__main__.MyModel`` to ``my.script.MyModel`` when the script was
    started with ``python -m my.script`` (reference: ``configurable.py:967``).
    """
    main = sys.modules.get('__main__')
    spec = getattr(main, '__spec__', None)
    if spec is not None and spec.name not in (None, '__main__'):
        # Only active for ``python -m pkg.script`` (like the reference);
        # for ``python script.py`` re-importing would re-execute the script.
        name = spec.name
        return name[:-len('.__main__')] if name.endswith('.__main__') else name
    return '__main__'


def get_module_name_from_file(file):
    """Importable module path of a source file, by walking up while
    ``__init__.py`` exists (reference: ``configurable.py:944``).

    >>> get_module_name_from_file(__file__)
    'padertorch_tpu_torch.configurable'
    """
    import os
    file = os.path.normcase(os.path.abspath(file))
    file, module_path = os.path.split(file)
    module_path = os.path.splitext(module_path)[0]
    while file:
        if not os.path.isfile(os.path.join(file, '__init__.py')):
            break
        file, part = os.path.split(file)
        module_path = part + '.' + module_path
    return module_path if '.' in module_path else '__main__'


def class_to_str(cls) -> str:
    """Return the importable dotted path for a class/function.

    >>> class_to_str(dict)
    'dict'
    >>> class_to_str('padertorch_tpu_torch.configurable.Configurable')
    'padertorch_tpu_torch.configurable.Configurable'
    """
    if isinstance(cls, str):
        return cls
    module = getattr(cls, '__module__', None)
    name = getattr(cls, '__qualname__', None) or getattr(cls, '__name__', None)
    if name is None:
        raise TypeError(f'Cannot convert {cls!r} to an import path.')
    if module == '__main__':
        module = resolve_main_python_path()
    if module in (None, 'builtins'):
        full = name
    else:
        full = f'{module}.{name}'
    # Register objects that cannot be re-imported (doctest/notebook classes)
    # so that import_class can round-trip them.
    try:
        reimported = _import_class_strict(full)
        importable = reimported is cls
    except Exception:
        importable = False
    if not importable:
        _UNIMPORTABLE_REGISTRY[full] = cls
    return full


_JAX_PACKAGE = 'padertorch_tpu'
_PORT_PACKAGE = 'padertorch_tpu_torch'


def _import_class_strict(name: str):
    if name.startswith(_JAX_PACKAGE + '.'):
        name = _PORT_PACKAGE + name[len(_JAX_PACKAGE):]
    if '.' not in name:
        if hasattr(builtins, name):
            return getattr(builtins, name)
        return importlib.import_module(name)
    parts = name.split('.')
    module = None
    split = None
    for i in range(len(parts), 0, -1):
        try:
            module = importlib.import_module('.'.join(parts[:i]))
            split = i
            break
        except ImportError:
            continue
    if module is None:
        raise ImportError(f'Could not import any module prefix of {name!r}.')
    obj = module
    for attr in parts[split:]:
        try:
            obj = getattr(obj, attr)
        except AttributeError as e:
            raise ImportError(
                f"Could not import {'.'.join(parts[split:])!r} from "
                f"{'.'.join(parts[:split])!r},\nbecause {e}\n\n"
                'Make sure that\n'
                ' 1. This is the class you want to import.\n'
                ' 2. You activated the right environment.\n'
                ' 3. The module exists and has been installed with pip.\n'
                ' 4. You can import the module (and class) in ipython.\n'
            ) from None
    return obj


def import_class(name):
    """Import a dotted path; inverse of :func:`class_to_str`.

    Non-str inputs are returned unchanged.

    >>> import_class('dict')
    <class 'dict'>
    >>> import_class(dict)
    <class 'dict'>
    """
    if not isinstance(name, str):
        return name
    try:
        return _import_class_strict(name)
    except ImportError:
        if name in _UNIMPORTABLE_REGISTRY:
            return _UNIMPORTABLE_REGISTRY[name]
        raise


def recursive_class_to_str(config):
    """Deep-convert 'factory'/'partial' values and Paths to strings.

    >>> recursive_class_to_str({'factory': dict, 'p': Path('/tmp')})
    {'factory': 'dict', 'p': '/tmp'}
    """
    if isinstance(config, dict):
        return {
            k: class_to_str(v) if k in ('factory', 'partial') and not
            isinstance(v, (dict, list, tuple))
            else recursive_class_to_str(v)
            for k, v in config.items()
        }
    if isinstance(config, (list, tuple)):
        return type(config)(recursive_class_to_str(v) for v in config)
    if isinstance(config, Path):
        return str(config)
    return config


def _signature_defaults(factory):
    """Parameters of ``factory`` that carry a default value, in order.

    Returns (defaults_dict, parameter_names_in_order, has_var_keyword).
    """
    try:
        sig = inspect.signature(factory)
    except (ValueError, TypeError):
        return {}, [], True
    defaults = {}
    order = []
    has_var_kw = False
    for name, p in sig.parameters.items():
        if p.kind in (p.VAR_POSITIONAL,):
            continue
        if p.kind is p.VAR_KEYWORD:
            has_var_kw = True
            continue
        order.append(name)
        if p.default is not p.empty:
            defaults[name] = p.default
    return defaults, order, has_var_kw


def _effective_factory(updates, assigned):
    """Resolve the factory/partial of a config level. Returns (key, obj)."""
    for special in ('factory', 'partial'):
        if special in updates:
            return special, import_class(updates[special])
    for special in ('factory', 'partial'):
        if special in assigned:
            return special, import_class(assigned[special])
    return None, None


class _DogmaticConfig:
    """Mutable config view with Sacred-style dogmatic priority.

    Three priority layers, high to low:
      1. ``updates``   — user-provided; reads win, writes never touch it.
      2. ``assigned``  — values set inside ``finalize_dogmatic_config``.
      3. signature defaults of the effective factory, computed lazily so a
         factory change through an update immediately swaps the defaults.
    """

    def __init__(self, updates=None, assigned=None):
        self._updates = {} if updates is None else updates
        self._assigned = {} if assigned is None else assigned

    # -- factory handling --------------------------------------------------
    @property
    def special_key_and_factory(self):
        return _effective_factory(self._updates, self._assigned)

    def _defaults(self):
        _, factory = self.special_key_and_factory
        if factory is None:
            return {}, []
        defaults, order, _ = _signature_defaults(factory)
        return defaults, order

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key):
        if key in ('factory', 'partial'):
            special, factory = self.special_key_and_factory
            if special == key:
                return factory
            raise KeyError(key)
        for layer_name in ('updates', 'assigned'):
            layer = getattr(self, f'_{layer_name}')
            if key in layer:
                value = layer[key]
                if isinstance(value, (dict, _DogmaticConfig)):
                    return self._sub_view(key)
                return value
        defaults, _ = self._defaults()
        if key in defaults:
            value = defaults[key]
            if isinstance(value, dict):
                # Persist so mutations through the view survive.
                self._assigned[key] = copy.deepcopy(value)
                return self._sub_view(key)
            return value
        raise KeyError(key)

    def _sub_view(self, key):
        up = self._updates.get(key, {})
        if not isinstance(up, (dict, _DogmaticConfig)):
            # Non-dict update wins outright over a dict assignment.
            return up
        assigned = self._assigned.get(key)
        if isinstance(assigned, _DogmaticConfig):
            assigned = assigned._to_plain()
            self._assigned[key] = assigned
        if not isinstance(assigned, dict):
            assigned = {}
            self._assigned[key] = assigned
        if isinstance(up, _DogmaticConfig):
            up = up._to_plain()
        return _DogmaticConfig(updates=up, assigned=assigned)

    def __setitem__(self, key, value):
        if isinstance(value, _DogmaticConfig):
            value = value._to_plain()
        self._assigned[key] = value

    def __delitem__(self, key):
        found = False
        for layer in (self._updates, self._assigned):
            if key in layer:
                del layer[key]
                found = True
        if not found:
            raise KeyError(key)

    def __contains__(self, key):
        if key in self._updates or key in self._assigned:
            return True
        defaults, _ = self._defaults()
        return key in defaults

    def keys(self):
        defaults, order = self._defaults()
        seen = []
        special, _ = self.special_key_and_factory
        if special is not None:
            seen.append(special)
        for source in (order, self._updates, self._assigned):
            for k in source:
                if k in ('factory', 'partial'):
                    continue
                if k in seen:
                    continue
                if k in self._updates or k in self._assigned or k in defaults:
                    seen.append(k)
        return seen

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self.keys())

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def setdefault(self, key, default):
        if key not in self:
            self[key] = default
        return self[key]

    def update(self, other=(), **kwargs):
        items = other.items() if hasattr(other, 'items') else other
        for k, v in items:
            self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]

    def __repr__(self):
        body = ', '.join(f'{k!r}: {self.get(k)!r}' for k in self.keys())
        return f'{type(self).__name__}({{{body}}})'

    def _to_plain(self):
        """Collapse to a plain dict preserving priority (no finalization)."""
        defaults, _ = self._defaults()
        out = {}
        special, factory = self.special_key_and_factory
        if special is not None:
            out[special] = factory
        for k in self.keys():
            if k in ('factory', 'partial'):
                continue
            for layer in (self._updates, self._assigned, defaults):
                if k in layer:
                    v = layer[k]
                    if isinstance(v, _DogmaticConfig):
                        v = v._to_plain()
                    out[k] = v
                    break
        return out

    # -- finalization --------------------------------------------------------
    def to_dict(self, _seen=None):
        """Run finalize_dogmatic_config recursively, return plain dict."""
        special, factory = self.special_key_and_factory
        if special == 'factory' and factory is not None:
            finalize = getattr(factory, 'finalize_dogmatic_config', None)
            if finalize is not None:
                finalize(self)
        out = {}
        if special is not None:
            out[special] = class_to_str(factory)
        for key in self.keys():
            if key in ('factory', 'partial'):
                continue
            value = self[key]
            out[key] = _finalize_value(value)
        return out


def _finalize_value(value):
    if isinstance(value, _DogmaticConfig):
        sp, _ = value.special_key_and_factory
        if sp is not None:
            return value.to_dict()
        return {
            k: _finalize_value(value[k]) for k in value.keys()
        }
    if isinstance(value, dict):
        if 'factory' in value or 'partial' in value:
            return _DogmaticConfig(updates={}, assigned=dict(value)).to_dict()
        return {k: _finalize_value(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_finalize_value(v) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclass_to_config(value)
    return value


def dataclass_to_config(obj):
    """Convert a dataclass instance to a factory config dict.

    Reference parity: ``configurable.py:613``.
    """
    config = {'factory': class_to_str(type(obj))}
    for f in dataclasses.fields(obj):
        config[f.name] = _finalize_value(getattr(obj, f.name))
    return config


class ConfigError(Exception):
    pass


def _test_config(config, path='config'):
    """Validate a finalized config: signature bind + JSON serializability."""
    if isinstance(config, dict):
        special = ('factory' if 'factory' in config
                   else 'partial' if 'partial' in config else None)
        if special is not None:
            factory = import_class(config[special])
            kwargs = {k: v for k, v in config.items() if k != special}
            try:
                sig = inspect.signature(factory)
            except (ValueError, TypeError):
                sig = None
            if sig is not None:
                try:
                    if special == 'partial':
                        sig.bind_partial(**kwargs)
                    else:
                        sig.bind(**kwargs)
                except TypeError as e:
                    params = list(sig.parameters)
                    unexpected = [k for k in kwargs if k not in params
                                  if not any(
                                      p.kind is p.VAR_KEYWORD
                                      for p in sig.parameters.values())]
                    hints = []
                    for k in unexpected:
                        close = difflib.get_close_matches(k, params, n=3)
                        if close:
                            hints.append(
                                f'  {k!r}: did you mean one of {close}?')
                    hint_text = ('\n' + '\n'.join(hints)) if hints else ''
                    raise ConfigError(
                        f'Invalid config for {path!r} '
                        f'(factory {class_to_str(factory)}):\n'
                        f'  {e}{hint_text}\n'
                        f'  Signature: {sig}\n'
                        f'  Got kwargs: {sorted(kwargs)}'
                    ) from None
            for k, v in kwargs.items():
                _test_config(v, path=f'{path}.{k}')
        else:
            for k, v in config.items():
                _test_config(v, path=f'{path}.{k}')
    elif isinstance(config, (list, tuple)):
        for i, v in enumerate(config):
            _test_config(v, path=f'{path}[{i}]')


def _test_json(config):
    try:
        json.dumps(recursive_class_to_str(config))
    except TypeError as e:
        raise ConfigError(
            f'Config is not JSON serializable: {e}\nConfig: {config!r}'
        ) from None


def config_to_instance(config):
    """Recursively instantiate a finalized config.

    Reference parity: ``configurable.py:1267``.

    - dict with ``'factory'`` -> ``factory(**instantiated_kwargs)``
    - dict with ``'partial'`` -> ``functools.partial(factory, **kwargs)``
    - lists/tuples/other dicts recursed, leaves returned as-is.
    """
    if isinstance(config, dict):
        if 'factory' in config:
            factory = import_class(config['factory'])
            kwargs = {
                k: config_to_instance(v)
                for k, v in config.items() if k != 'factory'
            }
            instance = factory(**kwargs)
            try:
                instance.config = recursive_class_to_str(
                    copy.deepcopy(config))
            except (AttributeError, TypeError):
                pass
            return instance
        if 'partial' in config:
            factory = import_class(config['partial'])
            kwargs = {
                k: config_to_instance(v)
                for k, v in config.items() if k != 'partial'
            }
            return functools.partial(factory, **kwargs)
        return {k: config_to_instance(v) for k, v in config.items()}
    if isinstance(config, (list, tuple)):
        return type(config)(config_to_instance(v) for v in config)
    return config


# Backwards-compatible alias: the reference exposes NestedChainMap as the
# public name of its dogmatic mapping (``configurable.py:1383``).
NestedChainMap = _DogmaticConfig


class Configurable:
    """Make subclasses configurable from JSON-serializable dicts.

    See module docstring. Reference parity: ``configurable.py:34``.
    """

    @classmethod
    def finalize_dogmatic_config(cls, config):
        """Fill in nested/dependent defaults; override in subclasses.

        ``config`` behaves like a Sacred dogmatic dict: user updates have
        priority over assignments made here.
        """

    @classmethod
    def get_config(cls, updates=None):
        """Return the finalized, JSON-serializable config dict."""
        target = cls
        if cls.__module__ == '__main__':
            target = import_class(class_to_str(cls))
        if isinstance(updates, _DogmaticConfig):
            raise ValueError(
                'get_config does not accept a dogmatic dict; it does not '
                'need to be called inside finalize_dogmatic_config.'
            )
        external_updates = updates if isinstance(updates, dict) else None
        updates = copy.deepcopy(updates) if updates else {}
        if 'factory' not in updates and 'partial' not in updates:
            updates['factory'] = target
        dogmatic = _DogmaticConfig(updates=updates, assigned={})
        config = dogmatic.to_dict()
        _test_config(config)
        _test_json(config)
        if external_updates is not None:
            # Sacred-style in-place propagation of the finalized config.
            external_updates.clear()
            external_updates.update(copy.deepcopy(config))
        return config

    @classmethod
    def from_config(cls, config):
        """Instantiate from a finalized config dict."""
        assert isinstance(config, dict), config
        assert 'factory' in config or 'partial' in config, config
        if 'factory' in config:
            factory = import_class(config['factory'])
            if isinstance(factory, type) and isinstance(cls, type) \
                    and cls not in (Configurable,) \
                    and isinstance(factory, type):
                # Loose check like the reference: warn-free acceptance of
                # subclasses and unrelated factories (duck typing).
                pass
        return config_to_instance(config)

    @classmethod
    def new(cls, updates=None):
        """``from_config(get_config(updates))`` in one call."""
        return cls.from_config(cls.get_config(updates))

    @classmethod
    def from_file(
            cls,
            config_path,
            in_config_path='',
    ):
        """Instantiate from a JSON/YAML config file.

        Args:
            config_path: path to ``config.json`` / ``config.yaml``.
            in_config_path: dotted path inside the file, e.g.
                ``'trainer.model'``.
        """
        from padertorch_tpu_torch.io import load_config
        from padertorch_tpu_torch.utils.nested import get_by_path
        config = load_config(config_path)
        if in_config_path:
            config = get_by_path(config, in_config_path)
        return cls.from_config(config)

    @property
    def config(self):
        cfg = getattr(self, '_config', None)
        if cfg is None:
            raise AttributeError(
                f'{type(self).__name__} was not created via from_config, '
                'so it has no config.'
            )
        return cfg

    @config.setter
    def config(self, value):
        self._config = value
