"""Sacred-style command-line config overrides.

The reference drives its recipes with sacred: ``python -m ...train
with batch_size=8 model.units=300 dprnn`` (SURVEY.md §5).  This module
provides the same UX without the sacred dependency:

>>> updates, named = parse_with_updates(
...     ['with', 'batch_size=8', 'model.units=300', 'dprnn'])
>>> updates
{'batch_size': 8, 'model': {'units': 300}}
>>> named
['dprnn']

Values parse as JSON first (numbers, booleans, lists, null), falling
back to plain strings:

>>> parse_with_updates(['with', 'lr=1e-3', 'name=run1',
...                     'flags=[1,2]'])[0]
{'lr': 0.001, 'name': 'run1', 'flags': [1, 2]}

Integration (preferred — sacred's dogmatic contract): parse the
overrides *first* and hand them to ``get_config`` as updates, so
``finalize_dogmatic_config`` sees them and they outrank its
assignments::

    args, rest = parser.parse_known_args()
    updates, named = parse_with_updates(rest)
    config = get_trainer_config(storage_dir, nested_merge(
        base_updates, updates))

:func:`apply_cli_updates` remains for post-finalization use (e.g. when
the config comes from a file); it *validates* every override path
against the finalized config and raises on unknown keys with a
difflib suggestion, instead of silently inserting typos.
"""
import difflib
import json

from padertorch_tpu_torch.utils.nested import nested_merge

__all__ = ['parse_with_updates', 'apply_cli_updates']


def _parse_value(text):
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


def parse_with_updates(argv):
    """Parse sacred-style CLI tokens.

    Args:
        argv: leftover CLI tokens; an optional leading ``with`` is
            skipped.  ``a.b=c`` tokens become nested updates, bare
            tokens are collected as named-config selectors.

    Returns:
        (updates dict, list of named-config names)
    """
    updates = {}
    named = []
    tokens = list(argv)
    if tokens and tokens[0] == 'with':
        tokens = tokens[1:]
    for token in tokens:
        if '=' not in token:
            named.append(token)
            continue
        key, _, value = token.partition('=')
        parts = key.split('.')
        if not all(parts):
            raise ValueError(
                f'Malformed override {token!r}: empty key component')
        node = updates
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_value(value)
    return updates, named


def apply_cli_updates(config, argv, named_configs=None):
    """Merge sacred-style CLI overrides into a config dict.

    Args:
        config: the (dogmatic) config from ``get_config``.
        argv: leftover CLI tokens (see :func:`parse_with_updates`).
        named_configs: optional dict name -> update-dict (the analog
            of sacred named configs); selected by bare tokens.

    Every override path must already exist in ``config`` (typos raise
    with a suggestion instead of being silently inserted):

    >>> cfg = {'lr': 1.0, 'model': {'units': 600}}
    >>> apply_cli_updates(cfg, ['with', 'model.units=300', 'small'],
    ...                   named_configs={'small': {'lr': 0.1}})
    {'lr': 0.1, 'model': {'units': 300}}
    >>> apply_cli_updates(cfg, ['with', 'model.unitz=300'])
    Traceback (most recent call last):
    ...
    KeyError: "Unknown config key 'model.unitz'; did you mean 'model.units'?"
    """
    updates, named = parse_with_updates(argv)
    _validate_paths(config, updates)
    merged = config
    for name in named:
        if named_configs is None or name not in named_configs:
            known = sorted(named_configs or [])
            raise ValueError(
                f'Unknown named config {name!r}; known: {known}')
        merged = nested_merge(merged, named_configs[name])
    return nested_merge(merged, updates)


def _validate_paths(config, updates, _prefix=''):
    """Raise KeyError (with a difflib suggestion) for override paths
    that do not exist in the finalized config."""
    for key, value in updates.items():
        path = f'{_prefix}{key}'
        if not isinstance(config, dict) or key not in config:
            candidates = list(config) if isinstance(config, dict) else []
            close = difflib.get_close_matches(key, [
                str(c) for c in candidates], n=1)
            suggestion = (
                f"; did you mean '{_prefix}{close[0]}'?" if close else
                f'; known keys: {sorted(map(str, candidates))}')
            raise KeyError(
                f'Unknown config key {path!r}{suggestion}')
        if isinstance(value, dict):
            _validate_paths(config[key], value, _prefix=f'{path}.')
