"""Run every module-level doctest of the port.

As ``tests/test_doctests.py`` does for ``padertorch_tpu``: any ``.py``
under ``padertorch_tpu_torch`` with a ``>>>`` prompt runs as one
parametrized test, so a failing example names its module.
"""
import doctest
import importlib
from pathlib import Path

import pytest
import torch

import padertorch_tpu_torch

PKG_ROOT = Path(padertorch_tpu_torch.__file__).parent


def _modules_with_doctests():
    names = []
    for path in sorted(PKG_ROOT.rglob('*.py')):
        if '_build' in path.parts or '>>> ' not in path.read_text():
            continue
        rel = path.relative_to(PKG_ROOT.parent).with_suffix('')
        name = '.'.join(rel.parts)
        if name.endswith('.__init__'):
            name = name[:-len('.__init__')]
        names.append(name)
    return names


@pytest.mark.parametrize('module_name', _modules_with_doctests())
def test_module_doctests(module_name):
    module = importlib.import_module(module_name)
    torch.manual_seed(0)
    result = doctest.testmod(
        module, optionflags=doctest.NORMALIZE_WHITESPACE
        | doctest.ELLIPSIS)
    assert result.attempted > 0, module_name
    assert result.failed == 0, (
        f'{result.failed}/{result.attempted} doctests failed '
        f'in {module_name}')
