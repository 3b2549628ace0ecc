"""Per-experiment Makefile templates for the recipes.

Counterpart of ``padertorch_tpu/contrib/examples/_makefile.py``, copied.

The reference writes a Makefile into every experiment's storage dir so
finished/running trainings can be resumed, evaluated, and inspected
from inside the directory (``pit/train.py:93-117`` via the template,
``contrib/cb/io.py:105`` SimpleMakefile).  Every recipe's train.py
calls :func:`write_recipe_makefile` after creating the storage dir.
"""
import shlex
import sys
from pathlib import Path

from padertorch_tpu_torch.contrib.cb.io import SimpleMakefile

__all__ = ['write_recipe_makefile', 'evaluate_args_of']


def write_recipe_makefile(storage_dir, train_module,
                          evaluate_module=None, train_args=None,
                          evaluate_args=''):
    """Write ``<storage_dir>/Makefile`` with train/evaluate/tensorboard
    targets bound to this experiment directory.

    ``train_args`` defaults to the launching process's CLI arguments, so
    ``make train`` re-runs this exact training configuration (into a
    fresh experiment dir, like the reference's init-generated Makefile).
    """
    if train_args is None:
        train_args = shlex.join(sys.argv[1:])
    storage_dir = Path(storage_dir)
    m = SimpleMakefile()
    m += f'# experiment: {storage_dir}'
    m += ''
    m += 'train:'
    m += (f'\tpython -m {train_module} '
          f'{train_args}'.rstrip())
    m += ''
    if evaluate_module is not None:
        m += 'evaluate:'
        m += (f'\tpython -m {evaluate_module} '
              f'--model_path {storage_dir} {evaluate_args}'.rstrip())
        m += ''
    m += 'tensorboard:'
    m += f'\ttensorboard --logdir {storage_dir}'
    return m.dump(storage_dir)


def evaluate_args_of(args):
    """The ``evaluate`` target's data and device arguments for a recipe's
    parsed ``args``: ``--synthetic`` where the training read the synthetic
    set (the JAX recipes' rule), else ``--database <json>``; and
    ``--device <device>`` where the training ran off the card."""
    database = getattr(args, 'database', None)
    if getattr(args, 'synthetic', False) or database is None:
        out = ['--synthetic']
    else:
        out = ['--database', str(database)]
    device = getattr(args, 'device', 'cuda')
    if device != 'cuda':
        out += ['--device', str(device)]
    return shlex.join(out)
