"""Experiment folder + Makefile helpers.

Counterpart of ``padertorch_tpu/contrib/cb/io.py``, copied as it is
(reference ``padertorch/contrib/cb/io.py``): ``get_new_folder``
and ``SimpleMakefile`` (written into experiment dirs so re-run/eval
commands are one ``make`` away), plus the target-keyed ``Makefile``
(cb/io.py:223), the ``makefile`` context manager (:507) and
``write_makefile_and_config`` (:548).
"""
import contextlib
import datetime
from pathlib import Path

from padertorch_tpu_torch.io import get_new_subdir

__all__ = ['get_new_folder', 'SimpleMakefile', 'Makefile', 'makefile',
           'write_makefile_and_config']


def get_new_folder(basedir, try_id=None, mkdir=True, consider_mpi=False):
    """Successively numbered new folder under basedir (cb/io.py:11); the
    port runs one process per storage dir, so ``consider_mpi`` changes
    nothing."""
    del try_id, consider_mpi
    return get_new_subdir(basedir, id_naming='index', mkdir=mkdir)


class SimpleMakefile:
    """Collect make targets and write a Makefile (cb/io.py:105).

    >>> m = SimpleMakefile()
    >>> m += 'train:'
    >>> m += '\\tpython -m myexp.train'
    >>> m.text == 'train:\\n\\tpython -m myexp.train\\n'
    True
    """

    def __init__(self):
        self.lines = []

    def __iadd__(self, line):
        self.lines.append(line)
        return self

    @property
    def text(self):
        return '\n'.join(self.lines) + '\n'

    def dump(self, path):
        path = Path(path)
        if path.is_dir():
            path = path / 'Makefile'
        path.write_text(self.text)
        return path


class Makefile:
    """Target-keyed Makefile builder (reference cb/io.py:223).

    Targets are a dict ``{target_name: command_or_list_of_commands}``;
    raw lines (variable definitions, pattern rules) are appended after
    the targets, matching the reference's rendering order.

    >>> m = Makefile()
    >>> m['run'] = 'python -m myexp.train --config config.yaml'
    >>> m['resume'] = ['echo resuming', 'python -m myexp.train --resume']
    >>> m.add_raw('ckpts := $(wildcard checkpoints/*.ptt)')
    >>> print(m.text.replace('\\t', '    '))
    run:
        python -m myexp.train --config config.yaml
    <BLANKLINE>
    resume:
        echo resuming
        python -m myexp.train --resume
    <BLANKLINE>
    ckpts := $(wildcard checkpoints/*.ptt)
    <BLANKLINE>
    """

    def __init__(self, data: dict = None):
        self.globals = []
        self.data = {} if data is None else {**data}

    def __setitem__(self, target, value):
        assert isinstance(target, str), (type(target), target)
        self.data[target] = value

    def add_raw(self, raw: str):
        """Append a raw Makefile line (variable/pattern rule)."""
        self.globals.append(raw)

    def add_run_cmd(self, main_python_path, config='config.yaml',
                    target='run'):
        """``make run`` re-launching the experiment from its config.

        The reference's equivalent launches via sacred
        (``python -m <module> with config.yaml``); here the repo CLI
        convention (``--config``) is used.
        """
        self.data[target] = (
            f'python -m {main_python_path} --config {config}')

    def add_resume_cmd(self, main_python_path, config='config.yaml',
                       target='resume'):
        """``make resume`` continuing from ``ckpt_latest`` (reference
        ``add_sacred_resume_cmd``, adapted to the repo CLI)."""
        self.data[target] = (
            f'python -m {main_python_path} --config {config} --resume')

    def add_tail_cmd(self, target='tail'):
        """``make tail`` following the newest log files (generic
        version of the reference's ccs-specific ``tail`` target)."""
        self.data[target] = [
            '$(eval log_file := $(shell ls log/*.log 2>/dev/null '
            '| sort | tail -n 1))',
            'tail -F $(log_file)',
        ]

    @property
    def text(self):
        blocks = []
        for target, cmds in self.data.items():
            if isinstance(cmds, str):
                cmds = [cmds]
            blocks.append('\n'.join(
                [f'{target}:'] + [f'\t{cmd}' for cmd in cmds]))
        blocks.extend(self.globals)
        return '\n\n'.join(blocks) + '\n'

    def dump(self, path):
        path = Path(path)
        if path.is_dir():
            path = path / 'Makefile'
        path.write_text(self.text)
        return path


@contextlib.contextmanager
def makefile(folder, when_exist='fail'):
    """Context manager yielding a :class:`Makefile` that is written to
    ``<folder>/Makefile`` on exit (reference cb/io.py:507).

    ``when_exist``: 'fail' (default) raises if a Makefile exists;
    'backup' renames the old one with a timestamp; 'append' appends;
    'overwrite' replaces.
    """
    file = Path(folder) / 'Makefile'
    append = False
    backup = False
    if when_exist == 'backup':
        backup = file.exists()
    elif when_exist == 'append':
        append = True
    elif when_exist == 'overwrite':
        pass
    elif when_exist == 'fail':
        if file.exists():
            raise FileExistsError(
                f'Remove the Makefile {file} before writing a new one, '
                "or set when_exist to 'backup', 'append' or 'overwrite'.")
    else:
        raise ValueError(when_exist)

    m = Makefile()
    yield m

    if backup:
        now = datetime.datetime.today().strftime('%Y_%m_%d_%H_%M_%S')
        file.rename(Path(folder) / f'Makefile_{now}')
    with file.open(mode='a' if append else 'w') as fd:
        fd.write(m.text)


def write_makefile_and_config(
        storage_dir, _config, _run=None, backend='yaml',
        write_config=True, write_makefile=True, main_python_path=None):
    """Write a config file and a run/resume Makefile into
    ``storage_dir`` so the experiment can be re-launched from inside
    its directory (reference cb/io.py:548).

    ``_run`` may be a sacred-style run object exposing
    ``main_function`` (its module path is used); otherwise pass
    ``main_python_path`` or the ``__main__`` module is resolved.
    """
    from padertorch_tpu_torch import io as pt_io
    from padertorch_tpu_torch.configurable import resolve_main_python_path

    assert backend in ('yaml', 'json'), backend
    storage_dir = Path(storage_dir)

    if main_python_path is None:
        if _run is not None and hasattr(_run, 'main_function'):
            main_python_path = _run.main_function.__module__
            if main_python_path == '__main__':
                main_python_path = resolve_main_python_path()
        else:
            main_python_path = resolve_main_python_path()

    config_name = f'config.{backend}'
    if write_config:
        pt_io.dump_config(_config, storage_dir / config_name)
    if write_makefile:
        with makefile(storage_dir, when_exist='overwrite') as m:
            m.add_run_cmd(main_python_path, config=config_name)
            m.add_resume_cmd(main_python_path, config=config_name)
    return storage_dir
