"""``trainer.test_run``: the pre-training burn test.

Counterpart of ``padertorch_tpu/train/runtime_tests.py`` (reference
``padertorch/train/runtime_tests.py:74``).  Trains twice
(2 epochs x 2 examples) into temporary dirs with mocked trainer counters
and hooks, then asserts:

- the validation outputs are deterministic across the two runs,
- the initial losses of both runs are equal,
- the loss *changes* after training (gradients actually flow),
- model parameters are restored afterwards,
- review keys are legal,
- the checkpoint directory contains exactly the expected files,
- all summaries were drained.

The validation pass runs in eval mode without gradients, so a sound model
gives the same outputs in both runs; one whose eval forward draws random
numbers fails here.
"""
import contextlib
import copy
import itertools
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from padertorch_tpu_torch.migrate import to_jax_state_dict
from padertorch_tpu_torch.train.hooks import (
    SummaryHook,
    CheckpointHook,
    ValidationHook,
    StopTrainingHook,
    Hook,
)
from padertorch_tpu_torch.utils.nested import nested_op

__all__ = ['test_run', 'test_run_from_config', 'nested_test_assert_allclose']

# pytest must not collect these as test functions:
test_run_from_config__test__ = False


def nested_test_assert_allclose(actual, desired, atol=1e-6, rtol=1e-6):
    """assert_allclose over nested dicts/lists/arrays (tensors ok)."""
    def compare(a, d, path):
        if isinstance(a, dict):
            assert isinstance(d, dict) and a.keys() == d.keys(), (path, a, d)
            for k in a:
                compare(a[k], d[k], f'{path}.{k}')
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(d), (path, a, d)
            for i, (x, y) in enumerate(zip(a, d)):
                compare(x, y, f'{path}[{i}]')
        elif isinstance(a, str) or a is None:
            assert a == d, (path, a, d)
        else:
            np.testing.assert_allclose(
                _to_numpy(a), _to_numpy(d), atol=atol, rtol=rtol,
                err_msg=f'at {path}')
    compare(actual, desired, 'root')


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:   # numpy has no bf16
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class _RecorderHook(Hook):
    """Records each train step's (loss, output, review) in order."""

    def __init__(self):
        self.records = []
        self.optimize_count = 0

    def post_step(self, trainer, example, model_output, review):
        self.records.append(dict(
            inputs=example,
            output=model_output,
            review=review,
            loss=review['scalars']['loss'],
        ))

    def post_optimize(self, trainer, summary):
        self.optimize_count += 1


class _Iterable:
    """Iterable without __len__ (like a prefetching pipeline)."""

    def __init__(self, data):
        self.data = data

    def __iter__(self):
        yield from self.data

    def __len__(self):
        raise TypeError(
            f'object of type {type(self).__name__} has no len()')


def test_run(
        trainer,
        train_iterator,
        validation_iterator,
        test_with_known_iterator_length=False,
        temporary_directory=None,
        *,
        deterministic_atol=1e-5,
        deterministic_rtol=1e-5,
        loss_atol=1e-6,
        loss_rtol=1e-6,
        virtual_minibatch_size=None,
):
    print('Start test run')

    @contextlib.contextmanager
    def backup_state_dict(trainer):
        state_dict = copy.deepcopy(trainer.state_dict())
        try:
            yield
        finally:
            trainer.load_state_dict(state_dict)

    with contextlib.ExitStack() as exit_stack:
        if temporary_directory is None:
            storage_dir = Path(exit_stack.enter_context(
                tempfile.TemporaryDirectory())).expanduser().resolve()
        else:
            storage_dir = Path(temporary_directory).expanduser().resolve()
            assert list(storage_dir.glob('*')) == [], (
                list(storage_dir.glob('*')))
        exit_stack.enter_context(
            mock.patch.object(trainer, 'iteration', new=-1))
        exit_stack.enter_context(
            mock.patch.object(trainer, 'epoch', new=-1))
        if virtual_minibatch_size is not None:
            assert virtual_minibatch_size > 0, virtual_minibatch_size
            exit_stack.enter_context(mock.patch.object(
                trainer, 'virtual_minibatch_size',
                new=virtual_minibatch_size))

        vbs = trainer.virtual_minibatch_size

        sub_train = list(itertools.islice(train_iterator, 2 * vbs))
        sub_validation = list(itertools.islice(validation_iterator, 2))
        assert len(sub_train) == 2 * vbs, (
            f'test_run needs {2 * vbs} train batches but the iterator '
            f'yielded only {len(sub_train)}; enlarge the (synthetic) '
            f'training set or lower the batch size.')
        assert len(sub_validation) == 2, (
            f'test_run needs 2 validation batches but the iterator '
            f'yielded only {len(sub_validation)}; enlarge the '
            f'(synthetic) validation set or lower the batch size.')
        if test_with_known_iterator_length:
            from padertorch_tpu_torch.data.dataset import from_list
            sub_train = from_list(sub_train, immutable_warranty='copy')
            sub_validation = from_list(
                sub_validation, immutable_warranty='copy')
        else:
            sub_train = _Iterable(sub_train)
            sub_validation = _Iterable(sub_validation)

        # Spy on validation: wrap the generator to count calls.
        validate_calls = []
        original_validate = trainer.validate

        @contextlib.contextmanager
        def ensure_unchanged_parameter(trainer):
            before = to_jax_state_dict(trainer.model)
            yield
            after = to_jax_state_dict(trainer.model)
            assert before.keys() == after.keys(), (
                before.keys(), after.keys())
            for k in before:
                np.testing.assert_equal(
                    np.asarray(before[k]), np.asarray(after[k]))

        recorder = _RecorderHook()

        with ensure_unchanged_parameter(trainer):
            hooks = [
                SummaryHook((1, 'epoch')),
                CheckpointHook((1, 'epoch')),
                ValidationHook(
                    (1, 'epoch'), sub_validation, max_checkpoints=None),
                StopTrainingHook((1, 'epoch')),
                recorder,
            ]
            exit_stack.enter_context(
                mock.patch.object(trainer, 'hooks', new=hooks))

            val_records = []

            def record_validate(iterator):
                validate_calls.append(1)
                for example, out, review in original_validate(iterator):
                    val_records.append(dict(
                        inputs=example, output=out, review=review,
                        loss=review['scalars']['loss'],
                        _val=True,
                    ))
                    yield example, out, review

            validate_calls.clear()
            exit_stack.enter_context(mock.patch.object(
                trainer, 'validate', new=record_validate))

            with backup_state_dict(trainer):
                exit_stack.enter_context(mock.patch.object(
                    trainer, 'storage_dir', new=storage_dir))
                trainer.train(sub_train)
            run1_train = list(recorder.records)
            run1_val = list(val_records)
            recorder.records.clear()
            val_records.clear()

            with backup_state_dict(trainer):
                storage_dir_2 = Path(exit_stack.enter_context(
                    tempfile.TemporaryDirectory())).expanduser().resolve()
                exit_stack.enter_context(mock.patch.object(
                    trainer, 'storage_dir', new=storage_dir_2))
                trainer.train(sub_train)
            run2_train = list(recorder.records)
            run2_val = list(val_records)

        # -- call counts ----------------------------------------------------
        assert recorder.optimize_count == 4, recorder.optimize_count
        assert len(validate_calls) == 4, len(validate_calls)
        n_steps = (len(run1_train) + len(run1_val)
                   + len(run2_train) + len(run2_val))
        assert n_steps == 4 * vbs + 8, (n_steps, vbs)

        # Chronological order per run: [val ex1, val ex2](pre-training),
        # train steps, [val ex1, val ex2](after epoch 1).
        dt1, dt2 = run1_val[0], run1_val[1]
        dt3, dt4 = run1_val[-2], run1_val[-1]
        dt5, dt6 = run2_val[0], run2_val[1]
        dt7, dt8 = run2_val[-2], run2_val[-1]

        def fetch(record):
            return nested_op(_to_numpy, {
                'output': record['output'],
                'review': record['review'],
                'loss': record['loss'],
            })

        dt1, dt2, dt3, dt4, dt5, dt6, dt7, dt8 = map(
            fetch, (dt1, dt2, dt3, dt4, dt5, dt6, dt7, dt8))

        # determinism between runs (eval mode with fixed keys)
        nested_test_assert_allclose(
            dt1['output'], dt5['output'],
            atol=deterministic_atol, rtol=deterministic_rtol)
        nested_test_assert_allclose(
            dt2['output'], dt6['output'],
            atol=deterministic_atol, rtol=deterministic_rtol)
        nested_test_assert_allclose(
            dt1['review'], dt5['review'],
            atol=deterministic_atol, rtol=deterministic_rtol)
        nested_test_assert_allclose(
            dt2['review'], dt6['review'],
            atol=deterministic_atol, rtol=deterministic_rtol)

        # initial losses equal across runs
        nested_test_assert_allclose(
            dt1['loss'], dt5['loss'], rtol=loss_rtol, atol=loss_atol)
        nested_test_assert_allclose(
            dt2['loss'], dt6['loss'], rtol=loss_rtol, atol=loss_atol)

        # the loss must change after training
        try:
            with np.testing.assert_raises(AssertionError):
                nested_test_assert_allclose(
                    dt1['loss'], dt3['loss'], rtol=1e-6, atol=1e-6)
                nested_test_assert_allclose(
                    dt2['loss'], dt4['loss'], rtol=1e-6, atol=1e-6)
                nested_test_assert_allclose(
                    dt5['loss'], dt7['loss'], rtol=1e-6, atol=1e-6)
                nested_test_assert_allclose(
                    dt6['loss'], dt8['loss'], rtol=1e-6, atol=1e-6)
        except AssertionError:
            raise AssertionError(
                'The loss of the model did not change between two '
                'validations.\nThis is usually caused by a zero gradient '
                'or a loss independent of the parameters.'
            )

        # review key check
        allowed_summary_keys = (
            {'loss', 'losses'}
            | set(SummaryHook.empty_summary_dict().keys())
        )
        got = set(run1_train[0]['review'].keys())
        if len(got - allowed_summary_keys) != 0:
            raise ValueError(
                f'Found keys: {got}\n'
                f'Allowed: {allowed_summary_keys}\n'
                f'Delta: {got - allowed_summary_keys}'
            )

        # summaries drained
        for hook in hooks:
            summary = getattr(hook, 'summary', {})
            assert all(len(s) == 0 for s in summary.values()), (
                hook, summary)

        # exact checkpoint layout
        files = list(storage_dir.glob('*'))
        assert len(files) == 2, files
        for file in files:
            if 'tfevents' in file.name:
                pass
            elif file.name == 'checkpoints':
                checkpoint_names = {f.name for f in file.glob('*')}
                expect = {
                    'ckpt_latest.ptt',
                    'ckpt_best_loss.ptt',
                    'ckpt_0.ptt',
                    'ckpt_2.ptt',
                    'ckpt_ranking.json',
                }
                assert checkpoint_names == expect, (
                    checkpoint_names, expect)
                ckpt_last = (file / 'ckpt_latest.ptt').resolve().name
                assert ckpt_last == 'ckpt_2.ptt', ckpt_last
            else:
                raise AssertionError(f'Unexpected file {file}')

    print('Successfully finished test run')


def test_run_from_config(
        trainer_config,
        train_iterator,
        validation_iterator,
        test_with_known_iterator_length=False,
):
    """Reference parity: ``runtime_tests.py:413``."""
    from padertorch_tpu_torch.train.trainer import Trainer
    trainer_config = copy.deepcopy(trainer_config)
    with tempfile.TemporaryDirectory() as tmp_dir:
        trainer_config['storage_dir'] = tmp_dir
        tmp_dir = Path(tmp_dir)
        t = Trainer.from_config(trainer_config)
        files_before = tuple(tmp_dir.glob('*'))
        if len(files_before) != 0:
            raise Exception(files_before)
        test_run(
            t,
            train_iterator,
            validation_iterator,
            test_with_known_iterator_length=test_with_known_iterator_length,
        )
        files_after = tuple(tmp_dir.glob('*'))
        if files_after != files_before:
            raise Exception(files_after, files_before)


# pytest should not collect the public functions as tests
test_run.__test__ = False
test_run_from_config.__test__ = False
