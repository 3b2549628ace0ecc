"""Hooks: all non-core training-loop behavior.

Counterpart of ``padertorch_tpu/train/hooks.py`` (reference
``padertorch/train/hooks.py``): the same priorities, lifecycle
(``pre_step``/``post_step``/``post_optimize``/``close``/``set_last``/
``state_dict``), summary aggregation, checkpoint ranking and early
stopping.

Review values arriving in ``post_step`` are tensors on the model's device.
They are accumulated as they are (detached, no host sync) and fetched to
numpy only when a summary is finalized.

Every hook of the JAX package is here, with its uid and its state's keys,
but ``JaxProfilerHook``, whose counterpart is :class:`TorchProfilerHook`.
Two defaults differ: :class:`EnergyEstimateHook` reads the card's power
limit where the JAX one assumes a TPU's budget, and :class:`EMAHook` keeps
its average keyed by parameter name.
"""
import bisect
import json
import re
import subprocess
import time
import types
from collections import defaultdict
from contextlib import contextmanager
from enum import IntEnum
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.train.trigger import IntervalTrigger, EndTrigger

__all__ = [
    'Priority',
    'Hook',
    'TriggeredHook',
    'SummaryHook',
    'CheckpointHook',
    'ValidationHook',
    'BackOffValidationHook',
    'LRSchedulerHook',
    'ProgressBarHook',
    'TorchProfilerHook',
    'EnergyEstimateHook',
    'EmissionsTrackerHook',
    'EMAHook',
    'StopTrainingHook',
    'StopTraining',
    'AnnealingHook',
    'LossWeightAnnealingHook',
    'ModelAttributeAnnealingHook',
    'LRAnnealingHook',
]

CKPT_EXT = '.ptt'


def _natkey(name):
    """Natural sort key: 'ckpt_10' sorts after 'ckpt_2'."""
    return tuple(
        int(part) if part.isdigit() else part
        for part in re.split(r'(\d+)', str(name))
    )


class Priority(IntEnum):
    """Hook dispatch order (higher runs first). Reference: ``hooks.py:43``."""
    END = 10
    CHECKPOINT = 11  # after other hooks, so latest hook states get saved
    DEFAULT = 15
    VALIDATION = 20
    PROGRESS = 30
    PRINT = 40
    SUMMARY = 50


class Hook:
    @property
    def priority(self):
        return Priority.DEFAULT

    @property
    def uid(self):
        """Unique id keying this hook's state in trainer checkpoints."""
        return type(self).__qualname__

    def state_dict(self):
        return None

    def load_state_dict(self, state_dict):
        raise NotImplementedError

    def pre_step(self, trainer):
        """Called before each iteration of the train iterator."""

    def post_step(self, trainer, example, model_output, review):
        """Called after each train step."""

    def post_optimize(self, trainer, summary):
        """Called after each optimizer step with grad-norm/lr summary."""

    def close(self, trainer):
        pass

    def set_last(self, iteration, epoch):
        pass


class TriggeredHook(Hook):
    def __init__(self, trigger=None):
        self.trigger = IntervalTrigger.new(trigger)

    def set_last(self, iteration, epoch):
        self.trigger.set_last(iteration, epoch)


def _fetch(value):
    """Tensor -> numpy (a no-op for host values); a bf16 tensor (numpy has
    no bf16) becomes float32."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return value


def _scalars_to_list(scalars):
    scalars = _fetch(scalars)
    if isinstance(scalars, np.ndarray):
        return scalars.flatten().tolist()
    if isinstance(scalars, (list, tuple)):
        return list(scalars)
    assert np.isscalar(scalars), scalars
    return [scalars]


def _detach(value):
    return value.detach() if isinstance(value, torch.Tensor) else value


class SummaryHook(TriggeredHook):
    """Aggregates review dicts and writes them to the tfevents file.

    Reference parity: ``hooks.py:153``.  Values are held as tensors until
    ``finalize_summary`` fetches them.
    """

    create_snapshot = True

    def __init__(self, trigger, summary_prefix='training'):
        super().__init__(trigger)
        self.summary_prefix = summary_prefix
        self.reset_summary()

    @property
    def priority(self):
        return Priority.SUMMARY

    @staticmethod
    def empty_summary_dict():
        # MappingProxyType guards against typo'd keys (like the reference).
        return types.MappingProxyType(dict(
            scalars=defaultdict(list),
            histograms=defaultdict(list),
            audios=dict(),
            images=dict(),
            texts=dict(),
            figures=dict(),
            timings=dict(),
            buffers=defaultdict(list),
            snapshots=dict(),
        ))

    def reset_summary(self):
        self.summary = self.empty_summary_dict()
        self.create_snapshot = True

    def update_summary(self, review):
        allowed_keys = {
            'scalars', 'histograms', 'audios', 'images', 'texts',
            'figures', 'buffers', 'snapshots',
        }
        redundant_keys = set(review.keys()) - allowed_keys
        assert len(redundant_keys) == 0, (
            redundant_keys, review.keys(), allowed_keys)
        assert len(review) >= 1, review
        popped = {**review}
        # scalars/histograms: keep the raw (device) values; fetch later
        for key, value in popped.pop('scalars', {}).items():
            self.summary['scalars'][key].append(_detach(value))
        for key, value in popped.pop('histograms', {}).items():
            self.summary['histograms'][key].append(_detach(value))
            self.summary['histograms'][key] = \
                self.summary['histograms'][key][-1_000_000:]
        for key, value in popped.pop('buffers', {}).items():
            self.summary['buffers'][key].append(_detach(value))
        for key, value in popped.pop('snapshots', {}).items():
            self.summary['snapshots'][key] = _detach(value)  # keep last
        for key, value in popped.pop('audios', {}).items():
            self.summary['audios'][key] = value  # keep last
        for key, value in popped.pop('images', {}).items():
            self.summary['images'][key] = _detach(value)  # keep last
        for key, value in popped.pop('figures', {}).items():
            self.summary['figures'][key] = value  # keep last
        for key, value in popped.pop('texts', {}).items():
            assert isinstance(value, str), value
            self.summary['texts'][key] = value  # keep last
        assert len(popped) == 0, (popped, review)

    def _materialize_summary(self):
        """Fetch tensors to the host, flatten scalars to float lists."""
        summary = dict(self.summary)
        for kind in ('scalars', 'histograms'):
            summary[kind] = defaultdict(list, {
                k: [x for v in vals for x in _scalars_to_list(v)]
                for k, vals in summary[kind].items()
            })
        summary['buffers'] = defaultdict(list, {
            k: [_fetch(v) for v in vals]
            for k, vals in summary['buffers'].items()
        })
        for kind in ('snapshots', 'images'):
            summary[kind] = {k: _fetch(v) for k, v in summary[kind].items()}
        self.summary = types.MappingProxyType(summary)

    def compute_timings(self, timer):
        timer_dict = timer.as_dict
        summary_timings = {}
        sum_time_per_iteration = np.sum(
            timer_dict.get('time_per_iteration', [0]))
        if sum_time_per_iteration > 0:
            for k in [
                'time_per_data_loading',
                'time_per_to_device',
                'time_per_forward',
                'time_per_review',
                'time_per_backward',
                'time_per_optimize',
            ]:
                if k in timer_dict:
                    summary_timings[k.replace('_per_', '_rel_')] = \
                        np.sum(timer_dict.pop(k)) / sum_time_per_iteration
        summary_timings.update({
            key: timing.mean() for key, timing in timer_dict.items()
        })
        timer.clear()
        return summary_timings

    def finalize_summary(self, trainer):
        assert len(self.summary['timings']) == 0, self.summary['timings']
        self._materialize_summary()
        for key, timing in self.compute_timings(trainer.train_timer).items():
            self.summary['timings'][key] = timing
        self.summary = trainer.model.modify_summary(self.summary)
        assert len(self.summary['buffers']) == 0, (
            'buffers have to be converted during modify_summary')
        assert len(self.summary['snapshots']) == 0, (
            'snapshots have to be converted during modify_summary')

    def dump_summary(self, trainer):
        iteration = trainer.iteration
        prefix = self.summary_prefix
        time_prefix = f'{prefix}_timings'
        tags = set()

        def check_tag(tag):
            if tag in tags:
                raise AssertionError(
                    f'The tag {tag!r} is used multiple times.\n\n'
                    'Tensorboard has problems when different events have '
                    'the same tag, e.g. you cannot report `grad_norm` as '
                    'scalar and histogram. A common workaround is to append '
                    'an `_` for the histogram (i.e. `grad_norm_`).'
                )
            tags.add(tag)
            return tag

        for key, scalar in self.summary['scalars'].items():
            trainer.writer.add_scalar(
                check_tag(f'{prefix}/{key}'), scalar, iteration)
        for key, scalar in self.summary['timings'].items():
            trainer.writer.add_scalar(
                check_tag(f'{time_prefix}/{key}'),
                np.mean(scalar), iteration)
        for key, histogram in self.summary['histograms'].items():
            tag = check_tag(f'{prefix}/{key}')
            values = np.array(histogram)
            values = values[np.isfinite(values)]
            if values.size == 0:
                # all-NaN histograms (e.g. a diverged loss being reported
                # during shutdown) must not mask the original error
                continue
            trainer.writer.add_histogram(tag, values, iteration)
        for key, audio in self.summary['audios'].items():
            tag = check_tag(f'{prefix}/{key}')
            if isinstance(audio, (tuple, list)):
                assert len(audio) == 2, (len(audio), audio)
                trainer.writer.add_audio(
                    tag, audio[0], iteration, sample_rate=audio[1])
            else:
                trainer.writer.add_audio(
                    tag, audio, iteration, sample_rate=16000)
        for key, image in self.summary['images'].items():
            trainer.writer.add_image(
                check_tag(f'{prefix}/{key}'), image, iteration)
        for key, text in self.summary['texts'].items():
            trainer.writer.add_text(
                check_tag(f'{prefix}/{key}'), text, iteration)
        for key, figure in self.summary['figures'].items():
            trainer.writer.add_figure(
                check_tag(f'{prefix}/{key}'), figure, iteration)
        self.reset_summary()

    def pre_step(self, trainer):
        if self.trigger(iteration=trainer.iteration, epoch=trainer.epoch) \
                and trainer.iteration != 0:
            self.finalize_summary(trainer)
            self.dump_summary(trainer)
        if self.create_snapshot:
            trainer.model.create_snapshot = True

    def post_step(self, trainer, example, model_out, review):
        self.update_summary(review)
        if self.create_snapshot:
            trainer.model.create_snapshot = self.create_snapshot = False

    def post_optimize(self, trainer, summary):
        self.post_step(trainer, None, None, summary)

    def close(self, trainer):
        self.finalize_summary(trainer)
        self.dump_summary(trainer)

    def set_last(self, iteration, epoch):
        self.reset_summary()
        super().set_last(iteration, epoch)


class CheckpointHook(TriggeredHook):
    """Periodically saves trainer state. Reference: ``hooks.py:409``."""

    @property
    def priority(self):
        return Priority.CHECKPOINT

    def _save_latest_checkpoint(self, trainer):
        checkpoint_path = trainer.default_checkpoint_path()
        checkpoint_path.parent.mkdir(parents=True, exist_ok=True)
        trainer.save_checkpoint()

    def pre_step(self, trainer):
        if self.trigger(iteration=trainer.iteration, epoch=trainer.epoch):
            self._save_latest_checkpoint(trainer)

    def close(self, trainer):
        self._save_latest_checkpoint(trainer)

    def set_last(self, iteration, epoch):
        # composite triggers (Any/All/Not) have no single ``last``;
        # their sub-triggers handle the rewind via plain set_last
        last = getattr(self.trigger, 'last', None)
        if last is not None and last[0] > iteration:
            # has to be re-triggered after the iteration was rewound
            super().set_last(-1, -1)
        else:
            super().set_last(iteration, epoch)


class ValidationHook(SummaryHook):
    """Validation + checkpoint ranking + stale-checkpoint deletion.

    Reference parity: ``hooks.py:439``.
    """

    def __init__(
            self, trigger, iterator, metric='loss', maximize=False,
            max_checkpoints=1, early_stopping_patience=None,
    ):
        super().__init__(trigger, summary_prefix='validation')
        self.iterator = iterator
        # what to rank by
        self.metric, self.maximize = metric, maximize
        self.max_checkpoints = max_checkpoints
        self.early_stopping_patience = early_stopping_patience
        # resumable state (see state_dict)
        self.ckpt_ranking, self.n_degradations = [], 0
        self.last_validation = -1

    @property
    def priority(self):
        return Priority.VALIDATION

    @property
    def _best_ckpt_name(self):
        return f'ckpt_best_{self.metric}{CKPT_EXT}'

    def state_dict(self):
        return {
            'ckpt_ranking': [list(pair) for pair in self.ckpt_ranking],
            'n_degradations': self.n_degradations,
        }

    def load_state_dict(self, state_dict):
        self.ckpt_ranking = [tuple(pair)
                             for pair in state_dict['ckpt_ranking']]
        self.n_degradations = int(state_dict['n_degradations'])

    def finalize_summary(self, trainer):
        # Uses the validate timer instead of the train timer.
        assert len(self.summary['timings']) == 0, self.summary['timings']
        self._materialize_summary()
        for key, timing in self.compute_timings(
                trainer.validate_timer).items():
            self.summary['timings'][key] = timing
        self.summary = trainer.model.modify_summary(self.summary)

    def pre_step(self, trainer):
        if self.trigger(iteration=trainer.iteration, epoch=trainer.epoch):
            self.run_validation(trainer)
            self.last_validation = trainer.iteration
        if (
                self.early_stopping_patience is not None
                and self.n_degradations > self.early_stopping_patience
        ):
            print(f'Early stopping after {trainer.epoch} epochs and '
                  f'{trainer.iteration} iterations')
            raise StopTraining

    def run_validation(self, trainer):
        """Full validation pass -> score -> checkpoint ranking update.

        The checkpoint for this iteration does not exist yet: the
        CheckpointHook runs at lower priority and writes it *after* this
        hook, so the ranking entry recorded here (hook state) is part of
        that very checkpoint.
        """
        score = self._validation_score(trainer)
        # an asynchronous write in flight must commit before the pruning
        # below reads the directory and the latest checkpoint's link
        trainer.wait_for_checkpoint_writes()
        self._rank_checkpoint(
            trainer.checkpoint_dir,
            trainer.default_checkpoint_path().name,
            score,
        )

    def _validation_score(self, trainer):
        """Run the model over the validation set; returns the metric."""
        assert not any(self.summary.values()), (
            'summary not drained before validation', self.summary)
        assert not trainer.validate_timer.timings, trainer.validate_timer
        print('Starting Validation')
        # snapshots (images) only for the first example; the flag is
        # restored afterwards
        snapshot_before = trainer.model.create_snapshot
        trainer.model.create_snapshot = True
        n_examples = 0
        try:
            for _, _, review in trainer.validate(self.iterator):
                trainer.model.create_snapshot = False
                self.update_summary(review)
                n_examples += 1
        finally:
            trainer.model.create_snapshot = snapshot_before
        if n_examples == 0:
            raise RuntimeError(
                f'Validation iterator yielded no examples: '
                f'{self.iterator!r}')

        # modify_summary must see eval mode
        trainer.model.eval()
        try:
            self.finalize_summary(trainer)
        finally:
            trainer.model.train()
        scalars = self.summary['scalars']
        if self.metric not in scalars:
            raise KeyError(
                f'Validation metric {self.metric!r} missing from the '
                f'review scalars {sorted(scalars)}; return it from '
                f'review()/modify_summary().')
        score = float(scalars[self.metric])
        self.dump_summary(trainer)
        print(f'Finished Validation. Mean {self.metric}: {score}')
        return score

    def _rank_checkpoint(self, ckpt_dir, ckpt_name, score):
        """Insert (ckpt_name, score) into the ranking, prune checkpoints
        beyond max_checkpoints, track degradations, persist the ranking.

        Names are stored relative so the storage dir stays movable; ties
        go to the older checkpoint (natural name order).
        """
        self.ckpt_ranking.append((ckpt_name, score))
        sign = -1.0 if self.maximize else 1.0
        self.ckpt_ranking.sort(
            key=lambda entry: (sign * entry[1], _natkey(entry[0])))
        if self.max_checkpoints is not None:
            # the latest checkpoint must survive pruning even when it
            # ranks badly: until the CheckpointHook (lower priority)
            # writes this round's checkpoint and repoints the symlink,
            # deleting it would leave ckpt_latest dangling if the
            # process dies in between (crash-resume would find nothing)
            latest = ckpt_dir / f'ckpt_latest{CKPT_EXT}'
            latest_target = (latest.resolve().name
                             if latest.is_symlink() else None)
            kept = []
            for index, (name, value) in enumerate(self.ckpt_ranking):
                if (index < self.max_checkpoints
                        or name == ckpt_name       # being written now
                        or name == latest_target):  # crash-resume anchor
                    kept.append((name, value))
                    continue
                stale = ckpt_dir / name
                if stale.exists():
                    stale.unlink()
            self.ckpt_ranking = kept
        if self.ckpt_ranking[0][0] == ckpt_name:
            self.n_degradations = 0
        else:
            self.n_degradations += 1
        # persist next to the checkpoints (reference layout:
        # checkpoints/ckpt_ranking.json)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        (ckpt_dir / 'ckpt_ranking.json').write_text(json.dumps({
            'metric': self.metric,
            'maximize': self.maximize,
            'ranking': [list(pair) for pair in self.ckpt_ranking],
        }, indent=2))

    def post_step(self, trainer, example, model_out, review):
        if trainer.iteration == self.last_validation:
            ckpt_dir = trainer.checkpoint_dir
            ckpt_path = trainer.default_checkpoint_path()
            trainer.wait_for_checkpoint_writes()
            if not ckpt_path.exists():
                raise RuntimeError(
                    'Before each validation the CheckpointHook has to '
                    f'write a checkpoint.\nCould not find {ckpt_path}.\n'
                    f'Found only:\n'
                    f'{[str(f) for f in ckpt_dir.iterdir()]}'
                )
            self.set_best_symlink(ckpt_dir)

    def set_best_symlink(self, ckpt_dir):
        best = ckpt_dir / self._best_ckpt_name
        if best.is_symlink():
            best.unlink()
        try:
            best.symlink_to(self.ckpt_ranking[0][0])
        except FileExistsError:
            raise FileExistsError(
                f'Best checkpoint {best} needs to be a symlink to a '
                'checkpoint, not a file!'
            ) from None

    def close(self, trainer):
        # ckpt_ranking may be empty when training stops before the
        # first validation fired (composite trigger, early crash) even
        # though the CheckpointHook created the directory: there is
        # no best checkpoint to link then
        if trainer.checkpoint_dir.exists() and self.ckpt_ranking:
            self.set_best_symlink(trainer.checkpoint_dir)
        ckpt_name = trainer.default_checkpoint_path().name
        if ckpt_name not in [c[0] for c in self.ckpt_ranking]:
            # ensure it is deleted after resume
            self.ckpt_ranking.append(
                (ckpt_name, -np.inf if self.maximize else np.inf))


class BackOffValidationHook(ValidationHook):
    """Validation + learning-rate back-off to the best checkpoint.

    Reference parity: ``hooks.py:636``.  After ``back_off_patience``
    degradations in a row (at most ``n_back_off`` times), ``ckpt_latest``
    is pointed at the best checkpoint, the ranked checkpoints after it are
    deleted, the trainer reloads it and every optimizer's learning rate is
    multiplied by ``lr_update_factor``.
    """

    def __init__(
            self, trigger, iterator, metric='loss', maximize=False,
            max_checkpoints=1, early_stopping_patience=None, n_back_off=0,
            lr_update_factor=1 / 10, back_off_patience=None,
    ):
        super().__init__(
            trigger, iterator, metric=metric, maximize=maximize,
            max_checkpoints=max_checkpoints,
            early_stopping_patience=early_stopping_patience,
        )
        self.remaining_back_offs = n_back_off
        self.lr_update_factor = lr_update_factor
        if n_back_off > 0:
            assert lr_update_factor < 1, lr_update_factor
            assert back_off_patience is not None
        self.back_off_patience = back_off_patience
        if early_stopping_patience is not None \
                and back_off_patience is not None:
            assert early_stopping_patience >= back_off_patience, (
                early_stopping_patience, back_off_patience)

    def state_dict(self):
        return {
            'remaining_back_offs': self.remaining_back_offs,
            **super().state_dict(),
        }

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        assert state_dict['remaining_back_offs'] <= self.remaining_back_offs
        self.remaining_back_offs = int(state_dict['remaining_back_offs'])

    def run_validation(self, trainer):
        super().run_validation(trainer)
        if (
                self.remaining_back_offs > 0
                and self.n_degradations > self.back_off_patience
        ):
            self._back_off(trainer)

    def _back_off(self, trainer):
        best_ckpt = self.ckpt_ranking[0][0]
        print(f'Back off to {best_ckpt}.')
        ckpt_dir = trainer.checkpoint_dir
        latest = (ckpt_dir / f'ckpt_latest{CKPT_EXT}').absolute()
        if latest.is_symlink():
            latest.unlink()
        latest.symlink_to(best_ckpt)

        best_iter = int(Path(best_ckpt).stem[len('ckpt_'):])
        for j in reversed(range(len(self.ckpt_ranking))):
            ckpt = self.ckpt_ranking[j][0]
            if int(Path(ckpt).stem[len('ckpt_'):]) > best_iter:
                ckpt_path = ckpt_dir / ckpt
                if ckpt_path.exists():
                    ckpt_path.unlink()
                self.ckpt_ranking.pop(j)

        remaining_back_offs = self.remaining_back_offs
        trainer.load_checkpoint()
        self.n_degradations = 0
        self.remaining_back_offs = remaining_back_offs - 1

        optimizer = trainer.optimizer
        for opt in (optimizer.values() if isinstance(optimizer, dict)
                    else [optimizer]):
            opt.lr = opt.lr * self.lr_update_factor


class LRSchedulerHook(TriggeredHook):
    """Applies a learning-rate schedule ``fn(step_count) -> lr``.

    Counterpart of the JAX package's hook (reference ``hooks.py:745``):
    any callable maps the trigger count to an absolute learning rate.  On
    resume the restored count's rate is applied at once.
    """

    def __init__(self, lr_scheduler, trigger=(1, 'epoch'),
                 optimizer_key=None):
        super().__init__(trigger)
        self.lr_scheduler = lr_scheduler
        self.optimizer_key = optimizer_key
        self._count = 0
        self._apply_pending = False

    def state_dict(self):
        return {'count': self._count}

    def load_state_dict(self, state_dict):
        self._count = int(state_dict['count'])
        self._apply_pending = True

    def _optimizer(self, trainer):
        opt = trainer.optimizer
        if self.optimizer_key is not None:
            opt = opt[self.optimizer_key]
        return opt

    def pre_step(self, trainer):
        if self._apply_pending:
            # the checkpoint's learning rate may predate a changed
            # schedule, and the next firing may be a period away
            self._apply_pending = False
            self._optimizer(trainer).lr = float(
                self.lr_scheduler(self._count))
        if self.trigger(iteration=trainer.iteration, epoch=trainer.epoch):
            if trainer.iteration > 0:
                self._count += 1
            self._optimizer(trainer).lr = float(
                self.lr_scheduler(self._count))

    def set_last(self, iteration, epoch):
        super().set_last(iteration, epoch)
        if hasattr(self.trigger, 'unit'):
            if self.trigger.unit == 'epoch':
                self._count = epoch // self.trigger.period
            else:
                self._count = iteration // self.trigger.period
        # a composite trigger has no single period: the count stays


class ProgressBarHook(TriggeredHook):
    """tqdm progress bar. Reference parity: ``hooks.py:794``."""

    def __init__(self, stop_trigger, max_it_len=None, update_interval=100):
        super().__init__((update_interval, 'iteration'))
        try:
            from tqdm import tqdm
        except ImportError as e:
            raise ImportError(
                'progress_bar=True (ProgressBarHook) needs the tqdm '
                'package') from e
        if isinstance(stop_trigger, EndTrigger):
            length, unit = stop_trigger.period, stop_trigger.unit
        elif isinstance(stop_trigger, (tuple, list)):
            length, unit = stop_trigger
        else:
            raise ValueError(
                f'stop_trigger must be a trigger or tuple, got '
                f'{type(stop_trigger)}: {stop_trigger}')
        if unit == 'iteration':
            max_iteration = length
        elif unit == 'epoch':
            if max_it_len is not None:
                max_iteration = length * max_it_len
            else:
                self.num_epochs = length
                max_iteration = None
        else:
            raise ValueError(f'unit {unit} unknown')
        self.pbar = tqdm(initial=1, total=max_iteration, smoothing=1)

    @property
    def priority(self):
        return Priority.PROGRESS

    def set_last(self, iteration, epoch):
        super().set_last(iteration, epoch)
        self.pbar.n = iteration

    def pre_step(self, trainer):
        iteration, epoch = trainer.iteration, trainer.epoch
        if epoch == 1 and self.pbar.total is None:
            if hasattr(self, 'num_epochs'):
                self.pbar.total = (iteration + 1) * self.num_epochs
        if self.trigger(iteration, epoch) and iteration > 1:
            self.pbar.update(iteration - self.pbar.n)

    def close(self, trainer):
        self.pbar.close()


class TorchProfilerHook(TriggeredHook):
    """Record ``num_steps`` training steps with ``torch.profiler``.

    The counterpart of the JAX package's ``JaxProfilerHook``
    (``padertorch_tpu/train/hooks.py:969``): when the trigger fires, the
    host's and (for a model on a CUDA card) the card's activity of the next
    ``num_steps`` steps is recorded and written as a Chrome trace,
    ``storage_dir/profile/trace_<iteration>.json`` (``trace_path``), which
    ``chrome://tracing`` or Perfetto open.

    >>> hook = TorchProfilerHook((500, 'iteration'), num_steps=3)
    """

    def __init__(self, trigger=(500, 'iteration'), num_steps=5,
                 log_dir=None):
        super().__init__(trigger)
        self.num_steps = num_steps
        self.log_dir = log_dir
        self.trace_path = None
        self._remaining = 0
        self._profiler = None

    def pre_step(self, trainer):
        if self._profiler is not None:
            self._remaining -= 1
            if self._remaining <= 0:
                self._stop(trainer)
            return
        if self.trigger(trainer.iteration, trainer.epoch):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if trainer.device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._remaining = self.num_steps

    def _dir(self, trainer):
        if self.log_dir is not None:
            return Path(self.log_dir)
        return Path(trainer.storage_dir) / 'profile'

    def _stop(self, trainer):
        if trainer.device.type == 'cuda':
            torch.cuda.synchronize(trainer.device)
        self._profiler.stop()
        directory = self._dir(trainer)
        directory.mkdir(parents=True, exist_ok=True)
        self.trace_path = directory / f'trace_{trainer.iteration}.json'
        self._profiler.export_chrome_trace(str(self.trace_path))
        self._profiler = None
        print(f'TorchProfilerHook: trace written to {self.trace_path}')

    def close(self, trainer):
        if self._profiler is not None:
            self._stop(trainer)


def card_power_limit_watts(device):
    """The power limit of the CUDA card ``device`` in watts, as
    ``nvidia-smi --query-gpu=power.limit`` reads it (raises where it
    cannot be read)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit',
         '--format=csv,noheader,nounits', '-i', str(index)],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip())


class EnergyEstimateHook(TriggeredHook):
    """Dependency-free energy and CO2 estimate -> event-file scalars.

    Counterpart of the JAX package's hook (there for the reference's
    codecarbon ``EmissionsTrackerHook``, ``hooks.py:1032``): ``energy =
    elapsed * (chip watts + host watts)``, ``co2 = energy * grid carbon
    intensity``, an upper-bound proxy rather than a measurement.  With
    ``chip_watts=None`` (the default) the card's power limit is read once,
    through ``nvidia-smi``, for a model on a CUDA card; a model on the CPU
    counts the host alone.

    Writes ``<prefix>/energy_kwh``, ``<prefix>/co2_kg`` and
    ``<prefix>/avg_power_watts`` at every trigger firing and at close.
    """

    def __init__(self, trigger=(1, 'epoch'), prefix='x_emissions',
                 chip_watts=None, host_watts=100.0,
                 grid_kg_co2_per_kwh=0.475):
        super().__init__(trigger)
        self.prefix = prefix
        self.chip_watts = None if chip_watts is None else float(chip_watts)
        self.host_watts = float(host_watts)
        self.grid_kg_co2_per_kwh = float(grid_kg_co2_per_kwh)
        self._start = None
        self._kwh_before = 0.0

    @property
    def priority(self):
        return Priority.SUMMARY

    @property
    def watts(self):
        return self.chip_watts + self.host_watts

    def state_dict(self):
        # the consumed energy carries over a resume
        return {'consumed_kwh_before': self._consumed_kwh()}

    def load_state_dict(self, state_dict):
        self._kwh_before = float(state_dict['consumed_kwh_before'])

    def _consumed_kwh(self):
        if self._start is None:
            return self._kwh_before
        elapsed_h = (time.monotonic() - self._start) / 3600.0
        return self._kwh_before + elapsed_h * self.watts / 1000.0

    def _report(self, trainer):
        energy_kwh = self._consumed_kwh()
        trainer.writer.add_scalar(
            f'{self.prefix}/energy_kwh', energy_kwh, trainer.iteration)
        trainer.writer.add_scalar(
            f'{self.prefix}/co2_kg',
            energy_kwh * self.grid_kg_co2_per_kwh, trainer.iteration)
        trainer.writer.add_scalar(
            f'{self.prefix}/avg_power_watts', self.watts,
            trainer.iteration)

    def pre_step(self, trainer):
        if self.chip_watts is None:
            device = trainer.device
            self.chip_watts = (card_power_limit_watts(device)
                               if device.type == 'cuda' else 0.0)
        if self._start is None:
            self._start = time.monotonic()
        if self.trigger(iteration=trainer.iteration, epoch=trainer.epoch):
            self._report(trainer)

    def close(self, trainer):
        if self._start is not None:
            self._report(trainer)


#: reference name for :class:`EnergyEstimateHook` (there
#: ``EmissionsTrackerHook``, ``train/hooks.py:893``)
EmissionsTrackerHook = EnergyEstimateHook


class EMAHook(Hook):
    """Exponential moving average of the trained parameters.

    Counterpart of the JAX package's hook: after every optimizer step,
    on the parameters' device, ``ema = decay * ema + (1 - decay) * p`` (that
    expression, not ``lerp``, whose rounding differs); the first step
    copies the parameters.  The average is keyed by parameter name, in the
    trainer's checkpoints too, and restored at the first ``pre_step``
    after a load.

    Usage::

        ema = EMAHook(decay=0.999)
        trainer.register_hook(ema)
        trainer.train(ds)
        with ema.average_parameters(trainer.model):
            evaluate(trainer.model)        # runs with the average
    """

    def __init__(self, decay=0.999):
        assert 0.0 < decay < 1.0, decay
        self.decay = decay
        self.ema_params = None
        self._loaded = None

    @staticmethod
    def _trained(model):
        return {n: p for n, p in model.named_parameters() if p.requires_grad}

    @torch.no_grad()
    def post_optimize(self, trainer, summary):
        params = self._trained(trainer.model)
        if self.ema_params is None:
            self.ema_params = {n: p.detach().clone()
                               for n, p in params.items()}
            return
        average = list(self.ema_params.values())
        torch._foreach_mul_(average, self.decay)
        torch._foreach_add_(average, torch._foreach_mul(
            [params[n] for n in self.ema_params], 1.0 - self.decay))

    @contextmanager
    def average_parameters(self, model):
        """Swap the average into ``model`` for the block, then back."""
        assert self.ema_params is not None, 'no optimizer step ran yet'
        params = self._trained(model)
        with torch.no_grad():
            backup = {n: params[n].detach().clone() for n in self.ema_params}
            for n, value in self.ema_params.items():
                params[n].copy_(value)
        try:
            yield model
        finally:
            with torch.no_grad():
                for n, value in backup.items():
                    params[n].copy_(value)

    def state_dict(self):
        if self.ema_params is None:
            return {'decay': self.decay}
        return {'decay': self.decay, 'average': dict(self.ema_params)}

    def load_state_dict(self, state):
        self.decay = float(state['decay'])
        self._loaded = state.get('average')

    def pre_step(self, trainer):
        # finish a restore once the model's devices are known
        if self._loaded is not None:
            params = self._trained(trainer.model)
            self.ema_params = {n: _tensor_on(v, params[n].device)
                               for n, v in self._loaded.items()}
            self._loaded = None


def _tensor_on(value, device):
    """A copy of a checkpoint's array (or tensor) on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    return torch.tensor(np.asarray(value), device=device)


class StopTrainingHook(TriggeredHook):
    """Raises StopTraining when the end trigger fires."""

    def __init__(self, trigger):
        super().__init__(EndTrigger.new(trigger))

    @property
    def priority(self):
        return Priority.END

    def pre_step(self, trainer):
        if self.trigger(trainer.iteration, trainer.epoch):
            print(f'Training ended after {trainer.epoch} epochs and '
                  f'{trainer.iteration} iterations')
            raise StopTraining


class StopTraining(Exception):
    """Signal to stop the training loop."""


class AnnealingHook(TriggeredHook):
    """Piecewise-linear annealing of a value, relative to its initial value.

    Reference parity: ``hooks.py:884``.  Breakpoints are (x, y) pairs with
    y relative to the initial value.
    """

    def __init__(self, trigger, breakpoints, unit, name):
        super().__init__(trigger)
        self.breakpoints = sorted(breakpoints, key=lambda x: x[0])
        self.unit = unit
        self.name = name
        self.scale = None

    @property
    def uid(self):
        return super().uid + f'({self.name})'

    def get_value(self, trainer):
        raise NotImplementedError

    def set_value(self, trainer, value):
        raise NotImplementedError

    def state_dict(self):
        return {'scale': self.scale}

    def load_state_dict(self, state_dict):
        self.scale = state_dict['scale']

    def pre_step(self, trainer):
        if self.trigger(iteration=trainer.iteration, epoch=trainer.epoch):
            if self.scale is None:
                self.scale = float(np.asarray(self.get_value(trainer)))
            if self.unit == 'iteration':
                x = trainer.iteration
            elif self.unit == 'epoch':
                x = trainer.epoch
            else:
                raise ValueError(f'{self.unit} is not a valid unit.')
            self.set_value(trainer, self._interpolate(x) * self.scale)

    def _interpolate(self, x):
        """Piecewise-linear lookup over the sorted breakpoints; the
        implicit origin is (0, 1.0) and the curve is flat past the end."""
        xs = [bx for bx, _ in self.breakpoints]
        i = bisect.bisect_right(xs, x)
        if i == len(self.breakpoints):
            return self.breakpoints[-1][1]
        x0, y0 = (0, 1.0) if i == 0 else self.breakpoints[i - 1]
        x1, y1 = self.breakpoints[i]
        return y0 + (y1 - y0) * (x - x0) / (x1 - x0)


class LossWeightAnnealingHook(AnnealingHook):
    """Anneals an entry of ``trainer.loss_weights``."""

    def get_value(self, trainer):
        return trainer.loss_weights[self.name]

    def set_value(self, trainer, value):
        trainer.loss_weights[self.name] = value


class ModelAttributeAnnealingHook(AnnealingHook):
    """Anneals a (dotted) attribute of the trainer's model."""

    def get_module(self, trainer):
        module = trainer.model
        for attr in self.name.split('.')[:-1]:
            module = getattr(module, attr)
        return module

    def get_value(self, trainer):
        return getattr(self.get_module(trainer), self.name.split('.')[-1])

    def set_value(self, trainer, value):
        setattr(self.get_module(trainer), self.name.split('.')[-1], value)


class LRAnnealingHook(AnnealingHook):
    """Anneals an optimizer's learning rate (of ``trainer.optimizer[name]``
    for a dict of optimizers)."""

    def __init__(self, trigger, breakpoints, unit, name=None):
        super().__init__(trigger, breakpoints, unit, name)

    @property
    def uid(self):
        if self.name is None:
            return type(self).__qualname__
        return super().uid

    def _optimizer(self, trainer):
        optimizer = trainer.optimizer
        if self.name is not None:
            assert isinstance(optimizer, dict), type(optimizer)
            optimizer = optimizer[self.name]
        return optimizer

    def get_value(self, trainer):
        return self._optimizer(trainer).lr

    def set_value(self, trainer, value):
        self._optimizer(trainer).lr = value
