"""Hooks: all non-core training-loop behavior.

Counterpart of ``padertorch_tpu/train/hooks.py`` (reference
``padertorch/train/hooks.py``): the same priorities, lifecycle
(``pre_step``/``post_step``/``post_optimize``/``close``/``set_last``/
``state_dict``), summary aggregation, checkpoint ranking and early
stopping.

Review values arriving in ``post_step`` are tensors on the model's device.
They are accumulated as they are (detached, no host sync) and fetched to
numpy only when a summary is finalized.

Ported: ``SummaryHook``, ``CheckpointHook``, ``ValidationHook``,
``StopTrainingHook``.  The back-off, learning-rate scheduler, progress
bar, annealing, EMA, profiler and energy hooks of the JAX package are not
ported yet.
"""
import json
import re
import types
from collections import defaultdict
from enum import IntEnum

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
    'StopTrainingHook',
    'StopTraining',
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
