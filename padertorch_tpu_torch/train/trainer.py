"""The training loop.

Counterpart of ``padertorch_tpu/train/trainer.py`` (reference
``padertorch/train/trainer.py:35``).  The JAX trainer compiles forward,
review, backward, clip and optimizer update into one program; here the
step is eager PyTorch: ``forward``, ``review``, the weighted loss,
``backward``, then clip and ``optimizer.step``.  What carries over:

- **No host sync in the step.**  Losses, the gradient norm and the review
  stay tensors on the model's device; the summary hook fetches them when
  it writes.  The non-finite-loss check (reference ``trainer.py:624``)
  reads the loss one step late, so it never waits for the step that was
  just enqueued; the last step's loss is checked when training ends, and
  a non-finite one raises then too.
- **Virtual minibatch** (gradient accumulation, reference
  ``trainer.py:357``) keeps the reference's *sum* (not mean) semantics:
  the gradients of ``virtual_minibatch_size`` examples add up in
  ``.grad``, then one optimizer step runs.
- **Loss weights** are read at every step, so a hook may change them
  while training runs.
- **Checkpoints** are ``.ptt`` files whose ``model`` entry is in the JAX
  package's layout (``migrate.to_jax_state_dict``), with ``iteration``,
  ``epoch`` and ``hooks`` as the JAX trainer writes them, so one storage
  dir loads in both packages.  The ``optimizer`` entry is this package's
  own (``torch.optim`` state keyed by parameter name).
- **Precision** (``precision='bfloat16'`` or a
  :class:`~padertorch_tpu_torch.train.precision.Precision`): the train and
  validation steps cast the example and run the model under
  ``Precision.cast_module`` (bf16 casts of float32 masters); the loss is
  cast to float32 before the backward, so gradients, clipping, the
  optimizer's moments and the checkpoints stay float32.
- **A dict of optimizers** keyed by direct submodule: each optimizer gets
  its submodule's parameters and clips, steps, reports and checkpoints
  apart.  With ``adversarial=True`` each key ``k`` takes the gradient of
  ``loss_weights[k] * losses[k]`` with respect to submodule ``k`` alone:
  one forward, then ``torch.autograd.grad`` per key from the same graph
  (a forward per key would update running statistics and draw dropout
  twice, and ``backward`` per key would leak the generator's loss into
  the discriminator), and only then does any optimizer step.
- **Asynchronous checkpoints** (``async_checkpointing=True``): the state
  is copied to the host before ``save_checkpoint`` returns (the live
  parameters and optimizer state are changed in place by the next step,
  so the writer thread must not see them), then written by a thread;
  the next save, a load, validation and the end of training wait for it,
  and a failed write raises there.

Not ported (each raises ``NotImplementedError`` when asked for):
``sharding``, ``checkpoint_format='orbax'``, ``MultiDeviceTrainer``.
"""
import itertools
import re
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.configurable import Configurable
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)
from padertorch_tpu_torch.serialize import dump_state, load_state
from padertorch_tpu_torch.summary.writer import SummaryWriter
from padertorch_tpu_torch.train.hooks import (
    SummaryHook,
    CheckpointHook,
    StopTrainingHook,
    BackOffValidationHook,
    EnergyEstimateHook,
    ProgressBarHook,
    StopTraining,
)
from padertorch_tpu_torch.train.optimizer import Optimizer, Adam
from padertorch_tpu_torch.train.precision import Precision

__all__ = ['Trainer', 'ContextTimerDict', 'MultiDeviceTrainer',
           'InteractiveTrainer', 'InteractiveWriter']

CKPT_EXT = '.ptt'


class ContextTimerDict:
    """Collect wall times per phase via context managers, with pause.

    Reference parity: ``train/trainer.py:944``.

    >>> timer = ContextTimerDict()
    >>> with timer['foo']:
    ...     pass
    >>> sorted(timer.as_dict.keys())
    ['foo']
    """

    def __init__(self):
        self.timings = defaultdict(list)

    @contextmanager
    def __getitem__(self, key):
        assert isinstance(key, str), key
        handle = _TimerHandle()
        start = time.perf_counter()
        try:
            yield handle
        finally:
            stop = time.perf_counter()
            self.timings[key].append(stop - start - handle.paused_total)

    @staticmethod
    def timestamp():
        return time.perf_counter()

    @property
    def as_dict(self):
        return {k: np.array(v) for k, v in self.timings.items()}

    def clear(self):
        self.timings.clear()

    def __repr__(self):
        return f'{type(self).__name__}({dict(self.timings)})'


class _TimerHandle:
    def __init__(self):
        self.paused_total = 0.0

    @contextmanager
    def pause(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.paused_total += time.perf_counter() - t0


def _not_ported(what):
    raise NotImplementedError(
        f'{what} is not ported yet: padertorch_tpu_torch trains on one '
        'device and writes .ptt checkpoints')


def _host_copy(state):
    """``state`` with every tensor and array copied to the host and every
    container rebuilt: nothing in it aliases what a later step changes."""
    if isinstance(state, torch.Tensor):
        return state.detach().to('cpu', copy=True)
    if isinstance(state, np.ndarray):
        return state.copy()
    if isinstance(state, dict):
        return {k: _host_copy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_host_copy(v) for v in state)
    return state


class Trainer(Configurable):
    """Owns the model, optimizer, storage dir layout and the train loop.

    Storage dir structure (same contract as the reference)::

        .
        ├── checkpoints
        │   ├── ckpt_7122.ptt
        │   ├── ckpt_14244.ptt
        │   ├── ckpt_best_loss.ptt -> ckpt_7122.ptt
        │   ├── ckpt_latest.ptt -> ckpt_14244.ptt
        │   └── ckpt_ranking.json
        ├── events.out.tfevents.*
    """

    @classmethod
    def finalize_dogmatic_config(cls, config):
        if 'optimizer' not in config.keys():
            config['optimizer'] = {'factory': Adam}

    def __init__(
            self,
            model: Model,
            storage_dir,
            optimizer,
            loss_weights=None,
            adversarial=False,
            summary_trigger=(1, 'epoch'),
            checkpoint_trigger=(1, 'epoch'),
            stop_trigger=(1, 'epoch'),
            virtual_minibatch_size=1,
            sharding=None,
            checkpoint_format='ptt',
            async_checkpointing=False,
            precision=None,
    ):
        if not isinstance(model, torch.nn.Module):
            raise TypeError(
                'Expect the model to be a subclass of '
                'padertorch_tpu_torch.Model.\n'
                f'Got: type: {type(model)}\n{model}'
            )
        if sharding is not None:
            _not_ported(f'sharding={sharding!r}')
        if checkpoint_format != 'ptt':
            _not_ported(f'checkpoint_format={checkpoint_format!r}')
        self.model = model
        self.adversarial = bool(adversarial)
        if self.adversarial and not isinstance(optimizer, dict):
            raise TypeError(
                'adversarial=True requires a dict of optimizers keyed by '
                'submodule name (e.g. {"generator": ..., '
                '"discriminator": ...}), got ' + repr(type(optimizer))
            )
        if isinstance(optimizer, dict):
            # per-submodule optimizers: the keys name direct submodules
            optimizer = {
                k: opti for k, opti in optimizer.items() if opti is not None
            }
            for key, opti in optimizer.items():
                assert isinstance(opti, Optimizer), opti
                sub = getattr(model, key)
                opti.set_parameters(sub.named_parameters(), module=sub)
        else:
            assert isinstance(optimizer, Optimizer), optimizer
            optimizer.set_parameters(model.named_parameters(), module=model)
        self.optimizer = optimizer

        self.storage_dir = Path(storage_dir).expanduser().resolve()
        self.async_checkpointing = bool(async_checkpointing)
        self._ckpt_writer = None
        self._ckpt_writer_error = None
        self.writer_cls = SummaryWriter
        self.writer = None
        self.train_timer = ContextTimerDict()
        self.validate_timer = ContextTimerDict()
        self.iteration = -1
        self.epoch = -1

        self.loss_weights = loss_weights
        self.virtual_minibatch_size = virtual_minibatch_size
        if isinstance(precision, str):
            precision = Precision(precision)
        assert precision is None or isinstance(precision, Precision), \
            precision
        self.precision = precision

        self.hooks = [
            SummaryHook(summary_trigger),
            CheckpointHook(checkpoint_trigger),
            StopTrainingHook(stop_trigger),
        ]
        self._summary_trigger = summary_trigger
        self._stop_trigger = stop_trigger
        self._checkpoint_trigger = checkpoint_trigger
        self._prev_loss = None  # one-step-delayed finite check

    @property
    def device(self):
        return next(self.model.parameters()).device

    @property
    def _optimizers(self):
        """{key: optimizer}; the key of a single optimizer is ''."""
        if isinstance(self.optimizer, dict):
            return self.optimizer
        return {'': self.optimizer}

    # ------------------------------------------------------------------ #
    # one step                                                            #
    # ------------------------------------------------------------------ #
    def _loss_and_review(self, model, example):
        """forward + review + loss weighting; the loss weights are read
        now.  Returns (loss, weighted, model_out, review): ``weighted`` is
        the dict of weighted losses (``None`` for a review with one
        ``loss``), which the adversarial step differentiates key by key."""
        loss_weights = self.loss_weights
        model_out = model(example)
        review = dict(model.review(example, model_out))
        review.setdefault('scalars', {})
        review['scalars'] = dict(review['scalars'])
        weighted = None
        if 'losses' in review:
            assert 'loss' not in review, review
            losses = review.pop('losses')
            if (len(losses) != 1 and loss_weights is None
                    and not self.adversarial):
                raise Exception(
                    'You can not have multiple losses without specifying '
                    f'loss_weights. losses: {losses}'
                )
            if loss_weights is not None and len(losses) != 1 \
                    and set(loss_weights.keys()) != set(losses.keys()):
                raise Exception(
                    'You can not have multiple losses without specifying a '
                    f'loss_weight for each loss.\nlosses: {losses}\n'
                    f'loss_weights: {loss_weights}'
                )
            loss = 0.0
            weighted = {}
            for key, value in losses.items():
                weight = (loss_weights[key]
                          if loss_weights is not None else 1.0)
                loss = loss + weight * value
                weighted[key] = weight * value
                review['scalars'][key] = value
                review['scalars'][f'{key}_loss_weight'] = np.float32(weight)
        else:
            assert 'loss' in review, review
            loss = review.pop('loss')
        assert loss.dim() == 0, loss
        review['scalars']['loss'] = loss
        return loss, weighted, model_out, review

    def _backward(self, loss, weighted):
        """Add the step's gradients to ``.grad``: of the loss, or for
        ``adversarial=True`` of each key's weighted loss with respect to
        its submodule alone, all from the one forward's graph."""
        if not self.adversarial:
            loss.backward()
            return
        keys = list(self.optimizer)
        if weighted is None or set(weighted) != set(keys):
            raise Exception(
                'adversarial=True requires review["losses"] keyed exactly '
                'like the optimizer dict.\n'
                f'optimizer keys: {sorted(keys)}\n'
                f'losses keys: {sorted(weighted or {})}'
            )
        grads = {}
        for i, key in enumerate(keys):
            params = self.optimizer[key].parameters
            grads[key] = torch.autograd.grad(
                weighted[key].float(), params,
                retain_graph=i < len(keys) - 1,
                allow_unused=True, materialize_grads=True)
        # every key's gradients come from the same parameters: none is
        # written to .grad before all are taken
        for key, key_grads in grads.items():
            for p, g in zip(self.optimizer[key].parameters, key_grads):
                p.grad = g if p.grad is None else p.grad + g

    def _check_prev_loss_finite(self):
        if self._prev_loss is None:
            return
        loss = self._prev_loss.detach().cpu().numpy()
        self._prev_loss = None
        if not np.all(np.isfinite(loss)):
            log_path_pattern = self.log_error_state({
                'model_state': to_jax_state_dict(self.model),
            })
            raise RuntimeError(
                f'The loss ({loss}) is not finite.\n'
                f'See error states in {log_path_pattern}.'
            )

    # ------------------------------------------------------------------ #
    # training                                                            #
    # ------------------------------------------------------------------ #
    def train(self, train_dataset, *, progress_bar=False,
              track_emissions=False, resume=False):
        """Train the model where it is (see :meth:`to`). See the class
        docstring for the storage layout.

        ``train_dataset`` must be a re-iterable of examples (not a
        generator).
        """
        if track_emissions and not any(
                isinstance(h, EnergyEstimateHook) for h in self.hooks):
            # in self.hooks, so that its state is checkpointed and
            # restored; before load_checkpoint, which asserts that every
            # saved hook state found its hook
            self.hooks.append(EnergyEstimateHook(self._summary_trigger))
        if resume:
            assert resume is True, resume
            self.load_checkpoint()
        else:
            assert not self.checkpoint_dir.exists(), (
                'A checkpoint directory already exists. If you want '
                'to restart the training set resume to True.'
            )
            self.iteration = 0
            self.epoch = 0

        self.model.train()
        self.writer = self.writer_cls(self.storage_dir)
        hooks = [*self.hooks]
        if progress_bar:
            try:
                max_it_len = len(train_dataset)
            except TypeError:
                max_it_len = None
            progress = ProgressBarHook(self._stop_trigger, max_it_len)
            progress.set_last(self.iteration, self.epoch)
            hooks.append(progress)
        if track_emissions:
            for hook in hooks:
                if isinstance(hook, EnergyEstimateHook):
                    hook.set_last(self.iteration, self.epoch)
        hooks = sorted(hooks, key=lambda h: h.priority, reverse=True)

        assert self.virtual_minibatch_size >= 1, self.virtual_minibatch_size
        vbs = self.virtual_minibatch_size
        self.model.zero_grad(set_to_none=True)

        try:
            train_iterable = None
            while True:
                new_epoch = False
                if train_iterable is None:
                    new_epoch = True
                    for hook in hooks:
                        hook.pre_step(self)
                    train_iterable = iter(train_dataset)

                optimize = True
                with self.train_timer['time_per_iteration'] as timer:
                    for minibatch_index in range(vbs):
                        with self.train_timer['time_per_data_loading']:
                            example = list(
                                itertools.islice(train_iterable, 1))
                            if len(example) == 0:
                                train_iterable = None
                                self.epoch += 1
                                if minibatch_index == 0:
                                    optimize = False
                                break
                        example = example[0]

                        if new_epoch:
                            new_epoch = False
                        elif minibatch_index == 0:
                            with timer.pause():
                                for hook in hooks:
                                    hook.pre_step(self)

                        loss, weighted, example, model_out, review = \
                            self._step(self.model, example, self.train_timer)
                        with self.train_timer['time_per_backward']:
                            self._backward(loss, weighted)
                        self._check_prev_loss_finite()
                        self._prev_loss = loss.detach()

                        with timer.pause():
                            for hook in hooks:
                                hook.post_step(
                                    self, example, model_out, review)
                        del example, model_out, review, loss, weighted

                    if optimize:
                        with self.train_timer['time_per_optimize']:
                            norms = {key: opt.step() for key, opt
                                     in self._optimizers.items()}
                            self.model.zero_grad(set_to_none=True)
                            optimizer_summary = self._optimizer_summary(
                                norms)
                            for hook in hooks:
                                hook.post_optimize(self, optimizer_summary)
                        self.iteration += 1

        except StopTraining:
            pass
        finally:
            # the deferred finite check must neither replace an exception
            # already propagating nor skip closing the hooks and the
            # writer: collect it, close everything, then raise it on an
            # otherwise clean exit
            unwinding = sys.exc_info()[0] is not None
            finite_exc = None
            try:
                self._check_prev_loss_finite()
            except RuntimeError as e:
                if unwinding:
                    print(f'Note: also detected while unwinding: {e!r}')
                else:
                    finite_exc = e
            try:
                for hook in hooks:
                    hook.close(self)
                # the last checkpoint may still be in flight: train()
                # returns after it is written
                self.wait_for_checkpoint_writes()
            except Exception:
                print('Exception in finally. May hide actual exception!!!\n'
                      'You may comment this finally block for debugging.')
                raise
            finally:
                self.writer.close()
                self.writer = None
            if finite_exc is not None:
                raise finite_exc

    def _optimizer_summary(self, norms):
        """Each optimizer's pre-clip gradient norm and learning rate (none
        for ``Adafactor(lr=None)``), named as the JAX trainer names them."""
        summary = {'scalars': {}, 'histograms': {}}
        for key, norm in norms.items():
            lr = self._optimizers[key].lr
            prefix = f'{key}_' if key else ''
            summary['scalars'][f'{prefix}grad_norm'] = norm
            summary['histograms'][f'{prefix}grad_norm_'] = norm.reshape(1)
            if lr is not None:
                summary['scalars'][
                    f'lr/{key}/param_group_0' if key
                    else 'lr/param_group_0'] = lr
        return summary

    # ------------------------------------------------------------------ #
    # validation                                                          #
    # ------------------------------------------------------------------ #
    _non_validation_start_time = None

    def validate(self, validation_iterator):
        """Generator yielding (example, model_out, review) per example.

        Used by the ValidationHook; runs in eval mode without gradients.
        """
        validation_start_time = self.validate_timer.timestamp()
        if self._non_validation_start_time is not None:
            self.validate_timer.timings['non_validation_time'].append(
                validation_start_time - self._non_validation_start_time)

        with self.validate_timer['validation_time']:
            self.model.eval()
            try:
                validation_iter = iter(validation_iterator)
                while True:
                    with self.validate_timer['time_per_iteration']:
                        try:
                            with self.validate_timer[
                                    'time_per_data_loading']:
                                example = next(validation_iter)
                        except StopIteration:
                            break
                        with torch.no_grad():
                            example, model_out, review = \
                                self.validation_step(self.model, example)
                    yield example, model_out, review
                    del example, model_out, review
            finally:
                self.model.train()
                self._non_validation_start_time = \
                    self.validate_timer.timestamp()

    def train_step(self, model, example):
        """forward + review + loss weighting of one example (with the
        graph for ``backward``); returns (loss, example on the device,
        model_out, review)."""
        return self.step(model, example, self.train_timer)

    def validation_step(self, model, example):
        return self.step(model, example, self.validate_timer)[1:]

    def step(self, model, example, timer):
        """Reference parity: ``trainer.py:541``.  Under ``precision`` the
        example is cast, the forward and review run on the model's casts
        (``Precision.cast_module``) and the loss is cast to float32."""
        loss, _, example, model_out, review = self._step(
            model, example, timer)
        return loss, example, model_out, review

    def _step(self, model, example, timer):
        """:meth:`step` that also returns the weighted losses."""
        prec = self.precision
        with timer['time_per_to_device']:
            example = model.example_to_device(example, self.device)
            if prec is not None and prec.cast_examples:
                example = prec.cast_floating(example)
        with timer['time_per_forward']:
            if prec is None:
                loss, weighted, model_out, review = self._loss_and_review(
                    model, example)
            else:
                with prec.cast_module(model):
                    loss, weighted, model_out, review = \
                        self._loss_and_review(model, example)
                loss = loss.float()
        return loss, weighted, example, model_out, review

    def log_error_state(self, data_dict, folder='log', file=sys.stdout):
        """Dump debugging state to ``storage_dir/log/error_state_*.ptt``.

        Reference parity: ``trainer.py:640``."""
        written = []
        for k, v in data_dict.items():
            p = self.storage_dir / folder / f'error_state_{k}{CKPT_EXT}'
            p.parent.mkdir(exist_ok=True, parents=True)
            try:
                dump_state(v, p)
                written.append(k)
            except Exception as e:
                log_file = self.storage_dir / folder / f'{k}.log'
                log_file.write_text(f'{type(e)}: {e}')
                print(f'Cannot save {k}. {type(e)}: {e}. See {log_file}',
                      file=file)
        written = ','.join(written)
        return str(
            self.storage_dir / folder / f'error_state_{{{written}}}{CKPT_EXT}')

    # ------------------------------------------------------------------ #
    # hooks registration                                                  #
    # ------------------------------------------------------------------ #
    def register_hook(self, hook):
        if isinstance(hook, (tuple, list)):
            for h in hook:
                self.register_hook(h)
        else:
            self.hooks.append(hook)

    def register_validation_hook(
            self, validation_iterator, metric='loss', maximize=False,
            max_checkpoints=1, n_back_off=0, lr_update_factor=1 / 10,
            back_off_patience=None, early_stopping_patience=None,
    ):
        """Reference parity: ``trainer.py:699``."""
        self.register_hook(BackOffValidationHook(
            trigger=self._checkpoint_trigger,
            iterator=validation_iterator,
            metric=metric,
            maximize=maximize,
            max_checkpoints=max_checkpoints,
            n_back_off=n_back_off,
            lr_update_factor=lr_update_factor,
            back_off_patience=back_off_patience,
            early_stopping_patience=early_stopping_patience,
        ))

    # ------------------------------------------------------------------ #
    # checkpointing                                                       #
    # ------------------------------------------------------------------ #
    @property
    def checkpoint_dir(self):
        return self.storage_dir / 'checkpoints'

    def default_checkpoint_path(self) -> Path:
        return self.checkpoint_dir / f'ckpt_{self.iteration}{CKPT_EXT}'

    def state_dict(self):
        """``model`` in the JAX package's layout (numpy arrays),
        ``iteration``, ``epoch``, ``optimizer`` (this package's own) and
        ``hooks`` keyed by hook uid."""
        if isinstance(self.optimizer, dict):
            optimizer_state = {
                k: o.state_dict() for k, o in self.optimizer.items()}
        else:
            optimizer_state = self.optimizer.state_dict()
        state = dict(
            model=to_jax_state_dict(self.model),
            iteration=self.iteration,
            epoch=self.epoch,
            optimizer=optimizer_state,
            hooks=dict(),
        )
        for hook in self.hooks:
            hook_state = hook.state_dict()
            if hook_state is not None:
                assert hook.uid not in state['hooks'], (
                    hook.uid, state['hooks'].keys())
                state['hooks'][hook.uid] = hook_state
        return state

    def wait_for_checkpoint_writes(self):
        """Block until an asynchronous checkpoint write has committed (a
        no-op for synchronous checkpoints); raise, once, the error of a
        write that failed."""
        writer = self._ckpt_writer
        if writer is not None:
            writer.join()
            self._ckpt_writer = None
        error = self._ckpt_writer_error
        if error is not None:
            self._ckpt_writer_error = None
            raise RuntimeError(
                'Asynchronous checkpoint write failed') from error

    def save_checkpoint(self, checkpoint_path=None):
        if checkpoint_path is None:
            checkpoint_path = self.default_checkpoint_path()
        checkpoint_path = Path(checkpoint_path)
        # at most one write in flight
        self.wait_for_checkpoint_writes()
        state = self.state_dict()
        if not self.async_checkpointing:
            self._write_checkpoint(state, checkpoint_path, self.iteration)
            return
        # the model's and the optimizers' tensors (and, on the CPU, the
        # model entry's arrays) alias what the next step changes in
        # place: the thread gets host copies, made before returning
        state = _host_copy(state)
        iteration = self.iteration

        def write():
            try:
                self._write_checkpoint(state, checkpoint_path, iteration)
            except BaseException as e:  # raised by the next wait
                self._ckpt_writer_error = e

        self._ckpt_writer = threading.Thread(
            target=write, name='ckpt-writer', daemon=True)
        self._ckpt_writer.start()

    @staticmethod
    def _write_checkpoint(state, checkpoint_path, iteration):
        """Dump ``state``, then repoint ``ckpt_latest`` (the file is
        written to a temporary name and renamed, so the link moves only to
        a whole checkpoint)."""
        dump_state(state, checkpoint_path)
        latest = (checkpoint_path.parent / f'ckpt_latest{CKPT_EXT}').absolute()
        if latest.is_symlink():
            latest.unlink()
        latest.symlink_to(checkpoint_path.name)
        print(f'Saved model and optimizer state at iteration '
              f'{iteration} to {checkpoint_path}')

    def load_state_dict(self, state_dict):
        from_jax_state_dict(self.model, state_dict['model'])
        if isinstance(self.optimizer, dict):
            assert set(self.optimizer) == set(state_dict['optimizer']), (
                set(self.optimizer), set(state_dict['optimizer']))
            for key, opt in self.optimizer.items():
                opt.load_state_dict(state_dict['optimizer'][key])
        else:
            self.optimizer.load_state_dict(state_dict['optimizer'])
        self.iteration = int(state_dict['iteration'])
        self.epoch = int(state_dict['epoch'])
        hook_states = dict(state_dict.get('hooks', {}))
        for hook in self.hooks:
            hook.set_last(self.iteration, self.epoch)
            if hook.uid in hook_states:
                hook.load_state_dict(hook_states.pop(hook.uid))
        assert len(hook_states) == 0, hook_states.keys()

    def load_checkpoint(self):
        self.wait_for_checkpoint_writes()
        checkpoint_path = self._resolve_checkpoint_path()
        self.load_state_dict(load_state(checkpoint_path))
        print(f'Loaded checkpoint {checkpoint_path!r} '
              f'(iteration {self.iteration})')

    def _resolve_checkpoint_path(self):
        """Find the checkpoint to resume from (ckpt_latest, with a
        fallback to the newest ckpt_<it> on a dangling symlink)."""
        # clean up partial writes of an interrupted save (tmp+rename
        # means a *.tmp* path is by definition incomplete)
        for orphan in self.checkpoint_dir.glob('*.tmp*'):
            print(f'Removing incomplete checkpoint write {orphan}')
            orphan.unlink(missing_ok=True)
        checkpoint_path = self.checkpoint_dir / f'ckpt_latest{CKPT_EXT}'
        if not checkpoint_path.exists():
            candidates = sorted(
                (p for p in self.checkpoint_dir.glob(f'ckpt_*{CKPT_EXT}')
                 if re.fullmatch(r'ckpt_\d+' + re.escape(CKPT_EXT), p.name)
                 and p.exists()),
                key=lambda p: int(re.findall(r'\d+', p.name)[0]))
            assert candidates, (
                f'No checkpoint found in {self.checkpoint_dir} '
                f'(ckpt_latest missing/dangling and no ckpt_<it> files)')
            checkpoint_path = candidates[-1]
            print(f'WARNING: ckpt_latest{CKPT_EXT} is missing or '
                  f'dangling; resuming from {checkpoint_path.name}')
        return checkpoint_path

    # -- device ------------------------------------------------------------
    def to(self, device):
        self.model.to(device)
        for opt in self._optimizers.values():
            opt.to(device)
        return self

    def cpu(self):
        return self.to('cpu')

    def cuda(self, device=None):
        return self.to('cuda' if device is None else device)

    # ------------------------------------------------------------------ #
    def test_run(
            self,
            train_iterator,
            validation_iterator,
            *,
            test_with_known_iterator_length=False,
            temporary_directory=None,
            deterministic_atol=1e-5,
            deterministic_rtol=1e-5,
            loss_atol=1e-6,
            loss_rtol=1e-6,
            virtual_minibatch_size=None,
    ):
        """Burn test: see
        ``padertorch_tpu_torch.train.runtime_tests.test_run``."""
        from padertorch_tpu_torch.train.runtime_tests import test_run
        test_run(
            self,
            train_iterator,
            validation_iterator,
            test_with_known_iterator_length=test_with_known_iterator_length,
            temporary_directory=temporary_directory,
            deterministic_atol=deterministic_atol,
            deterministic_rtol=deterministic_rtol,
            loss_atol=loss_atol,
            loss_rtol=loss_rtol,
            virtual_minibatch_size=virtual_minibatch_size,
        )


class MultiDeviceTrainer(Trainer):
    """Named in reference configs (``trainer.py:921``); not ported."""

    def __init__(self, *args, **kwargs):
        _not_ported('MultiDeviceTrainer')


class InteractiveWriter:
    """Summary writer that prints scalars instead of writing event files.

    Reference parity: ``trainer.py:1083``.
    """

    def __init__(self, *args, **kwargs):
        pass

    def add_scalar(self, tag, value, step):
        print(f'[{step}] {tag}: {value}')

    def __getattr__(self, name):
        if name.startswith('add_') or name in ('close', 'flush'):
            return lambda *args, **kwargs: None
        raise AttributeError(name)


class InteractiveTrainer(Trainer):
    """Trainer for notebook use: prints scalars instead of writing an
    event file (checkpoints as :class:`Trainer`).

    Reference parity: ``trainer.py:1048``.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.writer_cls = InteractiveWriter
