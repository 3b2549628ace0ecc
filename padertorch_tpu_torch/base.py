"""Model base class: ``torch.nn.Module`` plus the config and checkpoint
contract.

Counterpart of ``padertorch_tpu/base.py`` ``Model`` (reference
``padertorch/base.py``): a user implements ``forward(inputs)`` and
``review(inputs, outputs)`` and the trainer owns the loop; the model is
built from a config (``Configurable``) and loads a finished training with
:meth:`Model.from_storage_dir`, from the ``config.json`` and the ``.ptt``
checkpoint that either package's trainer writes.
"""
from pathlib import Path

import numpy as np
import torch

from padertorch_tpu_torch.configurable import Configurable
from padertorch_tpu_torch.utils.nested import get_by_path

__all__ = ['Model']


class Model(torch.nn.Module, Configurable):
    """Abstract base for trainable models.

    Subclasses implement:

    - ``forward(inputs) -> outputs``: the network.
    - ``review(inputs, outputs) -> dict``: loss and report; allowed keys
      (reference ``base.py:254-318``):

      - ``loss``: scalar tensor, the training objective, or
      - ``losses``: dict of named scalar losses (weighted by the trainer's
        ``loss_weights``),
      - ``scalars``: dict name -> scalar/tensor (aggregated as means),
      - ``histograms``: dict name -> tensor of values,
      - ``images``: dict name -> image array [*, H, W] in [0, 1],
      - ``audios``: dict name -> signal or (signal, sampling rate),
      - ``texts``, ``figures``: accepted, but the event writer does not
        write them yet,
      - ``buffers``: dict name -> tensor, collected across steps for
        custom aggregation in ``modify_summary``,
      - ``snapshots``: dict name -> tensor, keep-last (only computed when
        ``self.create_snapshot`` is True).
    """

    # When False, models should skip expensive snapshot computation; the
    # SummaryHook flips this so snapshots are only built when they will be
    # written to the event file (reference ``base.py:235``).
    create_snapshot = False

    def forward(self, inputs):
        raise NotImplementedError

    def review(self, inputs, outputs) -> dict:
        """Compute loss and report from inputs and ``forward`` outputs."""
        raise NotImplementedError

    def modify_summary(self, summary: dict) -> dict:
        """Post-process an aggregated summary (on the host).

        Called by the summary hook just before writing, e.g. to compute an
        accuracy from buffered labels.  Implementations must drain
        ``summary['buffers']`` and convert ``summary['snapshots']`` they
        consume.  The default reduces scalar lists to their mean
        (reference ``base.py:320-358``).
        """
        for key, scalar in summary['scalars'].items():
            summary['scalars'][key] = np.mean(np.asarray(scalar))
        assert len(summary['buffers']) == 0, (
            'intermediate format buffers has to be converted during '
            'modify_summary')
        assert len(summary['snapshots']) == 0, (
            'intermediate format snapshots has to be converted during '
            'modify_summary')
        return summary

    def example_to_device(self, example, device=None):
        """Move a (nested) numpy example to a device (default: the
        device of the model's parameters).  Reference: ``base.py:360``."""
        from padertorch_tpu_torch.data.batch import example_to_device
        if device is None:
            device = next(self.parameters()).device
        return example_to_device(example, device)

    def load_checkpoint(self, checkpoint_path, in_checkpoint_path='model'):
        """Fill the parameters from a checkpoint file of either package's
        trainer (a ``.ptt`` state, whose model entry is in the JAX
        model's ``state_dict`` layout); returns ``self``."""
        from padertorch_tpu_torch.migrate import from_jax_state_dict
        from padertorch_tpu_torch.serialize import load_state
        state = load_state(checkpoint_path)
        if in_checkpoint_path:
            state = get_by_path(state, in_checkpoint_path)
        return from_jax_state_dict(self, state)

    @classmethod
    def from_config_and_checkpoint(
            cls,
            config_path,
            checkpoint_path,
            in_config_path='trainer.model',
            in_checkpoint_path='model',
    ):
        """Reference parity: ``base.py:75``."""
        model = cls.from_file(config_path, in_config_path)
        return model.load_checkpoint(checkpoint_path, in_checkpoint_path)

    @classmethod
    def from_storage_dir(
            cls,
            storage_dir,
            config_name='config.json',
            checkpoint_name='ckpt_best_loss.ptt',
            in_config_path='trainer.model',
            in_checkpoint_path='model',
    ):
        """Load the model of a finished training. Reference: ``base.py:183``."""
        storage_dir = Path(storage_dir)
        return cls.from_config_and_checkpoint(
            config_path=storage_dir / config_name,
            checkpoint_path=storage_dir / 'checkpoints' / checkpoint_name,
            in_config_path=in_config_path,
            in_checkpoint_path=in_checkpoint_path,
        )
