"""Model base class: ``torch.nn.Module`` plus the config and checkpoint
contract.

Counterpart of ``padertorch_tpu/base.py`` ``Model`` (reference
``padertorch/base.py``): a user implements ``forward(inputs)``; the model is
built from a config (``Configurable``) and loads a finished training with
:meth:`Model.from_storage_dir`, from the ``config.json`` and the ``.ptt``
checkpoint that the JAX trainer writes.  ``review`` comes with training.
"""
from pathlib import Path

import torch

from padertorch_tpu_torch.configurable import Configurable
from padertorch_tpu_torch.utils.nested import get_by_path

__all__ = ['Model']


class Model(torch.nn.Module, Configurable):
    """Abstract base for models; subclasses implement ``forward``."""

    def forward(self, inputs):
        raise NotImplementedError

    def load_checkpoint(self, checkpoint_path, in_checkpoint_path='model'):
        """Fill the parameters from a checkpoint file of the JAX trainer
        (a ``.ptt`` state, whose model entry is the JAX model's
        ``state_dict``); returns ``self``."""
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
