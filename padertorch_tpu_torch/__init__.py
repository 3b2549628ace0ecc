"""padertorch_tpu_torch: the PyTorch + CUDA port of padertorch_tpu.

Module paths mirror ``padertorch_tpu``'s.  The package imports torch,
numpy and scipy, never JAX and never ``padertorch_tpu``.  The hand-written
CUDA kernels (``csrc/``) are built and loaded at their first call on a
CUDA tensor; importing the package touches no GPU.

    >>> import padertorch_tpu_torch as pt
    >>> pt.models.bss.PermutationInvariantTrainingModel  # doctest: +ELLIPSIS
    <class '...PermutationInvariantTrainingModel'>
"""
from padertorch_tpu_torch.configurable import Configurable
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch import utils
from padertorch_tpu_torch import io
from padertorch_tpu_torch import nn
from padertorch_tpu_torch import ops
from padertorch_tpu_torch import modules
from padertorch_tpu_torch import models
from padertorch_tpu_torch import migrate
from padertorch_tpu_torch import evaluation
from padertorch_tpu_torch import summary
from padertorch_tpu_torch import train
from padertorch_tpu_torch.train.optimizer import Adam, AdamW, SGD
from padertorch_tpu_torch.train.trainer import Trainer

__version__ = '0.1.0'
