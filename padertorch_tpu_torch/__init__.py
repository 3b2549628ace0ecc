"""padertorch_tpu_torch: the PyTorch + CUDA port of padertorch_tpu.

Module paths mirror ``padertorch_tpu``'s.  The package imports torch,
numpy and scipy, never JAX and never ``padertorch_tpu``.  The hand-written
CUDA kernels (``csrc/``) are built and loaded at their first call on a
CUDA tensor; importing the package touches no GPU.

The port computes in true float32, as its kernels do and as the JAX
package's ``Precision.HIGHEST`` products do: importing the package turns
off TF32 for torch's matrix products and for cuDNN's convolutions (torch
leaves the latter on by default, and cuDNN's TF32 algorithms differ from
one another by more than ``Trainer.test_run``'s limit of 1e-5).  This holds
for every way into the package: a recipe's ``main``, ``Trainer.from_config``
or ``Model.from_storage_dir``.  A caller who wants TF32 sets the two flags
of ``torch.backends`` back after the import.

    >>> import padertorch_tpu_torch as pt
    >>> pt.models.bss.PermutationInvariantTrainingModel  # doctest: +ELLIPSIS
    <class '...PermutationInvariantTrainingModel'>
"""
import torch

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
from padertorch_tpu_torch.train import (
    Trainer, Optimizer, Adam, AdamW, SGD, Adadelta, Adafactor, Lion, Muon,
)
from padertorch_tpu_torch.train.trainer import InteractiveTrainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = '0.1.0'
