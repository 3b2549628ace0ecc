from padertorch_tpu_torch.models import bss, tasnet
from padertorch_tpu_torch.models.bss import (
    PermutationInvariantTrainingModel, DeepClusteringModel,
)
from padertorch_tpu_torch.models.tasnet import TasNet
