from padertorch_tpu_torch.models import bss, tasnet
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.models.tasnet import TasNet
