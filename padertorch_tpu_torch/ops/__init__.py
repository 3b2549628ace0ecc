from padertorch_tpu_torch.ops._stft import STFT, HostSTFT
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP
