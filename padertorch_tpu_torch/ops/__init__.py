from padertorch_tpu_torch.ops._stft import STFT, HostSTFT
from padertorch_tpu_torch.ops.streaming import StreamingSTFT, StreamingISTFT
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP
from padertorch_tpu_torch.ops import losses
from padertorch_tpu_torch.ops import sequence
from padertorch_tpu_torch.ops.sequence.mask import compute_mask
from padertorch_tpu_torch.ops.losses import (
    deep_clustering_loss, pit_loss, compute_pairwise_losses,
    pit_loss_from_loss_matrix,
)
