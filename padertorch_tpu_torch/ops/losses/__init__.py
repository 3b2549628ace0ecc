from padertorch_tpu_torch.ops.losses.regression import (
    mse_loss, log_mse_loss, sdr_loss, si_sdr_loss, log1p_mse_loss,
    source_aggregated_sdr_loss,
)
from padertorch_tpu_torch.ops.losses.source_separation import (
    deep_clustering_loss, pit_loss, compute_pairwise_losses,
    pit_loss_from_loss_matrix,
)
