from padertorch_tpu_torch.ops.losses.source_separation import (
    deep_clustering_loss, pit_loss, compute_pairwise_losses,
    pit_loss_from_loss_matrix,
)
