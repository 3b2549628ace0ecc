from padertorch_tpu_torch.ops.losses.regression import (
    mse_loss, log_mse_loss, sdr_loss, si_sdr_loss, log1p_mse_loss,
    source_aggregated_sdr_loss,
)
from padertorch_tpu_torch.ops.losses.source_separation import (
    deep_clustering_loss, pit_loss, compute_pairwise_losses,
    pit_loss_from_loss_matrix,
)
from padertorch_tpu_torch.ops.losses.ctc import (
    ctc_loss, ctc_greedy_decode, ctc_beam_search_decode,
    edit_distance,
)
from padertorch_tpu_torch.ops.losses.rnnt import (
    rnnt_loss, rnnt_greedy_decode, rnnt_beam_search,
)
from padertorch_tpu_torch.ops.losses.stft import (
    spectral_convergence_loss, log_stft_magnitude_loss,
    stft_magnitude_loss, multi_resolution_stft_loss,
)
