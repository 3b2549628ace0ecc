from padertorch_tpu_torch.summary.tbx_utils import (
    mask_to_image, stft_to_image, spectrogram_to_image, review_dict,
)
from padertorch_tpu_torch.summary.writer import SummaryWriter
from padertorch_tpu_torch.summary.tfevents import (
    load_events_as_dict, scalars_from_events,
)
