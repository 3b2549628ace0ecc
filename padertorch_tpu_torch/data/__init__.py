from padertorch_tpu_torch.data.batch import example_to_device
from padertorch_tpu_torch.data.utils import collate_fn, pad_tensor, pad_batch, pad_to_multiple
