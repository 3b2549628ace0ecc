from padertorch_tpu_torch.ops.sequence.mask import compute_mask
