"""Hand-written CUDA kernels (sources in ``padertorch_tpu_torch/csrc``).

Each wrapper module holds the kernel's launcher and its plain PyTorch
version.  Nothing is built or loaded until a wrapper gets a CUDA tensor.
"""
