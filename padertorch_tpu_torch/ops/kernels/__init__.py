"""Hand-written CUDA kernels (sources in ``padertorch_tpu_torch/csrc``).

Each wrapper module holds the kernel's launcher and its plain PyTorch
version.  Nothing is built or loaded until a wrapper gets a CUDA tensor.
Importing this package registers the six inference kernels as the custom
operators ``torch.ops.ptt.*`` (``_ops.py``), which a loaded
``torch.export`` artifact calls.
"""
from padertorch_tpu_torch.ops.kernels import (  # noqa: F401
    attention, gru, int8_matmul, logmel, lstm, masked_istft)
