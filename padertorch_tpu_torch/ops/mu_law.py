"""mu-law companding.  Counterpart of ``padertorch_tpu/ops/mu_law.py``
(reference ``padertorch/ops/mu_law.py``)."""
import math

import torch

__all__ = ['mu_law_encode', 'mu_law_decode']


def mu_law_encode(x, mu_quantization=256):
    """Encode a [-1, 1] signal to mu-law quantization indices (int32; the
    value is truncated, not rounded, as in the JAX package).  The indices
    are computed in float32 whatever the signal's dtype: in bf16 the sum
    before the truncation is 256 near x = 1, one past the table (the JAX
    package's gathers clamp such an index; ``torch.nn.Embedding`` raises).

    >>> mu_law_encode(torch.tensor([-1.0, 0.0, 1.0])).tolist()
    [0, 128, 255]
    """
    x = x.float()
    mu = mu_quantization - 1.0
    scaling = math.log1p(mu)
    x_mu = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / scaling
    return ((x_mu + 1) / 2 * mu + 0.5).to(torch.int32)


def mu_law_decode(x, mu_quantization=256):
    """Decode mu-law indices back to a [-1, 1] signal.

    >>> decoded = mu_law_decode(mu_law_encode(torch.tensor([-0.5, 0.0, 0.5])))
    >>> [round(float(v), 2) for v in decoded]
    [-0.5, 0.0, 0.5]
    """
    x = x.to(torch.float32)
    mu = mu_quantization - 1.0
    signal = 2 * (x / mu) - 1
    magnitude = (1 / mu) * ((1 + mu) ** torch.abs(signal) - 1)
    return torch.sign(signal) * magnitude
