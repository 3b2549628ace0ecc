"""LoRA adapters: parameter-efficient fine-tuning (Hu et al. 2021).

Counterpart of ``padertorch_tpu/lora.py``.  ``y = x W^T + b + (alpha/r)
(x A) B`` with the base weight frozen and ``B`` zero-initialized, so
fine-tuning starts exactly at the pretrained model.  The JAX package
freezes by registering the base as buffers; the port keeps them as
parameters with ``requires_grad=False``, so the Trainer's optimizer (which
takes the parameters that require a gradient) sees only ``lora_a`` and
``lora_b``.  ``lora_a`` is (in, r) and ``lora_b`` (r, out), the JAX
package's names and layouts; the base ``weight`` is (out, in), torch's
``Linear`` layout (``migrate.py`` transposes it).

For serving, :func:`merge_lora` folds ``A @ B`` back into a dense
``nn.Linear``, so the deployed model has no adapter and composes with
``quantize_module`` and ``serve.export_model``.

>>> _ = torch.manual_seed(0)
>>> head = torch.nn.Sequential(nn.LayerNorm(16), nn.Linear(16, 8)).eval()
>>> x = torch.randn(2, 16)
>>> before = head(x)
>>> apply_lora(head, rank=4)
1
>>> bool(torch.equal(head(x), before))  # B = 0: starts at the identity
True
>>> mark_only_lora_trainable(head)  # the norm's weight and bias
2
>>> [tuple(p.shape) for p in head.parameters() if p.requires_grad]
[(16, 4), (4, 8)]
"""
import math

import torch

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.module import swap_submodules

__all__ = ['LoRALinear', 'apply_lora', 'merge_lora',
           'mark_only_lora_trainable']


class LoRALinear(torch.nn.Module):
    """``nn.Linear`` with a trainable low-rank delta on a frozen base."""

    def __init__(self, base, rank, alpha=None, dropout=0.0):
        super().__init__()
        self.in_features = base.in_features
        self.out_features = base.out_features
        self.rank = rank
        self.scaling = (alpha if alpha is not None else rank) / rank
        weight = base.weight.detach()
        self.weight = torch.nn.Parameter(weight, requires_grad=False)
        self.bias = (None if base.bias is None else torch.nn.Parameter(
            base.bias.detach(), requires_grad=False))
        # A: uniform in +-1/sqrt(in) like the paper's kaiming-uniform;
        # B: zeros, so the delta starts at 0
        bound = 1.0 / math.sqrt(self.in_features)
        self.lora_a = torch.nn.Parameter(torch.empty(
            (self.in_features, rank), dtype=weight.dtype,
            device=weight.device).uniform_(-bound, bound))
        self.lora_b = torch.nn.Parameter(torch.zeros(
            (rank, self.out_features), dtype=weight.dtype,
            device=weight.device))
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        # the base as ``nn.Linear`` computes it (outside float32 the bias
        # is added to the rounded product, as in the JAX package)
        if nn._fused(x, self.bias):
            y = torch.nn.functional.linear(x, self.weight, self.bias)
        else:
            y = torch.nn.functional.linear(x, self.weight) + self.bias
        h = self.dropout(x) if self.dropout is not None else x
        return y + (h @ self.lora_a) @ self.lora_b * self.scaling

    def merged(self):
        """Fold the adapter into a plain ``nn.Linear`` (serving)."""
        weight = self.weight + (self.lora_a @ self.lora_b
                                * self.scaling).t()
        lin = nn.Linear(self.in_features, self.out_features,
                        bias=self.bias is not None, device=weight.device,
                        dtype=weight.dtype)
        with torch.no_grad():
            lin.weight.copy_(weight)
            if self.bias is not None:
                lin.bias.copy_(self.bias)
        return lin

    def extra_repr(self):
        return (f'in_features={self.in_features}, '
                f'out_features={self.out_features}, rank={self.rank}')


def apply_lora(module, rank=8, alpha=None, dropout=0.0, targets=None):
    """Swap ``nn.Linear`` layers under ``module`` (in place) for
    :class:`LoRALinear`; returns how many were adapted.

    Args:
        targets: optional collection of attribute-name substrings to
            restrict adaptation (e.g. ``('q_proj', 'v_proj')``, the LoRA
            paper's default for transformers).  None adapts every Linear.
    """
    def predicate(item, name):
        if type(item) not in (nn.Linear, torch.nn.Linear):
            return False
        return targets is None or any(t in name for t in targets)

    return swap_submodules(
        module, predicate,
        lambda lin: LoRALinear(lin, rank, alpha=alpha, dropout=dropout))


def merge_lora(module):
    """Fold every adapter back into a dense ``nn.Linear`` (in place);
    returns how many were merged.  The result is adapter-free for serving
    and export, and matches the adapted forward to rounding."""
    return swap_submodules(
        module, lambda item, name: isinstance(item, LoRALinear),
        lambda layer: layer.merged())


def mark_only_lora_trainable(module):
    """Freeze every parameter under ``module`` but the adapters' ``lora_a``
    and ``lora_b`` (``requires_grad=False``), so that an optimizer built on
    the parameters that require a gradient trains only the adapters.
    Returns how many parameters it froze."""
    adapters = {id(p) for layer in module.modules()
                if isinstance(layer, LoRALinear)
                for p in (layer.lora_a, layer.lora_b)}
    count = 0
    for p in module.parameters():
        if id(p) not in adapters and p.requires_grad:
            p.requires_grad_(False)
            count += 1
    return count
