"""Deep clustering model.  Counterpart of ``padertorch_tpu/contrib/tcl/
dc.py`` (reference ``padertorch/contrib/tcl/dc.py``).

The model itself lives in ``padertorch_tpu_torch.models.bss``; re-exported
here for reference-layout parity.
"""
from padertorch_tpu_torch.models.bss import DeepClusteringModel

__all__ = ['DeepClusteringModel']
