"""Reference-layout re-export: TasNet is a core model family here."""
from padertorch_tpu_torch.models.tasnet import TasNet

__all__ = ['TasNet']
