"""Reference-layout re-export of the TasNet encoder/decoder pairs."""
from padertorch_tpu_torch.models.tasnet import (
    TasEncoder, TasDecoder, StftEncoder, IstftDecoder,
)

__all__ = ['TasEncoder', 'TasDecoder', 'StftEncoder', 'IstftDecoder']
