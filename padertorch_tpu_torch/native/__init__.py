"""Native host-side data preparation (counterpart of
``padertorch_tpu/native``); ``NATIVE_AVAILABLE`` is read from
``dataprep`` when asked for, which builds the library then."""
from padertorch_tpu_torch.native import dataprep
from padertorch_tpu_torch.native.dataprep import (
    pcm16_to_float32, mu_law_encode, mu_law_decode, frame_signal,
)

__all__ = ['NATIVE_AVAILABLE', 'pcm16_to_float32', 'mu_law_encode',
           'mu_law_decode', 'frame_signal']


def __getattr__(name):
    if name == 'NATIVE_AVAILABLE':
        return dataprep.NATIVE_AVAILABLE
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
