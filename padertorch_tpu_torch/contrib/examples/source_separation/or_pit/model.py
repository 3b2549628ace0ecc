"""Reference-layout re-export: OR-PIT is a core model family here."""
from padertorch_tpu_torch.models.or_pit import (
    OneAndRestPIT, one_and_rest_permutation_invariant_loss,
)

__all__ = ['OneAndRestPIT', 'one_and_rest_permutation_invariant_loss']
