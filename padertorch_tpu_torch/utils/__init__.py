from . import nested
from .nested import (
    flatten,
    deflatten,
    nested_merge,
    nested_update,
    nested_op,
    get_by_path,
    set_by_path,
)
