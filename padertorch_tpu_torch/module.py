"""Module-tree helpers.

Counterpart of the one helper of ``padertorch_tpu/module.py`` that the
port needs so far, :func:`swap_submodules` (under
``quantize.quantize_module``).  The JAX package walks attributes, lists,
tuples and dicts of its own ``Module``; here the children of an
``nn.Module`` are walked, the items of an ``nn.ModuleList`` or
``nn.ModuleDict`` among them.
"""
import torch

__all__ = ['swap_submodules']


def swap_submodules(module, predicate, convert):
    """Walk ``module``'s tree in place, replacing every submodule for which
    ``predicate(submodule, attr_name)`` is true with ``convert(submodule)``
    (items of a ``ModuleList``/``ModuleDict`` pass the container's
    attribute name, as the items of a list do in the JAX package); a
    replaced submodule is not walked.  Returns how many were swapped.

    >>> net = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.ReLU())
    >>> swap_submodules(net, lambda m, name: isinstance(m, torch.nn.ReLU),
    ...                 lambda m: torch.nn.Tanh())
    1
    >>> net[1]
    Tanh()
    """
    containers = (torch.nn.ModuleList, torch.nn.ModuleDict)

    def walk(mod, item_name=None):
        count = 0
        for name, child in list(mod.named_children()):
            attr = name if item_name is None else item_name
            if predicate(child, attr):
                setattr(mod, name, convert(child))
                count += 1
            else:
                count += walk(child, name if isinstance(child, containers)
                              else None)
        return count

    return walk(module)
