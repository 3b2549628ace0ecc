"""Dropout+Linear+activation stacks.

Counterpart of ``padertorch_tpu/modules/fully_connected.py`` (reference
``padertorch/modules/fully_connected.py:9``).
"""
from padertorch_tpu_torch import nn
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP

__all__ = ['fully_connected_stack']


def fully_connected_stack(
        input_size,
        hidden_size,
        output_size,
        activation='relu',
        dropout=0.5,
        output_activation=None,
):
    """Build [Dropout, Linear, activation] * N as an ``nn.Sequential``.

    ``dropout`` is the forget probability (like the reference/torch).

    >>> import torch
    >>> stack = fully_connected_stack(513, [1024, 1024], 1024)
    >>> len(stack)  # 3 x (dropout, linear) + 2 activations
    8
    >>> stack.eval()(torch.ones((2, 513))).shape
    torch.Size([2, 1024])
    """
    assert input_size is not None, input_size
    assert output_size is not None, output_size

    if hidden_size is None:
        l_n_units = [input_size, output_size]
    elif isinstance(hidden_size, (list, tuple)):
        l_n_units = [input_size] + list(hidden_size) + [output_size]
    elif isinstance(hidden_size, int):
        l_n_units = [input_size, hidden_size, output_size]
    else:
        raise TypeError(hidden_size)

    activations = [activation] * (len(l_n_units) - 2) + [output_activation]

    layers = []
    for l_idx, n_units in enumerate(l_n_units[:-1]):
        layers.append(nn.Dropout(dropout))
        layers.append(nn.Linear(n_units, l_n_units[l_idx + 1]))
        if activations[l_idx] is not None \
                and activations[l_idx] != 'identity':
            layers.append(ACTIVATION_FN_MAP[activations[l_idx]]())
    return nn.Sequential(*layers)
