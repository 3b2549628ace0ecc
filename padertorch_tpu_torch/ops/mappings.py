"""String-to-callable dispatchers with helpful error messages.

Counterpart of ``padertorch_tpu/ops/mappings.py`` (reference
``padertorch/ops/mappings.py``), mapping to ``torch.nn`` activations with
the JAX package's default axes (softmax over the last axis, GLU over
axis -2).
"""
import difflib
import functools

from padertorch_tpu_torch import nn

__all__ = ['ACTIVATION_FN_MAP', 'Dispatcher', 'DispatchError']


class DispatchError(KeyError):
    def __init__(self, item, keys):
        close = difflib.get_close_matches(str(item), [str(k) for k in keys],
                                          n=5, cutoff=0.3)
        super().__init__(f'Invalid option {item!r}. Close matches: {close}.')


class Dispatcher(dict):
    """Dict with a did-you-mean error message.

    >>> d = Dispatcher(abc=1, bcd=2)
    >>> d['abc']
    1
    >>> d['acd']  # doctest: +ELLIPSIS
    Traceback (most recent call last):
    ...
    padertorch_tpu_torch.ops.mappings.DispatchError: "Invalid option 'acd'...
    """

    def __getitem__(self, item):
        try:
            return super().__getitem__(item)
        except KeyError:
            raise DispatchError(item, self.keys()) from None


class _CallableDispatcher(Dispatcher):
    """Callable inputs pass through unchanged (reference ``mappings.py:10``).

    >>> d = _CallableDispatcher(abc=1)
    >>> d[len]
    <built-in function len>
    """

    def __getitem__(self, item):
        if callable(item):
            return item
        return super().__getitem__(item)


ACTIVATION_FN_MAP = _CallableDispatcher(
    relu=nn.ReLU,
    prelu=nn.PReLU,
    leaky_relu=nn.LeakyReLU,
    elu=nn.ELU,
    gelu=nn.GELU,
    silu=nn.SiLU,
    tanh=nn.Tanh,
    sigmoid=nn.Sigmoid,
    softmax=functools.partial(nn.Softmax, dim=-1),
    glu=functools.partial(nn.GLU, dim=-2),
    identity=nn.Identity,
)
