"""The inference kernels as ``torch.library`` custom operators.

The six kernels that serve a forward pass (the lean LSTM and GRU forwards,
the attention forward, the fused log-mel front end, the fused masked
iSTFT and the int8 matrix product) are each one operator of the
``ptt`` namespace (``torch.ops.ptt.<name>``), so that ``torch.export``
records them as single nodes and a loaded artifact launches the same
kernels as the eager model.  Each operator has

- a CPU implementation, the kernel's plain PyTorch version;
- a CUDA implementation, the kernel's launch (its checks, route planner,
  scratch and launch counter run there, on concrete tensors);
- a fake implementation that gives the launch's output shapes, dtypes and
  strides (symbolic sizes where the input's are);

and no default implementation: an operator called on a CUDA tensor
launches the kernel or raises.  Importing
``padertorch_tpu_torch.ops.kernels`` registers all six; nothing is built
until a CUDA implementation runs.

The wrappers (``lstm_cell_scan``, ``gru_cell_scan``, ``flash_attention``,
``LogMelFrontend``, ``masked_istft``, ``int8_matmul``) keep their
signatures and take the operator wherever autograd does not record (eval
under ``no_grad`` and every export); the training forwards and backwards
stay ``torch.autograd.Function``s.  Outside tracing, a wrapper given a
CUDA tensor calls the operator's CUDA implementation itself
(:func:`call`): the same function the operator runs, without the
dispatcher's cost per call, which the int8 decoder pays 97 times a token.
"""
import torch

__all__ = ['NAMESPACE', 'define', 'call', 'EAGER_DIRECT']

NAMESPACE = 'ptt'

# outside tracing, send a CUDA tensor straight to the operator's CUDA
# implementation (False: through the dispatcher, as a traced graph does);
# chip_smoke.py phase 21 times the decoder both ways
EAGER_DIRECT = True


def define(name, plain, launch, fake):
    """Register ``ptt::<name>`` with ``plain`` as its CPU implementation
    (its type annotations give the schema), ``launch`` as its CUDA one and
    ``fake`` as its fake one; returns the operator.  ``launch`` is kept on
    it as ``op.cuda_impl``."""
    op = torch.library.custom_op(f'{NAMESPACE}::{name}', plain,
                                 mutates_args=(), device_types='cpu')
    op.register_kernel('cuda')(launch)
    op.register_fake(fake)
    op.cuda_impl = launch
    return op


def call(op, *args):
    """``op(*args)``; on a CUDA tensor outside tracing (with
    :data:`EAGER_DIRECT`) the operator's CUDA implementation itself."""
    if (EAGER_DIRECT and args[0].is_cuda
            and not torch.compiler.is_compiling()):
        return op.cuda_impl(*args)
    return op(*args)
