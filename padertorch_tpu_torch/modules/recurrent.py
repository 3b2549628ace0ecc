"""Multi-layer (bidirectional) LSTM and GRU over the cell-scan kernels.

Counterpart of ``padertorch_tpu/modules/recurrent.py`` ``LSTM`` and ``GRU``
on their time-major stack (``_forward_time_major``): one transpose at entry
and one at exit; per layer the input projection of both directions is one
batched matmul, and the recurrence of both directions is one call of
:func:`padertorch_tpu_torch.ops.kernels.lstm.lstm_cell_scan` or
:func:`padertorch_tpu_torch.ops.kernels.gru.gru_cell_scan` (one kernel
launch on a CUDA tensor, the plain time loop on a CPU tensor).

Variable lengths use masks: the carry freezes beyond a sequence's length
(final states match packed-sequence semantics) and outputs are zero in the
padding.  The backward direction runs on the time-flipped sequence and
mask: the carry freezes through the leading padding, then the valid part
runs in reverse, and flipping the output back restores alignment.
``seq_lens`` may be a list or numpy array on the host: only the lengths
are copied to the device, where the mask is built, and no step waits for
the device to read a length.

Parameters carry ``torch.nn.LSTM``'s and ``torch.nn.GRU``'s names and
layouts (``weight_ih_l{k}[_reverse]`` (G*H, in), ``weight_hh_l{k}[_reverse]``
(G*H, H), ``bias_ih_...`` and ``bias_hh_...``; gate order i, f, g, o or
r, z, n), so ``padertorch_tpu.migrate.import_torch_state_dict`` maps them
onto the JAX model unchanged.  The kernels use the sum of the two biases,
and only ``bias_ih`` is trained: the JAX modules have one fused bias, and
two trained copies of it would each get its gradient, which doubles the
bias's share of the global gradient norm and its step.  ``bias_hh`` stays
in the module and in ``state_dict()`` with ``requires_grad=False``.  The
GRU cell has no hidden bias (``n = tanh(gx_n + r * gh_n)``): the n block of
its ``bias_hh`` has to be zero, which ``migrate.to_jax_state_dict`` checks.

On CUDA tensors the recurrence trains through the kernels too: under grad
mode the cell scans are ``torch.autograd.Function``s whose forward and
backward are kernels, and nothing here detaches.

Precision, as in the JAX package.  The parameters are float32 masters (or,
under the trainer's bf16 policy, bf16 casts of them); carries and final
states are always float32, and each layer's output is cast back to the
input's dtype, so a float32 model stays float32 outside the RNN and a bf16
stream stays bf16.  With ``compute_dtype='bfloat16'`` the input projection
multiplies bf16 operands with float32 sums (:func:`project`), adds the
bias in float32 and rounds the gates once to bf16, the stream dtype of the
cell scan, whose recurrent products are bf16 with float32 sums too.
Without it the projection sums in float32 (bf16 inputs and weights are
widened, which is exact) and the scan runs its float32 kernels.  The LSTM
and the GRU have both kernels on the card, and the plain versions compute
the same contract on the CPU.  :func:`set_rnn_backend` sets
``compute_dtype`` on every RNN of a module tree, as the JAX package's
does.
"""
import math

import numpy as np
import torch

from padertorch_tpu_torch.ops.kernels.gru import gru_cell_scan
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, matmul_f32, product_dtype, sum_outer)

__all__ = ['LSTM', 'GRU', 'StatefulLSTM', 'project', 'set_rnn_backend']


class _Project(torch.autograd.Function):
    """See :func:`project`."""

    @staticmethod
    def forward(ctx, x, w, bias):
        n_dir, t_len, batch, _ = x.shape
        rows = x.reshape(n_dir, t_len * batch, -1)
        gates = matmul_f32(rows, w.transpose(1, 2)) + bias[:, None, :]
        ctx.save_for_backward(x, w)
        return gates.to(x.dtype).reshape(
            n_dir, t_len, batch, -1).transpose(0, 1).reshape(
            t_len, n_dir * batch, -1).contiguous()

    @staticmethod
    def backward(ctx, d_gates):
        x, w = ctx.saved_tensors
        n_dir, t_len, batch, _ = x.shape
        dx = dw = d_bias = None
        if ctx.needs_input_grad[1]:
            # (D, G, F): sum over the steps and rows of d_gates_t^T x_t
            dw = sum_outer(d_gates, x.transpose(0, 1), n_dir).to(w.dtype)
        d_gates = d_gates.reshape(t_len, n_dir, batch, -1).transpose(
            0, 1)                                           # (D, T, B, G)
        if ctx.needs_input_grad[0]:
            dx = matmul_f32(d_gates.reshape(n_dir, t_len * batch, -1),
                            w).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[2]:
            d_bias = d_gates.float().sum(dim=(1, 2))
        return dx, dw, d_bias


def project(x_pair, w_ih, bias):
    """The input projection: x_pair (D, T, B, F) and w_ih (D, G, F), both
    of one dtype (float32, or bf16 under ``compute_dtype='bfloat16'``),
    and a float32 bias -> gates (T, D * B, G) = x @ w_ih^T + bias in that
    dtype.  The products are summed in float32
    (:func:`~padertorch_tpu_torch.ops.kernels.lstm.matmul_f32`: on the card
    one GEMM with a float32 output) and the bias added before the one
    rounding, as the JAX package's ``preferred_element_type`` projection
    and its cast to the stream dtype.  Its backward takes the gate
    adjoints of that dtype: the input adjoint and the weight gradient are
    products with float32 sums (the weight's over T * B rows by
    :func:`~padertorch_tpu_torch.ops.kernels.lstm.sum_outer`), the bias
    gradient a float32 sum."""
    return _Project.apply(x_pair, w_ih, bias)


class _RNNBase(torch.nn.Module):
    """What ``LSTM`` and ``GRU`` share: parameters, the layer loop, masks,
    directions, dropout.  A subclass sets ``gates`` (gate blocks per unit)
    and ``num_states`` and implements ``_scan``."""

    gates = None
    num_states = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, dropout=0.0, compute_dtype=None):
        """``dropout`` acts between layers in training mode; set
        ``self.generator`` to a ``torch.Generator`` to draw its masks from
        that instead of the global generator.  ``compute_dtype``: None or
        'bfloat16' (see the module docstring)."""
        super().__init__()
        self.compute_dtype = product_dtype(compute_dtype)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dropout = dropout
        self.num_directions = 2 if bidirectional else 1
        self.generator = None
        gates = self.gates * hidden_size
        for layer in range(num_layers):
            in_size = (input_size if layer == 0
                       else hidden_size * self.num_directions)
            for suffix in self._suffixes():
                for name, shape in (
                        ('weight_ih', (gates, in_size)),
                        ('weight_hh', (gates, hidden_size)),
                        ('bias_ih', (gates,)), ('bias_hh', (gates,))):
                    self.register_parameter(
                        f'{name}_l{layer}{suffix}',
                        torch.nn.Parameter(torch.empty(shape),
                                           requires_grad=name != 'bias_hh'))
        self.reset_parameters()

    def _suffixes(self):
        return ('', '_reverse')[:self.num_directions]

    def reset_parameters(self):
        """U(-1/sqrt(H), 1/sqrt(H)) like torch's and the JAX modules, whose
        one bias ``bias_ih`` stands for; the frozen ``bias_hh`` starts at
        zero (a loaded ``torch.nn`` state may hold any)."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for name, p in self.named_parameters():
            if name.startswith('bias_hh'):
                torch.nn.init.zeros_(p)
            else:
                torch.nn.init.uniform_(p, -bound, bound)

    def _layer_weights(self, layer):
        """(w_ih (D, G*H, in), w_hh (D, H, G*H), bias (D, G*H))."""
        ps = [{name: getattr(self, f'{name}_l{layer}{suffix}')
               for name in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}
              for suffix in self._suffixes()]
        w_ih = torch.stack([p['weight_ih'] for p in ps])
        w_hh = torch.stack([p['weight_hh'].t() for p in ps]).contiguous()
        bias = torch.stack([p['bias_ih'] + p['bias_hh'] for p in ps])
        return w_ih, w_hh, bias

    def _scan(self, gates_x, w_hh, mask_t, init):
        """-> (out (T, D*B, H), tuple of final states (D*B, H))."""
        raise NotImplementedError

    def _mask(self, seq_lens, t_len, device):
        """(T, D*B) float mask, the second direction's flipped in time.
        Only the lengths cross to the device (a few bytes, which does not
        make the host wait for the card); the mask is built there."""
        if not isinstance(seq_lens, torch.Tensor):
            seq_lens = torch.from_numpy(np.asarray(seq_lens).reshape(-1))
        lens = seq_lens.to(device)
        mask_t = (torch.arange(t_len, device=device)[:, None]
                  < lens[None, :]).to(torch.float32)        # (T, B)
        if self.num_directions == 2:
            mask_t = torch.cat([mask_t, mask_t.flip(0)], dim=1)
        return mask_t.contiguous()

    def forward(self, x, seq_lens=None, state=None):
        """x: (B, T, input_size) -> (B, T, H * num_directions).

        Args:
            seq_lens: optional (B,) valid lengths (list, numpy or tensor).
            state: optional initial state(s), each (num_layers * D, B, H):
                ``(h0, c0)`` for the LSTM, ``h0`` for the GRU.

        Returns (output, final state(s)), stacked like torch's:
        (num_layers * D, B, H).
        """
        batch, t_len, _ = x.shape
        n_dir = self.num_directions
        hdim = self.hidden_size
        mask_t = None
        if seq_lens is not None:
            mask_t = self._mask(seq_lens, t_len, x.device)
        if state is not None and self.num_states == 1:
            state = (state,)
        in_dtype = x.dtype
        out_t = x.transpose(0, 1)                           # (T, B, F)
        finals = [[] for _ in range(self.num_states)]
        for layer in range(self.num_layers):
            w_ih, w_hh, bias = self._layer_weights(layer)
            w_hh = w_hh.float()
            x_dir = [out_t, out_t.flip(0)][:n_dir]
            x_pair = torch.stack(x_dir)                     # (D, T, B, F)
            operand = self.compute_dtype or torch.float32
            gates_x = project(x_pair.to(operand), w_ih.to(operand),
                              bias.float())
            if state is None:
                h0 = x.new_zeros((n_dir * batch, hdim), dtype=torch.float32)
                init = (h0,) + tuple(torch.zeros_like(h0) for _ in
                                     range(self.num_states - 1))
            else:
                sl = slice(layer * n_dir, (layer + 1) * n_dir)
                init = tuple(s[sl].reshape(n_dir * batch, hdim).to(
                    torch.float32).contiguous() for s in state)
            o_t, last = self._scan(gates_x, w_hh, mask_t, init)
            outs = [o_t[:, :batch]]
            if n_dir == 2:
                outs.append(o_t[:, batch:].flip(0))
            out_t = torch.cat(outs, dim=-1).to(in_dtype)
            for collected, s in zip(finals, last):
                collected.append(s.reshape(n_dir, batch, hdim))
            if self.dropout and self.training \
                    and layer < self.num_layers - 1:
                keep = 1.0 - self.dropout
                drop_mask = torch.empty_like(out_t).bernoulli_(
                    keep, generator=self.generator)
                out_t = out_t * drop_mask / keep
        finals = tuple(torch.cat(f) for f in finals)
        return (out_t.transpose(0, 1),
                finals[0] if self.num_states == 1 else finals)

    def extra_repr(self):
        return (f'{self.input_size}, {self.hidden_size}, '
                f'num_layers={self.num_layers}, '
                f'bidirectional={self.bidirectional}')


class LSTM(_RNNBase):
    """Multi-layer (bi)LSTM, batch-first; returns (output, (h, c))."""

    gates = 4
    num_states = 2

    def _scan(self, gates_x, w_hh, mask_t, init):
        o_t, h_t, c_t = lstm_cell_scan(gates_x, w_hh, mask_t, *init,
                                       compute_dtype=self.compute_dtype)
        return o_t, (h_t, c_t)


class GRU(_RNNBase):
    """Multi-layer (bi)GRU, batch-first; returns (output, h)."""

    gates = 3
    num_states = 1

    def _scan(self, gates_x, w_hh, mask_t, init):
        o_t, h_t = gru_cell_scan(gates_x, w_hh, mask_t, *init,
                                 compute_dtype=self.compute_dtype)
        return o_t, (h_t,)


class StatefulLSTM(torch.nn.Module):
    """An :class:`LSTM` that keeps its state across calls (streaming).

    Counterpart of ``padertorch_tpu/modules/recurrent.py`` ``StatefulLSTM``:
    each call continues from the final ``(h, c)`` of the call before
    (``states``; None starts from zeros), through ``LSTM(...,
    state=...)``, so one utterance fed chunk by chunk gives the outputs
    of one call over the whole of it.  The states are the layer stack's,
    (num_layers * D, B, H) each; ``del module.states`` starts a new
    stream.  As in the JAX package, ``batch_first=False`` is not taken.
    """

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, dropout=0.0, batch_first=True,
                 save_states=True, compute_dtype=None):
        super().__init__()
        if not batch_first:
            raise ValueError('batch_first=False is not supported')
        self.lstm = LSTM(input_size, hidden_size, num_layers=num_layers,
                         bidirectional=bidirectional, dropout=dropout,
                         compute_dtype=compute_dtype)
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        self.num_layers = num_layers
        self.batch_first = batch_first
        self.save_states = save_states
        self._states = None

    @property
    def states(self):
        return self._states

    @states.setter
    def states(self, states):
        self._states = states

    @states.deleter
    def states(self):
        self._states = None

    def forward(self, x):
        h, states = self.lstm(x, state=self._states)
        self._states = states if self.save_states else None
        return h


def set_rnn_backend(module, backend, remat=None, compute_dtype='keep'):
    """Set the time-loop backend, and optionally the compute dtype, of every
    RNN inside a module tree, as ``padertorch_tpu/modules/recurrent.py``
    ``set_rnn_backend`` does.

    >>> from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
    >>> dprnn = set_rnn_backend(
    ...     DPRNN(16, 8, window_length=10, hop_size=5, num_blocks=1,
    ...           inter_chunk_type='bgru', intra_chunk_type='bgru'),
    ...     'pallas', compute_dtype='bfloat16')
    >>> dprnn.dprnn_blocks[0].intra_chunk_rnn.rnn.compute_dtype
    torch.bfloat16

    Args:
        module: any module tree (model, separator, ...).
        backend: 'pallas', the cell-scan kernels (the plain versions on a
            CPU tensor), or 'scan', the JAX package's ``lax.scan`` loop,
            which the port has only as the plain versions: on a module
            with parameters on the card it raises.
        remat: the JAX package's per-layer rematerialization; the port
            has none, so on the card anything but None raises (on the CPU
            the result is the same either way).
        compute_dtype: 'keep' leaves each RNN's compute dtype; any other
            value (None, 'bfloat16') overrides it on every ``LSTM`` and
            ``GRU`` in the tree.

    Returns the module (changed in place) for chaining.  Raises
    AssertionError where the tree holds no RNN, as the JAX function does.
    """
    if backend not in ('scan', 'pallas'):
        raise ValueError(f"backend={backend!r}: 'scan' or 'pallas'")
    on_card = any(p.is_cuda for p in module.parameters())
    if on_card and (backend != 'pallas' or remat is not None):
        raise NotImplementedError(
            f'set_rnn_backend(backend={backend!r}, remat={remat!r}): on the '
            "card the recurrence runs in the kernels ('pallas') only, "
            'without rematerialization; the scan backend and remat are '
            "the JAX package's (padertorch_tpu/modules/recurrent.py)")
    rnns = [sub for sub in module.modules() if isinstance(sub, _RNNBase)]
    assert rnns, 'no RNN modules found in the tree'
    if compute_dtype != 'keep':
        for rnn in rnns:
            rnn.compute_dtype = product_dtype(compute_dtype)
    return module
