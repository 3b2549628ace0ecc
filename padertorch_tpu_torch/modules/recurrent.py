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
"""
import math

import numpy as np
import torch

from padertorch_tpu_torch.ops.kernels.gru import gru_cell_scan
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, time_groups)

__all__ = ['LSTM', 'GRU']


class _RNNBase(torch.nn.Module):
    """What ``LSTM`` and ``GRU`` share: parameters, the layer loop, masks,
    directions, dropout.  A subclass sets ``gates`` (gate blocks per unit)
    and ``num_states`` and implements ``_scan``."""

    gates = None
    num_states = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, dropout=0.0):
        """``dropout`` acts between layers in training mode; set
        ``self.generator`` to a ``torch.Generator`` to draw its masks from
        that instead of the global generator."""
        super().__init__()
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
        out_t = x.transpose(0, 1).to(torch.float32)         # (T, B, F)
        finals = [[] for _ in range(self.num_states)]
        for layer in range(self.num_layers):
            w_ih, w_hh, bias = self._layer_weights(layer)
            x_dir = [out_t, out_t.flip(0)][:n_dir]
            x_pair = torch.stack(x_dir)                     # (D, T, B, F)
            # the steps in groups s of u, and one (expanded) copy of the
            # weights per group: the same product forward, and in backward
            # the weight gradient becomes a batch of partial sums (see
            # time_groups) that the expand's adjoint adds up
            groups = time_groups(t_len, *w_ih.shape[1:], n_dir, x.device) \
                if w_ih.requires_grad and torch.is_grad_enabled() else 1
            gates_x = torch.einsum(
                'dsubf,sdgf->sudbg',
                x_pair.reshape(n_dir, groups, t_len // groups, batch, -1),
                w_ih.expand(groups, *w_ih.shape))
            gates_x = (gates_x.reshape(t_len, n_dir, batch, -1)
                       + bias[None, :, None, :]).reshape(
                t_len, n_dir * batch, self.gates * hdim).contiguous()
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
            out_t = torch.cat(outs, dim=-1)
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
        o_t, h_t, c_t = lstm_cell_scan(gates_x, w_hh, mask_t, *init)
        return o_t, (h_t, c_t)


class GRU(_RNNBase):
    """Multi-layer (bi)GRU, batch-first; returns (output, h)."""

    gates = 3
    num_states = 1

    def _scan(self, gates_x, w_hh, mask_t, init):
        o_t, h_t = gru_cell_scan(gates_x, w_hh, mask_t, *init)
        return o_t, (h_t,)
