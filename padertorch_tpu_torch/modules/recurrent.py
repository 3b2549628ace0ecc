"""Multi-layer (bidirectional) LSTM over the cell-scan kernel.

Counterpart of ``padertorch_tpu/modules/recurrent.py`` ``LSTM`` on its
time-major stack (``_forward_time_major``): one transpose at entry and one
at exit; per layer the input projection of both directions is one batched
matmul, and the recurrence of both directions is one call of
:func:`padertorch_tpu_torch.ops.kernels.lstm.lstm_cell_scan` (one kernel
launch on a CUDA tensor, the plain time loop on a CPU tensor).

Variable lengths use masks: the carry freezes beyond a sequence's length
(final states match packed-sequence semantics) and outputs are zero in the
padding.  The backward direction runs on the time-flipped sequence and
mask: the carry freezes through the leading padding, then the valid part
runs in reverse, and flipping the output back restores alignment.

Parameters carry ``torch.nn.LSTM``'s names and layouts
(``weight_ih_l{k}[_reverse]`` (4H, in), ``weight_hh_l{k}[_reverse]``
(4H, H), ``bias_ih_...`` and ``bias_hh_...``; gate order i, f, g, o), so
``padertorch_tpu.migrate.import_torch_state_dict`` maps them onto the JAX
model unchanged.  The kernel uses the sum of the two biases, and only
``bias_ih`` is trained: the JAX LSTM has one fused bias, and two trained
copies of it would each get its gradient, which doubles the bias's share
of the global gradient norm and its step.  ``bias_hh`` stays in the
module and in ``state_dict()`` with ``requires_grad=False``.

On CUDA tensors the recurrence trains through the kernels too: under grad
mode ``lstm_cell_scan`` is a ``torch.autograd.Function`` whose forward
and backward are kernels, and nothing here detaches.
"""
import math

import torch

from padertorch_tpu_torch.ops.kernels.lstm import lstm_cell_scan

__all__ = ['LSTM']


class LSTM(torch.nn.Module):
    """Multi-layer (bi)LSTM, batch-first; returns (output, (h, c))."""

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
        gates = 4 * hidden_size
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
        """U(-1/sqrt(H), 1/sqrt(H)) like torch.nn.LSTM and the JAX LSTM,
        whose one bias ``bias_ih`` stands for; the frozen ``bias_hh``
        starts at zero (a loaded ``torch.nn.LSTM`` state may hold any)."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for name, p in self.named_parameters():
            if name.startswith('bias_hh'):
                torch.nn.init.zeros_(p)
            else:
                torch.nn.init.uniform_(p, -bound, bound)

    def _layer_weights(self, layer):
        """(w_ih (D, 4H, in), w_hh (D, H, 4H), bias (D, 4H))."""
        ps = [{name: getattr(self, f'{name}_l{layer}{suffix}')
               for name in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}
              for suffix in self._suffixes()]
        w_ih = torch.stack([p['weight_ih'] for p in ps])
        w_hh = torch.stack([p['weight_hh'].t() for p in ps]).contiguous()
        bias = torch.stack([p['bias_ih'] + p['bias_hh'] for p in ps])
        return w_ih, w_hh, bias

    def forward(self, x, seq_lens=None, state=None):
        """x: (B, T, input_size) -> (B, T, H * num_directions).

        Args:
            seq_lens: optional (B,) valid lengths.
            state: optional (h0, c0), each (num_layers * D, B, H).

        Returns (output, (h_n, c_n)), the final states stacked like
        torch's: (num_layers * D, B, H).
        """
        batch, t_len, _ = x.shape
        n_dir = self.num_directions
        hdim = self.hidden_size
        mask_t = None
        if seq_lens is not None:
            lens = torch.as_tensor(seq_lens, device=x.device)
            mask = (torch.arange(t_len, device=x.device)[None, :]
                    < lens[:, None]).to(torch.float32)
            mask_t = mask.t()                               # (T, B)
            if n_dir == 2:
                mask_t = torch.cat([mask_t, mask_t.flip(0)], dim=1)
            mask_t = mask_t.contiguous()                    # (T, D*B)
        out_t = x.transpose(0, 1).to(torch.float32)         # (T, B, F)
        h_n, c_n = [], []
        for layer in range(self.num_layers):
            w_ih, w_hh, bias = self._layer_weights(layer)
            x_dir = [out_t, out_t.flip(0)][:n_dir]
            x_pair = torch.stack(x_dir)                     # (D, T, B, F)
            gates_x = torch.einsum('dtbf,dgf->tdbg', x_pair, w_ih)
            gates_x = (gates_x + bias[None, :, None, :]).reshape(
                t_len, n_dir * batch, 4 * hdim).contiguous()
            if state is None:
                h0 = x.new_zeros((n_dir * batch, hdim), dtype=torch.float32)
                c0 = torch.zeros_like(h0)
            else:
                sl = slice(layer * n_dir, (layer + 1) * n_dir)
                h0, c0 = (s[sl].reshape(n_dir * batch, hdim).to(
                    torch.float32).contiguous() for s in state)
            o_t, h_t, c_t = lstm_cell_scan(gates_x, w_hh, mask_t, h0, c0)
            outs = [o_t[:, :batch]]
            if n_dir == 2:
                outs.append(o_t[:, batch:].flip(0))
            out_t = torch.cat(outs, dim=-1)
            h_n.append(h_t.reshape(n_dir, batch, hdim))
            c_n.append(c_t.reshape(n_dir, batch, hdim))
            if self.dropout and self.training \
                    and layer < self.num_layers - 1:
                keep = 1.0 - self.dropout
                drop_mask = torch.empty_like(out_t).bernoulli_(
                    keep, generator=self.generator)
                out_t = out_t * drop_mask / keep
        return out_t.transpose(0, 1), (torch.cat(h_n), torch.cat(c_n))

    def extra_repr(self):
        return (f'{self.input_size}, {self.hidden_size}, '
                f'num_layers={self.num_layers}, '
                f'bidirectional={self.bidirectional}')
