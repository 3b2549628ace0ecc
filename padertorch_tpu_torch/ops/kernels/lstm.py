"""LSTM cell recurrence over time: inference forward, training forward
and backward.

Counterpart of ``padertorch_tpu/ops/pallas/lstm.py`` ``lstm_cell_scan``
with its custom VJP.  On a CUDA tensor :func:`lstm_cell_scan` launches
hand-written kernels, one cooperative launch each for all T steps and both
directions: without gradients the lean forward of
``csrc/lstm_cell_scan.cu``; when a gradient is asked for, through
:class:`LSTMCellScan`, the training forward of the same file (which also
stores the activated gates and c_{t-1}) and, in ``backward``, the adjoint
recurrence of ``csrc/lstm_cell_scan_bwd.cu``.  ``dW_hh`` is a matrix
product outside the kernels, as in the JAX package.

On a CPU tensor it runs :func:`lstm_cell_scan_plain`, a Python time loop
of per-direction matmuls that autograd differentiates.
:func:`lstm_cell_scan_train_plain` and :func:`lstm_cell_scan_bwd_plain`
repeat the two training kernels' arithmetic step by step; tests hold the
kernels against them.

The backward is exact for contiguous-valid masks (suffix padding, or
prefix padding as the flipped direction of a bidirectional layer has it),
which is what sequence lengths produce.
"""
import torch

from padertorch_tpu_torch.ops.kernels import _build

__all__ = ['lstm_cell_scan', 'lstm_cell_scan_plain', 'LSTMCellScan',
           'lstm_cell_scan_train_plain', 'lstm_cell_scan_bwd_plain',
           'recurrent_weight_grad', 'sum_outer', 'time_groups']


def _norm_w(w_hh):
    """-> (w (D, H, gates * H), D)."""
    if w_hh.dim() == 2:
        return w_hh[None], 1
    return w_hh, w_hh.shape[0]


def lstm_cell_scan_plain(gates_x, w_hh, mask, h0, c0):
    """Plain PyTorch version of :func:`lstm_cell_scan` (same contract)."""
    w, n_dir = _norm_w(w_hh)
    t_len, rows, g4 = gates_x.shape
    hdim = g4 // 4
    h, c = h0, c0
    outs = []
    for t in range(t_len):
        gh = torch.bmm(h.reshape(n_dir, rows // n_dir, hdim), w)
        gates = gates_x[t] + gh.reshape(rows, g4)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if mask is None:
            h_out = h_new
        else:
            m = mask[t][:, None]
            h_new = torch.where(m > 0, h_new, h)
            c_new = torch.where(m > 0, c_new, c)
            h_out = h_new * m
        outs.append(h_out)
        h, c = h_new, c_new
    return torch.stack(outs), h, c


def lstm_cell_scan_train_plain(gates_x, w_hh, mask, h0, c0):
    """Plain PyTorch version of the training forward kernel.

    Returns ``(out, c_seq, gates, h_T, c_T)``: beside the outputs of
    :func:`lstm_cell_scan_plain`, ``c_seq`` (T, rows, H) holds c_{t-1} of
    every step (on a masked step the frozen c) and ``gates`` (T, rows, 4H)
    the activated gates i, f, g, o as computed (also on a masked step).
    """
    w, n_dir = _norm_w(w_hh)
    t_len, rows, g4 = gates_x.shape
    hdim = g4 // 4
    h, c = h0, c0
    outs, c_seq, acts = [], [], []
    for t in range(t_len):
        gh = torch.bmm(h.reshape(n_dir, rows // n_dir, hdim), w)
        z_i, z_f, z_g, z_o = (gates_x[t] + gh.reshape(rows, g4)).chunk(4, -1)
        i, f, g, o = (torch.sigmoid(z_i), torch.sigmoid(z_f),
                      torch.tanh(z_g), torch.sigmoid(z_o))
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if mask is None:
            h_out = h_new
        else:
            m = mask[t][:, None]
            h_new = torch.where(m > 0, h_new, h)
            c_new = torch.where(m > 0, c_new, c)
            h_out = h_new * m
        acts.append(torch.cat([i, f, g, o], dim=-1))
        c_seq.append(c)
        outs.append(h_out)
        h, c = h_new, c_new
    return torch.stack(outs), torch.stack(c_seq), torch.stack(acts), h, c


def lstm_cell_scan_bwd_plain(gates, c_seq, w_hh, mask, d_out, dh_t, dc_t):
    """Plain PyTorch version of the backward kernel: the adjoint recurrence
    in reverse time from the stored residuals.

    Returns ``(dgates_x (T, rows, 4H), dh0, dc0)``.
    """
    w, n_dir = _norm_w(w_hh)
    t_len, rows, g4 = gates.shape
    hdim = g4 // 4
    w_t = w.transpose(1, 2)
    dh_carry, dc_carry = dh_t, dc_t
    dgx = [None] * t_len
    for t in reversed(range(t_len)):
        i, f, g, o = gates[t].chunk(4, dim=-1)
        c_prev = c_seq[t]
        tanh_c = torch.tanh(f * c_prev + i * g)
        dh = dh_carry + d_out[t]
        d_o = dh * tanh_c
        dc = dc_carry + dh * o * (1 - tanh_c * tanh_c)
        dz = torch.cat([dc * g * i * (1 - i), dc * c_prev * f * (1 - f),
                        dc * i * (1 - g * g), d_o * o * (1 - o)], dim=-1)
        if mask is not None:
            m = mask[t][:, None]
            dz = dz * m
        dh_prev = torch.bmm(dz.reshape(n_dir, rows // n_dir, g4),
                            w_t).reshape(rows, hdim)
        dc_prev = dc * f
        if mask is not None:
            dh_prev = torch.where(m > 0, dh_prev, dh_carry)
            dc_prev = torch.where(m > 0, dc_prev, dc_carry)
        dgx[t] = dz
        dh_carry, dc_carry = dh_prev, dc_prev
    return torch.stack(dgx), dh_carry, dc_carry


def time_groups(t_len, out_rows, out_cols, n_dir, device):
    """Into how many groups of steps to cut a weight-gradient product that
    reduces over (T, rows) into ``n_dir`` results of (out_rows, out_cols).

    With a small result and many rows (a dual-path RNN's chunk batches:
    26,000 rows into 128 x 384) one product has too few output tiles to
    occupy the card.  The groups become a batch axis and their partial
    results are summed, so that about one tile per multiprocessor is in
    flight.  The answer divides ``t_len`` and is 1 where the result is
    large enough by itself, and on the CPU."""
    if device.type != 'cuda':
        return 1
    tiles = n_dir * -(-out_rows // 128) * -(-out_cols // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, sms // tiles)
    return max(g for g in range(1, min(want, t_len) + 1) if t_len % g == 0)


def sum_outer(a, b, n_dir):
    """sum over t and rows of a_t^T b_t per direction: a (T, D*B, M),
    b (T, D*B, N) -> (D, M, N), in :func:`time_groups` groups of steps."""
    t_len, rows, m = a.shape
    n = b.shape[-1]
    batch = rows // n_dir
    groups = time_groups(t_len, m, n, n_dir, a.device)
    per = t_len // groups
    return torch.einsum(
        'sudbm,sudbn->sdmn', a.reshape(groups, per, n_dir, batch, m),
        b.reshape(groups, per, n_dir, batch, n)).sum(0)


def recurrent_weight_grad(dgx, out, h0, mask, n_dir):
    """``dW_hh`` (D, H, 4H) = sum_t h_{t-1}^T dz_t per direction.

    h_{t-1} is ``out`` shifted by one step.  ``out`` is zero in the padding,
    but a valid step whose predecessor is masked carries the frozen
    initial state; with contiguous-valid masks that is the segment start
    alone, whose dz joins step 0's in the ``h0`` term.
    """
    t_len = dgx.shape[0]
    dz0 = dgx[0]
    if mask is not None and t_len > 1:
        starts = mask[1:] * (1.0 - mask[:-1])
        dz0 = dz0 + torch.einsum('tb,tbg->bg', starts, dgx[1:])
    dw = sum_outer(h0[None], dz0[None], n_dir)
    if t_len > 1:
        dw = dw + sum_outer(out[:-1], dgx[1:], n_dir)
    return dw


def _check(gates_x, w, n_dir, mask, h0, c0=None, n_gates=4):
    """Raise for what the cell-scan kernels do not take (shapes, float32,
    one device, contiguity).  ``n_gates``: gate blocks per hidden unit
    (4 for the LSTM; the GRU wrapper passes 3 and no ``c0``)."""
    if gates_x.dim() != 3 or gates_x.shape[0] < 1:
        raise ValueError(f'gates_x must be (T >= 1, rows, {n_gates}H), got '
                         f'{tuple(gates_x.shape)}')
    t_len, rows, width = gates_x.shape
    if width % n_gates or rows % n_dir:
        raise ValueError(f'gates_x {tuple(gates_x.shape)} does not split '
                         f'into {n_gates} gates and {n_dir} directions')
    hdim = width // n_gates
    expected = {'gates_x': (gates_x, (t_len, rows, width)),
                'w_hh': (w, (n_dir, hdim, width)),
                'mask': (mask, (t_len, rows)),
                'h0': (h0, (rows, hdim)), 'c0': (c0, (rows, hdim))}
    for name, (tensor, shape) in expected.items():
        if tensor is None:
            continue
        if tuple(tensor.shape) != shape:
            raise ValueError(f'{name}: expected shape {shape}, got '
                             f'{tuple(tensor.shape)}')
        if tensor.dtype != torch.float32:
            raise TypeError(f'{name}: the kernel takes float32, got '
                            f'{tensor.dtype}')
        if tensor.device != gates_x.device:
            raise ValueError(f'{name} is on {tensor.device}, gates_x on '
                             f'{gates_x.device}')
        if not tensor.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _launch(gates_x, w, n_dir, mask, h0, c0, train=False):
    """Launch the forward kernel; with ``train`` the variant that also
    returns the residuals ``c_seq`` and ``gates``."""
    t_len, rows, g4 = gates_x.shape
    hdim = g4 // 4

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=gates_x.device)

    out, h_t, c_t = empty(t_len, rows, hdim), empty(rows, hdim), \
        empty(rows, hdim)
    hbuf = empty(2, rows, hdim)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(gates_x)
    inputs = (gates_x.data_ptr(), w.data_ptr(),
              None if mask is None else mask.data_ptr(),
              h0.data_ptr(), c0.data_ptr(), out.data_ptr())
    sizes = (t_len, n_dir, rows // n_dir, hdim, device, stream)
    if train:
        c_seq, gates = empty(t_len, rows, hdim), empty(t_len, rows, g4)
        err = lib.lstm_cell_scan_fwd_train(
            *inputs, c_seq.data_ptr(), gates.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr(), hbuf.data_ptr(), *sizes)
        _build.check(lib, err, 'lstm_cell_scan training forward kernel')
        lstm_cell_scan.launches['fwd_train'] += 1
        return out, c_seq, gates, h_t, c_t
    err = lib.lstm_cell_scan_fwd(
        *inputs, h_t.data_ptr(), c_t.data_ptr(), hbuf.data_ptr(), *sizes)
    _build.check(lib, err, 'lstm_cell_scan kernel')
    lstm_cell_scan.launches['fwd'] += 1
    return out, h_t, c_t


def _launch_bwd(gates, c_seq, w, n_dir, mask, d_out, dh_t, dc_t):
    t_len, rows, g4 = gates.shape
    dgx = torch.empty_like(gates)
    dh0 = torch.empty_like(dh_t)
    dc0 = torch.empty_like(dc_t)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(gates)
    err = lib.lstm_cell_scan_bwd(
        gates.data_ptr(), c_seq.data_ptr(), w.data_ptr(),
        None if mask is None else mask.data_ptr(), d_out.data_ptr(),
        dh_t.data_ptr(), dc_t.data_ptr(), dgx.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), t_len, n_dir, rows // n_dir, g4 // 4, device, stream)
    _build.check(lib, err, 'lstm_cell_scan backward kernel')
    lstm_cell_scan.launches['bwd'] += 1
    return dgx, dh0, dc0


class LSTMCellScan(torch.autograd.Function):
    """:func:`lstm_cell_scan` on CUDA tensors with a gradient: ``forward``
    is the training forward kernel, ``backward`` the backward kernel plus
    the ``dW_hh`` matrix product.  ``w`` is (D, H, 4H)."""

    @staticmethod
    def forward(ctx, gates_x, w, mask, h0, c0):
        n_dir = w.shape[0]
        out, c_seq, gates, h_t, c_t = _launch(
            gates_x, w, n_dir, mask, h0, c0, train=True)
        # gates_x itself is not needed again: `gates` has its shape
        ctx.save_for_backward(w, mask, h0, out, c_seq, gates)
        return out, h_t, c_t

    @staticmethod
    def backward(ctx, d_out, dh_t, dc_t):
        w, mask, h0, out, c_seq, gates = ctx.saved_tensors
        n_dir = w.shape[0]
        d_out, dh_t, dc_t = (
            torch.zeros_like(like) if grad is None else grad.contiguous()
            for grad, like in ((d_out, out), (dh_t, h0), (dc_t, h0)))
        dgx, dh0, dc0 = _launch_bwd(
            gates, c_seq, w, n_dir, mask, d_out, dh_t, dc_t)
        dw = recurrent_weight_grad(dgx, out, h0, mask, n_dir)
        return dgx, dw, None, dh0, dc0


def lstm_cell_scan(gates_x, w_hh, mask, h0, c0):
    """Run the LSTM cell recurrence over time.

    Args:
        gates_x: (T, rows, 4H) float32, the precomputed ``x @ W_ih + b``
            (gate order i, f, g, o).  For a direction-stacked call,
            rows = D * B and row block d belongs to direction d.
        w_hh: (H, 4H) recurrent weights, or (D, H, 4H) per direction
            (``h @ w_hh`` layout).
        mask: (T, rows) validity mask or None; where it is 0, h and c
            keep their values and the output is 0.
        h0, c0: (rows, H) initial state.

    Returns:
        (out (T, rows, H), h_T, c_T).  CPU tensors run the plain version;
        CUDA tensors launch the kernels (or raise): the lean forward, or,
        when grad mode is on and an input requires a gradient, the
        training forward, whose ``backward`` is a kernel too.
        ``lstm_cell_scan.launches`` counts the launches per kernel
        (``fwd``, ``fwd_train``, ``bwd``).
    """
    w, n_dir = _norm_w(w_hh)
    if gates_x.device.type == 'cpu':
        return lstm_cell_scan_plain(gates_x, w_hh, mask, h0, c0)
    if gates_x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {gates_x.device}')
    _check(gates_x, w, n_dir, mask, h0, c0)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (gates_x, w, h0, c0)):
        return LSTMCellScan.apply(gates_x, w, mask, h0, c0)
    return _launch(gates_x, w, n_dir, mask, h0, c0)


lstm_cell_scan.launches = {'fwd': 0, 'fwd_train': 0, 'bwd': 0}
