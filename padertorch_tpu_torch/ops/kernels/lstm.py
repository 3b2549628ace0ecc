"""LSTM cell recurrence over time, inference forward.

Counterpart of ``padertorch_tpu/ops/pallas/lstm.py`` ``lstm_cell_scan``
(its lean forward, ``_fwd_call(..., with_residuals=False)``).  On a CUDA
tensor :func:`lstm_cell_scan` launches the hand-written kernel of
``csrc/lstm_cell_scan.cu`` (one cooperative launch for all T steps and
both directions); on a CPU tensor it runs :func:`lstm_cell_scan_plain`,
a Python time loop of per-direction matmuls.
"""
import torch

from padertorch_tpu_torch.ops.kernels import _build

__all__ = ['lstm_cell_scan', 'lstm_cell_scan_plain']


def _norm_w(w_hh):
    """-> (w (D, H, 4H), D)."""
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


def _check(gates_x, w, n_dir, mask, h0, c0):
    if gates_x.dim() != 3 or gates_x.shape[0] < 1:
        raise ValueError(f'gates_x must be (T >= 1, rows, 4H), got '
                         f'{tuple(gates_x.shape)}')
    t_len, rows, g4 = gates_x.shape
    if g4 % 4 or rows % n_dir:
        raise ValueError(f'gates_x {tuple(gates_x.shape)} does not split '
                         f'into 4 gates and {n_dir} directions')
    hdim = g4 // 4
    expected = {'gates_x': (gates_x, (t_len, rows, g4)),
                'w_hh': (w, (n_dir, hdim, g4)), 'mask': (mask, (t_len, rows)),
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


def _launch(gates_x, w, n_dir, mask, h0, c0):
    t_len, rows, g4 = gates_x.shape
    hdim = g4 // 4
    out = torch.empty((t_len, rows, hdim), dtype=torch.float32,
                      device=gates_x.device)
    h_t = torch.empty_like(h0)
    c_t = torch.empty_like(c0)
    hbuf = torch.empty((2, rows, hdim), dtype=torch.float32,
                       device=gates_x.device)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(gates_x)
    err = lib.lstm_cell_scan_fwd(
        gates_x.data_ptr(), w.data_ptr(),
        None if mask is None else mask.data_ptr(),
        h0.data_ptr(), c0.data_ptr(), out.data_ptr(), h_t.data_ptr(),
        c_t.data_ptr(), hbuf.data_ptr(), t_len, n_dir, rows // n_dir,
        hdim, device, stream)
    _build.check(lib, err, 'lstm_cell_scan kernel')
    lstm_cell_scan.launches += 1
    return out, h_t, c_t


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
        CUDA tensors launch the kernel (or raise).
    """
    w, n_dir = _norm_w(w_hh)
    if gates_x.device.type == 'cpu':
        return lstm_cell_scan_plain(gates_x, w_hh, mask, h0, c0)
    if gates_x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {gates_x.device}')
    _check(gates_x, w, n_dir, mask, h0, c0)
    return _launch(gates_x, w, n_dir, mask, h0, c0)


lstm_cell_scan.launches = 0
