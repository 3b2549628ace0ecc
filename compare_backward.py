"""Time the port's two backward kernels in one checkout, and measure the
attention gradients' error at head size 128 over long sequences, on the
card.

Run it once per checkout, in one card call, to compare two versions on the
same card (unpack the other checkout with ``git archive`` into a directory
that git ignores); alternate them, as in parent, change, change, parent:

    python3 compare_backward.py <checkout> lstm
    python3 compare_backward.py <checkout> attention

``lstm``: ``lstm_cell_scan``'s backward kernel alone at the DPRNN-TasNet's
intra (T=100, 260 rows per direction, H=128) and inter (T=65, 400 rows,
chunk mask) shapes and at the uPIT layer's (T=500, 16 rows, H=600,
ragged): the median of 5 windows of 10 launches by CUDA events, the
largest difference from the plain backward, and the grid the kernel takes
(where the checkout reports it).  ``attention``: the gradients of
``flash_attention`` relative to autograd through the plain version (each
gradient's largest difference over its largest entry) at D = 128 and T =
2048 and 4096, and whether two backward runs give the same bits; then the
two backward kernels' time at (4, 8, 2048, 128) full and causal and at
(8, 12, 2048, 64) full.  float32 throughout.  Prints the card's name and
power limit first; exits non-zero without a card.
"""
import subprocess
import sys

import numpy as np
import torch


def median_ms(fn, iters=10, windows=5):
    """Median over ``windows`` of the mean ms of ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return float(np.median(out)), out


def lstm_backward(lk):
    rng = np.random.RandomState(0)
    for label, t_len, batch, hdim, kind in [
            ('DPRNN intra', 100, 260, 128, None),
            ('DPRNN inter', 65, 400, 128, 'chunks'),
            ('uPIT', 500, 16, 600, 'ragged')]:
        rows = 2 * batch
        mask = None
        if kind == 'chunks':
            lens = np.repeat([t_len, t_len - 11, t_len - 20, t_len - 30],
                             batch // 4)
        elif kind == 'ragged':
            lens = rng.randint(t_len // 2, t_len + 1, size=batch)
            lens[0] = t_len
        if kind:
            fwd = np.arange(t_len)[:, None] < lens[None, :]
            mask = torch.tensor(np.concatenate([fwd, fwd[::-1]], 1)
                                .astype('float32')).cuda()
        gx = torch.rand(t_len, rows, 4 * hdim, device='cuda') * 2 - 1
        w = (torch.rand(2, hdim, 4 * hdim, device='cuda') * 2 - 1) \
            / np.sqrt(hdim)
        h0 = torch.rand(rows, hdim, device='cuda') * 0.2 - 0.1
        _, c_seq, gates, _, _ = lk.lstm_cell_scan_train_plain(
            gx, w, mask, h0, h0.clone())
        cot = [torch.rand(t_len, rows, hdim, device='cuda') * 2 - 1,
               torch.rand(rows, hdim, device='cuda') * 2 - 1,
               torch.rand(rows, hdim, device='cuda') * 2 - 1]
        got = lk._launch_bwd(gates, c_seq, w, 2, mask, *cot)
        want = lk.lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ms, windows = median_ms(
            lambda: lk._launch_bwd(gates, c_seq, w, 2, mask, *cot))
        grid = (lk.bwd_grid(2, batch, hdim) if hasattr(lk, 'bwd_grid')
                else 'not reported')
        print(f'lstm backward {label}: {ms:.4f} ms (windows '
              f'{[round(x, 4) for x in windows]}), max |kernel - plain| '
              f'{err:.3e}, grid {grid}', flush=True)


def attention_backward(ak):
    for label, b, h, h_kv, t_len, d, masks in [
            ('(2, 8, 2048, 128) full', 2, 8, 8, 2048, 128, {}),
            ('(2, 8, 2048, 128) causal', 2, 8, 8, 2048, 128,
             {'causal': True}),
            ('(2, 8, 4096, 128) full', 2, 8, 8, 4096, 128, {}),
            ('(2, 8, 4096, 128) causal', 2, 8, 8, 4096, 128,
             {'causal': True}),
            ('gqa (1, 8 over 2, 4096, 128)', 1, 8, 2, 4096, 128, {}),
            ('(2, 8, 4096, 64) full', 2, 8, 8, 4096, 64, {})]:
        rng = np.random.RandomState(0)
        q, k, v, d_o = (
            torch.tensor(rng.randn(*shape), dtype=torch.float32,
                         device='cuda')
            for shape in ((b, h, t_len, d), (b, h_kv, t_len, d),
                          (b, h_kv, t_len, d), (b, h, t_len, d)))

        def grads(fn):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            return torch.autograd.grad(fn(*leaves, **masks), leaves, d_o)

        got, want = grads(ak.flash_attention), grads(ak.flash_attention_plain)
        rel = [float((x - y).abs().max() / y.abs().max())
               for x, y in zip(got, want)]
        same = all(torch.equal(x, y)
                   for x, y in zip(got, grads(ak.flash_attention)))
        del want
        torch.cuda.empty_cache()
        print(f'attention gradients {label}: dq, dk, dv relative '
              + ', '.join(f'{r:.3e}' for r in rel)
              + f'; two runs the same bits: {same}', flush=True)
    for label, b, h, t_len, d, causal in [
            ('(4, 8, 2048, 128) full', 4, 8, 2048, 128, False),
            ('(4, 8, 2048, 128) causal', 4, 8, 2048, 128, True),
            ('(8, 12, 2048, 64) full', 8, 12, 2048, 64, False)]:
        rng = np.random.RandomState(0)
        q, k, v, d_o = (torch.tensor(rng.randn(b, h, t_len, d),
                                     dtype=torch.float32, device='cuda')
                        for _ in range(4))
        scale = 1.0 / np.sqrt(d)
        out, lse = ak._launch_fwd(q, k, v, None, causal, None, None, scale,
                                  train=True)
        args = (q, k, v, None, d_o, lse, (d_o * out).sum(-1), causal, None,
                None, scale)
        ms, windows = median_ms(lambda: ak._launch_bwd(*args))
        print(f'attention backward kernels {label}: {ms:.4f} ms (windows '
              f'{[round(x, 4) for x in windows]})', flush=True)


def main():
    root, part = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        sys.exit('compare_backward.py needs a card')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip())
    sys.path.insert(0, root)
    from padertorch_tpu_torch.ops.kernels import _build
    from padertorch_tpu_torch.ops.kernels import attention as ak
    from padertorch_tpu_torch.ops.kernels import lstm as lk
    _build.load_library()
    print(f'checkout {root}, {part}', flush=True)
    {'lstm': lambda: lstm_backward(lk),
     'attention': lambda: attention_backward(ak)}[part]()


if __name__ == '__main__':
    main()
