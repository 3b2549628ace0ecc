"""Time the port's two backward kernels in one checkout, and measure the
attention gradients' error at head size 128 over long sequences, on the
card.

Run it once per checkout, in one card call, to compare two versions on the
same card (unpack the other checkout with ``git archive`` into a directory
that git ignores); alternate them, as in parent, change, change, parent:

    python3 compare_backward.py <checkout> lstm
    python3 compare_backward.py <checkout> attention
    python3 compare_backward.py <checkout> attention-bits
    python3 compare_backward.py <checkout> attention-bf16
    python3 compare_backward.py <checkout> attention-bf16-fwd
    python3 compare_backward.py <checkout> lstm-bf16
    python3 compare_backward.py <checkout> lstm-bf16-fwd
    python3 compare_backward.py <checkout> gru-bf16
    python3 compare_backward.py <checkout> gru-bf16-fwd
    python3 compare_backward.py <checkout> bgru-step
    python3 compare_backward.py <checkout> wavenet-digests

``lstm``: ``lstm_cell_scan``'s backward kernel alone at the DPRNN-TasNet's
intra (T=100, 260 rows per direction, H=128) and inter (T=65, 400 rows,
chunk mask) shapes and at the uPIT layer's (T=500, 16 rows, H=600,
ragged): the median of 5 windows of 10 launches by CUDA events, the
largest difference from the plain backward, and the grid the kernel takes
(where the checkout reports it).  ``attention``: the gradients of
``flash_attention`` relative to autograd through the plain version (each
gradient's largest difference over its largest entry) at D = 128 and T =
2048 and 4096, and whether two backward runs give the same bits; then the
two backward kernels' time, and the forward kernel's, at (4, 8, 2048,
128) full and causal and at (8, 12, 2048, 64) full.  ``attention-bits``:
a digest (SHA-256) of the backward kernels' dq, dk, dv at the SepFormer's
two shapes, (8, 12, 2048, 64) full and causal, grouped-query heads and
D = 128 with key lengths, on inputs made from a seed and the plain
forward's output and log-sum-exp, and one of the forward kernel's output
and log-sum-exp on the same inputs, so that two checkouts whose kernels
should agree bit for bit print the same digests.  float32 throughout.
``attention-bf16``: the bf16 backward kernels (``delta`` included, as the
autograd Function runs them) at the SepFormer's two shapes, bench.py's
three and (8, 12, 2048, 64) full, and at (4, 8, 2048, 128) and (4, 8, 2048,
256) full where the checkout takes that head size, each beside SDPA's bf16
backward, with the device time of each kernel from the profiler.
``attention-bf16-fwd``: the bf16 forward kernel alone (no log-sum-exp
kept, as a served request runs it) at the SepFormer's two shapes,
bench.py's three, (8, 12, 2048, 64) full, grouped-query (4, 8 over 2,
1024, 64) causal and ragged, (4, 8, 1000, 32) causal and (4, 8, 2048, 128)
and (4, 8, 2048, 256) full: the median of 5 windows of 10 launches, a
digest of its output and log-sum-exp (the training forward), and SDPA's
bf16 forward where it takes the masks (none, or causal).
``lstm-bf16``: the bf16 backward kernel alone at ``chip_smoke.py`` phase
23's four shapes (the uPIT layer, the DPRNN's two, T=64 H=75 ragged) on
the residuals of the plain bf16 training forward: the median of 5 windows
of 10 launches, the largest difference from the plain bf16 backward, and
the grid (and route) the kernel takes.  ``lstm-bf16-fwd``: the two bf16
forward kernels alone (the lean one, as a served request runs it, and the
training one) at the same shapes: the median of 5 windows of 10 launches,
the largest difference from the plain bf16 forward, a digest of the
outputs, and the grid (and route) each takes; then the same at two wide
layers (``LSTM_BF16_FWD_WIDE``: 2 x 1100 at 2 and 16 rows a direction).
``gru-bf16``: the bf16 GRU backward alone at ``GRU_BF16_SHAPES`` (the
DPRNN's intra and inter chunk RNNs, the speaker classifier recipe's GRU at
H = 64 and its class defaults at H = 256) on the residuals of the plain
bf16 training forward, beside the float32 backward of the same checkout at
the same shape: the median of 5 windows of 10 launches and the mean of a
launch from replays of a CUDA graph of 20 (the eager calls at the
classifier's shape are as short as the host's work between them), the
host's µs a launch (100 calls in a row on the host clock: the wrapper's
work), the largest difference from the plain bf16 backward, a digest of
dgx, dgh and dh0, and the route (``gru.kernel_route`` where the checkout
has it).
``gru-bf16-fwd``: the same for the two bf16 forwards (the lean one, as a
served request runs it, and the training one) beside the float32 training
forward; then the lean one alone at T=503, 16 rows, one direction, H =
160 and 192 (``GRU_BF16_LEAN_SHAPES``: on the checkout's own route,
which was the resident one before the cluster route took these widths).
``bgru-step``: the tasnet recipe's ``dprnn`` with ``bgru``
chunk RNNs at full width under ``precision='bfloat16'`` after
``set_rnn_backend(..., compute_dtype='bfloat16')`` (``chip_smoke.py``
phase 29's bf16 run) at B=4 x 16000 from seed 0: the median host clock of
20 training steps, each ended by a synchronize, and from ``torch.profiler``
over 5 more the card's busy time a step and the device time a step of the
GRU kernels (the kernels whose name holds ``gru_``).  ``wavenet-digests``:
a digest of ``wavenet_sample``'s greedy indices and teacher-forced
indices and logits on fixed inputs at full width (16 layers, dilations
1 ... 128 twice, R=64, S=O=256, 200 steps) at 1, 8, 20, 40 and 132 rows
(clusters of 16, 8, 4 and 2 CTAs a row, and one block a row, on an
H100), so that two checkouts whose sampler should agree bit for bit
print the same digests.  Prints the card's
name and power limit first; exits non-zero without a card.
"""
import hashlib
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
        ms, windows = median_ms(lambda: ak._launch_fwd(
            q, k, v, None, causal, None, None, scale, train=False))
        print(f'attention forward kernel {label}: {ms:.4f} ms (windows '
              f'{[round(x, 4) for x in windows]})', flush=True)


def attention_backward_bits(ak):
    for label, b, h, h_kv, t_len, d, masks in [
            ('intra (264, 8, 100, 16)', 264, 8, 8, 100, 16, {}),
            ('inter (400, 8, 66, 16) ragged', 400, 8, 8, 66, 16,
             {'key_padding_lens': np.repeat([66, 55, 46, 36], 100)}),
            ('(8, 12, 2048, 64) full', 8, 12, 12, 2048, 64, {}),
            ('(8, 12, 2048, 64) causal', 8, 12, 12, 2048, 64,
             {'causal': True}),
            ('gqa (4, 8 over 2, 1024, 64)', 4, 8, 2, 1024, 64, {}),
            ('D=128 (2, 8 over 2, 130 x 77) ragged', 2, 8, 2, 130, 128,
             {'key_padding_lens': [77, 50]})]:
        rng = np.random.RandomState(0)
        q, k, v, d_o = (
            torch.tensor(rng.randn(*shape), dtype=torch.float32,
                         device='cuda')
            for shape in ((b, h, t_len, d), (b, h_kv, t_len, d),
                          (b, h_kv, t_len, d), (b, h, t_len, d)))
        with torch.no_grad():
            out, lse = ak.flash_attention_fwd_plain(q, k, v, **masks)
        lens = ak._lens_tensor(masks.get('key_padding_lens'), b, q.device)
        grads = ak._launch_bwd(q, k, v, lens, d_o, lse.contiguous(),
                               (d_o * out).sum(-1), masks.get('causal', False),
                               None, None, 1.0 / np.sqrt(d))
        print(f'attention backward bits {label}: {sha256(grads)}', flush=True)
        forward = ak._launch_fwd(q, k, v, lens, masks.get('causal', False),
                                 None, None, 1.0 / np.sqrt(d), train=True)
        print(f'attention forward bits {label}: {sha256(forward)}',
              flush=True)


BF16_SHAPES = [
    ('intra (264, 8, 100, 16)', 264, 8, 100, 16, {}),
    ('inter (400, 8, 66, 16) ragged', 400, 8, 66, 16,
     {'key_padding_lens': np.concatenate([np.repeat([66, 55, 46, 36], 100)[
         :-2], [1, 0]])}),
    ('(8, 12, 2048, 64) full', 8, 12, 2048, 64, {}),
    ('(8, 12, 4096, 64) causal', 8, 12, 4096, 64, {'causal': True}),
    ('(8, 12, 1024, 64) full', 8, 12, 1024, 64, {}),
    ('(8, 12, 4096, 64) window (255, 256)', 8, 12, 4096, 64,
     {'window': (255, 256)}),
    ('(4, 8, 2048, 128) full', 4, 8, 2048, 128, {}),
    ('(4, 8, 2048, 256) full', 4, 8, 2048, 256, {})]


def attention_backward_bf16(ak):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, b, h, t_len, d, masks in BF16_SHAPES:
        if d > ak.HEAD_SIZES[-1]:
            print(f'attention bf16 backward {label}: head size not taken',
                  flush=True)
            continue
        rng = np.random.RandomState(0)
        q, k, v, d_o = (torch.tensor(rng.randn(b, h, t_len, d),
                                     device='cuda').bfloat16()
                        for _ in range(4))
        lens = ak._lens_tensor(masks.get('key_padding_lens'), b, q.device)
        window = masks.get('window')
        config = (masks.get('causal', False),
                  *(window if window else (None, None)), 1.0 / np.sqrt(d))
        out, lse = ak._launch_fwd(q, k, v, lens, *config, train=True)

        def backward():
            delta = (d_o.float() * out.float()).sum(-1)
            return ak._launch_bwd(q, k, v, lens, d_o, lse, delta, *config)

        ms, windows = median_ms(backward)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                backward()
            torch.cuda.synchronize()
        kernels = {e.key.split('(')[0][-40:]: round(
            e.device_time_total / e.count / 1000, 4)
            for e in prof.key_averages() if e.device_time_total > 0}
        # SDPA's backward on the same shape (its masks: causal, or none)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = sdpa(*leaves, is_causal=masks.get('causal', False))
        lib_ms, _ = median_ms(lambda: torch.autograd.grad(
            ref, leaves, d_o, retain_graph=True))
        print(f'attention bf16 backward {label}: {ms:.4f} ms (windows '
              f'{[round(x, 4) for x in windows]}; device ms by kernel '
              f'{kernels}); scaled_dot_product_attention bf16 backward '
              f'{lib_ms:.4f} ms', flush=True)
        del leaves, ref
        torch.cuda.empty_cache()


BF16_FWD_SHAPES = [
    ('intra (264, 8, 100, 16)', 264, 8, 8, 100, 16, {}),
    ('inter (400, 8, 66, 16) ragged', 400, 8, 8, 66, 16,
     {'key_padding_lens': np.repeat([66, 55, 46, 36], 100)}),
    ('(8, 12, 2048, 64) full', 8, 12, 12, 2048, 64, {}),
    ('(8, 12, 4096, 64) causal', 8, 12, 12, 4096, 64, {'causal': True}),
    ('(8, 12, 1024, 64) full', 8, 12, 12, 1024, 64, {}),
    ('(8, 12, 4096, 64) window (255, 256)', 8, 12, 12, 4096, 64,
     {'window': (255, 256)}),
    ('gqa (4, 8 over 2, 1024, 64) causal, ragged', 4, 8, 2, 1024, 64,
     {'causal': True, 'key_padding_lens': [1024, 777, 300, 1]}),
    ('(4, 8, 1000, 32) causal', 4, 8, 8, 1000, 32, {'causal': True}),
    ('(4, 8, 2048, 128) full', 4, 8, 8, 2048, 128, {}),
    ('(4, 8, 2048, 256) full', 4, 8, 8, 2048, 256, {})]


def attention_forward_bf16(ak):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, b, h, h_kv, t_len, d, masks in BF16_FWD_SHAPES:
        if d > ak.HEAD_SIZES[-1]:
            print(f'attention bf16 forward {label}: head size not taken',
                  flush=True)
            continue
        rng = np.random.RandomState(0)
        q, k, v = (torch.tensor(rng.randn(*shape), device='cuda').bfloat16()
                   for shape in ((b, h, t_len, d), (b, h_kv, t_len, d),
                                 (b, h_kv, t_len, d)))
        lens = ak._lens_tensor(masks.get('key_padding_lens'), b, q.device)
        window = masks.get('window')
        config = (masks.get('causal', False),
                  *(window if window else (None, None)), 1.0 / np.sqrt(d))
        ms, windows = median_ms(lambda: ak._launch_fwd(q, k, v, lens, *config,
                                                       train=False))
        bits = sha256(ak._launch_fwd(q, k, v, lens, *config, train=True))
        shown = ''
        if set(masks) <= {'causal'} and h_kv == h:
            lib_ms, _ = median_ms(lambda: sdpa(
                q, k, v, is_causal=masks.get('causal', False)))
            shown = (f'; scaled_dot_product_attention bf16 {lib_ms:.4f} ms '
                     f'({ms / lib_ms:.2f} times)')
        print(f'attention bf16 forward {label}: {ms:.4f} ms (windows '
              f'{[round(x, 4) for x in windows]}){shown}; bits '
              f'{bits[:16]}', flush=True)
        torch.cuda.empty_cache()


def lstm_backward_bf16(lk):
    import chip_smoke
    for label, t_len, batch, hdim, kind, _ in chip_smoke.LSTM_BF16_SHAPES:
        args, cot = chip_smoke.recurrence_inputs(t_len, batch, hdim, kind,
                                                 gates=4)
        gx, w, mask, h0, c0 = args
        _, c_seq, gates, _, _ = lk.lstm_cell_scan_train_plain(
            gx.bfloat16(), w, mask, h0, c0, 'bfloat16')
        bwd_in = (gates, c_seq, w, mask, cot[0].bfloat16(), cot[1], cot[2])
        got = lk._launch_bwd(gates, c_seq, w, 2, mask, *bwd_in[4:])
        want = lk.lstm_cell_scan_bwd_plain(*bwd_in, 'bfloat16')
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        ms, windows = median_ms(
            lambda: lk._launch_bwd(gates, c_seq, w, 2, mask, *bwd_in[4:]))
        grid = lk.bwd_grid(2, batch, hdim, bf16=True)
        print(f'lstm bf16 backward {label}: {ms:.4f} ms (windows '
              f'{[round(x, 4) for x in windows]}), max |kernel - plain| '
              f'{err:.3e}, grid {grid}', flush=True)


# wide bf16 layers, T=50, ragged: (label, T, rows per direction, H, mask);
# at two rows a direction the staged search stages W_hh but the forwards'
# mma plan does not fit (66 slices of 16 units a direction fill the 132
# SMs of an H100), at 16 rows both stream
LSTM_BF16_FWD_WIDE = [('wide T=50 D*B=4 H=1100 ragged', 50, 2, 1100, 'ragged'),
                      ('wide T=50 D*B=32 H=1100 ragged', 50, 16, 1100,
                       'ragged')]


def lstm_forward_bf16(lk):
    import chip_smoke
    shapes = [shape[:5] for shape in chip_smoke.LSTM_BF16_SHAPES]
    for label, t_len, batch, hdim, kind in shapes + LSTM_BF16_FWD_WIDE:
        args, _ = chip_smoke.recurrence_inputs(t_len, batch, hdim, kind,
                                               gates=4)
        gx, w, mask, h0, c0 = args
        gx = gx.bfloat16()
        kernels = {
            'lean': lambda: lk.lstm_cell_scan(gx, w, mask, h0, c0,
                                              compute_dtype='bfloat16'),
            'training': lambda: lk._launch(gx, w, 2, mask, h0, c0,
                                           train=True)}
        plain = {'lean': lk.lstm_cell_scan_plain,
                 'training': lk.lstm_cell_scan_train_plain}
        for name, kernel in kernels.items():
            with torch.no_grad():
                got = kernel()
                want = plain[name](gx, w, mask, h0, c0, 'bfloat16')
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
                ms, windows = median_ms(kernel)
            grid = lk.device_grid('lstm_fwd', 2, batch, hdim, True,
                                  torch.cuda.current_device(),
                                  name == 'training')
            print(f'lstm bf16 {name} forward {label}: {ms:.4f} ms (windows '
                  f'{[round(x, 4) for x in windows]}), max |kernel - plain| '
                  f'{err:.3e}, digest {sha256(got)[:16]}, grid {grid}',
                  flush=True)
            del got, want
        torch.cuda.empty_cache()


# (label, T, rows per direction, H, mask, directions)
GRU_BF16_SHAPES = [
    ('intra T=100 D*B=520 H=128', 100, 260, 128, None, 2),
    ('inter T=65 D*B=800 H=128', 65, 400, 128, 'chunks', 2),
    ('classifier recipe T=66 D*B=8 H=64 one direction', 66, 8, 64, 'ragged',
     1),
    ('classifier defaults T=503 D*B=16 H=256 one direction', 503, 16, 256,
     'ragged', 1)]
# widths of the lean forward alone: the narrow end of its cluster route,
# where an older checkout's lean forward ran the resident route
GRU_BF16_LEAN_SHAPES = [
    ('T=503 D*B=16 H=160 one direction', 503, 16, 160, 'ragged', 1),
    ('T=503 D*B=16 H=192 one direction', 503, 16, 192, 'ragged', 1)]


def gru_bf16(gk, part):
    """``gru-bf16`` (``part`` 'bwd') or ``gru-bf16-fwd`` ('fwd')."""
    import chip_smoke
    device = torch.cuda.current_device()
    limits = gk.device_limits(device)
    for label, t_len, batch, hdim, kind, n_dir in GRU_BF16_SHAPES:
        args, cot = chip_smoke.recurrence_inputs(t_len, batch, hdim, kind,
                                                 gates=3, directions=n_dir)
        gx, w, mask, h0 = args
        gx16 = gx.bfloat16()
        train16 = gk.gru_cell_scan_train_plain(gx16, w, mask, h0, 'bfloat16')
        f32_train = gk._launch(gx, w, n_dir, mask, h0, train=True)
        bwd_in = (*train16[1:4], w, mask, cot[0].bfloat16(), cot[1])
        if part == 'fwd':
            kernels = {
                'lean': lambda: gk.gru_cell_scan(gx16, w, mask, h0,
                                                 compute_dtype='bfloat16'),
                'training': lambda: gk._launch(gx16, w, n_dir, mask, h0,
                                               train=True)}
            plain = {'lean': gk.gru_cell_scan_plain(gx16, w, mask, h0,
                                                    'bfloat16'),
                     'training': train16}
            f32 = ('the float32 training forward',
                   lambda: gk._launch(gx, w, n_dir, mask, h0, train=True))
        else:
            kernels = {'backward': lambda: gk._launch_bwd(
                *bwd_in[:3], w, n_dir, mask, *bwd_in[5:])}
            plain = {'backward': gk.gru_cell_scan_bwd_plain(*bwd_in,
                                                            'bfloat16')}
            f32 = ('the float32 backward', lambda: gk._launch_bwd(
                *f32_train[1:4], w, n_dir, mask, *cot))
        for name, kernel in kernels.items():
            with torch.no_grad():
                got = kernel()
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, plain[name]))
                ms, windows = median_ms(kernel)
            route = 'resident or cooperative'
            if hasattr(gk, 'kernel_route'):
                kind_of = {'lean': 'fwd', 'training': 'fwd_train',
                           'backward': 'bwd'}[name]
                route = gk.kernel_route(kind_of, n_dir, batch, hdim, True,
                                        *limits) or 'cooperative'
            print(f'gru bf16 {name} {label}: {ms:.4f} ms (windows '
                  f'{[round(x, 4) for x in windows]}), from graph replays '
                  f'{graph_ms(kernel)}, host {host_us(kernel):.1f} us a '
                  f'launch, route {route}, max |kernel - plain| {err:.3e}, '
                  f'digest {sha256(got)[:16]}', flush=True)
            del got
        f32_ms, _ = median_ms(f32[1])
        print(f'gru {f32[0]} {label}: {f32_ms:.4f} ms, from graph replays '
              f'{graph_ms(f32[1])}', flush=True)
        torch.cuda.empty_cache()
    if part != 'fwd':
        return
    for label, t_len, batch, hdim, kind, n_dir in GRU_BF16_LEAN_SHAPES:
        args, _ = chip_smoke.recurrence_inputs(t_len, batch, hdim, kind,
                                               gates=3, directions=n_dir)
        gx, w, mask, h0 = args
        gx16 = gx.bfloat16()
        plain = gk.gru_cell_scan_plain(gx16, w, mask, h0, 'bfloat16')
        route = gk.kernel_route('fwd', n_dir, batch, hdim, True,
                                *limits) or 'cooperative'

        def kernel():
            return gk.gru_cell_scan(gx16, w, mask, h0,
                                    compute_dtype='bfloat16')

        with torch.no_grad():
            got = kernel()
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, plain))
            ms, windows = median_ms(kernel)
        print(f'gru bf16 lean {label}: {ms:.4f} ms (windows '
              f'{[round(x, 4) for x in windows]}), route {route}, max '
              f'|kernel - plain| {err:.3e}, digest {sha256(got)[:16]}',
              flush=True)
        torch.cuda.empty_cache()


def wavenet_digests(wk):
    """``wavenet-digests``: ``wavenet_sample``'s digests by rows."""
    n_layers, r, s, o, steps = 16, 64, 256, 256, 200
    dilations = [2 ** (i % 8) for i in range(n_layers)]
    rng = np.random.RandomState(7)

    def u(*shape):
        bound = np.sqrt(3.0 / shape[-2]) if len(shape) > 1 else 0.1
        return torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype('float32')).cuda()

    w = {'w_prev': u(n_layers, r, 2 * r), 'w_curr': u(n_layers, r, 2 * r),
         'b_dil': u(n_layers, 2 * r), 'w_res': u(n_layers - 1, r, r),
         'b_res': u(n_layers - 1, r), 'w_skip': u(n_layers, r, s),
         'b_skip': u(n_layers, s), 'w_out': u(s, o), 'w_end': u(o, o),
         'embed': torch.from_numpy(rng.randn(256, r).astype(
             'float32')).cuda()}
    for rows in (1, 8, 20, 40, 132):
        cond = torch.from_numpy(rng.randn(
            steps, rows, n_layers, 2 * r).astype('float32')).cuda()
        forced = torch.from_numpy(rng.randint(0, o, (steps, rows)).astype(
            'int32')).cuda()
        with torch.no_grad():
            greedy = wk.wavenet_sample(cond, w, dilations)
            idx, logits = wk.wavenet_sample(
                cond, w, dilations, forced_input=forced, return_logits=True)
        print(f'wavenet_sample {rows} rows: digest '
              f'{sha256((greedy, idx, logits))[:16]}', flush=True)


def host_us(fn, calls=100):
    """The host's µs a call of ``fn`` (the wrapper's own work up to the
    launch, outputs allocated): ``calls`` calls in a row on the host clock,
    with no wait for the card between them (the launch queue takes them
    all)."""
    import time
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        took = time.perf_counter() - start
        torch.cuda.synchronize()
    return took / calls * 1e6


def graph_ms(fn):
    """The ms of one call of ``fn`` from replays of a CUDA graph of 20
    (``chip_smoke.graph_ms``: no host work between the launches), as text,
    or why none was captured."""
    import chip_smoke
    try:
        return f'{chip_smoke.graph_ms(fn, iters=20):.4f} ms'
    except RuntimeError as err:
        return f'not captured ({str(err).splitlines()[0]})'
    finally:
        torch.cuda.empty_cache()


def bgru_step():
    import tempfile
    import time
    from pathlib import Path

    import chip_smoke
    from padertorch_tpu_torch.contrib.examples.source_separation.tasnet \
        import train as tas_train
    from padertorch_tpu_torch.modules.recurrent import set_rnn_backend
    from padertorch_tpu_torch.train.trainer import Trainer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(0)
        trainer = Trainer.from_config(tas_train.get_trainer_config(
            Path(tmp) / 'bgru', variant='dprnn',
            updates=chip_smoke.tasnet_updates(
                'bgru', {'precision': 'bfloat16'}))).to('cuda')
        set_rnn_backend(trainer.model, 'pallas', compute_dtype='bfloat16')
        example = trainer.model.example_to_device(
            chip_smoke.tasnet_batch(4, 16000, seed=1), 'cuda')

        def step():
            loss = trainer.train_step(trainer.model, example)[0]
            loss.backward()
            trainer.optimizer.step()
            trainer.optimizer.zero_grad()

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        host = []
        for _ in range(20):
            start = time.perf_counter()
            step()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - start) * 1e3)
        steps = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3 / steps
        gru = sum(e.self_device_time_total for e in events
                  if 'gru_' in e.key) / 1e3 / steps
        print(f'bgru DPRNN step, bf16 GRUs under the policy, B=4 x 16000: '
              f'host clock {np.median(host):.3f} ms (steps '
              f'{[round(x, 3) for x in host]}); busy {busy:.3f} ms a step, '
              f'the GRU kernels {gru:.3f} ms of it', flush=True)


def sha256(tensors):
    """Digest of the tensors' bytes (bf16 as its 16-bit patterns)."""
    digest = hashlib.sha256()
    for x in tensors:
        digest.update(x.detach().cpu().contiguous().view(torch.uint8)
                      .numpy().tobytes())
    return digest.hexdigest()


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
    from padertorch_tpu_torch.ops.kernels import gru as gk
    from padertorch_tpu_torch.ops.kernels import lstm as lk
    from padertorch_tpu_torch.ops.kernels import wavenet as wk
    _build.load_library()
    print(f'checkout {root}, {part}', flush=True)
    {'lstm': lambda: lstm_backward(lk),
     'attention': lambda: attention_backward(ak),
     'attention-bits': lambda: attention_backward_bits(ak),
     'attention-bf16': lambda: attention_backward_bf16(ak),
     'attention-bf16-fwd': lambda: attention_forward_bf16(ak),
     'lstm-bf16': lambda: lstm_backward_bf16(lk),
     'lstm-bf16-fwd': lambda: lstm_forward_bf16(lk),
     'gru-bf16': lambda: gru_bf16(gk, 'bwd'),
     'gru-bf16-fwd': lambda: gru_bf16(gk, 'fwd'),
     'bgru-step': bgru_step,
     'wavenet-digests': lambda: wavenet_digests(wk)}[part]()


if __name__ == '__main__':
    main()
