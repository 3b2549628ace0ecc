"""Time one checkout's ``masked_istft`` kernel on the card, to compare two
versions in one card call.

Unpack the other checkout with ``git archive`` into a directory that git
ignores and alternate them, as in parent, change, change, parent:

    python3 compare_istft.py <checkout>

At the uPIT recipe's geometry (``STFT(512, 128)``, fading ``'full'``,
stacked frames of a spectrogram times 10 under K masks from numpy seed 0)
for (K, T) = (2, 127), the request, and (32, 500), and at ``STFT(400,
100)`` for (2, 127): the kernel's time by CUDA events over 20 eager calls
after a warm-up, and from a CUDA graph of 20 calls replayed (the device's
time without the host's), the plain version's eager time, and the largest
difference from plain.  float32.  Prints the card's name and power limit
first; exits non-zero without a card.
"""
import subprocess
import sys

import numpy as np
import torch


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=5, warmup=1) / iters


def main():
    root = sys.argv[1]
    if not torch.cuda.is_available():
        sys.exit('compare_istft.py needs a card')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip())
    sys.path.insert(0, root)
    from padertorch_tpu_torch.ops._stft import STFT
    from padertorch_tpu_torch.ops.kernels import _build
    from padertorch_tpu_torch.ops.kernels.masked_istft import (
        masked_istft, masked_istft_plain)
    _build.load_library()
    print(f'checkout {root}', flush=True)
    for size, shift, n_rows, frames in [(512, 128, 2, 127),
                                        (512, 128, 32, 500),
                                        (400, 100, 2, 127)]:
        stft = STFT(size, shift, fading='full',
                    complex_representation='stacked')
        rng = np.random.RandomState(0)
        spec = torch.from_numpy(rng.randn(frames, size // 2 + 1, 2).astype(
            'float32') * 10).cuda()
        mask = torch.from_numpy(rng.uniform(
            0, 1, (n_rows, frames, size // 2 + 1)).astype('float32')).cuda()

        def kernel():
            return masked_istft(spec, mask, stft=stft)

        err = float((kernel() - masked_istft_plain(
            spec, mask, stft=stft)).abs().max())
        print(f'masked_istft STFT({size}, {shift}) ({n_rows}, {frames}): '
              f'graph {graph_ms(kernel):.4f} ms, eager {cuda_ms(kernel):.4f}'
              f' ms, plain eager '
              f'{cuda_ms(lambda: masked_istft_plain(spec, mask, stft=stft)):.4f}'
              f' ms, max |kernel - plain| {err:.3e}', flush=True)


if __name__ == '__main__':
    main()
