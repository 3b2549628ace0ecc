"""Where the time of ``serve.export_generate``'s trace goes.

Traces the unrolled greedy loop of a bf16 int8 ``TransformerDecoder`` at
bench.py's widths (d_model 1024, 16 heads, vocabulary 1024, 128 frames of
memory) with a symbolic batch, once on the card and once on the CPU of the
same host (the CPU trace with ``QuantizedLinear(use_kernel=True)``, so
both record the ``ptt::int8_matmul`` operator), under cProfile.  Prints,
for each, the seconds, the graph's nodes and the number of
``torch.export.export`` calls (more than one: ``serve._trace`` narrowed a
symbolic axis and traced again); writes both profiles to
``chiprun_out/export_profile.txt``.

    python export_profile.py [layers] [steps]      # default 2 4
"""
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

import torch

from padertorch_tpu_torch import serve
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    TransformerDecoder, autoregressive_generate)
from padertorch_tpu_torch.quantize import QuantizedLinear, quantize_module


def decoder(layers, device, use_kernel):
    torch.manual_seed(0)
    dec = TransformerDecoder(d_model=1024, num_layers=layers,
                             num_heads=16).eval().to(torch.bfloat16)
    quantize_module(dec)
    head = QuantizedLinear.from_linear(
        torch.nn.Linear(1024, 1024).to(torch.bfloat16))
    for m in (*dec.modules(), head):
        if isinstance(m, QuantizedLinear):
            m.use_kernel = use_kernel
    emb = torch.randn(1024, 1024).to(torch.bfloat16)
    return dec.to(device), head.to(device), emb.to(device)


def main(layers=2, steps=4):
    calls = []
    export = torch.export.export

    def counted(*args, **kwargs):
        calls.append(1)
        return export(*args, **kwargs)

    torch.export.export = counted
    out = Path('chiprun_out')
    out.mkdir(exist_ok=True)
    report = []
    for device, use_kernel in (('cuda', None), ('cpu', True)):
        dec, head, emb = decoder(layers, device, use_kernel)
        memory = torch.randn(2, 128, 1024).to(torch.bfloat16).to(device)

        def loop(m):
            return autoregressive_generate.__wrapped__(
                dec, m, embed=lambda t: emb[t], logits_head=head, bos_id=0,
                max_len=steps)

        calls.clear()
        profile = cProfile.Profile()
        start = time.perf_counter()
        profile.enable()
        program = serve._trace(serve._Call(loop), memory,
                               ({0: torch.export.Dim('b')},))
        profile.disable()
        seconds = time.perf_counter() - start
        nodes = len(program.graph.nodes)
        line = (f'{device}: {layers} layers x {steps} steps traced in '
                f'{seconds:.2f} s (under cProfile), {nodes} nodes, '
                f'{seconds / nodes * 1e3:.2f} ms a node, {len(calls)} '
                f'torch.export.export call(s)')
        print(line, flush=True)
        text = io.StringIO()
        stats = pstats.Stats(profile, stream=text)
        stats.sort_stats('tottime').print_stats(30)
        stats.sort_stats('cumulative').print_stats(50)
        report += [line, text.getvalue()]
    (out / 'export_profile.txt').write_text('\n'.join(report))


if __name__ == '__main__':
    main(*map(int, sys.argv[1:3]))
