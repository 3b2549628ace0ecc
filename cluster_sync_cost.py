"""Measure, on the card, what it costs the CTAs of a thread-block cluster to
wait for one another: the primitives between two dependent products of
``csrc/wavenet_sample.cu`` on its cluster route.

    python3 cluster_sync_cost.py

Builds a small CUDA program (nvcc, into a temporary directory) and prints
the card's name and power limit, then the cycles per iteration, read with
``clock64`` by thread 0 of CTA 0 over 2000 iterations, of:

- ``__syncthreads`` alone;
- a cluster barrier (``cluster.sync()``: ``barrier.cluster.arrive.release``
  and ``wait.acquire``), for clusters of 1, 2, 4, 8 and 16 CTAs of 128,
  256 and 512 threads;
- the sampler's exchange: each CTA sends one 4-byte value to every CTA of
  the cluster with ``st.async``, counted on the receiver's ``mbarrier``,
  and waits until the values of all CTAs have arrived (two mbarriers in
  turn, a block barrier before the sends), for the same clusters.

A one-off probe, kept as the reproducible source of the cycle counts that
the design note of the sampler's cluster route cites; no main path runs
it.  Exits non-zero without a card or without nvcc.
"""
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCE = r'''
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
namespace cg = cooperative_groups;
__device__ long long g_cycles;

__device__ __forceinline__ uint32_t addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// MODE 0: __syncthreads; 1: cluster.sync(); 2: st.async + mbarrier
template <int MODE>
__global__ void bench(int iters) {
    __shared__ float vals[16];
    __shared__ __align__(8) uint64_t bars[2];
    cg::cluster_group cl = cg::this_cluster();
    const int n = cl.num_blocks(), me = cl.block_rank();
    if (threadIdx.x == 0) {
        for (int i = 0; i < 2; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(addr(&bars[i])));
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cl.sync();
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) {
        if (MODE == 0) {
            __syncthreads();
        } else if (MODE == 1) {
            cl.sync();
        } else {
            uint64_t* bar = &bars[i & 1];
            __syncthreads();
            if (threadIdx.x < n) {
                uint32_t dst, mb;
                asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                             : "=r"(dst) : "r"(addr(&vals[me])),
                               "r"((int)threadIdx.x));
                asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                             : "=r"(mb) : "r"(addr(bar)),
                               "r"((int)threadIdx.x));
                asm volatile(
                    "st.async.shared::cluster.mbarrier::complete_tx::bytes"
                    ".b32 [%0], %1, [%2];"
                    :: "r"(dst), "r"(i), "r"(mb) : "memory");
            }
            if (threadIdx.x == 0)
                asm volatile(
                    "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                    :: "r"(addr(bar)), "r"(4 * n) : "memory");
            uint32_t done = 0;
            while (!done)
                asm volatile(
                    "{ .reg .pred p; mbarrier.try_wait.parity.acquire"
                    ".cluster.shared::cta.b64 p, [%1], %2; "
                    "selp.u32 %0, 1, 0, p; }"
                    : "=r"(done) : "r"(addr(bar)), "r"((i >> 1) & 1)
                    : "memory");
        }
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0 && blockIdx.x == 0) g_cycles = (t1 - t0) / iters;
    cl.sync();
}

template <int MODE>
long long run(int n, int threads) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n);
    cfg.blockDim = dim3(threads);
    cudaLaunchAttribute a;
    a.id = cudaLaunchAttributeClusterDimension;
    a.val.clusterDim.x = n;
    a.val.clusterDim.y = 1;
    a.val.clusterDim.z = 1;
    cfg.attrs = &a;
    cfg.numAttrs = 1;
    cudaFuncSetAttribute(bench<MODE>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (cudaLaunchKernelEx(&cfg, bench<MODE>, 2000) != cudaSuccess ||
        cudaDeviceSynchronize() != cudaSuccess) {
        fprintf(stderr, "launch failed\n");
        exit(1);
    }
    long long cycles = 0;
    cudaMemcpyFromSymbol(&cycles, g_cycles, sizeof(cycles));
    return cycles;
}

int main() {
    printf("__syncthreads, 512 threads: %lld cycles\n", run<0>(1, 512));
    for (int threads : {128, 256, 512})
        for (int n : {1, 2, 4, 8, 16})
            printf("cluster of %2d CTAs of %3d threads: cluster.sync %lld "
                   "cycles, st.async + mbarrier exchange %lld cycles\n",
                   n, threads, run<1>(n, threads), run<2>(n, threads));
    return 0;
}
'''


def main():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    if smi.returncode != 0:
        sys.exit('cluster_sync_cost.py needs a card')
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / 'cost.cu', Path(tmp) / 'cost'
        src.write_text(SOURCE)
        subprocess.run(['/usr/local/cuda/bin/nvcc', '-gencode',
                        'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                        '-o', str(exe), str(src)], check=True)
        print(subprocess.run([str(exe)], check=True, capture_output=True,
                             text=True).stdout, end='')


if __name__ == '__main__':
    main()
