// Device helpers shared by the LSTM forward and backward kernels.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ float sigmoidf_(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// 16-byte asynchronous copy into shared memory that bypasses L1 (the
// source was written by other blocks of the same launch; L1 is not
// coherent across SMs).
__device__ __forceinline__ void cp_async16_cg(void* smem, const void* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K slices per (row, unit) pair: as many as 1024 threads allow, at most 8
inline int k_slices(int P, int K) {
    int ks = 1024 / P;
    ks = ks > 8 ? 8 : ks;
    ks = ks > K ? K : ks;
    return ks < 1 ? 1 : ks;
}
