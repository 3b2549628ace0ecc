// Device and host helpers shared by the LSTM and GRU cell-scan kernels.
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

// How a cell-scan grid (the GRU kernels, the LSTM forward) divides a
// layer: a block owns one direction, a slice of U hidden units (n_ub
// slices) and a range of RB rows of its direction (n_rb ranges), of which
// it stages RS at once; KS K slices.
struct ScanGrid {
    int U, n_ub, n_rb, RB, RS, KS, blocks, threads;
    size_t smem;
};

// For unit slices of U: split the Bd rows of a direction into ranges until
// the grid has about one block per SM (never more blocks than SMs from the
// split alone).  RS, KS, threads and smem are left to the caller.
inline ScanGrid split_rows(int U, int D, int Bd, int H, int n_sm) {
    ScanGrid g = {};
    g.U = U;
    g.n_ub = (H + U - 1) / U;
    int n_rb = n_sm / (D * g.n_ub);
    n_rb = n_rb < 1 ? 1 : n_rb;
    n_rb = n_rb > Bd ? Bd : n_rb;
    g.RB = (Bd + n_rb - 1) / n_rb;
    g.n_rb = (Bd + g.RB - 1) / g.RB;
    g.blocks = D * g.n_ub * g.n_rb;
    return g;
}

// Pick the grid of a cell-scan kernel whose product sums over K terms.
// Unit slices U are tried widest first (every block of a row range stages
// the same rows, so wide slices stage less); for each, the rows are split
// (split_rows), and the rows staged at once (RS) are as many as the
// threads of a block and shared memory beside the weights allow, evened
// out over the chunks.  `smem_bytes(U, RB, RS, KS)` is the kernel's need.
// The first U whose grid is co-resident and fills at least half the SMs is
// taken, else the co-resident one with the most blocks.  `best->blocks`
// stays 0 when none is co-resident.  Leaves the kernel's dynamic shared
// memory limit set for `best`.
template <class Smem>
cudaError_t pick_scan_grid(const void* kernel, int D, int Bd, int H, int K,
                           int n_sm, int max_smem, Smem smem_bytes,
                           ScanGrid* best) {
    *best = ScanGrid{};
    const int units[] = {32, 16, 8, 4};
    for (int cand : units) {
        if (cand > 4 && cand >= 2 * H) continue;
        ScanGrid c = split_rows(cand, D, Bd, H, n_sm);
        c.RS = c.RB < 1024 / cand ? c.RB : 1024 / cand;
        while (c.RS > 0 &&
               smem_bytes(cand, c.RB, c.RS, 8) > (size_t)max_smem) {
            --c.RS;
        }
        if (c.RS == 0) continue;
        const int chunks = (c.RB + c.RS - 1) / c.RS;
        c.RS = (c.RB + chunks - 1) / chunks;
        c.KS = k_slices(c.RS * cand, K);
        c.smem = smem_bytes(cand, c.RB, c.RS, c.KS);
        c.threads = (c.KS * c.RS * cand + 31) / 32 * 32;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
        if (err != cudaSuccess) return err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, c.threads, c.smem);
        if (err != cudaSuccess) return err;
        if (per_sm == 0 || c.blocks > per_sm * n_sm) continue;
        if (c.blocks > best->blocks) *best = c;
        if (2 * c.blocks >= n_sm) break;
    }
    if (best->blocks == 0) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)best->smem);
}
