// Device and host helpers shared by the LSTM and GRU cell-scan kernels.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

// clock64 probes of a step's parts (cell, grid sync, exchange, product) in
// thread 0 of block 0, built only with -DLSTM_PROBE (the script
// lstm_bwd_probe.py): cycles summed over the steps of a launch into the
// array that the source names PROBE_CYCLES.  The clock is read again after
// the sum is stored, so that the next part does not count the probe's own
// load of it.
#ifdef LSTM_PROBE
#define PROBE_INIT() long long probe_t = clock64()
#define PROBE(part)                                                   \
    do {                                                              \
        if (blockIdx.x == 0 && threadIdx.x == 0) {                    \
            const long long probe_now = clock64();                    \
            PROBE_CYCLES[part] += probe_now - probe_t;                \
            asm volatile("mov.u64 %0, %%clock64;"                     \
                         : "=l"(probe_t) :: "memory");                \
        }                                                             \
    } while (0)

// Read a source's probe cycles into out[0..3] and zero them.
template <class Cycles>
int probe_take(const Cycles& cycles, long long* out) {
    cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) return err;
    err = cudaMemcpyFromSymbol(out, cycles, sizeof(cycles));
    if (err != cudaSuccess) return err;
    const long long zeros[4] = {0, 0, 0, 0};
    return cudaMemcpyToSymbol(cycles, zeros, sizeof(zeros));
}
#else
#define PROBE_INIT() \
    do {             \
    } while (0)
#define PROBE(part) \
    do {            \
    } while (0)
#endif
enum { PROBE_CELL, PROBE_SYNC, PROBE_EXCHANGE, PROBE_PRODUCT };

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

// The element types of a cell-scan kernel's variant: its streams (gate
// inputs, outputs, residuals, gate adjoints) in device memory, and four
// neighbouring weights (or gate adjoints) as one shared-memory slot.  The
// float32 variant keeps float32 everywhere.  The bf16 variant keeps the
// streams and the staged weights in bf16, widens each value as it is read
// and rounds each product operand to bf16 (round to nearest even, as
// astype does); the products of bf16 values are exact in float32, so the
// float32 FMAs compute what a bf16 tensor-core product with float32
// accumulation computes.  Carries and states stay float32.
template <bool BF16> struct ScanTypes;

template <> struct ScanTypes<false> {
    using S = float;
    using W4 = float4;
    static __device__ __forceinline__ float ld(const float* p) { return *p; }
    static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
    static __device__ __forceinline__ void stcg(float* p, float v) {
        __stcg(p, v);
    }
    static __device__ __forceinline__ float4 unpack(const float4& v) {
        return v;
    }
    static __device__ __forceinline__ void set(float4* slot, int g,
                                               float v) {
        reinterpret_cast<float*>(slot)[g] = v;
    }
    static __device__ __forceinline__ float operand(float v) { return v; }
};

template <> struct ScanTypes<true> {
    using S = __nv_bfloat16;
    using W4 = uint2;  // four bf16
    static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
        return __bfloat162float(*p);
    }
    static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
        *p = __float2bfloat16_rn(v);
    }
    static __device__ __forceinline__ void stcg(__nv_bfloat16* p, float v) {
        __stcg(p, __float2bfloat16_rn(v));
    }
    static __device__ __forceinline__ float4 unpack(const uint2& v) {
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v.y));
        return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    static __device__ __forceinline__ void set(uint2* slot, int g, float v) {
        reinterpret_cast<__nv_bfloat16*>(slot)[g] = __float2bfloat16_rn(v);
    }
    static __device__ __forceinline__ float operand(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
};

// K slices per (row, unit) pair: as many as `threads` allow, at most 8
inline int k_slices(int P, int K, int threads = 1024) {
    int ks = threads / P;
    ks = ks > 8 ? 8 : ks;
    ks = ks > K ? K : ks;
    return ks < 1 ? 1 : ks;
}

// How a cell-scan grid (the GRU and LSTM kernels) divides a
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
// threads of a block (at most `max_threads`) and shared memory beside the
// weights allow, evened out over the chunks.  `smem_bytes(U, RB, RS, KS)`
// is the kernel's need.
// The first U whose grid is co-resident and fills at least half the SMs is
// taken, else the co-resident one with the most blocks.  `best->blocks`
// stays 0 when none is co-resident.  Leaves the kernel's dynamic shared
// memory limit set for `best`.
template <class Smem>
cudaError_t pick_scan_grid(const void* kernel, int D, int Bd, int H, int K,
                           int n_sm, int max_smem, Smem smem_bytes,
                           ScanGrid* best, int max_threads = 1024) {
    *best = ScanGrid{};
    const int units[] = {32, 16, 8, 4};
    for (int cand : units) {
        if (cand > 4 && cand >= 2 * H) continue;
        ScanGrid c = split_rows(cand, D, Bd, H, n_sm);
        c.RS = c.RB < max_threads / cand ? c.RB : max_threads / cand;
        while (c.RS > 0 &&
               smem_bytes(cand, c.RB, c.RS, 8) > (size_t)max_smem) {
            --c.RS;
        }
        if (c.RS == 0) continue;
        const int chunks = (c.RB + c.RS - 1) / c.RS;
        c.RS = (c.RB + chunks - 1) / chunks;
        c.KS = k_slices(c.RS * cand, K, max_threads);
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

namespace {

// The streamed route's weights: W_hh[d] (H, NG * H) as the slots a block
// stages (ScanTypes<BF16>::W4, four float32 or bf16 values, each rounded
// as the staging rounds it), packed once a launch in device memory so
// that a step reads one slot with one load and, in bf16, half the bytes.
// Either way a warp's units read neighbouring slots, as they read the
// staged ones.  Forward (`fwd`): slot (d, k, j) holds the NG gates'
// weights of unit j at row k (zeros past NG), D * H * H slots.  Backward:
// slot (d, c, j) holds columns 4c ... 4c + 3 of row j (zeros past
// NG * H), D * G4 * H slots, G4 = ceil(NG * H / 4).
template <bool BF16>
__global__ void pack_slots_kernel(const float* __restrict__ w,
                                  typename ScanTypes<BF16>::W4* __restrict__ out,
                                  int D, int H, int NG, int fwd) {
    using Ty = ScanTypes<BF16>;
    const int G = NG * H;
    const int G4 = (G + 3) / 4;
    const size_t n = (size_t)D * H * (fwd ? H : G4);
    for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
         idx += (size_t)gridDim.x * blockDim.x) {
        typename Ty::W4 slot;
        for (int i = 0; i < 4; ++i) {
            float v = 0.0f;
            if (fwd) {
                const size_t dk = idx / H;  // d * H + k
                const int j = idx % H;
                if (i < NG) v = w[dk * G + (size_t)i * H + j];
            } else {
                const size_t dc = idx / H;    // d * G4 + c
                const int j = idx % H;
                const int col = 4 * (int)(dc % G4) + i;
                if (col < G) v = w[(dc / G4 * H + j) * G + col];
            }
            Ty::set(&slot, i, v);
        }
        out[idx] = slot;
    }
}

}  // namespace

// Bytes of the streamed route's packed weights (pack_slots_kernel).
inline size_t packed_slots_bytes(bool bf16, int D, int H, int NG, bool fwd) {
    const size_t slots = (size_t)D * H * (fwd ? H : (NG * H + 3) / 4);
    return slots * (bf16 ? 8 : 16);
}

// Pack W_hh (D, H, NG * H) into `out` (packed_slots_bytes) on `stream`.
template <bool BF16>
cudaError_t pack_slots(const float* w, void* out, int D, int H, int NG,
                       bool fwd, cudaStream_t stream) {
    if (out == nullptr) return cudaErrorInvalidValue;
    const size_t n = packed_slots_bytes(BF16, D, H, NG, fwd) / (BF16 ? 8 : 16);
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    pack_slots_kernel<BF16><<<blocks, 256, 0, stream>>>(
        w, static_cast<typename ScanTypes<BF16>::W4*>(out), D, H, NG,
        fwd ? 1 : 0);
    return cudaGetLastError();
}

// The two routes of a cooperative cell-scan kernel.  Resident: each block
// stages its slice of W_hh in shared memory once (`w_unit` bytes a hidden
// unit of the slice) beside what `rest(U, RB, RS, KS)` counts.  Streamed,
// where no resident grid is co-resident (a wide layer: two directions of
// float32 W_hh at H = 1024 are 33.5 MB, the card's shared memory about
// 30 MB): the same grid and arithmetic with the weights read from device
// memory (through L2) every step, as slots packed once a launch
// (pack_slots), so a block needs only `rest`; where even
// that grid has more blocks than the card holds at once (H = 3072 and
// more), blocks of at most 512, 256, ... 32 threads (fewer rows staged at
// once and K slices), so that more of them share an SM.  The
// resident grid is tried first, so every shape that fits keeps its grid.
// *streamed is 1 when the streamed grid was taken (`pick_streamed`, the
// streamed search alone); best->blocks stays 0 when neither is
// co-resident.  Leaves the taken kernel's dynamic shared memory limit set.
template <class Rest>
cudaError_t pick_streamed(const void* streamed, int D, int Bd, int H, int K,
                          int n_sm, int max_smem, Rest rest,
                          ScanGrid* best) {
    for (int threads = 1024; threads >= 32; threads /= 2) {
        cudaError_t err = pick_scan_grid(streamed, D, Bd, H, K, n_sm,
                                         max_smem, rest, best, threads);
        if (err != cudaSuccess || best->blocks > 0) return err;
    }
    return cudaSuccess;
}

template <class Rest>
cudaError_t pick_route(const void* resident, const void* streamed, int D,
                       int Bd, int H, int K, int n_sm, int max_smem,
                       size_t w_unit, Rest rest, ScanGrid* best,
                       int* stream_route) {
    *stream_route = 0;
    const auto with_w = [=](int U, int RB, int RS, int KS) {
        return w_unit * U + rest(U, RB, RS, KS);
    };
    cudaError_t err = pick_scan_grid(resident, D, Bd, H, K, n_sm, max_smem,
                                     with_w, best);
    if (err != cudaSuccess || best->blocks > 0) return err;
    *stream_route = 1;
    return pick_streamed(streamed, D, Bd, H, K, n_sm, max_smem, rest, best);
}

// ---- the bf16 `mma` routes of the LSTM kernels (lstm_cell_scan.cu,
// lstm_cell_scan_bwd.cu): a block of 16 warps owns a direction, 16 units
// and a range of rows; its slice of W_hh[d], rounded to bf16, is the A
// operand of `mma.sync.m16n8k16` (one M tile of 16 units, or four: the
// forwards' gates), held in the warps' registers for the whole launch; the
// step's rows are the B operand, N.

constexpr int MMA_UNITS = 16;           // a block's units: one M tile a gate
constexpr int MMA_WARPS = 16;           // 512 threads
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_RED = MMA_UNITS + 4;  // a partial-sum row, padded

// How an `mma` route divides a layer: a block owns a direction, one of
// n_ub slices of 16 units and one of n_rb ranges of RB rows, of which it
// stages RS at once; the product's K is KT k-steps of 16 in KCH chunks of
// KC (a warp's), and each chunk's warps split the row tiles NG ways.
struct MmaPlan {
    int n_ub, n_rb, RB, RS, KT, KC, KCH, NG, blocks;
    size_t smem;
};

// Shared memory of a block: the staged rows (RS padded to 8, each of 16 KT
// bf16 plus 16 bytes), the chunks' partial sums (`red_row` floats a staged
// row), and two float32 carries of the block's (row, unit) pairs.
inline size_t mma_smem(int KT, int KCH, int RB, int RS, int red_row) {
    const size_t rsp = (RS + 7) / 8 * 8;
    return sizeof(__nv_bfloat16) * rsp * (16 * (size_t)KT + 8)
           + sizeof(float) * ((size_t)KCH * rsp * red_row
                              + 2 * (size_t)RB * MMA_UNITS);
}

// The plan of a product over K, with partial sums of `red_row` floats a
// row, a warp's chunk at most kc_max k-steps (blocks 0 where none fits):
// one block an SM, so the unit slices of all directions must not
// outnumber the SMs; the
// rows are split until the grid has about one block per SM, and staged in
// as few chunks as shared memory allows, evened out.  ops/kernels/lstm.py
// `mma_plan` is its mirror.
inline MmaPlan mma_plan(int D, int Bd, int H, int K, int red_row,
                        int kc_max, int n_sm, int max_smem) {
    MmaPlan p = {};
    p.n_ub = (H + MMA_UNITS - 1) / MMA_UNITS;
    const int cols = D * p.n_ub;
    p.KT = (K + 15) / 16;
    p.KC = (p.KT + MMA_WARPS - 1) / MMA_WARPS;
    if (cols > n_sm || p.KC > kc_max) return p;
    p.KCH = (p.KT + p.KC - 1) / p.KC;
    p.NG = MMA_WARPS / p.KCH;
    int n_rb = n_sm / cols;
    n_rb = n_rb < 1 ? 1 : (n_rb > Bd ? Bd : n_rb);
    p.RB = (Bd + n_rb - 1) / n_rb;
    p.n_rb = (Bd + p.RB - 1) / p.RB;
    int rs = p.RB;
    while (rs > 0
           && mma_smem(p.KT, p.KCH, p.RB, rs, red_row) > (size_t)max_smem) {
        --rs;
    }
    if (rs == 0) return p;
    const int chunks = (p.RB + rs - 1) / rs;
    p.RS = (p.RB + chunks - 1) / chunks;
    p.smem = mma_smem(p.KT, p.KCH, p.RB, p.RS, red_row);
    p.blocks = cols * p.n_rb;
    return p;
}

// Set `kernel`'s dynamic shared memory limit to the plan's and zero
// plan->blocks where the grid is not co-resident.
inline cudaError_t fit_mma(const void* kernel, int n_sm, MmaPlan* plan) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)plan->smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, MMA_THREADS, plan->smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0 || plan->blocks > per_sm * n_sm) plan->blocks = 0;
    return cudaSuccess;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// c += a b: A (16 x 16, row-major fragments), B (16 x 8, b0 and b1), bf16
// operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments (16 deep, 8 wide) of eight k-contiguous bf16 rows: lanes 0-7
// point at the rows' first 8 values, lanes 8-15 at the next 8
__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t& b0,
                                        uint32_t& b1) {
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b0), "=r"(b1)
                 : "r"(addr)
                 : "memory");
}

// ---- the bf16 `mma` routes of the GRU training forward and backward
// (gru_cell_scan.cu, gru_cell_scan_bwd.cu): a block of 16 warps owns a
// direction and a range of rows with all H units, so it runs all T steps
// with no grid sync; the direction's W_hh, rounded to bf16, is the A
// operand of `mma.sync.m16n8k16` in the warps' registers for the whole
// launch; the rows of a step are the B operand, one N tile of 8.  A warp
// owns one tile of 16 units (the forward: its three gates' M tiles) and a
// chunk of KC k-steps of 16; the KCH chunks of a tile are summed on the
// tensor cores from zero, meet in shared memory and are added in float32
// in chunk order by the thread of each (row, unit) pair, which applies
// the cell.

// The widest H: 8 tiles of 16 units, so that two warps share each tile's K
// and a warp holds at most 48 registers of W_hh (the forward: 3 gates x 4
// k-steps x 4; the backward: 12 k-steps x 4).  From H = 129 a tile has one
// warp, which would hold all of K: 108 registers of W_hh in either kernel,
// more than the 128 a thread of 512 may keep beside the step's state.
constexpr int GRU_MMA_MAX_H = 128;
constexpr int GRU_MMA_ROWS = 8;   // rows staged at once: one N tile
// The training forward's K chunks a tile, at most: each chunk's partial
// sums are three gates' float4s to add, and at the classifier's H = 64 two
// chunks of two k-steps beat four chunks of one on an H100
constexpr int GRU_MMA_FWD_CHUNKS = 2;
// The steps ahead of its use that a step's inputs are prefetched into L2
// (each is loaded into registers one step ahead), where the launch's
// streams, read and written, outgrow the card's L2: a smaller layer's
// streams stay there, and the prefetches only cost instructions.  The
// streams' bf16 values a (step, row), in units of H, by kernel: the
// training forward's 9 (gx, out, the gates, gh_n, h_{t-1}), the
// backward's 12, the lean forward's 4 (gx and out).
constexpr int GRU_MMA_AHEAD = 2;
enum { GRU_MMA_TRAIN = 0, GRU_MMA_BWD = 1, GRU_MMA_LEAN = 2 };

// The steps ahead of a launch's prefetches (0: none) for `kernel` (one of
// the three above) on a card of `l2_bytes` of L2.
inline int gru_mma_ahead(int kernel, int T, int D, int Bd, int H,
                         int l2_bytes) {
    const int per_h = kernel == GRU_MMA_BWD ? 12
                      : kernel == GRU_MMA_LEAN ? 4 : 9;
    const size_t streams =
        (size_t)T * D * Bd * per_h * H * sizeof(__nv_bfloat16);
    return streams > (size_t)l2_bytes ? GRU_MMA_AHEAD : 0;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// How an `mma` route divides a layer: a block owns a direction and one of
// n_rb ranges of RB rows, taken RS (<= 8) at a time, each chunk of rows
// through all T steps; K (H forward, 3H backward) is KT k-steps of 16 in
// KCH chunks of KC.
struct GruMmaPlan {
    int n_rb, RB, RS, KT, KC, KCH, blocks;
    size_t smem;
};

// Shared memory: the staged bf16 rows (8, 16 KT + 8) and the chunks'
// partial sums, (KCH, 8) rows of 16 n_ut + 1 float4s (the forward's three
// gates) or of 16 n_ut + 4 floats (the backward), n_ut = ceil(H / 16).
inline size_t gru_mma_smem(int bwd, int H, int KT, int KCH) {
    const size_t n_ut = (H + 15) / 16;
    const size_t red = bwd ? sizeof(float) * (16 * n_ut + 4)
                           : sizeof(float4) * (16 * n_ut + 1);
    return sizeof(__nv_bfloat16) * GRU_MMA_ROWS * (16 * (size_t)KT + 8)
           + red * KCH * GRU_MMA_ROWS;
}

// The plan of the training forward (bwd 0) or the backward (bwd 1) at (D,
// Bd, H) on a card of n_sm SMs (blocks 0 where none fits: H above
// GRU_MMA_MAX_H, more directions than SMs, or too little shared memory).
// One block an SM in one wave: the rows of a direction are spread over
// n_sm / D blocks (on an H100 faster than blocks of a whole N tile of 8
// rows at the DPRNN's shapes), staged 8 at most at a time, evened out;
// each tile of 16 units gets 16 / n_ut warps, at most one a k-step (the
// forward at most GRU_MMA_FWD_CHUNKS), and K is cut into that many chunks.
// ops/kernels/gru.py `mma_plan` is its mirror.
inline GruMmaPlan gru_mma_plan(int bwd, int D, int Bd, int H, int n_sm,
                               int max_smem) {
    GruMmaPlan p = {};
    const int per_dir = D > 0 ? n_sm / D : 0;
    if (H < 1 || H > GRU_MMA_MAX_H || Bd < 1 || per_dir < 1) return p;
    const int n_ut = (H + 15) / 16;
    p.KT = ((bwd ? 3 * H : H) + 15) / 16;
    int warps = MMA_WARPS / n_ut < p.KT ? MMA_WARPS / n_ut : p.KT;
    if (!bwd && warps > GRU_MMA_FWD_CHUNKS) warps = GRU_MMA_FWD_CHUNKS;
    p.KC = (p.KT + warps - 1) / warps;
    p.KCH = (p.KT + p.KC - 1) / p.KC;
    p.RB = (Bd + per_dir - 1) / per_dir;
    p.n_rb = (Bd + p.RB - 1) / p.RB;
    const int chunks = (p.RB + GRU_MMA_ROWS - 1) / GRU_MMA_ROWS;
    p.RS = (p.RB + chunks - 1) / chunks;
    p.smem = gru_mma_smem(bwd, H, p.KT, p.KCH);
    if (p.smem > (size_t)max_smem) return p;
    p.blocks = D * p.n_rb;
    return p;
}

// The card's limits that the `mma` routes read, queried once a device.
struct GruMmaLimits {
    int n_sm, max_smem, l2_bytes;
};

inline cudaError_t gru_mma_limits(int device, GruMmaLimits* limits) {
    static std::mutex lock;
    static std::map<int, GruMmaLimits> known;
    std::lock_guard<std::mutex> hold(lock);
    auto it = known.find(device);
    if (it == known.end()) {
        GruMmaLimits l;
        cudaError_t err = cudaDeviceGetAttribute(
            &l.n_sm, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        err = cudaDeviceGetAttribute(
            &l.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        if (err != cudaSuccess) return err;
        err = cudaDeviceGetAttribute(&l.l2_bytes, cudaDevAttrL2CacheSize,
                                     device);
        if (err != cudaSuccess) return err;
        it = known.emplace(device, l).first;
    }
    *limits = it->second;
    return cudaSuccess;
}

// The plan at the card's own limits.
inline cudaError_t gru_mma_device_plan(int bwd, int D, int Bd, int H,
                                       int device, GruMmaPlan* plan) {
    GruMmaLimits l;
    cudaError_t err = gru_mma_limits(device, &l);
    if (err != cudaSuccess) return err;
    *plan = gru_mma_plan(bwd, D, Bd, H, l.n_sm, l.max_smem);
    return cudaSuccess;
}

// Let `kernel` take `smem` bytes of dynamic shared memory on `device`
// (the current one), setting the attribute only where it grows.
inline cudaError_t gru_mma_allow_smem(const void* kernel, int device,
                                      size_t smem) {
    static std::mutex lock;
    static std::map<std::pair<int, const void*>, size_t> allowed;
    std::lock_guard<std::mutex> hold(lock);
    size_t& have = allowed[{device, kernel}];
    if (smem <= have) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) have = smem;
    return err;
}

// ---- the cluster route of the lean bf16 GRU forward
// (gru_cell_scan_cluster.cu): above GRU_MMA_MAX_H one block's registers
// cannot hold a direction's W_hh, so a thread-block cluster of C CTAs owns
// a direction and a range of rows, CTA c the unit tiles [c n_ut / C,
// (c + 1) n_ut / C) of its three gates (n_ut = ceil(H / 16)), as the `mma`
// route's block owns all of them; the CTAs share bf16(h_t) through
// distributed shared memory.

// A warp's k-steps of each gate's M tile, at most: 3 x 4 x 4 = 48
// registers of W_hh a thread, what the `mma` route's kernels hold at
// H = 128 without a spill
constexpr int GRU_CLUSTER_KC = 4;

// How the cluster route divides a layer: C CTAs a cluster, each of at
// most TPC unit tiles; K = H in KT k-steps, KCH chunks of KC a tile (a
// warp each: warp w takes local tile w / (16 / TPC), chunk w % (16 /
// TPC)); n_rb ranges of RB rows a direction, one cluster each, taken RS
// (<= 8) at a time; clusters = D n_rb, blocks = C clusters (0 where none
// fits); smem bytes a CTA.
struct GruClusterPlan {
    int C, TPC, KT, KC, KCH, n_rb, RB, RS, clusters, blocks;
    size_t smem;
};

// Shared memory of a CTA: two mbarriers (16 bytes), two staged tiles of
// bf16(h) (8 rows of 16 KT + 8), and the chunks' partial sums, two sets
// (by step parity) of (KCH, 8) rows of 16 TPC + 1 float4s.
inline size_t gru_cluster_smem(int KT, int KCH, int TPC) {
    return 16
           + sizeof(__nv_bfloat16) * 2 * GRU_MMA_ROWS * (16 * (size_t)KT + 8)
           + sizeof(float4) * 2 * (size_t)KCH * GRU_MMA_ROWS
                 * (16 * (size_t)TPC + 1);
}

// The cluster's shape at H: the smallest portable C (2, 4, 8) whose CTAs
// each own a tile and whose warps hold at most GRU_CLUSTER_KC k-steps of
// W_hh (C 0 where none does, or the shared memory does not fit).  The
// rows are left to gru_cluster_plan.
inline GruClusterPlan gru_cluster_shape(int H, int max_smem) {
    GruClusterPlan p = {};
    const int n_ut = (H + 15) / 16;
    for (int C = 2; C <= 8 && H >= 1; C *= 2) {
        if (n_ut < C) break;
        const int tpc = (n_ut + C - 1) / C;
        const int wpt = MMA_WARPS / tpc;
        const int warps = wpt < n_ut ? wpt : n_ut;
        if (warps < 1) continue;
        const int kc = (n_ut + warps - 1) / warps;
        if (kc > GRU_CLUSTER_KC) continue;
        p.C = C;
        p.TPC = tpc;
        p.KT = n_ut;
        p.KC = kc;
        p.KCH = (n_ut + kc - 1) / kc;
        p.smem = gru_cluster_smem(p.KT, p.KCH, p.TPC);
        if (p.smem > (size_t)max_smem) p.C = 0;
        return p;
    }
    return p;
}

// The plan at (D, Bd, H) where the card runs `max_clusters` clusters of
// the shape's C at once: the rows of a direction spread over
// max_clusters / D clusters (one CTA an SM: on an H100 rows spread beat
// whole N tiles on the `mma` route), staged 8 at most at a time, evened
// out (blocks 0 where no shape fits or fewer clusters than directions
// run at once).  ops/kernels/gru.py `cluster_plan` is its mirror.
inline GruClusterPlan gru_cluster_plan(int D, int Bd, int H, int max_smem,
                                       int max_clusters) {
    GruClusterPlan p = gru_cluster_shape(H, max_smem);
    const int per_dir = D > 0 ? max_clusters / D : 0;
    if (p.C == 0 || Bd < 1 || per_dir < 1) {
        p.blocks = 0;
        return p;
    }
    p.RB = (Bd + per_dir - 1) / per_dir;
    p.n_rb = (Bd + p.RB - 1) / p.RB;
    const int chunks = (p.RB + GRU_MMA_ROWS - 1) / GRU_MMA_ROWS;
    p.RS = (p.RB + chunks - 1) / chunks;
    p.clusters = D * p.n_rb;
    p.blocks = p.C * p.clusters;
    return p;
}
