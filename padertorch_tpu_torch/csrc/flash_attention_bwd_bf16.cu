// Backward of exact softmax attention for bf16 q, k, v and dO on Hopper's
// warpgroup tensor cores: dq, dk, dv recomputed tile by tile from q, k, v,
// dO, the stored log-sum-exp and delta = sum(dO * O, -1), never forming
// the (Tq, Tk) probabilities in device memory.
//
// Replaces: padertorch_tpu/ops/pallas/attention.py, the backward of
// `flash_attention` through `_bwd_call` (kernel `_dqkv_kernel`) for bf16
// inputs (the float32 kernels are csrc/flash_attention_bwd.cu).
//
// The JAX kernel's numerics: S = Q K^T and dP = dO V^T from bf16 operands
// with float32 sums; P and dS stay float32 (softmax(S) recomputed from the
// log-sum-exp; dS = P (dP - delta)); dV = P^T dO, dK = dS^T Q and dQ = dS K
// take P and dS in float32; every sum is float32; each gradient is rounded
// to bf16 once, when it is stored.
//
// What bounds it on the card: the arithmetic, five products per visible
// (query, key) pair.  A design on `mma.sync` (the float32 side of dV, dK,
// dQ as 2xTF32, P and dS through shared memory, cp.async) reached 15% to
// 20% of that bound on an H100; `mma.sync` runs at about a quarter of the
// tensor cores' rate on this card.
//
// Design.  Two kernels, each owning its outputs, as before: dK/dV a block
// per (batch x KV head, tile of 64 keys), the query heads of its group
// summed in head order inside the block; dQ a block per (batch x head,
// tile of 64 queries).  No atomics; every sum in a fixed order, so two
// runs give the same bits.  A block is one consumer warpgroup (128
// threads, wgmma's 64 rows: the block's keys or queries).  One thread
// brings the block's own tiles (K and V, or Q and dO) once and the
// streamed ones (Q and dO, or K and V, 64 rows a tile) into a ring of two
// stages by TMA, each stage completing on its own `mbarrier` (the dK/dV
// block's threads also stage the tile's lse and delta), and refills a
// stage once every thread is done with it.  The kernel is a chain of
// latencies (a tile's products wait on its loads, its elementwise work on
// its products), so a block keeps no producer warp: without one, the
// registers of three blocks fit an SM at D = 64 (four at D <= 32), and
// their chains overlap.  A (rows, D)
// bf16 tile lands in boxes of at most 64 columns, rows of up to 128 bytes
// in TMA's swizzled layout (128-, 64- or 32-byte swizzle by the row's
// width), which `wgmma` reads with the same swizzle as a K-major operand
// (rows along M or N, D along K: S and dP) and, transposed by the
// descriptor, as an MN-major one (rows along K, D along N: the B operand
// of dV, dK, dQ).
//
// Per tile the consumers form S (or S^T) and dP (or dP^T) with
// `wgmma.m64n64k16` from shared memory, bf16 in, float32 out; take P and
// dS elementwise in the accumulators (a masked probability set to zero,
// the test per pair skipped where every pair of the tile is visible); and
// feed them to the gradient products from registers: the accumulator
// layout of a 64 x 64 product is the layout of the A operand of the next.
// The float32 side of those products is split into three bf16 pieces, hi
// = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid), 24 significant
// bits, each a bf16 `wgmma` (`m64nNk16`, N = 64 output columns at most)
// against the exact bf16 operand: three bf16 products, against the two
// 2xTF32 ones at a quarter of the rate before.  A tile's products (lo,
// mid, hi) accumulate on the tensor cores from zero; the tiles' sums are
// added into the running float32 sums by float32 adds (the tensor cores'
// own float32 sums, left to run over thousands of queries, drift further
// from plain's).  Tile loops cover only the tiles some owned row can see.
// The output columns a block computes are at most 64 (two accumulators of
// 64 x 64 float32 are 64 registers a thread): at D = 128 and 256 the
// columns are split over a third grid dimension, each block recomputing S
// and dP over the whole head.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "flash_attention_hopper.cuh"

namespace {

using flash::bf16;
using flash::clamp_len;
using flash::LOG2E;
using flash::Mask;
using flash::tile_visible;
using flash::visible;
using namespace hopper;

constexpr int STAGES = 2;       // the streamed tiles' ring
constexpr int THREADS = 128;    // one warpgroup
constexpr int STEPS = ROWS / 16;  // k-steps over a tile's rows

// The blocks that share an SM (as many as their shared memory allows, the
// registers of a thread capped for it): a block's chain of products,
// waits and elementwise work is latency, and the other blocks' work
// fills it (at D = 64 three blocks of 168 registers ran faster on an H100
// than two of 229 and than four of 128, which spill more)
__host__ __device__ constexpr int blocks_per_sm(int D) {
    return D <= 32 ? 4 : (D <= 64 ? 3 : (D <= 128 ? 2 : 1));
}



__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}

// x and y (neighbouring columns of a row) as three packed bf16 pieces:
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); each
// difference is exact in float32, so hi + mid + lo keeps 24 bits of x
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    const float rx = x - hf.x, ry = y - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
    const float2 mf = __bfloat1622float2(m);
    hi = bits(h);
    mid = bits(m);
    lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// The A operands of the (64 x 64) accumulator `acc`, K = its 64 columns
// in STEPS k-steps, as three pieces: a[piece][kk], piece 0 hi, 1 mid,
// 2 lo.  Columns 16 kk ... of a k-step are the accumulator's 8-column
// tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pieces(const float (&acc)[32],
                                       uint32_t (&a)[3][STEPS][4]) {
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            split3(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1], a[0][kk][j],
                   a[1][kk][j], a[2][kk][j]);
        }
    }
}

// acc += pieces (64 x 64) B, B a (64, D) tile's MN-major columns [col0,
// col0 + N): the lo, mid and hi products, each over STEPS k-steps,
// accumulated from zero on the tensor cores, then added in float32.
template <int D, int N>
__device__ __forceinline__ void product_into(float (&acc)[N / 2],
                                             const uint32_t (&a)[3][STEPS][4],
                                             const bf16* tile, int col0) {
    float t[N / 2];
    wgmma_fence();
#pragma unroll
    for (int piece = 2; piece >= 0; --piece) {
#pragma unroll
        for (int kk = 0; kk < STEPS; ++kk) {
            wgmma_rs<N>(t, a[piece][kk], mn_major<D>(tile, col0, kk),
                        piece != 2 || kk != 0);
        }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] += t[j];
}

// c1 = A1 B1^T and c2 = A2 B2^T over the head size: two (64 x 64)
// products of (ROWS, D) tiles, both K-major
template <int D>
__device__ __forceinline__ void two_products(float (&c1)[32],
                                             const bf16* a1, const bf16* b1,
                                             float (&c2)[32],
                                             const bf16* a2,
                                             const bf16* b2) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<64>(c1, k_major<D>(a1, kk), k_major<D>(b1, kk), kk > 0);
        wgmma_ss<64>(c2, k_major<D>(a2, kk), k_major<D>(b2, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
}

// Store a (64 x N) accumulator times `scale` as bf16 rows row0 + ... of a
// matrix with rows D apart, columns [col0, col0 + N); rows at or beyond T
// are not stored.
template <int D, int N>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[N / 2],
                                           int row0, int T, int col0,
                                           float scale) {
    const int lane = threadIdx.x & 31;
    const int ra = row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
    const int c = col0 + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
        if (ra < T) {
            flash::store2(dst + (size_t)ra * D + c + 8 * n,
                          acc[4 * n] * scale, acc[4 * n + 1] * scale);
        }
        if (ra + 8 < T) {
            flash::store2(dst + (size_t)(ra + 8) * D + c + 8 * n,
                          acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
        }
    }
}

// q, dO: (BH, Tq, D) through mq, mdo; k, v: (BH / group, Tk, D) through mk,
// mv (bf16, maps of dims {D, T, BH}); lse, delta: (BH, Tq) float32; lens:
// (BH / H,) or nullptr; dk, dv: (BH / group, Tk, D) bf16.  blockIdx.x: KV
// head row, blockIdx.y: key tile, blockIdx.z: output columns.  Shared
// memory: K, V tiles | Q, dO a tile each per stage | lse * log2(e), delta
// 64 each per stage | mbarriers: K and V, one per stage.
template <int D>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(D)) dkdv_kernel(
        const __grid_constant__ CUtensorMap mq,
        const __grid_constant__ CUtensorMap mk,
        const __grid_constant__ CUtensorMap mv,
        const __grid_constant__ CUtensorMap mdo,
        const int* __restrict__ lens, const float* __restrict__ lse,
        const float* __restrict__ delta, bf16* __restrict__ dk,
        bf16* __restrict__ dv, int H, int group, int Tq, int Tk, Mask msk,
        float scale) {
    constexpr int DO = cols_of(D), TILE = ROWS * D;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* k_s = aligned(smem_raw);
    bf16* v_s = k_s + TILE;
    bf16* q_s = v_s + TILE;
    bf16* do_s = q_s + STAGES * TILE;
    float* lse_s = reinterpret_cast<float*>(do_s + STAGES * TILE);
    float* dl_s = lse_s + STAGES * ROWS;
    uint64_t* kv_bar = reinterpret_cast<uint64_t*>(dl_s + STAGES * ROWS);
    uint64_t* full = kv_bar + 1;

    const int bkv = blockIdx.x;
    const int c0 = blockIdx.y * ROWS;
    const int col0 = blockIdx.z * DO;
    const int kv_len = clamp_len(lens, (bkv * group) / H, Tk);
    // query rows that can see some key of this tile: [lo, hi)
    int lo = 0;
    if (msk.causal) {
        lo = c0;
    } else if (msk.right >= 0) {
        lo = max(0, c0 - msk.right);
    }
    lo = lo / ROWS * ROWS;
    int hi = Tq;
    if (msk.left >= 0) hi = min(hi, c0 + ROWS + msk.left);
    if (c0 >= kv_len) hi = lo;  // every key of the tile is padding
    const int nqt = hi > lo ? (hi - lo + ROWS - 1) / ROWS : 0;
    const int total = group * nqt;  // (head, query tile) in head order

    // tile i of the stream into its stage: lse and delta by every thread,
    // Q and dO by TMA from thread 0
    const int tid = threadIdx.x;
    auto load = [&](int i) {
        const int st = i % STAGES;
        const int i0 = lo + (i % nqt) * ROWS;
        const int bh = bkv * group + i / nqt;
        for (int r = tid; r < ROWS; r += THREADS) {
            const bool in = i0 + r < Tq;
            lse_s[st * ROWS + r] =
                in ? lse[(size_t)bh * Tq + i0 + r] * LOG2E : 0.0f;
            dl_s[st * ROWS + r] = in ? delta[(size_t)bh * Tq + i0 + r] : 0.0f;
        }
        if (tid == 0) {
            mbar_arrive_expect_tx(&full[st], 2 * TILE * sizeof(bf16));
            tma_tile<D>(q_s + st * TILE, &mq, i0, bh, &full[st]);
            tma_tile<D>(do_s + st * TILE, &mdo, i0, bh, &full[st]);
        }
    };
    if (tid == 0) {
        mbar_init(kv_bar, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * TILE * sizeof(bf16));
        tma_tile<D>(k_s, &mk, c0, bkv, kv_bar);
        tma_tile<D>(v_s, &mv, c0, bkv, kv_bar);
    }
    for (int i = 0; i < STAGES && i < total; ++i) load(i);
    __syncthreads();  // the first stages' lse and delta

    const int lane = tid & 31;
    const int rr = lane >> 2, qq = lane & 3;
    const int key_a = c0 + 16 * (tid >> 5) + rr;   // and key_a + 8
    const float scale2 = scale * LOG2E;
    float dk_acc[DO / 2], dv_acc[DO / 2];
#pragma unroll
    for (int j = 0; j < DO / 2; ++j) dk_acc[j] = dv_acc[j] = 0.0f;
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < total; ++i) {
        const int st = i % STAGES;
        mbar_wait(&full[st], (i / STAGES) & 1);
        const int i0 = lo + (i % nqt) * ROWS;
        const bf16* q_t = q_s + st * TILE;
        const bf16* do_t = do_s + st * TILE;
        const float* lse_t = lse_s + st * ROWS;
        const float* dl_t = dl_s + st * ROWS;
        const bool all = tile_visible(msk, i0, i0 + ROWS, c0, c0 + ROWS, Tq,
                                      kv_len);
        // S^T = K Q^T and dP^T = V dO^T: keys by queries
        float s[32], dp[32];
        two_products<D>(s, k_s, q_t, dp, v_s, do_t);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int key = key_a + ((j >> 1) & 1) * 8;
            const int ql = 8 * (j >> 2) + 2 * qq + (j & 1);
            const int qr = i0 + ql;
            const float p =
                all || (qr < Tq && visible(msk, qr, key, kv_len))
                    ? exp2f(fmaf(s[j], scale2, -lse_t[ql]))
                    : 0.0f;
            s[j] = p;
            dp[j] = p * (dp[j] - dl_t[ql]);
        }
        uint32_t a[3][STEPS][4];
        pieces(s, a);
        product_into<D, DO>(dv_acc, a, do_t, col0);   // dV += P^T dO
        pieces(dp, a);
        product_into<D, DO>(dk_acc, a, q_t, col0);    // dK += dS^T Q
        // every thread is done with the stage: refill it
        __syncthreads();
        if (i + STAGES < total) load(i + STAGES);
    }
    store_rows<D, DO>(dk + (size_t)bkv * Tk * D, dk_acc, c0, Tk, col0,
                      scale);
    store_rows<D, DO>(dv + (size_t)bkv * Tk * D, dv_acc, c0, Tk, col0,
                      1.0f);
}

// As above; dq: (BH, Tq, D) bf16.  blockIdx.x: batch x head row,
// blockIdx.y: query tile, blockIdx.z: output columns.  Shared memory: Q,
// dO tiles | K, V a tile each per stage | mbarriers: Q and dO, one per
// stage.
template <int D>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(D)) dq_kernel(
        const __grid_constant__ CUtensorMap mq,
        const __grid_constant__ CUtensorMap mk,
        const __grid_constant__ CUtensorMap mv,
        const __grid_constant__ CUtensorMap mdo,
        const int* __restrict__ lens, const float* __restrict__ lse,
        const float* __restrict__ delta, bf16* __restrict__ dq, int H,
        int group, int Tq, int Tk, Mask msk, float scale) {
    constexpr int DO = cols_of(D), TILE = ROWS * D;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* q_s = aligned(smem_raw);
    bf16* do_s = q_s + TILE;
    bf16* k_s = do_s + TILE;
    bf16* v_s = k_s + STAGES * TILE;
    uint64_t* qd_bar = reinterpret_cast<uint64_t*>(v_s + STAGES * TILE);
    uint64_t* full = qd_bar + 1;

    const int bh = blockIdx.x;
    const int r0 = blockIdx.y * ROWS;
    const int col0 = blockIdx.z * DO;
    const int kv_len = clamp_len(lens, bh / H, Tk);
    const int kvh = bh / group;
    // keys that some row of this tile can see: [lo, hi)
    int hi = kv_len;
    if (msk.causal) {
        hi = min(hi, r0 + ROWS);
    } else if (msk.right >= 0) {
        hi = min(hi, r0 + ROWS + msk.right);
    }
    int lo = 0;
    if (msk.left >= 0) lo = max(0, r0 - msk.left) / ROWS * ROWS;
    const int total = hi > lo ? (hi - lo + ROWS - 1) / ROWS : 0;

    // tile i of the stream into its stage, by TMA from thread 0
    const int tid = threadIdx.x;
    auto load = [&](int i) {
        const int st = i % STAGES;
        mbar_arrive_expect_tx(&full[st], 2 * TILE * sizeof(bf16));
        tma_tile<D>(k_s + st * TILE, &mk, lo + i * ROWS, kvh, &full[st]);
        tma_tile<D>(v_s + st * TILE, &mv, lo + i * ROWS, kvh, &full[st]);
    };
    if (tid == 0) {
        mbar_init(qd_bar, 1);
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_arrive_expect_tx(qd_bar, 2 * TILE * sizeof(bf16));
        tma_tile<D>(q_s, &mq, r0, bh, qd_bar);
        tma_tile<D>(do_s, &mdo, r0, bh, qd_bar);
        for (int i = 0; i < STAGES && i < total; ++i) load(i);
    }
    __syncthreads();  // the mbarriers initialised

    const int lane = tid & 31;
    const int qq = lane & 3;
    // this thread's two rows, their lse and delta
    const int qa = r0 + 16 * (tid >> 5) + (lane >> 2);
    const int qb = qa + 8;
    const float lse_a = qa < Tq ? lse[(size_t)bh * Tq + qa] * LOG2E : 0.0f;
    const float lse_b = qb < Tq ? lse[(size_t)bh * Tq + qb] * LOG2E : 0.0f;
    const float dl_a = qa < Tq ? delta[(size_t)bh * Tq + qa] : 0.0f;
    const float dl_b = qb < Tq ? delta[(size_t)bh * Tq + qb] : 0.0f;
    const float scale2 = scale * LOG2E;
    float dq_acc[DO / 2];
#pragma unroll
    for (int j = 0; j < DO / 2; ++j) dq_acc[j] = 0.0f;
    mbar_wait(qd_bar, 0);
    for (int i = 0; i < total; ++i) {
        const int st = i % STAGES;
        mbar_wait(&full[st], (i / STAGES) & 1);
        const int j0 = lo + i * ROWS;
        const bf16* k_t = k_s + st * TILE;
        const bf16* v_t = v_s + st * TILE;
        const bool all = tile_visible(msk, r0, r0 + ROWS, j0, j0 + ROWS, Tq,
                                      kv_len);
        // S = Q K^T and dP = dO V^T: queries by keys
        float s[32], dp[32];
        two_products<D>(s, q_s, k_t, dp, do_s, v_t);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const bool b = (j >> 1) & 1;
            const int row = b ? qb : qa;
            const int kl = 8 * (j >> 2) + 2 * qq + (j & 1);
            const float p =
                all || (row < Tq && visible(msk, row, j0 + kl, kv_len))
                    ? exp2f(fmaf(s[j], scale2, -(b ? lse_b : lse_a)))
                    : 0.0f;
            dp[j] = p * (dp[j] - (b ? dl_b : dl_a));
        }
        uint32_t a[3][STEPS][4];
        pieces(dp, a);
        product_into<D, DO>(dq_acc, a, k_t, col0);   // dQ += dS K
        // every thread is done with the stage: refill it
        __syncthreads();
        if (tid == 0 && i + STAGES < total) load(i + STAGES);
    }
    store_rows<D, DO>(dq + (size_t)bh * Tq * D, dq_acc, r0, Tq, col0, scale);
}


template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, const void* d_o, const void* lse,
                   const void* delta, void* dq, void* dk, void* dv, int BH,
                   int H, int group, int Tq, int Tk, Mask msk, float scale,
                   cudaStream_t stream) {
    constexpr int TILE = ROWS * D;
    const int z = D / cols_of(D);
    if (Tk == 0) {
        // no key: dq is zero, dk and dv are empty
        return cudaMemsetAsync(dq, 0, (size_t)BH * Tq * D * sizeof(bf16),
                               stream);
    }
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err = tile_map<D>(q, BH, Tq, &mq);
    if (err == cudaSuccess) err = tile_map<D>(d_o, BH, Tq, &mdo);
    if (err == cudaSuccess) err = tile_map<D>(k, BH / group, Tk, &mk);
    if (err == cudaSuccess) err = tile_map<D>(v, BH / group, Tk, &mv);
    if (err != cudaSuccess) return err;
    const auto lens_ = static_cast<const int*>(lens);
    const auto lse_ = static_cast<const float*>(lse);
    const auto delta_ = static_cast<const float*>(delta);
    // the mbarriers and room to align the tiles
    const size_t bars = sizeof(uint64_t) * (1 + STAGES) + ALIGN;
    const size_t smem_dkdv = sizeof(bf16) * (2 + 2 * STAGES) * TILE
                             + sizeof(float) * 2 * STAGES * ROWS + bars;
    const size_t smem_dq = sizeof(bf16) * (2 + 2 * STAGES) * TILE + bars;
    err = cudaFuncSetAttribute(dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dkdv);
    if (err != cudaSuccess) return err;
    const int key_tiles = (Tk + ROWS - 1) / ROWS;
    const int query_tiles = (Tq + ROWS - 1) / ROWS;
    if (key_tiles > 65535 || query_tiles > 65535) return cudaErrorInvalidValue;
    dkdv_kernel<D><<<dim3(BH / group, key_tiles, z), THREADS, smem_dkdv,
                     stream>>>(mq, mk, mv, mdo, lens_, lse_, delta_,
                               static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                               H, group, Tq, Tk, msk, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dq);
    if (err != cudaSuccess) return err;
    dq_kernel<D><<<dim3(BH, query_tiles, z), THREADS, smem_dq, stream>>>(
        mq, mk, mv, mdo, lens_, lse_, delta_, static_cast<bf16*>(dq), H,
        group, Tq, Tk, msk, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dO, dq: (BH, Tq, D) bf16; k, v, dk, dv: (BH / group, Tk, D) bf16;
// lse, delta: (BH, Tq) float32; lens: (BH / H,) int32 or null.  D is 16,
// 32, 64, 128 or 256; left/right -1 for an unbounded window side.  All
// pointers 16-byte aligned.  Launches the dk/dv kernel, then the dq
// kernel, on `stream`.  Returns cudaGetLastError() after the launches.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* lens, const void* d_o,
                             const void* lse, const void* delta, void* dq,
                             void* dk, void* dv, int BH, int H, int group,
                             int Tq, int Tk, int D, int causal, int left,
                             int right, float scale, int device,
                             void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (BH < 1 || Tq < 1 || Tk < 0 || group < 1 || H < 1 || BH % group != 0)
        return cudaErrorInvalidValue;
    const Mask msk = {causal, left, right};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS q, k, v, lens, d_o, lse, delta, dq, dk, dv, BH, H, group, \
                 Tq, Tk, msk, scale, st
    switch (D) {
        case 16: return launch<16>(BWD_ARGS);
        case 32: return launch<32>(BWD_ARGS);
        case 64: return launch<64>(BWD_ARGS);
        case 128: return launch<128>(BWD_ARGS);
        case 256: return launch<256>(BWD_ARGS);
        default: return cudaErrorInvalidValue;
    }
#undef BWD_ARGS
}

}  // extern "C"
