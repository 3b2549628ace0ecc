// Backward of exact softmax attention: dq, dk, dv recomputed tile by tile
// from q, k, v, dO, the stored log-sum-exp and delta = sum(dO * O, -1),
// never forming the (Tq, Tk) probabilities in device memory.
//
// Replaces: padertorch_tpu/ops/pallas/attention.py, the backward of
// `flash_attention` through `_bwd_call` (kernel `_dqkv_kernel`).
//
// What bounds it on the card: the arithmetic, five tile products per
// visible (query, key) pair: S = Q K^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K, each on the tensor cores as 3xTF32
// (flash_attention_common.cuh: float32 accuracy for three TF32 products).
//
// The TPU kernel visits every (query block, key block) tile once and adds
// each tile's dq into a block that stays resident across its sequential
// grid.  Blocks on a GPU run in no order, so that carry does not exist
// here, and adding into dq with atomics would make the sum's order change
// from run to run.  Instead two kernels, each owning its outputs outright:
//   dk/dv: one block per (batch * kv head, tile of 64 keys); each of its
//     four warps owns 16 keys and keeps their dk and dv accumulators in
//     registers (MMA fragments).  K and V of the tile sit in shared
//     memory; the query heads of the group (grouped-query attention) and,
//     per head, the query tiles that can see this key tile stream through
//     shared memory (q, dO, lse, delta), double-buffered with cp.async so
//     that the next tile's copy overlaps this tile's products.  Per tile a
//     warp forms S^T = K Q^T and dP^T = V dO^T (16 keys by the tile's
//     queries) in one loop, then P^T and dS^T elementwise, passes both
//     through shared memory as the A operands of dV += P^T dO and dK +=
//     dS^T Q, again in one loop up to D = 64 (two products in one loop
//     give the tensor cores twice the independent accumulator chains; at
//     D = 128 the registers hold one product's tile sum).  The group's heads
//     are summed in head order inside the block.
//   dq: one block per (batch * head, tile of 64 queries); each warp owns
//     16 queries and keeps dq in registers; K and V tiles stream through
//     shared memory, double-buffered; S and dP in one loop, then dS
//     through shared memory into dQ += dS K.
// Both recompute S and P, so the backward does 7 tile products where a
// single-pass kernel does 5; in exchange every output element is written
// once, by one thread, after a sum in a fixed order: two runs give the
// same bits.  A masked probability is set to zero explicitly, so fully
// masked rows (lse = -1e30) give zero gradients.  Tile loops cover only
// tiles that some owned row can see (kv_len, causal, window), and a tile
// whose every pair is visible skips the test per pair.  P is formed as
// exp2(s * scale * log2(e) - lse * log2(e)).  The tensor cores' float32
// accumulation of a long sum (dk over thousands of queries) drifts further
// from plain's than float32 adds do, so a tile's products are summed on
// the tensor cores and the tiles into the registers' running sums by
// float32 adds.
//
// The bf16 backward is csrc/flash_attention_bwd_bf16.cu (`wgmma`, TMA).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// Tile sizes of head size D: BS rows of the streamed operand per tile
// (fewer for wide heads, so that two blocks share an SM, and at D = 256 so
// that one block's tiles fit), and whether the tile sums of dV and dK run
// in one loop (D = 128 has registers for one at a time).  At D = 256 a
// block computes DO = 128 of the output columns (`out_cols`), the halves
// on a grid dimension of their own, each recomputing S and dP over the
// whole head: the accumulators of D = 128.
template <int D, typename T>
struct Tiles : TileShape<D, (D <= 32 ? 64 : (D <= 128 ? 32 : 16)), T> {
    static constexpr bool PAIR = D <= 64;
};

// Two independent products in one loop over K (twice the independent
// accumulator chains of one): c1 (16, 8 N) += A1 (16, 8 K) B1 and c2 +=
// A2 B2, A row-major (stride lda), B n-major (KN false: the (8 N, 8 K)
// matrix at b is B^T) or k-major (KN true), stride ldb.  The k step kk
// adds into the partial sums [kk % NP] (NP > 1 where N is small, for more
// chains); the partial sums are added in order at the end by the caller.
// With LIM only the first `lim` streamed rows count (a tile at the end of
// the sequence): the n tiles (n-major) or k steps (k-major) past them are
// skipped.  Full tiles take LIM false, which keeps the loops free of exits.
// Both operands float32, in 3xTF32.
template <bool LIM, bool KN, int K, int N, int NP>
__device__ __forceinline__ void gemm2(float (&c1)[NP][N][4], const float* a1,
                                      const float* b1, float (&c2)[NP][N][4],
                                      const float* a2, const float* b2,
                                      int lda, int ldb, int lim, int lane) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
        if (LIM && KN && kk * 8 >= lim) break;
        uint32_t ah1[4], al1[4], ah2[4], al2[4];
        load_a(a1 + kk * 8, lda, lane, ah1, al1);
        load_a(a2 + kk * 8, lda, lane, ah2, al2);
#pragma unroll
        for (int n = 0; n < N; ++n) {
            if (LIM && !KN && n * 8 >= lim) break;
            const int at = KN ? kk * 8 * ldb + n * 8 : n * 8 * ldb + kk * 8;
            uint32_t bh1[2], bl1[2], bh2[2], bl2[2];
            load_b<KN>(b1 + at, ldb, lane, bh1, bl1);
            load_b<KN>(b2 + at, ldb, lane, bh2, bl2);
            mma3(c1[kk % NP][n], ah1, al1, bh1, bl1);
            mma3(c2[kk % NP][n], ah2, al2, bh2, bl2);
        }
    }
}

// S and dP of a tile: c1 (16, 8 N) = A1 B1 and c2 = A2 B2 over the head
// size D, A row-major and B n-major (rows of the streamed operand), both
// with stride ld, in 3xTF32 (gemm2); with LIM the n tiles at or past
// `lim` are skipped.
template <bool LIM, int D, int N>
__device__ __forceinline__ void gemm_sdp(float (&c1)[1][N][4],
                                         const float* a1, const float* b1,
                                         float (&c2)[1][N][4],
                                         const float* a2, const float* b2,
                                         int ld, int lim, int lane) {
    gemm2<LIM, false, D / 8, N, 1>(c1, a1, b1, c2, a2, b2, ld, ld, lim,
                                   lane);
}

// acc += t, element by element
template <int NP, int N>
__device__ __forceinline__ void add_into(float (&acc)[NP][N][4],
                                         const float (&t)[NP][N][4]) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] += t[i][n][e];
        }
    }
}

// Store a warp's (16, 8 NO) accumulator, its NP partial sums added in
// order and times `scale`, as rows row0 ... row0 + 15 of a matrix of TO
// with rows D apart; rows at or beyond T
// are not stored.
template <int D, int NO, int NP, typename TO>
__device__ __forceinline__ void store_acc(TO* dst,
                                          float (&acc)[NP][NO][4],
                                          int row0, int T, float scale,
                                          int lane) {
    const int ra = row0 + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            x[e] = acc[0][n][e];
#pragma unroll
            for (int i = 1; i < NP; ++i) x[e] += acc[i][n][e];
            x[e] *= scale;
        }
        if (ra < T) store2(dst + (size_t)ra * D + n * 8 + c, x[0], x[1]);
        if (ra + 8 < T) {
            store2(dst + (size_t)(ra + 8) * D + n * 8 + c, x[2], x[3]);
        }
    }
}

// q, dO: (BH, Tq, D); k, v, dk, dv: (BH / group, Tk, D), all of T (float
// or bf16); lse, delta: (BH, Tq) float32; lens: (BH / H,) or nullptr.
// blockIdx.x: kv head row, blockIdx.y: key tile.  Shared memory: K, V
// (OWN, SD) | Q, dO two stages of (BS, SD) each | lse * log2(e), delta two
// stages of BS each | P^T, dS^T (OWN, SP) each, float32.
template <int D, typename T>
__global__ void __launch_bounds__(32 * WARPS) flash_bwd_dkdv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const int* __restrict__ lens,
        const T* __restrict__ d_o, const float* __restrict__ lse,
        const float* __restrict__ delta, T* __restrict__ dk,
        T* __restrict__ dv, int H, int group, int Tq, int Tk, Mask mk,
        float scale) {
    using TL = Tiles<D, T>;
    constexpr int BS = TL::BS, SD = TL::SD, SP = TL::SP;
    constexpr int NS = TL::NS, NP = TL::NP;
    // the block's output columns [col0, col0 + DO): NO tiles of 8
    constexpr int DO = out_cols(D), NO = DO / 8;
    const int col0 = blockIdx.z * DO;
    extern __shared__ float4 smem4[];
    T* k_s = reinterpret_cast<T*>(smem4);
    T* v_s = k_s + OWN * SD;
    T* q_s = v_s + OWN * SD;
    T* do_s = q_s + 2 * BS * SD;
    float* lse_s = reinterpret_cast<float*>(do_s + 2 * BS * SD);
    float* dl_s = lse_s + 2 * BS;
    float* p_s = dl_s + 2 * BS;
    float* ds_s = p_s + OWN * SP;

    const int lane = threadIdx.x & 31;
    const int row_w = (threadIdx.x >> 5) * 16;  // the warp's first key
    const int bkv = blockIdx.x;
    const int c0 = blockIdx.y * OWN;
    const int kv_len = clamp_len(lens, (bkv * group) / H, Tk);
    const float scale2 = scale * LOG2E;
    stage_rows<D, OWN>(k_s, k + (size_t)bkv * Tk * D, c0, Tk);
    stage_rows<D, OWN>(v_s, v + (size_t)bkv * Tk * D, c0, Tk);
    cp_async_commit();

    // query rows that can see some key of this tile: [lo, hi)
    int lo = 0;
    if (mk.causal) {
        lo = c0;
    } else if (mk.right >= 0) {
        lo = max(0, c0 - mk.right);
    }
    lo = lo / BS * BS;
    int hi = Tq;
    if (mk.left >= 0) hi = min(hi, c0 + OWN + mk.left);
    if (c0 >= kv_len) hi = lo;  // every key of the tile is padding
    const int nqt = hi > lo ? (hi - lo + BS - 1) / BS : 0;
    const int total = group * nqt;  // (head, query tile) in head order

    auto stage = [&](int i) {
        const int st = i & 1;
        const int i0 = lo + (i % nqt) * BS;
        const size_t bh = (size_t)bkv * group + i / nqt;
        stage_rows<D, BS>(q_s + st * BS * SD, q + bh * Tq * D, i0, Tq);
        stage_rows<D, BS>(do_s + st * BS * SD, d_o + bh * Tq * D, i0, Tq);
        for (int r = threadIdx.x; r < BS; r += blockDim.x) {
            const bool in = i0 + r < Tq;
            lse_s[st * BS + r] = in ? lse[bh * Tq + i0 + r] * LOG2E : 0.0f;
            dl_s[st * BS + r] = in ? delta[bh * Tq + i0 + r] : 0.0f;
        }
        cp_async_commit();
    };

    float dk_acc[NP][NO][4] = {};
    float dv_acc[NP][NO][4] = {};
    float* pw = p_s + row_w * SP;
    float* dsw = ds_s + row_w * SP;
    const int key_a = c0 + row_w + (lane >> 2);
    // a warp whose 16 keys are all padding has nothing to add
    const bool idle = c0 + row_w >= kv_len;
    if (total > 0) stage(0);
    for (int i = 0; i < total; ++i) {
        if (i + 1 < total) {
            stage(i + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int st = i & 1;
        const int i0 = lo + (i % nqt) * BS;
        const T* q_t = q_s + st * BS * SD;
        const T* do_t = do_s + st * BS * SD;
        const float* lse_t = lse_s + st * BS;
        const float* dl_t = dl_s + st * BS;
        const int nv = min(BS, hi - i0);  // query rows that count
        const bool all = tile_visible(mk, i0, i0 + BS, c0, c0 + OWN, Tq,
                                      kv_len);
        // a tile past the end of the rows that count takes the loops
        // with exits
        auto tile = [&](auto lim) {
            constexpr bool LIM = decltype(lim)::value;
            float s[1][NS][4] = {};
            float dp[1][NS][4] = {};
            gemm_sdp<LIM, D, NS>(s, k_s + row_w * SD, q_t, dp,
                                 v_s + row_w * SD, do_t, SD, nv, lane);
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                if (LIM && n * 8 >= nv) break;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = (lane >> 2) + (e >= 2 ? 8 : 0);
                    const int ql = n * 8 + 2 * (lane & 3) + (e & 1);
                    const int qr = i0 + ql;
                    const float p =
                        all || (qr < Tq && visible(mk, qr, key_a + (r & 8),
                                                   kv_len))
                            ? exp2f(fmaf(s[0][n][e], scale2, -lse_t[ql]))
                            : 0.0f;
                    pw[r * SP + ql] = p;
                    dsw[r * SP + ql] = p * (dp[0][n][e] - dl_t[ql]);
                }
            }
            __syncwarp();
            if constexpr (TL::PAIR) {
                float dv_t[NP][NO][4] = {};
                float dk_t[NP][NO][4] = {};
                gemm2<LIM, true, NS, NO, NP>(dv_t, pw, do_t, dk_t, dsw, q_t,
                                             SP, SD, nv, lane);
                add_into(dv_acc, dv_t);
                add_into(dk_acc, dk_t);
            } else {
                // registers for one tile sum at a time
                {
                    float dv_t[NP][NO][4] = {};
                    gemm_kn<LIM, NS, NO, NP>(dv_t, pw, SP, do_t + col0, SD,
                                             nv, lane);
                    add_into(dv_acc, dv_t);
                }
                {
                    float dk_t[NP][NO][4] = {};
                    gemm_kn<LIM, NS, NO, NP>(dk_t, dsw, SP, q_t + col0, SD,
                                             nv, lane);
                    add_into(dk_acc, dk_t);
                }
            }
        };
        if (idle) {
        } else if (D == 16 && nv < BS) {
            tile(std::true_type());
        } else {
            tile(std::false_type());
        }
        __syncthreads();  // the stage is free for the copy after next
    }
    cp_async_wait<0>();

    store_acc<D, NO, NP>(dk + (size_t)bkv * Tk * D + col0, dk_acc,
                         c0 + row_w, Tk, scale, lane);
    store_acc<D, NO, NP>(dv + (size_t)bkv * Tk * D + col0, dv_acc,
                         c0 + row_w, Tk, 1.0f, lane);
}

// blockIdx.x: batch * head row, blockIdx.y: query tile.  Shared memory:
// Q, dO (OWN, SD) | K, V two stages of (BS, SD) each | dS (OWN, SP).
template <int D, typename T>
__global__ void __launch_bounds__(32 * WARPS) flash_bwd_dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const int* __restrict__ lens,
        const T* __restrict__ d_o, const float* __restrict__ lse,
        const float* __restrict__ delta, T* __restrict__ dq, int H,
        int group, int Tq, int Tk, Mask mk, float scale) {
    using TL = Tiles<D, T>;
    constexpr int BS = TL::BS, SD = TL::SD, SP = TL::SP;
    constexpr int NS = TL::NS, NP = TL::NP;
    // the block's output columns [col0, col0 + DO): NO tiles of 8
    constexpr int DO = out_cols(D), NO = DO / 8;
    const int col0 = blockIdx.z * DO;
    extern __shared__ float4 smem4[];
    T* q_s = reinterpret_cast<T*>(smem4);
    T* do_s = q_s + OWN * SD;
    T* k_s = do_s + OWN * SD;
    T* v_s = k_s + 2 * BS * SD;
    float* ds_s = reinterpret_cast<float*>(v_s + 2 * BS * SD);

    const int lane = threadIdx.x & 31;
    const int row_w = (threadIdx.x >> 5) * 16;  // the warp's first query
    const int bh = blockIdx.x;
    const int r0 = blockIdx.y * OWN;
    const int kv_len = clamp_len(lens, bh / H, Tk);
    const float scale2 = scale * LOG2E;
    const T* k_bh = k + (size_t)(bh / group) * Tk * D;
    const T* v_bh = v + (size_t)(bh / group) * Tk * D;
    stage_rows<D, OWN>(q_s, q + (size_t)bh * Tq * D, r0, Tq);
    stage_rows<D, OWN>(do_s, d_o + (size_t)bh * Tq * D, r0, Tq);
    cp_async_commit();

    // this thread's two rows of the MMA fragments, their lse and delta
    const int qa = r0 + row_w + (lane >> 2);
    const int qb = qa + 8;
    const float lse_a = qa < Tq ? lse[(size_t)bh * Tq + qa] * LOG2E : 0.0f;
    const float lse_b = qb < Tq ? lse[(size_t)bh * Tq + qb] * LOG2E : 0.0f;
    const float dl_a = qa < Tq ? delta[(size_t)bh * Tq + qa] : 0.0f;
    const float dl_b = qb < Tq ? delta[(size_t)bh * Tq + qb] : 0.0f;

    // keys that some row of this tile can see: [lo, hi)
    int hi = kv_len;
    if (mk.causal) {
        hi = min(hi, r0 + OWN);
    } else if (mk.right >= 0) {
        hi = min(hi, r0 + OWN + mk.right);
    }
    int lo = 0;
    if (mk.left >= 0) lo = max(0, r0 - mk.left) / BS * BS;
    const int total = hi > lo ? (hi - lo + BS - 1) / BS : 0;

    auto stage = [&](int i) {
        const int st = i & 1;
        stage_rows<D, BS>(k_s + st * BS * SD, k_bh, lo + i * BS, Tk);
        stage_rows<D, BS>(v_s + st * BS * SD, v_bh, lo + i * BS, Tk);
        cp_async_commit();
    };

    float dq_acc[NP][NO][4] = {};
    float* dw = ds_s + row_w * SP;
    // a warp whose 16 queries are all past Tq has nothing to add
    const bool idle = r0 + row_w >= Tq;
    if (total > 0) stage(0);
    for (int i = 0; i < total; ++i) {
        if (i + 1 < total) {
            stage(i + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int st = i & 1;
        const int j0 = lo + i * BS;
        const T* k_t = k_s + st * BS * SD;
        const T* v_t = v_s + st * BS * SD;
        const int nv = min(BS, hi - j0);  // keys of the tile that count
        const bool all = tile_visible(mk, r0, r0 + OWN, j0, j0 + BS, Tq,
                                      kv_len);
        auto tile = [&](auto lim) {
            constexpr bool LIM = decltype(lim)::value;
            float s[1][NS][4] = {};
            float dp[1][NS][4] = {};
            gemm_sdp<LIM, D, NS>(s, q_s + row_w * SD, k_t, dp,
                                 do_s + row_w * SD, v_t, SD, nv, lane);
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                if (LIM && n * 8 >= nv) break;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool b = e >= 2;
                    const int row = b ? qb : qa;
                    const int kl = n * 8 + 2 * (lane & 3) + (e & 1);
                    const float p =
                        all || (row < Tq
                                && visible(mk, row, j0 + kl, kv_len))
                            ? exp2f(fmaf(s[0][n][e], scale2,
                                         -(b ? lse_b : lse_a)))
                            : 0.0f;
                    dw[((lane >> 2) + (b ? 8 : 0)) * SP + kl] =
                        p * (dp[0][n][e] - (b ? dl_b : dl_a));
                }
            }
            __syncwarp();
            float dq_t[NP][NO][4] = {};
            gemm_kn<LIM, NS, NO, NP>(dq_t, dw, SP, k_t + col0, SD, nv,
                                     lane);
            add_into(dq_acc, dq_t);
        };
        if (idle) {
        } else if (D == 16 && nv < BS) {
            tile(std::true_type());
        } else {
            tile(std::false_type());
        }
        __syncthreads();  // the stage is free for the copy after next
    }
    cp_async_wait<0>();

    store_acc<D, NO, NP>(dq + (size_t)bh * Tq * D + col0, dq_acc,
                         r0 + row_w, Tq, scale, lane);
}

template <int D, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* lens, const void* d_o, const void* lse,
                       const void* delta, void* dq, void* dk, void* dv, int BH,
                       int H, int group, int Tq, int Tk, Mask mk, float scale,
                       cudaStream_t stream) {
    using TL = Tiles<D, T>;
    const auto q_ = static_cast<const T*>(q);
    const auto k_ = static_cast<const T*>(k);
    const auto v_ = static_cast<const T*>(v);
    const auto do_ = static_cast<const T*>(d_o);
    const auto lens_ = static_cast<const int*>(lens);
    const auto lse_ = static_cast<const float*>(lse);
    const auto delta_ = static_cast<const float*>(delta);
    const size_t tiles_smem = sizeof(T) * (2 * OWN * TL::SD
                                           + 4 * TL::BS * TL::SD)
                              + sizeof(float) * OWN * TL::SP;

    if (Tk > 0) {
        const size_t smem = tiles_smem
                            + sizeof(float) * (4 * TL::BS + OWN * TL::SP);
        cudaError_t err = cudaFuncSetAttribute(
            flash_bwd_dkdv_kernel<D, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        const int tiles = (Tk + OWN - 1) / OWN;
        if (tiles > 65535) return cudaErrorInvalidValue;
        flash_bwd_dkdv_kernel<D, T><<<dim3(BH / group, tiles,
                                           D / out_cols(D)),
                                      32 * WARPS, smem, stream>>>(
            q_, k_, v_, lens_, do_, lse_, delta_, static_cast<T*>(dk),
            static_cast<T*>(dv), H, group, Tq, Tk, mk, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }

    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tiles_smem);
    if (err != cudaSuccess) return err;
    const int tiles = (Tq + OWN - 1) / OWN;
    if (tiles > 65535) return cudaErrorInvalidValue;
    flash_bwd_dq_kernel<D, T><<<dim3(BH, tiles, D / out_cols(D)),
                                32 * WARPS, tiles_smem, stream>>>(
        q_, k_, v_, lens_, do_, lse_, delta_, static_cast<T*>(dq), H,
        group, Tq, Tk, mk, scale);
    return cudaGetLastError();
}

template <typename T>
int bwd_entry(const void* q, const void* k, const void* v, const void* lens,
              const void* d_o, const void* lse, const void* delta, void* dq,
              void* dk, void* dv, int BH, int H, int group, int Tq, int Tk,
              int D, int causal, int left, int right, float scale,
              int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (BH < 1 || Tq < 1 || Tk < 0 || group < 1 || H < 1 || BH % group != 0)
        return cudaErrorInvalidValue;
    const flash::Mask mk = {causal, left, right};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS q, k, v, lens, d_o, lse, delta, dq, dk, dv, BH, H, group, \
                 Tq, Tk, mk, scale, st
    switch (D) {
        case 16: return launch_bwd<16, T>(BWD_ARGS);
        case 32: return launch_bwd<32, T>(BWD_ARGS);
        case 64: return launch_bwd<64, T>(BWD_ARGS);
        case 128: return launch_bwd<128, T>(BWD_ARGS);
        case 256: return launch_bwd<256, T>(BWD_ARGS);
        default: return cudaErrorInvalidValue;
    }
#undef BWD_ARGS
}

}  // namespace

extern "C" {

// q, dO, dq: (BH, Tq, D) float32; k, v, dk, dv: (BH / group, Tk, D); lse,
// delta: (BH, Tq); lens: (BH / H,) int32 or null.  D is 16, 32, 64, 128 or 256;
// left/right -1 for an unbounded window side.  All pointers 16-byte
// aligned.  Launches the dk/dv kernel, then the dq kernel, on `stream`.
// Returns cudaGetLastError() after the launches.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* lens, const void* d_o, const void* lse,
                        const void* delta, void* dq, void* dk, void* dv,
                        int BH, int H, int group, int Tq, int Tk, int D,
                        int causal, int left, int right, float scale,
                        int device, void* stream) {
    return bwd_entry<float>(q, k, v, lens, d_o, lse, delta, dq, dk, dv, BH,
                            H, group, Tq, Tk, D, causal, left, right, scale,
                            device, stream);
}

}  // extern "C"
