// Backward of exact softmax attention: dq, dk, dv recomputed tile by tile
// from q, k, v, dO, the stored log-sum-exp and delta = sum(dO * O, -1),
// never forming the (Tq, Tk) probabilities in device memory.
//
// Replaces: padertorch_tpu/ops/pallas/attention.py, the backward of
// `flash_attention` through `_bwd_call` (kernel `_dqkv_kernel`).
//
// What bounds it on the card: the arithmetic, five tile products per
// visible (query, key) pair: S = Q K^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K.  On the CUDA cores in float32 that is 67
// TFLOP/s at best; the tensor cores take float32 operands only as TF32,
// which keeps 10 bits of mantissa (about three digits), too few for the
// gradients' limit.  So every product is split ("3xTF32"): an operand x
// becomes hi, x with its 13 low mantissa bits cleared, and lo = x - hi,
// and a product accumulates lo*hi + hi*lo + hi*hi in float32
// (`mma.sync.m16n8k8` with TF32 operands), which carries about 20 bits
// of each operand: float32 accuracy for three tensor-core products per
// float32 one.
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
// Shared-memory rows are padded to D + 4 floats (and BS + 4), so the
// fragment loads of the first kind (8 rows by 4 columns) hit 32 banks;
// the transposed loads (4 rows by 8 columns) of the second product of
// each pair meet 2-way conflicts.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 4;
constexpr int OWN = 16 * WARPS;  // owned rows per block, 16 per warp

// Tile sizes of head size D: BS rows of the streamed operand per tile
// (fewer for wide heads, so that two blocks share an SM), the padded
// strides SD (of a (rows, D) tile) and SP (of a warp's (16, BS) P or dS),
// and the MMA tiles of 8 along D (ND) and along the streamed rows (NS).
template <int D>
struct Tiles {
    static constexpr int BS = D <= 32 ? 64 : 32;
    static constexpr int SD = D + 4;
    static constexpr int SP = BS + 4;
    static constexpr int ND = D / 8;
    static constexpr int NS = BS / 8;
    static constexpr int NP = D == 16 ? 2 : 1;  // partial sums of dq, dk, dv
    // the tile sums of dV and dK in one loop (D = 128 has registers for
    // one at a time)
    static constexpr bool PAIR = D <= 64;
};

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ int clamp_len(const int* lens, int b, int Tk) {
    if (lens == nullptr) return Tk;
    const int n = lens[b];
    return n < 0 ? 0 : (n > Tk ? Tk : n);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo exactly: hi is x with the 13 low mantissa bits cleared (a
// TF32 value), lo the rest, which the MMA reads as TF32 by its leading 19
// bits (the tensor core ignores the low 13 bits of a TF32 operand).  What
// 3xTF32 drops is lo's low bits and the lo * lo term, about 2^-20 of the
// product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
    mma(c, al, bh);
    mma(c, ah, bl);
    mma(c, ah, bh);
}

// The A fragment of the (16, 8) block at s (row-major, stride ld).
__device__ __forceinline__ void load_a(const float* s, int ld, int lane,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int r = lane >> 2, c = lane & 3;
    split(s[r * ld + c], hi[0], lo[0]);
    split(s[(r + 8) * ld + c], hi[1], lo[1]);
    split(s[r * ld + c + 4], hi[2], lo[2]);
    split(s[(r + 8) * ld + c + 4], hi[3], lo[3]);
}

// The B fragment (8 deep, 8 wide) at s of an operand kept n-major,
// B[k][n] = s[n * ld + k] (K or Q rows as the columns of a product), or,
// with KN, kept k-major, B[k][n] = s[k * ld + n].
template <bool KN>
__device__ __forceinline__ void load_b(const float* s, int ld, int lane,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
    const int n = lane >> 2, k = lane & 3;
    if (KN) {
        split(s[k * ld + n], hi[0], lo[0]);
        split(s[(k + 4) * ld + n], hi[1], lo[1]);
    } else {
        split(s[n * ld + k], hi[0], lo[0]);
        split(s[n * ld + k + 4], hi[1], lo[1]);
    }
}

// Two independent products in one loop over K (twice the independent
// accumulator chains of one): c1 (16, 8 N) += A1 (16, 8 K) B1 and c2 +=
// A2 B2, A row-major (stride lda), B n-major (KN false: the (8 N, 8 K)
// matrix at b is B^T) or k-major (KN true), stride ldb.  The k step kk
// adds into the partial sums [kk % NP] (NP > 1 where N is small, for more
// chains); the partial sums are added in order at the end by the caller.
// With LIM only the first `lim` streamed rows count (a tile at the end of
// the sequence): the n tiles (n-major) or k steps (k-major) past them are
// skipped.  Full tiles take LIM false, which keeps the loops free of exits.
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

// One product as gemm2's first: c (16, 8 N) += A (16, 8 K) B, B k-major.
template <bool LIM, int K, int N, int NP>
__device__ __forceinline__ void gemm_kn(float (&c)[NP][N][4], const float* a,
                                        int lda, const float* b, int ldb,
                                        int lim, int lane) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
        if (LIM && kk * 8 >= lim) break;
        uint32_t ah[4], al[4];
        load_a(a + kk * 8, lda, lane, ah, al);
#pragma unroll
        for (int n = 0; n < N; ++n) {
            uint32_t bh[2], bl[2];
            load_b<true>(b + kk * 8 * ldb + n * 8, ldb, lane, bh, bl);
            mma3(c[kk % NP][n], ah, al, bh, bl);
        }
    }
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

// Is every (query, key) pair of rows [q_lo, q_hi) and keys [k_lo, k_hi)
// visible?  Then a tile skips the test per pair.
__device__ __forceinline__ bool tile_visible(const Mask& mk, int q_lo,
                                             int q_hi, int k_lo, int k_hi,
                                             int Tq, int kv_len) {
    return q_hi <= Tq && k_hi <= kv_len && (!mk.causal || k_hi - 1 <= q_lo)
           && (mk.left < 0 || q_hi - 1 - k_lo <= mk.left)
           && (mk.right < 0 || k_hi - 1 - q_lo <= mk.right);
}

// Start the copy of rows [r0, r0 + ROWS) of a (T, D) matrix into shared
// memory of stride D + 4 (zeros beyond T).  All threads take part.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int T) {
    constexpr int C4 = D / 4;
    constexpr int SD = D + 4;
    for (int idx = threadIdx.x; idx < ROWS * C4; idx += blockDim.x) {
        const int r = idx / C4;
        const int c = 4 * (idx % C4);
        float* d = dst + r * SD + c;
        if (r0 + r < T) {
            cp_async16(d, src + (size_t)(r0 + r) * D + c);
        } else {
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
}

// Store a warp's (16, D) accumulator, its NP partial sums added in order
// and times `scale`, as rows row0 ... row0 + 15 of a (T, D) matrix; rows at
// or beyond T are not stored.
template <int D, int NP>
__device__ __forceinline__ void store_acc(float* dst,
                                          float (&acc)[NP][D / 8][4],
                                          int row0, int T, float scale,
                                          int lane) {
    const int ra = row0 + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            x[e] = acc[0][n][e];
#pragma unroll
            for (int i = 1; i < NP; ++i) x[e] += acc[i][n][e];
            x[e] *= scale;
        }
        if (ra < T) {
            *reinterpret_cast<float2*>(dst + (size_t)ra * D + n * 8 + c) =
                make_float2(x[0], x[1]);
        }
        if (ra + 8 < T) {
            *reinterpret_cast<float2*>(dst + (size_t)(ra + 8) * D + n * 8
                                       + c) = make_float2(x[2], x[3]);
        }
    }
}

// q, dO: (BH, Tq, D); k, v, dk, dv: (BH / group, Tk, D); lse, delta:
// (BH, Tq); lens: (BH / H,) or nullptr.  blockIdx.x: kv head row,
// blockIdx.y: key tile.  Shared memory: K, V (OWN, SD) | Q, dO two stages
// of (BS, SD) each | lse * log2(e), delta two stages of BS each | P^T,
// dS^T (OWN, SP) each.
template <int D>
__global__ void __launch_bounds__(32 * WARPS) flash_bwd_dkdv_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const int* __restrict__ lens,
        const float* __restrict__ d_o, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dk,
        float* __restrict__ dv, int H, int group, int Tq, int Tk, Mask mk,
        float scale) {
    using TL = Tiles<D>;
    constexpr int BS = TL::BS, SD = TL::SD, SP = TL::SP;
    constexpr int ND = TL::ND, NS = TL::NS, NP = TL::NP;
    extern __shared__ float4 smem4[];
    float* k_s = reinterpret_cast<float*>(smem4);
    float* v_s = k_s + OWN * SD;
    float* q_s = v_s + OWN * SD;
    float* do_s = q_s + 2 * BS * SD;
    float* lse_s = do_s + 2 * BS * SD;
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

    float dk_acc[NP][ND][4] = {};
    float dv_acc[NP][ND][4] = {};
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
        const float* q_t = q_s + st * BS * SD;
        const float* do_t = do_s + st * BS * SD;
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
            gemm2<LIM, false, ND, NS, 1>(s, k_s + row_w * SD, q_t, dp,
                                         v_s + row_w * SD, do_t, SD, SD, nv,
                                         lane);
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
                float dv_t[NP][ND][4] = {};
                float dk_t[NP][ND][4] = {};
                gemm2<LIM, true, NS, ND, NP>(dv_t, pw, do_t, dk_t, dsw, q_t,
                                             SP, SD, nv, lane);
                add_into(dv_acc, dv_t);
                add_into(dk_acc, dk_t);
            } else {
                // registers for one tile sum at a time
                {
                    float dv_t[NP][ND][4] = {};
                    gemm_kn<LIM, NS, ND, NP>(dv_t, pw, SP, do_t, SD, nv,
                                             lane);
                    add_into(dv_acc, dv_t);
                }
                {
                    float dk_t[NP][ND][4] = {};
                    gemm_kn<LIM, NS, ND, NP>(dk_t, dsw, SP, q_t, SD, nv,
                                             lane);
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

    store_acc<D, NP>(dk + (size_t)bkv * Tk * D, dk_acc, c0 + row_w, Tk,
                     scale, lane);
    store_acc<D, NP>(dv + (size_t)bkv * Tk * D, dv_acc, c0 + row_w, Tk,
                     1.0f, lane);
}

// blockIdx.x: batch * head row, blockIdx.y: query tile.  Shared memory:
// Q, dO (OWN, SD) | K, V two stages of (BS, SD) each | dS (OWN, SP).
template <int D>
__global__ void __launch_bounds__(32 * WARPS) flash_bwd_dq_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const int* __restrict__ lens,
        const float* __restrict__ d_o, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dq, int H,
        int group, int Tq, int Tk, Mask mk, float scale) {
    using TL = Tiles<D>;
    constexpr int BS = TL::BS, SD = TL::SD, SP = TL::SP;
    constexpr int ND = TL::ND, NS = TL::NS, NP = TL::NP;
    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);
    float* do_s = q_s + OWN * SD;
    float* k_s = do_s + OWN * SD;
    float* v_s = k_s + 2 * BS * SD;
    float* ds_s = v_s + 2 * BS * SD;

    const int lane = threadIdx.x & 31;
    const int row_w = (threadIdx.x >> 5) * 16;  // the warp's first query
    const int bh = blockIdx.x;
    const int r0 = blockIdx.y * OWN;
    const int kv_len = clamp_len(lens, bh / H, Tk);
    const float scale2 = scale * LOG2E;
    const float* k_bh = k + (size_t)(bh / group) * Tk * D;
    const float* v_bh = v + (size_t)(bh / group) * Tk * D;
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

    float dq_acc[NP][ND][4] = {};
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
        const float* k_t = k_s + st * BS * SD;
        const float* v_t = v_s + st * BS * SD;
        const int nv = min(BS, hi - j0);  // keys of the tile that count
        const bool all = tile_visible(mk, r0, r0 + OWN, j0, j0 + BS, Tq,
                                      kv_len);
        auto tile = [&](auto lim) {
            constexpr bool LIM = decltype(lim)::value;
            float s[1][NS][4] = {};
            float dp[1][NS][4] = {};
            gemm2<LIM, false, ND, NS, 1>(s, q_s + row_w * SD, k_t, dp,
                                         do_s + row_w * SD, v_t, SD, SD, nv,
                                         lane);
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
            float dq_t[NP][ND][4] = {};
            gemm_kn<LIM, NS, ND, NP>(dq_t, dw, SP, k_t, SD, nv, lane);
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

    store_acc<D, NP>(dq + (size_t)bh * Tq * D, dq_acc, r0 + row_w, Tq,
                     scale, lane);
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* lens, const void* d_o, const void* lse,
                       const void* delta, void* dq, void* dk, void* dv, int BH,
                       int H, int group, int Tq, int Tk, Mask mk, float scale,
                       cudaStream_t stream) {
    using TL = Tiles<D>;
    const auto q_ = static_cast<const float*>(q);
    const auto k_ = static_cast<const float*>(k);
    const auto v_ = static_cast<const float*>(v);
    const auto do_ = static_cast<const float*>(d_o);
    const auto lens_ = static_cast<const int*>(lens);
    const auto lse_ = static_cast<const float*>(lse);
    const auto delta_ = static_cast<const float*>(delta);
    const size_t tiles_smem = sizeof(float) * (2 * OWN * TL::SD
                                               + 4 * TL::BS * TL::SD
                                               + OWN * TL::SP);

    if (Tk > 0) {
        const size_t smem = tiles_smem
                            + sizeof(float) * (4 * TL::BS + OWN * TL::SP);
        cudaError_t err = cudaFuncSetAttribute(
            flash_bwd_dkdv_kernel<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        const int tiles = (Tk + OWN - 1) / OWN;
        if (tiles > 65535) return cudaErrorInvalidValue;
        flash_bwd_dkdv_kernel<D><<<dim3(BH / group, tiles), 32 * WARPS,
                                   smem, stream>>>(
            q_, k_, v_, lens_, do_, lse_, delta_, static_cast<float*>(dk),
            static_cast<float*>(dv), H, group, Tq, Tk, mk, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }

    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tiles_smem);
    if (err != cudaSuccess) return err;
    const int tiles = (Tq + OWN - 1) / OWN;
    if (tiles > 65535) return cudaErrorInvalidValue;
    flash_bwd_dq_kernel<D><<<dim3(BH, tiles), 32 * WARPS, tiles_smem,
                             stream>>>(
        q_, k_, v_, lens_, do_, lse_, delta_, static_cast<float*>(dq), H,
        group, Tq, Tk, mk, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dO, dq: (BH, Tq, D) float32; k, v, dk, dv: (BH / group, Tk, D); lse,
// delta: (BH, Tq); lens: (BH / H,) int32 or null.  D is 16, 32, 64 or 128;
// left/right -1 for an unbounded window side.  All pointers 16-byte
// aligned.  Launches the dk/dv kernel, then the dq kernel, on `stream`.
// Returns cudaGetLastError() after the launches.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* lens, const void* d_o, const void* lse,
                        const void* delta, void* dq, void* dk, void* dv,
                        int BH, int H, int group, int Tq, int Tk, int D,
                        int causal, int left, int right, float scale,
                        int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (BH < 1 || Tq < 1 || Tk < 0 || group < 1 || H < 1 || BH % group != 0)
        return cudaErrorInvalidValue;
    const flash::Mask mk = {causal, left, right};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16:
            return launch_bwd<16>(q, k, v, lens, d_o, lse, delta, dq, dk, dv,
                                  BH, H, group, Tq, Tk, mk, scale, st);
        case 32:
            return launch_bwd<32>(q, k, v, lens, d_o, lse, delta, dq, dk, dv,
                                  BH, H, group, Tq, Tk, mk, scale, st);
        case 64:
            return launch_bwd<64>(q, k, v, lens, d_o, lse, delta, dq, dk, dv,
                                  BH, H, group, Tq, Tk, mk, scale, st);
        case 128:
            return launch_bwd<128>(q, k, v, lens, d_o, lse, delta, dq, dk,
                                   dv, BH, H, group, Tq, Tk, mk, scale, st);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"
