// Forward of exact softmax attention for bf16 q, k, v on Hopper's
// warpgroup tensor cores: O and (for training) the log-sum-exp per query
// row, without the (Tq, Tk) logits in device memory.
//
// Replaces: padertorch_tpu/ops/pallas/attention.py, `flash_attention`
// through `_fwd_call` (kernel `_fwd_kernel`) for bf16 inputs (the float32
// kernel is csrc/flash_attention.cu).
//
// The JAX kernel's numerics for bf16 q, k, v: S = Q K^T from bf16
// operands with float32 sums (each product exact, as the float32 dot of
// the widened values); the online softmax, its maxima and sums float32; P
// rounded to bf16 only as the operand of P V, against the running maximum
// of the key tiles so far (tiles of ROWS = 64 keys from key 0, as the
// plain version's `key_tile=64`); O accumulated in float32 (rescaled, then
// the tile's product added on the tensor cores) and rounded to bf16 once;
// the log-sum-exp float32.
//
// What bounds it on the card: the arithmetic, 4 * D operations per visible
// (query, key) pair at the tensor cores' bf16 rate, and beside it the
// exponentials (one per pair, 16 a clock on an SM: at D = 64 as many
// clocks as the products).  A design on `mma.sync` (Q in registers, K and
// V by cp.async) reached 15% to 21% of the bound on an H100: `mma.sync`
// runs at about a quarter of the tensor cores' rate on this card.
//
// Design, as the bf16 backward's (csrc/flash_attention_bwd_bf16.cu; the
// Hopper parts in flash_attention_hopper.cuh).  A block owns WG * 64 query
// rows of one (batch, head), one consumer warpgroup (128 threads) for each
// 64 and no producer warp: thread 0 brings the block's Q tiles once and
// the K and V tiles (64 keys each) into a ring of STAGES stages by TMA, in
// the 128-, 64- or 32-byte swizzle of the rows' width, each stage
// completing on its own `full` mbarrier; every warp releases a stage on an
// `empty` mbarrier once its products have read it, and thread 0 refills
// it.  Per key tile i a warpgroup issues S_i = Q K_i^T (`wgmma.m64n64k16`,
// both operands K-major from shared memory) and behind it the previous
// tile's P V (`wgmma.m64nNk16`, N at most 128: P the register A operand,
// the accumulator layout of S being the A layout; V the MN-major B
// operand, transposed by the descriptor), waits for both, then takes the
// online softmax of S_i in the accumulators (a row's 64 columns over the
// four lanes of a quad), rescales O and rounds P_i to bf16 in registers.
// (With the softmax running while P V was in flight, ptxas serialized the
// products, C7520, and the kernel was slower on an H100.)  Tiles whose
// pairs are all visible take the softmax without the test per element;
// the others test each pair with selects.  The warpgroups and blocks that
// share an SM overlap one's softmax with another's products.  Tile loops
// cover only the tiles some row of the block sees (key padding, causal,
// window), each warpgroup computing only the tiles some row of its own
// sees.  Grouped-query attention reads KV head bh / group.  A block
// computes all D output columns at every head size (at D = 256 128 float
// accumulators a thread; splitting the columns over two blocks, each
// recomputing S, was slower on an H100).  A masked probability is exactly
// 0, so a row
// that sees no key ends with l = 0, O = 0 and lse = -1e30.  Every sum in a
// fixed order and no atomics: two runs give the same bits.
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
using flash::NEG;
using namespace hopper;

// 2^x on the special-function unit (subnormal results flushed to zero)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The online softmax of one key tile in a warpgroup's S accumulators (64
// queries by 64 keys j0 ...; a thread holds rows qa and qb, columns
// 8 n + 2 (lane % 4) + e % 2): masked logits become -inf (no part of the
// maximum, p = 0); the running maxima m (log2 units) and sums l of the
// thread's rows are updated, and s is replaced by p = 2^(s scale2 - m).
// alpha_a, alpha_b rescale what was summed before this tile.  `all`: every
// pair of the tile is visible, and the test per element is skipped.
// Fewer instructions an element than the float32 kernel's softmax_tile
// (csrc/flash_attention.cu): the exponentials on `ex2.approx.ftz`, the
// maximum over the unscaled logits (scale2 > 0 gives the same number), two
// partial chains a row; with softmax_tile this kernel was slower on an
// H100.
__device__ __forceinline__ void softmax_rows(
        float (&s)[ROWS / 8][4], float& m_a, float& m_b, float& l_a,
        float& l_b, float& alpha_a, float& alpha_b, bool all, const Mask& mk,
        int qa, int qb, int j0, int Tq, int kv_len, float scale2, int lane) {
    if (!all) {
#pragma unroll
        for (int n = 0; n < ROWS / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = e >= 2 ? qb : qa;
                const int col = j0 + n * 8 + 2 * (lane & 3) + (e & 1);
                bool keep = (row < Tq) & (col < kv_len);
                if (mk.causal) keep &= col <= row;
                if (mk.left >= 0) keep &= row - col <= mk.left;
                if (mk.right >= 0) keep &= col - row <= mk.right;
                s[n][e] = keep ? s[n][e] : -INFINITY;
            }
        }
    }
    // two partial maxima and sums a row: shorter dependent chains
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < ROWS / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e] = fmaxf(mx[e], s[n][e]);
    }
    float mx_a = fmaxf(mx[0], mx[1]), mx_b = fmaxf(mx[2], mx[3]);
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    mx_a = fmaxf(m_a, mx_a * scale2);
    mx_b = fmaxf(m_b, mx_b * scale2);
    alpha_a = ex2(m_a - mx_a);
    alpha_b = ex2(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < ROWS / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[n][e], scale2, e >= 2 ? -mx_b : -mx_a));
            sum[e] += p;
            s[n][e] = p;
        }
    }
    float sum_a = sum[0] + sum[1], sum_b = sum[2] + sum[3];
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    l_a = fmaf(l_a, alpha_a, sum_a);
    l_b = fmaf(l_b, alpha_b, sum_b);
}

// The shape of a block of head size D: WG consumer warpgroups of 64 query
// rows, a ring of STAGES K/V stages.
template <int D, int WG, int STAGES>
struct Fwd {
    static constexpr int THREADS = 128 * WG;
    static constexpr int QROWS = ROWS * WG;
    static constexpr int TILE = ROWS * D;      // a Q, K or V tile's elements
    static constexpr size_t SMEM =
        sizeof(bf16) * (WG + 2 * STAGES) * TILE
        + sizeof(uint64_t) * (1 + 2 * STAGES) + ALIGN;
};

// q, o: (BH, Tq, D) through mq; k, v: (BH / group, Tk, D) through mk, mv
// (bf16, maps of dims {D, T, BH}); lens: (BH / H,) or nullptr; lse: (BH,
// Tq) float32 or nullptr.  blockIdx.x: batch x head row, blockIdx.y: tile
// of WG * 64 queries.  Shared memory: Q tiles | K tiles, one per stage |
// V tiles, one per stage | mbarriers: Q, full per stage, empty per stage.
template <int D, int WG, int STAGES, int BPS>
__global__ void __launch_bounds__(128 * WG, BPS) fwd_kernel(
        const __grid_constant__ CUtensorMap mq,
        const __grid_constant__ CUtensorMap mk,
        const __grid_constant__ CUtensorMap mv,
        const int* __restrict__ lens, bf16* __restrict__ o,
        float* __restrict__ lse, int H, int group, int Tq, int Tk, Mask msk,
        float scale) {
    using F = Fwd<D, WG, STAGES>;
    constexpr int TILE = F::TILE;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* q_s = aligned(smem_raw);
    bf16* k_s = q_s + WG * TILE;
    bf16* v_s = k_s + STAGES * TILE;
    uint64_t* q_bar = reinterpret_cast<uint64_t*>(v_s + STAGES * TILE);
    uint64_t* full = q_bar + 1;
    uint64_t* empty = full + STAGES;

    const int bh = blockIdx.x;
    const int r0 = blockIdx.y * F::QROWS;
    const int kv_len = clamp_len(lens, bh / H, Tk);
    const int kvh = bh / group;
    // keys that some row of the block can see: [lo, hi), lo on a tile
    // boundary (the key tiles are those of key 0)
    int hi = kv_len;
    if (msk.causal) {
        hi = min(hi, r0 + F::QROWS);
    } else if (msk.right >= 0) {
        hi = min(hi, r0 + F::QROWS + msk.right);
    }
    int lo = 0;
    if (msk.left >= 0) lo = max(0, r0 - msk.left) / ROWS * ROWS;
    const int total = hi > lo ? (hi - lo + ROWS - 1) / ROWS : 0;
    // warpgroups with a query row below Tq
    const int busy = min(WG, (Tq - r0 + ROWS - 1) / ROWS);

    const int tid = threadIdx.x;
    // key tile i into its stage, K and V, by thread 0
    auto load = [&](int i) {
        const int st = i % STAGES;
        const int j0 = lo + i * ROWS;
        mbar_arrive_expect_tx(&full[st], 2 * TILE * sizeof(bf16));
        tma_tile<D>(k_s + st * TILE, &mk, j0, kvh, &full[st]);
        tma_tile<D>(v_s + st * TILE, &mv, j0, kvh, &full[st]);
    };
    if (tid == 0) {
        mbar_init(q_bar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * WG);   // lane 0 of every warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        mbar_arrive_expect_tx(q_bar, busy * TILE * sizeof(bf16));
        for (int w = 0; w < busy; ++w)
            tma_tile<D>(q_s + w * TILE, &mq, r0 + w * ROWS, bh, q_bar);
        for (int i = 0; i < STAGES && i < total; ++i) load(i);
    }
    __syncthreads();  // the mbarriers initialised

    const int wg = tid >> 7;   // this thread's warpgroup
    const int lane = tid & 31;
    const int rw0 = r0 + wg * ROWS;       // this warpgroup's first row
    const bool active = wg < busy;
    // keys some row of this warpgroup can see: [lo_w, hi_w)
    int hi_w = kv_len;
    if (msk.causal) {
        hi_w = min(hi_w, rw0 + ROWS);
    } else if (msk.right >= 0) {
        hi_w = min(hi_w, rw0 + ROWS + msk.right);
    }
    const int lo_w = msk.left >= 0 ? max(0, rw0 - msk.left) : 0;
    // this thread's two rows of the accumulators
    const int qa = rw0 + 16 * ((tid & 127) >> 5) + (lane >> 2);
    const int qb = qa + 8;
    const float scale2 = scale * LOG2E;
    const bf16* q_w = q_s + wg * TILE;
    float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;
    // the key tiles this warpgroup computes: [ia, ib) of the block's
    const int ia = active && lo_w > lo ? (lo_w - lo) / ROWS : 0;
    const int ib = active && hi_w > lo
                       ? max(ia, min(total, (hi_w - lo + ROWS - 1) / ROWS))
                       : ia;
    // this warp is done with tile r's stage; thread 0 refills it with tile
    // r + STAGES once every warp is
    auto release = [&](int r) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[r % STAGES]);
        if (tid == 0 && r + STAGES < total) {
            mbar_wait(&empty[r % STAGES], (r / STAGES) & 1);
            load(r + STAGES);
        }
    };
    // O += P V of the tile in stage `st` (V's keys along K, its columns
    // along N, at most 128 a product; P the register A operand)
    constexpr int NV = D < 128 ? D : 128;
    auto add_pv = [&](const uint32_t (&pa)[ROWS / 16][4], int st) {
        const bf16* v_t = v_s + st * TILE;
#pragma unroll
        for (int kc = 0; kc < ROWS / 16; ++kc) {
#pragma unroll
            for (int c = 0; c < D / NV; ++c) {
                wgmma_rs<NV>(acc + c * NV / 2, pa[kc],
                             mn_major<D>(v_t, c * NV, kc), 1);
            }
        }
        wgmma_commit();
    };
    // S = Q K^T of the tile in stage `st`: queries by keys
    auto qk = [&](float (&sv)[ROWS / 8][4], int st) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            wgmma_ss<ROWS>(&sv[0][0], k_major<D>(q_w, kk),
                           k_major<D>(k_s + st * TILE, kk), kk > 0);
        }
        wgmma_commit();
    };
    // the online softmax of tile i in sv, and its P rounded to bf16 as
    // the A operand of keys [16 kc, 16 kc + 16): the S accumulators of
    // columns 2 kc and 2 kc + 1
    auto softmax_p = [&](float (&sv)[ROWS / 8][4], int i, float& alpha_a,
                         float& alpha_b, uint32_t (&pa)[ROWS / 16][4]) {
        const int j0 = lo + i * ROWS;
        const bool all = flash::tile_visible(msk, rw0, rw0 + ROWS, j0,
                                             j0 + ROWS, Tq, kv_len);
        softmax_rows(sv, m_a, m_b, l_a, l_b, alpha_a, alpha_b, all, msk, qa,
                     qb, j0, Tq, kv_len, scale2, lane);
#pragma unroll
        for (int kc = 0; kc < ROWS / 16; ++kc) {
            pa[kc][0] = flash::pack_bf16(sv[2 * kc][0], sv[2 * kc][1]);
            pa[kc][1] = flash::pack_bf16(sv[2 * kc][2], sv[2 * kc][3]);
            pa[kc][2] = flash::pack_bf16(sv[2 * kc + 1][0], sv[2 * kc + 1][1]);
            pa[kc][3] = flash::pack_bf16(sv[2 * kc + 1][2], sv[2 * kc + 1][3]);
        }
    };
    auto wait_full = [&](int i) {
        mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    };
    if (active) mbar_wait(q_bar, 0);
    // tiles no row of this warpgroup sees go back as they come
    int i = 0;
    for (; i < ia; ++i) {
        wait_full(i);
        release(i);
    }
    if (ia < ib) {
        // the first tile: S alone (the running O is zero)
        uint32_t p[ROWS / 16][4];
        {
            wait_full(i);
            float s[ROWS / 8][4];
            wgmma_fence();
            qk(s, i % STAGES);
            wgmma_wait_all();
            fence_regs<ROWS / 2>(&s[0][0]);
            float alpha_a, alpha_b;
            softmax_p(s, i, alpha_a, alpha_b, p);
        }
        // then S of tile i and the P V of tile i - 1 in one wait, and the
        // softmax of tile i
        for (++i; i < ib; ++i) {
            wait_full(i);
            float s[ROWS / 8][4];
            wgmma_fence();
            qk(s, i % STAGES);
            add_pv(p, (i - 1) % STAGES);
            wgmma_wait_all();
            fence_regs<ROWS / 2>(&s[0][0]);
            fence_regs<D / 2>(acc);
            release(i - 1);
            float alpha_a, alpha_b;
            softmax_p(s, i, alpha_a, alpha_b, p);
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                acc[4 * n] *= alpha_a;
                acc[4 * n + 1] *= alpha_a;
                acc[4 * n + 2] *= alpha_b;
                acc[4 * n + 3] *= alpha_b;
            }
            // the rescaled O defined before the next products' fence
            fence_regs<D / 2>(acc);
        }
        // the last tile's P V
        wgmma_fence();
        add_pv(p, (ib - 1) % STAGES);
        wgmma_wait_all();
        fence_regs<D / 2>(acc);
        release(ib - 1);
    }
    for (; i < total; ++i) {
        wait_full(i);
        release(i);
    }
    if (!active) return;

    const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
    const int c = 2 * (lane & 3);
    bf16* o_bh = o + (size_t)bh * Tq * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        if (qa < Tq) {
            flash::store2(o_bh + (size_t)qa * D + c + 8 * n,
                          acc[4 * n] * inv_a, acc[4 * n + 1] * inv_a);
        }
        if (qb < Tq) {
            flash::store2(o_bh + (size_t)qb * D + c + 8 * n,
                          acc[4 * n + 2] * inv_b, acc[4 * n + 3] * inv_b);
        }
    }
    if (lse != nullptr && (lane & 3) == 0) {
        // m + log(l) in natural units; a row that saw no key keeps -1e30
        constexpr float LN2 = 0.6931471805599453f;
        if (qa < Tq)
            lse[(size_t)bh * Tq + qa] =
                l_a > 0.0f ? fmaf(m_a, LN2, logf(l_a)) : NEG;
        if (qb < Tq)
            lse[(size_t)bh * Tq + qb] =
                l_b > 0.0f ? fmaf(m_b, LN2, logf(l_b)) : NEG;
    }
}

// No key at all (Tk = 0): O is zero and the log-sum-exp -1e30.
__global__ void no_key_kernel(bf16* o, float* lse, size_t n_o, size_t n_lse) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_o;
         i += (size_t)gridDim.x * blockDim.x) {
        o[i] = __float2bfloat16_rn(0.0f);
        if (lse != nullptr && i < n_lse) lse[i] = NEG;
    }
}

template <int D, int WG, int STAGES, int BPS>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* lens, void* o, void* lse, int BH, int H,
                       int group, int Tq, int Tk, Mask msk, float scale,
                       cudaStream_t stream) {
    using F = Fwd<D, WG, STAGES>;
    if (Tk == 0) {
        const size_t n_o = (size_t)BH * Tq * D;
        no_key_kernel<<<(int)((n_o + 255) / 256 < 4096 ? (n_o + 255) / 256
                                                        : 4096),
                        256, 0, stream>>>(static_cast<bf16*>(o),
                                          static_cast<float*>(lse), n_o,
                                          (size_t)BH * Tq);
        return cudaGetLastError();
    }
    CUtensorMap mq, mk, mv;
    cudaError_t err = tile_map<D>(q, BH, Tq, &mq);
    if (err == cudaSuccess) err = tile_map<D>(k, BH / group, Tk, &mk);
    if (err == cudaSuccess) err = tile_map<D>(v, BH / group, Tk, &mv);
    if (err != cudaSuccess) return err;
    auto kernel = fwd_kernel<D, WG, STAGES, BPS>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)F::SMEM);
    if (err != cudaSuccess) return err;
    const int tiles = (Tq + F::QROWS - 1) / F::QROWS;
    if (tiles > 65535) return cudaErrorInvalidValue;
    kernel<<<dim3(BH, tiles), F::THREADS, F::SMEM, stream>>>(
        mq, mk, mv, static_cast<const int*>(lens), static_cast<bf16*>(o),
        static_cast<float*>(lse), H, group, Tq, Tk, msk, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (BH, Tq, D) bf16; k, v: (BH / group, Tk, D) bf16; lens: (BH / H,)
// int32 valid key counts or null; lse: (BH, Tq) float32 or null
// (inference).  D is 16, 32, 64, 128 or 256; left/right -1 for an
// unbounded window side.  All pointers 16-byte aligned.  Returns
// cudaGetLastError() after the launch.  Per head size: (warpgroups,
// stages, blocks an SM), the registers of a thread capped for the last.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* lens, void* o, void* lse, int BH,
                             int H, int group, int Tq, int Tk, int D,
                             int causal, int left, int right, float scale,
                             int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (BH < 1 || Tq < 1 || Tk < 0 || group < 1 || H < 1 || BH % group != 0)
        return cudaErrorInvalidValue;
    const Mask msk = {causal, left, right};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_ARGS q, k, v, lens, o, lse, BH, H, group, Tq, Tk, msk, scale, st
    switch (D) {
        case 16: return launch_fwd<16, 1, 2, 4>(FWD_ARGS);
        case 32: return launch_fwd<32, 1, 2, 4>(FWD_ARGS);
        case 64: return launch_fwd<64, 2, 3, 2>(FWD_ARGS);
        case 128: return launch_fwd<128, 2, 3, 1>(FWD_ARGS);
        case 256: return launch_fwd<256, 2, 2, 1>(FWD_ARGS);
        default: return cudaErrorInvalidValue;
    }
#undef FWD_ARGS
}

}  // extern "C"
