// Exact softmax attention without the (Tq, Tk) logits in device memory:
// forward pass, writing O and (for training) the log-sum-exp per query row.
//
// Replaces: padertorch_tpu/ops/pallas/attention.py, `flash_attention`
// through `_fwd_call` (kernel `_fwd_kernel`).
//
// What bounds it on the card: the arithmetic, 4 * Tq * Tk_visible * D
// float32 operations per (batch, head) against one read of q, k, v and one
// write of o.  The TPU kernel pads D to 128 lanes and T to 512-wide blocks
// for its matrix unit; neither is carried over: D is a template parameter
// (16, 32, 64, 128, 256; the wrapper zero-pads other head sizes to the
// next) and ragged Tq/Tk are bounds checks, so the separator's D = 16
// heads do no padded work.  At D = 256 a warp's 16 x 256 float32 output
// alone would take 128 registers a thread, so the output's columns are
// split over a third grid dimension: each block computes S and the softmax
// over the whole head and P V for DO = 128 columns (blockIdx.z; DO = D
// below 256, one block as before), and the z = 0 block writes the LSE.
//
// Design: one block per (batch * head, tile of 64 queries), four warps of
// 16 query rows each, as the backward's dq kernel.  The two products of a
// key tile run on the tensor cores as 3xTF32 (flash_attention_common.cuh).
// Q of the tile is split once into hi/lo fragments in registers (up to
// D = 64; at D = 128 the registers hold the output instead and Q's
// fragments are loaded per tile from shared memory).  K and V stream
// through shared memory in tiles of BS keys, double-buffered with
// cp.async.  Per tile a warp forms S = Q K^T (16 queries by BS keys) in
// its accumulator fragments, takes the online softmax there (row maxima
// and sums over the quad of lanes that shares a row, masks per element,
// skipped where every pair of the tile is visible), passes P through
// shared memory into the A-operand layout and forms O_tile = P V.  The
// running output is rescaled and O_tile added in float32 outside the
// tensor cores (one tensor-core sum per tile, as in the backward).  P is
// exp2 of log2(e)-scaled logits; a masked probability is exactly 0, so a
// fully masked row ends with l = 0, O = 0 and lse = -1e30.  The tile loop
// covers only keys that some row of the tile can see (kv_len, causal,
// window), so causal attention does about half the work and a window
// O(T * W).  Grouped-query attention reads KV row bh / group directly.
// The order of every sum is fixed and there are no atomics: two runs give
// the same bits.
//
// The bf16 forward is csrc/flash_attention_fwd_bf16.cu (`wgmma` from TMA
// tiles).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// BS keys per tile: 64 up to D = 64 (fewer softmax updates per key), 32 at
// D = 128 (so that two blocks share an SM).
template <int D>
using FwdTiles = TileShape<D, (D <= 64 ? 64 : 32)>;

// The online softmax of one key tile on a warp's S fragments (16 queries
// by 8 NS keys, keys j0 ...): masked logits become -inf (no part of the
// maximum, p = 0), the running maxima m (log2 units) and sums l of the
// thread's two rows are updated, and s is replaced by p = exp2(s * scale2
// - m).  alpha_a, alpha_b rescale what was summed before this tile.  With
// LIM only the keys below nv were computed.
template <bool LIM, int NS>
__device__ __forceinline__ void softmax_tile(
        float (&s)[NS][4], float& m_a, float& m_b, float& l_a, float& l_b,
        float& alpha_a, float& alpha_b, bool all, const Mask& mk, int qa,
        int qb, int j0, int nv, int Tq, int kv_len, float scale2,
        int lane) {
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
        if (LIM && n * 8 >= nv) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const bool b = e >= 2;
            const int col = j0 + n * 8 + 2 * (lane & 3) + (e & 1);
            if (!all && !((b ? qb : qa) < Tq
                          && visible(mk, b ? qb : qa, col, kv_len)))
                s[n][e] = -INFINITY;
            const float x = s[n][e] * scale2;
            if (b) {
                mx_b = fmaxf(mx_b, x);
            } else {
                mx_a = fmaxf(mx_a, x);
            }
        }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    alpha_a = exp2f(m_a - mx_a);
    alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
        if (LIM && n * 8 >= nv) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const bool b = e >= 2;
            const float p = exp2f(fmaf(s[n][e], scale2, -(b ? mx_b : mx_a)));
            if (b) {
                sum_b += p;
            } else {
                sum_a += p;
            }
            s[n][e] = p;
        }
    }
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    l_a = fmaf(l_a, alpha_a, sum_a);
    l_b = fmaf(l_b, alpha_b, sum_b);
}

// q, o: (BH, Tq, D); k, v: (BH / group, Tk, D); lens: (BH / H,) or
// nullptr; lse: (BH, Tq) or nullptr.  blockIdx.x: batch * head row,
// blockIdx.y: query tile.  Shared memory: Q (OWN, SD) | K, V two stages of
// (BS, SD) each | P (OWN, SP).
template <int D>
__global__ void __launch_bounds__(32 * WARPS) flash_fwd_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const int* __restrict__ lens,
        float* __restrict__ o, float* __restrict__ lse, int H, int group,
        int Tq, int Tk, Mask mk, float scale) {
    using TL = FwdTiles<D>;
    constexpr int BS = TL::BS, SD = TL::SD, SP = TL::SP;
    constexpr int ND = TL::ND, NS = TL::NS, NP = TL::NP;
    // the block's output columns [col0, col0 + DO): NO tiles of 8
    constexpr int DO = out_cols(D), NO = DO / 8;
    const int col0 = blockIdx.z * DO;
    constexpr bool QREG = D <= 64;   // Q's fragments in registers
    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);
    float* k_s = q_s + OWN * SD;
    float* v_s = k_s + 2 * BS * SD;
    float* p_s = reinterpret_cast<float*>(v_s + 2 * BS * SD);

    const int lane = threadIdx.x & 31;
    const int row_w = (threadIdx.x >> 5) * 16;  // the warp's first query
    const int bh = blockIdx.x;
    const int r0 = blockIdx.y * OWN;
    const int kv_len = clamp_len(lens, bh / H, Tk);
    const float scale2 = scale * LOG2E;
    const float* k_bh = k + (size_t)(bh / group) * Tk * D;
    const float* v_bh = v + (size_t)(bh / group) * Tk * D;
    stage_rows<D, OWN>(q_s, q + (size_t)bh * Tq * D, r0, Tq);
    cp_async_commit();

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
    if (total > 0) {
        stage(0);
        cp_async_wait<1>();   // Q has landed
    } else {
        cp_async_wait<0>();
    }
    __syncthreads();

    const float* qw = q_s + row_w * SD;
    uint32_t qh[QREG ? ND : 1][4], ql[QREG ? ND : 1][4];
    if constexpr (QREG) {
#pragma unroll
        for (int kk = 0; kk < ND; ++kk)
            load_a(qw + kk * 8, SD, lane, qh[kk], ql[kk]);
    }

    // this thread's two rows of the fragments, and their softmax state:
    // the running maximum (log2 units) and sum
    const int qa = r0 + row_w + (lane >> 2);
    const int qb = qa + 8;
    float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;
    float acc[NO][4] = {};
    float* pw = p_s + row_w * SP;
    // a warp whose 16 queries are all past Tq has nothing to compute
    const bool idle = r0 + row_w >= Tq;
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
        // a tile past the end of the keys that count takes the loops
        // with exits
        auto tile = [&](auto lim) {
            constexpr bool LIM = decltype(lim)::value;
            float s[NS][4] = {};
#pragma unroll
            for (int kk = 0; kk < ND; ++kk) {
                uint32_t ah[4], al[4];
                if constexpr (QREG) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        ah[e] = qh[kk][e];
                        al[e] = ql[kk][e];
                    }
                } else {
                    load_a(qw + kk * 8, SD, lane, ah, al);
                }
#pragma unroll
                for (int n = 0; n < NS; ++n) {
                    if (LIM && n * 8 >= nv) break;
                    uint32_t bh[2], bl[2];
                    load_b<false>(k_t + n * 8 * SD + kk * 8, SD, lane,
                                  bh, bl);
                    mma3(s[n], ah, al, bh, bl);
                }
            }
            float alpha_a, alpha_b;
            softmax_tile<LIM, NS>(s, m_a, m_b, l_a, l_b, alpha_a,
                                  alpha_b, all, mk, qa, qb, j0, nv, Tq,
                                  kv_len, scale2, lane);
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                if (LIM && n * 8 >= nv) break;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    pw[((lane >> 2) + (e >= 2 ? 8 : 0)) * SP + n * 8
                       + 2 * (lane & 3) + (e & 1)] = s[n][e];
                }
            }
            __syncwarp();
            float o_t[NP][NO][4] = {};
            gemm_kn<LIM, NS, NO, NP>(o_t, pw, SP, v_t + col0, SD, nv,
                                     lane);
#pragma unroll
            for (int n = 0; n < NO; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float t = o_t[0][n][e];
#pragma unroll
                    for (int j = 1; j < NP; ++j) t += o_t[j][n][e];
                    acc[n][e] = fmaf(acc[n][e],
                                     e >= 2 ? alpha_b : alpha_a, t);
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
    if (idle) return;

    const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
    const int c = 2 * (lane & 3);
    float* o_bh = o + (size_t)bh * Tq * D + col0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        if (qa < Tq) {
            store2(o_bh + (size_t)qa * D + n * 8 + c, acc[n][0] * inv_a,
                   acc[n][1] * inv_a);
        }
        if (qb < Tq) {
            store2(o_bh + (size_t)qb * D + n * 8 + c, acc[n][2] * inv_b,
                   acc[n][3] * inv_b);
        }
    }
    if (lse != nullptr && (lane & 3) == 0 && blockIdx.z == 0) {
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

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* lens, void* o, void* lse, int BH, int H,
                       int group, int Tq, int Tk, Mask mk, float scale,
                       cudaStream_t stream) {
    using TL = FwdTiles<D>;
    const size_t smem = sizeof(float) * (OWN * TL::SD + 4 * TL::BS * TL::SD
                                         + OWN * TL::SP);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles = (Tq + OWN - 1) / OWN;
    if (tiles > 65535) return cudaErrorInvalidValue;
    flash_fwd_kernel<D><<<dim3(BH, tiles, D / out_cols(D)), 32 * WARPS, smem,
                          stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(lens),
        static_cast<float*>(o), static_cast<float*>(lse), H, group, Tq, Tk,
        mk, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (BH, Tq, D) float32; k, v: (BH / group, Tk, D); lens: (BH / H,)
// int32 valid key counts or null; lse: (BH, Tq) or null (inference).
// D is 16, 32, 64, 128 or 256; left/right -1 for an unbounded window side.  All
// pointers 16-byte aligned.  Returns cudaGetLastError() after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* lens, void* o, void* lse, int BH, int H,
                        int group, int Tq, int Tk, int D, int causal,
                        int left, int right, float scale, int device,
                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (BH < 1 || Tq < 1 || Tk < 0 || group < 1 || H < 1 || BH % group != 0)
        return cudaErrorInvalidValue;
    const flash::Mask mk = {causal, left, right};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_ARGS q, k, v, lens, o, lse, BH, H, group, Tq, Tk, mk, scale, st
    switch (D) {
        case 16: return launch_fwd<16>(FWD_ARGS);
        case 32: return launch_fwd<32>(FWD_ARGS);
        case 64: return launch_fwd<64>(FWD_ARGS);
        case 128: return launch_fwd<128>(FWD_ARGS);
        case 256: return launch_fwd<256>(FWD_ARGS);
        default: return cudaErrorInvalidValue;
    }
#undef FWD_ARGS
}

}  // extern "C"
