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
// (16, 32, 64, 128) and ragged Tq/Tk are bounds checks, so the separator's
// D = 16 heads do no padded work.
//
// Design: one block per (batch * head, query tile).  A query row belongs to
// a group of G lanes (flash_attention_common.cuh) that keep the scaled q
// row, the output accumulator, the running maximum m and the running sum l
// in registers.  K and V stream through shared memory in tiles of 64 keys;
// every thread walks the tile's keys in chunks of 8: eight logits, one new
// maximum, one rescale of (l, acc), eight probabilities.  Masked
// probabilities are set to zero explicitly, so a fully masked row ends with
// l = 0 and gives 0 output (lse = -1e30).  The tile loop covers only keys
// that some row of the tile can see (kv_len, causal, window), so causal
// attention does about half the work and a window O(T * W).  Grouped-query
// attention reads KV row bh / group directly.  The order of every sum is
// fixed: two runs give the same bits.
#include <cuda_runtime.h>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

constexpr int CH = 8;  // keys per online-softmax update

// q, o: (BH, Tq, D); k, v: (BH / group, Tk, D); lens: (BH / H,) or nullptr;
// lse: (BH, Tq) or nullptr.  Shared memory: K tile, V tile, (TILE, D) each.
template <int D, int G>
__global__ void __launch_bounds__(256) flash_fwd_kernel(
        const float4* __restrict__ q, const float4* __restrict__ k,
        const float4* __restrict__ v, const int* __restrict__ lens,
        float4* __restrict__ o, float* __restrict__ lse, int H, int group,
        int Tq, int Tk, int rows, Mask mk, float scale) {
    constexpr int D4 = D / 4;
    constexpr int NV = D4 / G;
    extern __shared__ float4 smem[];
    float4* k_s = smem;
    float4* v_s = smem + TILE * D4;

    const int bh = blockIdx.x;
    const int r0 = blockIdx.y * rows;
    const int row = r0 + threadIdx.x / G;
    const int g = threadIdx.x % G;
    const bool live = row < Tq;
    int kv_len = Tk;
    if (lens != nullptr) {
        kv_len = lens[bh / H];
        kv_len = kv_len < 0 ? 0 : (kv_len > Tk ? Tk : kv_len);
    }
    const float4* k_bh = k + (size_t)(bh / group) * Tk * D4;
    const float4* v_bh = v + (size_t)(bh / group) * Tk * D4;

    float4 qr[NV], acc[NV];
    load_row<NV, G>(qr, q + ((size_t)bh * Tq + (live ? row : 0)) * D4, g,
                    live);
    scale_row<NV>(qr, scale);
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = NEG, l = 0.0f;

    // keys that some row of this tile can see: [lo, hi)
    int hi = kv_len;
    if (mk.causal) {
        hi = min(hi, r0 + rows);
    } else if (mk.right >= 0) {
        hi = min(hi, r0 + rows + mk.right);
    }
    int lo = 0;
    if (mk.left >= 0) lo = max(0, r0 - mk.left) / TILE * TILE;

    for (int j0 = lo; j0 < hi; j0 += TILE) {
        __syncthreads();
        stage_tile<D>(k_s, k_bh, j0, Tk);
        stage_tile<D>(v_s, v_bh, j0, Tk);
        __syncthreads();
        const int n = min(TILE, hi - j0);
        for (int jj = 0; jj < n; jj += CH) {
            float s[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c)
                s[c] = dot_share<NV, G>(qr, k_s + (jj + c) * D4, g);
            float mx = m;
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                s[c] = group_sum<G>(s[c]);
                if (!visible(mk, row, j0 + jj + c, kv_len)) s[c] = NEG;
                mx = fmaxf(mx, s[c]);
            }
            const float alpha = expf(m - mx);
            l *= alpha;
            scale_row<NV>(acc, alpha);
            m = mx;
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                // a masked logit is exactly NEG, a visible one far above it
                const float p = s[c] > 0.5f * NEG ? expf(s[c] - mx) : 0.0f;
                l += p;
                axpy_row<NV, G>(acc, p, v_s + (jj + c) * D4, g);
            }
        }
    }

    if (!live) return;
    const float l_safe = fmaxf(l, 1e-30f);
    scale_row<NV>(acc, 1.0f / l_safe);
    store_row<NV, G>(o + ((size_t)bh * Tq + row) * D4, acc, g);
    if (lse != nullptr && g == 0) lse[(size_t)bh * Tq + row] = m + logf(l_safe);
}

template <int D, int G>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* lens, void* o, void* lse, int BH, int H,
                       int group, int Tq, int Tk, Mask mk, float scale,
                       cudaStream_t stream) {
    const int rows = rows_per_block(Tq, max_rows(G));
    const size_t smem = sizeof(float4) * 2 * TILE * (D / 4);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles = (Tq + rows - 1) / rows;
    if (tiles > 65535) return cudaErrorInvalidValue;
    dim3 grid(BH, tiles);
    flash_fwd_kernel<D, G><<<grid, rows * G, smem, stream>>>(
        static_cast<const float4*>(q), static_cast<const float4*>(k),
        static_cast<const float4*>(v), static_cast<const int*>(lens),
        static_cast<float4*>(o), static_cast<float*>(lse), H, group, Tq, Tk,
        rows, mk, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (BH, Tq, D) float32; k, v: (BH / group, Tk, D); lens: (BH / H,)
// int32 valid key counts or null; lse: (BH, Tq) or null (inference).
// D is 16, 32, 64 or 128; left/right -1 for an unbounded window side.  All
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
    switch (D) {
        case 16:
            return launch_fwd<16, 1>(q, k, v, lens, o, lse, BH, H, group, Tq,
                                     Tk, mk, scale, st);
        case 32:
            return launch_fwd<32, 1>(q, k, v, lens, o, lse, BH, H, group, Tq,
                                     Tk, mk, scale, st);
        case 64:
            return launch_fwd<64, 2>(q, k, v, lens, o, lse, BH, H, group, Tq,
                                     Tk, mk, scale, st);
        case 128:
            return launch_fwd<128, 4>(q, k, v, lens, o, lse, BH, H, group,
                                      Tq, Tk, mk, scale, st);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"
