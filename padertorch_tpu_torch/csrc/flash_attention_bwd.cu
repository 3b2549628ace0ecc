// Backward of exact softmax attention: dq, dk, dv recomputed tile by tile
// from q, k, v, dO, the stored log-sum-exp and delta = sum(dO * O, -1),
// never forming the (Tq, Tk) probabilities in device memory.
//
// Replaces: padertorch_tpu/ops/pallas/attention.py, the backward of
// `flash_attention` through `_bwd_call` (kernel `_dqkv_kernel`).
//
// What bounds it on the card: the arithmetic.  The TPU kernel visits every
// (query block, key block) tile once and adds each tile's dq into a block
// that stays resident across its sequential grid.  Blocks on a GPU run in
// no order, so that carry does not exist here, and adding into dq with
// atomics would make the sum's order change from run to run.  Instead two
// kernels, each owning its outputs outright:
//   dk/dv: one block per (batch * kv head, key tile); a key row belongs to
//     a group of G lanes that keep k, v, dk, dv in registers; the query
//     heads of the group (grouped-query attention) and, per head, the
//     query tiles that can see this key tile stream through shared memory
//     (q, dO, lse, delta).  The group's heads are summed inside the block in
//     head order, so no per-head dk/dv tensor is written.
//   dq: one block per (batch * head, query tile); a query row keeps q, dO,
//     dq, lse and delta in registers; K and V tiles stream through shared
//     memory.
// Both recompute s = scale * q.k and p = exp(s - lse), so the backward
// does 7 tile products where the single-pass kernel does 5; in exchange
// every output element is written once, by one thread, in a fixed order:
// two runs give the same bits.  A masked probability is set to zero
// explicitly, so fully masked rows (lse = -1e30) give zero gradients.  Tile
// loops cover only tiles that some owned row can see (kv_len, causal,
// window).
#include <cuda_runtime.h>

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

__device__ __forceinline__ int clamp_len(const int* lens, int b, int Tk) {
    if (lens == nullptr) return Tk;
    const int n = lens[b];
    return n < 0 ? 0 : (n > Tk ? Tk : n);
}

// q, dO: (BH, Tq, D); k, v, dk, dv: (BH / group, Tk, D); lse, delta:
// (BH, Tq); lens: (BH / H,) or nullptr.  blockIdx.x: kv head row, blockIdx.y:
// key tile.  Shared memory: q tile, dO tile (TILE, D) each, then lse and
// delta (TILE floats each).
template <int D, int G>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_kernel(
        const float4* __restrict__ q, const float4* __restrict__ k,
        const float4* __restrict__ v, const int* __restrict__ lens,
        const float4* __restrict__ d_o, const float* __restrict__ lse,
        const float* __restrict__ delta, float4* __restrict__ dk,
        float4* __restrict__ dv, int H, int group, int Tq, int Tk, int rows,
        Mask mk, float scale) {
    constexpr int D4 = D / 4;
    constexpr int NV = D4 / G;
    extern __shared__ float4 smem[];
    float4* q_s = smem;
    float4* do_s = smem + TILE * D4;
    float* lse_s = reinterpret_cast<float*>(smem + 2 * TILE * D4);
    float* delta_s = lse_s + TILE;

    const int bkv = blockIdx.x;
    const int c0 = blockIdx.y * rows;
    const int col = c0 + threadIdx.x / G;
    const int g = threadIdx.x % G;
    const bool live = col < Tk;
    const int kv_len = clamp_len(lens, (bkv * group) / H, Tk);

    float4 kr[NV], vr[NV], dkr[NV], dvr[NV];
    const size_t kv_at = ((size_t)bkv * Tk + (live ? col : 0)) * D4;
    load_row<NV, G>(kr, k + kv_at, g, live);
    load_row<NV, G>(vr, v + kv_at, g, live);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        dkr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        dvr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    // query rows that can see some key of this tile: [lo, hi)
    int lo = 0;
    if (mk.causal) {
        lo = c0;
    } else if (mk.right >= 0) {
        lo = max(0, c0 - mk.right);
    }
    lo = lo / TILE * TILE;
    int hi = Tq;
    if (mk.left >= 0) hi = min(hi, c0 + rows + mk.left);
    if (c0 >= kv_len) hi = lo;  // every key of the tile is padding

    for (int hq = 0; hq < group; ++hq) {
        const size_t bh = (size_t)bkv * group + hq;
        const float4* q_bh = q + bh * Tq * D4;
        const float4* do_bh = d_o + bh * Tq * D4;
        for (int i0 = lo; i0 < hi; i0 += TILE) {
            __syncthreads();
            stage_tile<D>(q_s, q_bh, i0, Tq);
            stage_tile<D>(do_s, do_bh, i0, Tq);
            for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
                const bool in = i0 + r < Tq;
                lse_s[r] = in ? lse[bh * Tq + i0 + r] : 0.0f;
                delta_s[r] = in ? delta[bh * Tq + i0 + r] : 0.0f;
            }
            __syncthreads();
            const int n = min(TILE, hi - i0);
            for (int r = 0; r < n; ++r) {
                const float4* q_row = q_s + r * D4;
                const float4* do_row = do_s + r * D4;
                const float s =
                    scale * group_sum<G>(dot_share<NV, G>(kr, q_row, g));
                const float dp = group_sum<G>(dot_share<NV, G>(vr, do_row, g));
                const float p = visible(mk, i0 + r, col, kv_len)
                                    ? expf(s - lse_s[r]) : 0.0f;
                const float ds = p * (dp - delta_s[r]);
                axpy_row<NV, G>(dvr, p, do_row, g);
                axpy_row<NV, G>(dkr, ds, q_row, g);
            }
        }
    }

    if (!live) return;
    scale_row<NV>(dkr, scale);
    store_row<NV, G>(dk + ((size_t)bkv * Tk + col) * D4, dkr, g);
    store_row<NV, G>(dv + ((size_t)bkv * Tk + col) * D4, dvr, g);
}

// blockIdx.x: batch * head row, blockIdx.y: query tile.  Shared memory:
// K tile, V tile, (TILE, D) each.
template <int D, int G>
__global__ void __launch_bounds__(256) flash_bwd_dq_kernel(
        const float4* __restrict__ q, const float4* __restrict__ k,
        const float4* __restrict__ v, const int* __restrict__ lens,
        const float4* __restrict__ d_o, const float* __restrict__ lse,
        const float* __restrict__ delta, float4* __restrict__ dq, int H,
        int group, int Tq, int Tk, int rows, Mask mk, float scale) {
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
    const int kv_len = clamp_len(lens, bh / H, Tk);
    const float4* k_bh = k + (size_t)(bh / group) * Tk * D4;
    const float4* v_bh = v + (size_t)(bh / group) * Tk * D4;

    float4 qr[NV], dor[NV], dqr[NV];
    const size_t at = (size_t)bh * Tq + (live ? row : 0);
    load_row<NV, G>(qr, q + at * D4, g, live);
    load_row<NV, G>(dor, d_o + at * D4, g, live);
#pragma unroll
    for (int i = 0; i < NV; ++i) dqr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float lse_r = live ? lse[at] : 0.0f;
    const float delta_r = live ? delta[at] : 0.0f;

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
        for (int jj = 0; jj < n; ++jj) {
            const float4* k_row = k_s + jj * D4;
            const float s =
                scale * group_sum<G>(dot_share<NV, G>(qr, k_row, g));
            const float dp =
                group_sum<G>(dot_share<NV, G>(dor, v_s + jj * D4, g));
            const float p = live && visible(mk, row, j0 + jj, kv_len)
                                ? expf(s - lse_r) : 0.0f;
            axpy_row<NV, G>(dqr, p * (dp - delta_r), k_row, g);
        }
    }

    if (!live) return;
    scale_row<NV>(dqr, scale);
    store_row<NV, G>(dq + at * D4, dqr, g);
}

template <int D, int G>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* lens, const void* d_o, const void* lse,
                       const void* delta, void* dq, void* dk, void* dv, int BH,
                       int H, int group, int Tq, int Tk, Mask mk, float scale,
                       cudaStream_t stream) {
    const auto q4 = static_cast<const float4*>(q);
    const auto k4 = static_cast<const float4*>(k);
    const auto v4 = static_cast<const float4*>(v);
    const auto do4 = static_cast<const float4*>(d_o);
    const auto lens_i = static_cast<const int*>(lens);
    const auto lse_f = static_cast<const float*>(lse);
    const auto delta_f = static_cast<const float*>(delta);

    if (Tk > 0) {
        const int rows = rows_per_block(Tk, max_rows(G));
        const size_t smem =
            sizeof(float4) * 2 * TILE * (D / 4) + sizeof(float) * 2 * TILE;
        cudaError_t err = cudaFuncSetAttribute(
            flash_bwd_dkdv_kernel<D, G>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        const int tiles = (Tk + rows - 1) / rows;
        if (tiles > 65535) return cudaErrorInvalidValue;
        dim3 grid(BH / group, tiles);
        flash_bwd_dkdv_kernel<D, G><<<grid, rows * G, smem, stream>>>(
            q4, k4, v4, lens_i, do4, lse_f, delta_f, static_cast<float4*>(dk),
            static_cast<float4*>(dv), H, group, Tq, Tk, rows, mk, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }

    const int rows = rows_per_block(Tq, max_rows(G));
    const size_t smem = sizeof(float4) * 2 * TILE * (D / 4);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles = (Tq + rows - 1) / rows;
    if (tiles > 65535) return cudaErrorInvalidValue;
    dim3 grid(BH, tiles);
    flash_bwd_dq_kernel<D, G><<<grid, rows * G, smem, stream>>>(
        q4, k4, v4, lens_i, do4, lse_f, delta_f, static_cast<float4*>(dq), H,
        group, Tq, Tk, rows, mk, scale);
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
            return launch_bwd<16, 1>(q, k, v, lens, d_o, lse, delta, dq, dk,
                                     dv, BH, H, group, Tq, Tk, mk, scale, st);
        case 32:
            return launch_bwd<32, 2>(q, k, v, lens, d_o, lse, delta, dq, dk,
                                     dv, BH, H, group, Tq, Tk, mk, scale, st);
        case 64:
            return launch_bwd<64, 4>(q, k, v, lens, d_o, lse, delta, dq, dk,
                                     dv, BH, H, group, Tq, Tk, mk, scale, st);
        case 128:
            return launch_bwd<128, 8>(q, k, v, lens, d_o, lse, delta, dq, dk,
                                      dv, BH, H, group, Tq, Tk, mk, scale,
                                      st);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"
