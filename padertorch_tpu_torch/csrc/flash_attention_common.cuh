// Device and host helpers shared by the flash-attention forward and
// backward kernels.
//
// Thread layout of the forward kernel (the backward's kernels hold their
// rows as tensor-core fragments, flash_attention_bwd.cu): a query row
// belongs to a group of G neighbouring lanes of one warp; lane g of the
// group holds the float4 chunks g, g + G, g + 2G, ... of the row's D values
// (interleaved, so the G lanes read neighbouring 16-byte words of a
// shared-memory row and do not collide on banks).  A dot product over D is
// DPT = D / G FMAs per lane and a butterfly of log2(G) shuffles, after
// which every lane of the group holds the same sum, bit for bit.
#pragma once
#include <cuda_runtime.h>

namespace flash {

constexpr float NEG = -1e30f;   // the finite fill of a masked logit
constexpr int TILE = 64;        // rows of the streamed operand per tile

// Masks of one launch: keys beyond kv_len, causal (cols <= rows), and the
// (left, right) window, -1 for an unbounded side.
struct Mask {
    int causal, left, right;
};

__device__ __forceinline__ bool visible(const Mask& mk, int row, int col,
                                        int kv_len) {
    bool ok = col < kv_len;
    if (mk.causal) ok = ok && col <= row;
    if (mk.left >= 0) ok = ok && row - col <= mk.left;
    if (mk.right >= 0) ok = ok && col - row <= mk.right;
    return ok;
}

// Sum over the G lanes of a group; every lane gets the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// This lane's share of the dot product of a register row and a
// shared-memory row (both in the interleaved chunk layout).
template <int NV, int G>
__device__ __forceinline__ float dot_share(const float4 (&a)[NV],
                                           const float4* row, int g) {
    // four independent chains, so the FMAs do not wait on one another
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const float4 b = row[g + G * i];
        acc.x = fmaf(a[i].x, b.x, acc.x);
        acc.y = fmaf(a[i].y, b.y, acc.y);
        acc.z = fmaf(a[i].z, b.z, acc.z);
        acc.w = fmaf(a[i].w, b.w, acc.w);
    }
    return (acc.x + acc.y) + (acc.z + acc.w);
}

// acc += s * shared-memory row
template <int NV, int G>
__device__ __forceinline__ void axpy_row(float4 (&acc)[NV], float s,
                                         const float4* row, int g) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const float4 b = row[g + G * i];
        acc[i].x = fmaf(s, b.x, acc[i].x);
        acc[i].y = fmaf(s, b.y, acc[i].y);
        acc[i].z = fmaf(s, b.z, acc[i].z);
        acc[i].w = fmaf(s, b.w, acc[i].w);
    }
}

template <int NV>
__device__ __forceinline__ void scale_row(float4 (&acc)[NV], float s) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        acc[i].x *= s; acc[i].y *= s; acc[i].z *= s; acc[i].w *= s;
    }
}

// Load a register row from device memory (zeros when `live` is false).
template <int NV, int G>
__device__ __forceinline__ void load_row(float4 (&r)[NV], const float4* src,
                                         int g, bool live) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
        r[i] = live ? src[g + G * i] : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int NV, int G>
__device__ __forceinline__ void store_row(float4* dst, const float4 (&r)[NV],
                                          int g) {
#pragma unroll
    for (int i = 0; i < NV; ++i) dst[g + G * i] = r[i];
}

// Stage rows [j0, j0 + TILE) of a (T, D) matrix into shared memory, zeros
// beyond T.  All threads of the block take part.
template <int D>
__device__ __forceinline__ void stage_tile(float4* dst, const float4* src,
                                           int j0, int T) {
    constexpr int D4 = D / 4;
    for (int idx = threadIdx.x; idx < TILE * D4; idx += blockDim.x) {
        const int j = j0 + idx / D4;
        dst[idx] = j < T ? src[(size_t)j0 * D4 + idx]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// Rows of the owned operand per block: the T rows are split evenly over
// the fewest blocks of at most `max_rows` rows, rounded up to a multiple
// of 32 (max_rows is one).
inline int rows_per_block(int T, int max_rows) {
    const int n = (T + max_rows - 1) / max_rows;
    const int per = (T + n - 1) / n;
    return (per + 31) / 32 * 32;
}

// A block has at most 256 threads, a row G of them.
inline int max_rows(int G) {
    const int r = 256 / G;
    return r > 128 ? 128 : r;
}

}  // namespace flash
