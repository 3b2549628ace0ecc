// Device helpers shared by the flash-attention forward and backward
// kernels: masks, cp.async copies into padded shared-memory tiles, the
// 3xTF32 tensor-core products of the float32 kernels, and the bf16 packing
// and stores of the bf16 kernels (which run on `wgmma`:
// flash_attention_fwd_bf16.cu and flash_attention_bwd_bf16.cu, their Hopper
// parts in flash_attention_hopper.cuh).
//
// The tensor cores take float32 operands only as TF32, which keeps 10 bits
// of mantissa (about three digits), too few for float32 results.  So every
// product is split ("3xTF32"): an operand x becomes hi, x with its 13 low
// mantissa bits cleared, and lo = x - hi, and a product accumulates
// lo*hi + hi*lo + hi*hi in float32 (`mma.sync.m16n8k8` with TF32
// operands), which carries about 20 bits of each operand: float32 accuracy
// for three tensor-core products per float32 one.
//
// A block owns OWN = 64 rows (queries in the forward and the dq kernel,
// keys in the dk/dv kernel), 16 per warp, held as MMA fragments: a thread
// holds rows lane / 4 and lane / 4 + 8 of its warp's 16, and columns
// 2 (lane % 4) and 2 (lane % 4) + 1 of every 8-wide tile.  Shared-memory
// rows are padded by 16 bytes (D + 4 floats; BS + 4 for the float32 P and
// dS), so the fragment loads of the first kind (8 rows by 4 words) hit 32
// banks; the transposed loads (4 rows by 8 columns) meet 2-way conflicts.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;   // the finite fill of a masked logit
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;
constexpr int OWN = 16 * WARPS;  // owned rows per block, 16 per warp

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

// Is every (query, key) pair of rows [q_lo, q_hi) and keys [k_lo, k_hi)
// visible?  Then a tile skips the test per pair.
__device__ __forceinline__ bool tile_visible(const Mask& mk, int q_lo,
                                             int q_hi, int k_lo, int k_hi,
                                             int Tq, int kv_len) {
    return q_hi <= Tq && k_hi <= kv_len && (!mk.causal || k_hi - 1 <= q_lo)
           && (mk.left < 0 || q_hi - 1 - k_lo <= mk.left)
           && (mk.right < 0 || k_hi - 1 - q_lo <= mk.right);
}

// The valid key count of batch row b: lens[b] clamped to [0, Tk], or Tk.
__device__ __forceinline__ int clamp_len(const int* lens, int b, int Tk) {
    if (lens == nullptr) return Tk;
    const int n = lens[b];
    return n < 0 ? 0 : (n > Tk ? Tk : n);
}

// The output columns a block of head size D computes: all of them up to
// D = 128; at D = 256 half, the halves on a grid dimension of their own
// (a warp's 16 x 256 float32 accumulator would take 128 registers a
// thread).
__host__ __device__ constexpr int out_cols(int D) { return D > 128 ? 128 : D; }

// Tile sizes of head size D with BS rows of the streamed operand per tile,
// for inputs of type T: the padded strides SD (of a (rows, D) tile of T,
// 16 bytes of padding) and SP (of a warp's (16, BS) float32 P or dS), the
// MMA tiles of 8 along D (ND) and along the streamed rows (NS), and the
// partial sums of a product whose output is D wide (NP: two at D = 16, for
// more independent accumulator chains).
template <int D, int BS_, typename T = float>
struct TileShape {
    static constexpr int BS = BS_;
    static constexpr int SD = D + 16 / (int)sizeof(T);
    static constexpr int SP = BS + 4;
    static constexpr int ND = D / 8;
    static constexpr int NS = BS / 8;
    static constexpr int NP = D == 16 ? 2 : 1;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
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

// Start the copy of rows [r0, r0 + ROWS) of a (n_rows, D) matrix of T into
// shared memory of stride D + 16 / sizeof(T) (zeros beyond n_rows), 16
// bytes a copy: 4 float32 or 8 bf16 values (a bf16 row of D = 16 is two).
// All threads take part.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0,
                                           int n_rows) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int C = D / E;
    constexpr int SD = D + E;
    for (int idx = threadIdx.x; idx < ROWS * C; idx += blockDim.x) {
        const int r = idx / C;
        const int c = E * (idx % C);
        T* d = dst + r * SD + c;
        if (r0 + r < n_rows) {
            cp_async16(d, src + (size_t)(r0 + r) * D + c);
        } else {
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
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

// c (16, 8 N) += A (16, 8 K) B with B k-major (stride ldb), A row-major
// (stride lda).  The k step kk adds into the partial sums [kk % NP]; the
// caller adds them in order.  With LIM only the first `lim` rows of B
// count (a tile at the end of the sequence): the k steps past them are
// skipped.  Full tiles take LIM false, which keeps the loops free of exits.
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

// ---- bf16 values

// Two float32 values rounded to bf16 (to nearest even) and packed, the
// first in the low half: the operand order of a fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// Store two float32 values as the pair of T at dst: a float2, or two bf16
// values rounded once.
__device__ __forceinline__ void store2(float* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* dst, float x, float y) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x, y);
}

}  // namespace flash
