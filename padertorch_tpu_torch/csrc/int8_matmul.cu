// Weight-only int8 matrix product: out = cast((x @ w_q) * scale + bias).
//
// Replaces: padertorch_tpu/ops/pallas/int8_matmul.py, `int8_matmul`
// through `_int8_matmul_2d` (kernel `_kernel`), the product inside
// `QuantizedLinear.forward` (padertorch_tpu/quantize.py).
//
// What bounds it on the card: the bytes of the int8 weights.  Decoding
// runs it at M = 1 to 8 rows of x (up to 256 for a prefill), where it does
// 2 M operations per weight byte, against the 295 bf16 tensor-core
// operations per byte at which the card stops being bound by its memory.
// K * N bytes over 3.35 TB/s is 0.31 us for a (1024, 1024) weight and
// 1.25 us for (1024, 4096), so at the decoder's shapes a call is bound by
// its bytes and costs about one launch.
//
// What the TPU kernel does and what changes here.  The TPU kernel walks a
// grid over N in order, keeps x resident and converts one (K, block_n)
// weight tile at a time on chip.  A card needs many blocks in flight: N =
// 1024 in tiles of 64 columns is 16 blocks for 132 SMs.  So the weight is
// cut in both directions: block (tile, split) owns a tile of columns of
// rows [rows split, rows (split + 1)), with `rows` chosen by the wrapper
// from (K, N) alone (bf16: at most one block of 64 columns on each SM).
//
// bf16 x: one launch on the tensor cores (`int8_matmul_bf16_fwd`).
// - A and B are swapped: the block computes out^T = w_q^T x^T, so its 64
//   weight columns fill the MMA's 64-row side and the rows of x, 8 NG at
//   a time (zero-padded in shared memory), are the narrow N side: one
//   `wgmma.mma_async.m64n(8 NG)k16.f32.bf16.bf16` a k-step, NG = 1, 2, 4 or
//   8 by M.  The instructions of the four widths give each column the same
//   bits (a `cuda` test holds every row of a batch of up to 256 against
//   the row alone), so no row's arithmetic depends on the other rows.
// - A block has four consumer warpgroups and one producer warp.  The
//   producer copies the split's weight slice (up to 1024 rows of 64
//   columns) into shared memory by TMA, one (64 x 64)-byte box per chunk of
//   64 rows, all issued at once and each completing on its own `mbarrier`
//   (64-byte swizzle; rows past K and columns past N arrive as zeros; the
//   tensor map is kept per weight).  A weight whose rows are not 16-byte
//   aligned (N % 16 != 0) is loaded byte by byte into the same layout.
//   Meanwhile the consumers copy x's rows for the pass into the MMA's
//   core-matrix layout (8 rows of 16 bytes) with `cp.async`.
// - Warpgroup g takes chunks g, g + 4, ... of the split.  Widening happens
//   in registers: a thread reads two neighbouring columns of four weight
//   rows (the A fragment's rows r and r + 8 are columns 2 r and 2 r + 1, a
//   permutation of the output columns undone at the store), puts each
//   byte into the mantissa of 2^23 by a byte permute and one subtraction
//   (exact) and keeps the float's upper half, a bf16 that holds the int8
//   value exactly.  The widened weights are A from registers, x^T is B
//   from shared memory by descriptor, and the sums accumulate in float32;
//   each step's A fragment is widened two steps ahead (four fragments in
//   turn, two steps' products in flight).  The warpgroups' products are
//   added in their order in shared memory.
// - Split K and reduce in the same launch: with more than one split each
//   block writes its float32 partial sums; the last block of a column tile
//   to count itself in (an integer counter per tile, which that block
//   resets to 0) adds the splits in index order, multiplies by the scale,
//   adds the bias and casts.  No float atomics, no second launch.
// - What it costs (`chip_smoke.py` phase 20 on an NVIDIA H100 80GB HBM3 at
//   700 W).  At M = 1 a call is a chain of round trips, not bytes: the
//   first TMA box's arrival, the products of the split's rows, the count
//   and the last block's loads of the partial sums; it takes 5 to 20
//   times the bytes bound.  From M = 128 every column tile reads x again
//   from L2 and the partial sums grow with M: the kernel stays ahead of
//   the composed route up to 64 rows (`INT8_KERNEL_MAX_ROWS`).
//
// float32 x keeps the CUDA-core kernel (`int8_matmul_fwd`): a TF32 product
// fails the float32 limit, and the served decoder runs bf16.  Its block
// reads columns [128 tile, 128 tile + 128) of one split; each thread owns
// 16 columns (one 16-byte load of a weight row, widened by the same byte
// permute) and adds its rows in order with fmaf; a second kernel adds the
// splits in order, scales and adds the bias.
//
// Determinism.  Every output element is summed in one fixed order, which
// depends neither on M nor on the launch: the k-steps of a split in order
// (bf16: chained MMAs within a warpgroup, then the warpgroups in order;
// float32: each thread's rows with fmaf, a fixed butterfly of shuffles and
// a fixed order over the warps), then the splits in increasing order.  So
// a row of a batch equals the same row alone, bit for bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 16;            // columns per thread: one 16-byte load
constexpr int N_LANES = 8;         // threads along N in a warp
constexpr int K_LANES_WARP = 4;    // threads along K in a warp
constexpr int K_LANES = K_LANES_WARP * WARPS;  // 32 threads share a column
constexpr int BN = N_LANES * VEC;  // 128 columns per block
constexpr int MT_MAX = 4;          // rows of x per pass (1 when M = 1)
constexpr int UNROLL = 4;          // weight rows in flight per thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(float* out, size_t i, float v) {
    out[i] = v;
}

// byte i of `biased` (= the int8 value + 128) as the float 2^23 + byte,
// minus 2^23 + 128: the int8 value, exactly
__device__ __forceinline__ float widen(uint32_t biased, int i) {
    return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i))
           - 8388736.0f;
}

template <bool VECTOR>
__device__ __forceinline__ uint4 load_row(const int8_t* __restrict__ w,
                                          size_t at, int n, int N) {
    if (VECTOR) {
        return __ldg(reinterpret_cast<const uint4*>(w + at));
    }
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
        const uint32_t b = n + j < N
            ? static_cast<uint32_t>(static_cast<uint8_t>(__ldg(w + at + j)))
            : 0u;
        word[j / 4] |= b << (8 * (j % 4));
    }
    return make_uint4(word[0], word[1], word[2], word[3]);
}

// Partial sums: ws[s, m, n] = sum over rows k of split s of x[m, k] w[k, n].
// Grid (ceil(N / BN), S); shared memory: x (MT, rows) and the warps'
// partial sums (WARPS, MT, BN), float32.
template <typename T, bool VECTOR, int MT>
__global__ void __launch_bounds__(THREADS)
int8_matmul_partial(const T* __restrict__ x, const int8_t* __restrict__ w,
                    float* __restrict__ ws, int M, int K, int N, int rows) {
    extern __shared__ float smem[];
    float* xs = smem;                 // (MT, rows)
    float* red = smem + MT * rows;    // (WARPS, MT, BN)
    const int n0 = blockIdx.x * BN;
    const int k0 = blockIdx.y * rows;
    const int kn = min(rows, K - k0);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int ln = lane % N_LANES;
    const int lk = lane / N_LANES;
    const int kl = warp * K_LANES_WARP + lk;   // this thread's first row
    const int n = n0 + ln * VEC;
    const bool active = n < N;
    float* ws_split = ws + (size_t)blockIdx.y * M * N;

    for (int m0 = 0; m0 < M; m0 += MT) {
        const int mt = min(MT, M - m0);
        __syncthreads();   // the previous pass is done with xs and red
        for (int i = threadIdx.x; i < MT * rows; i += THREADS) {
            const int r = i / rows;
            const int c = i % rows;
            xs[i] = r < mt && c < kn
                ? to_float(x[(size_t)(m0 + r) * K + k0 + c]) : 0.0f;
        }
        __syncthreads();

        float acc[MT][VEC];
#pragma unroll
        for (int r = 0; r < MT; ++r)
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[r][j] = 0.0f;

        if (active) {
            for (int kk = kl; kk < kn; kk += K_LANES * UNROLL) {
                uint4 wv[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int k = kk + u * K_LANES;
                    // a row past the split reads as zeros (and meets x = 0)
                    wv[u] = k < kn
                        ? load_row<VECTOR>(w, (size_t)(k0 + k) * N + n, n, N)
                        : make_uint4(0u, 0u, 0u, 0u);
                    wv[u].x ^= 0x80808080u;   // int8 + 128, byte by byte
                    wv[u].y ^= 0x80808080u;
                    wv[u].z ^= 0x80808080u;
                    wv[u].w ^= 0x80808080u;
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int k = kk + u * K_LANES;
                    const int kc = k < kn ? k : 0;   // x is 0 there anyway
                    const uint32_t words[4] = {wv[u].x, wv[u].y, wv[u].z,
                                               wv[u].w};
                    float wf[VEC];
#pragma unroll
                    for (int j = 0; j < VEC; ++j)
                        wf[j] = widen(words[j / 4], j % 4);
#pragma unroll
                    for (int r = 0; r < MT; ++r) {
                        const float xv = k < kn ? xs[r * rows + kc] : 0.0f;
#pragma unroll
                        for (int j = 0; j < VEC; ++j)
                            acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
                    }
                }
            }
        }
        // the four K lanes of a warp that share a column: a fixed butterfly
#pragma unroll
        for (int r = 0; r < MT; ++r)
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 8);
                acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
            }
        if (lk == 0) {
#pragma unroll
            for (int r = 0; r < MT; ++r)
#pragma unroll
                for (int j = 0; j < VEC; ++j)
                    red[(warp * MT + r) * BN + ln * VEC + j] = acc[r][j];
        }
        __syncthreads();
        // the warps in increasing order
        for (int i = threadIdx.x; i < mt * BN; i += THREADS) {
            const int r = i / BN;
            const int c = i % BN;
            if (n0 + c >= N) continue;
            float sum = red[r * BN + c];
            for (int wi = 1; wi < WARPS; ++wi)
                sum += red[(wi * MT + r) * BN + c];
            ws_split[(size_t)(m0 + r) * N + n0 + c] = sum;
        }
    }
}

// out[m, n] = cast((sum over splits s in order of ws[s, m, n]) * scale[n]
//                  + bias[n]); bias_kind 0: none, 1: float32, 2: bf16.
template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_matmul_epilogue(const float* __restrict__ ws,
                     const float* __restrict__ scale,
                     const void* __restrict__ bias, int bias_kind,
                     T* __restrict__ out, int M, int N, int S) {
    const size_t total = (size_t)M * N;
    const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= total) return;
    const int n = static_cast<int>(i % N);
    float sum = ws[i];
    for (int s = 1; s < S; ++s) sum = __fadd_rn(sum, ws[(size_t)s * total + i]);
    float y = __fmul_rn(sum, scale[n]);
    if (bias_kind == 1)
        y = __fadd_rn(y, static_cast<const float*>(bias)[n]);
    else if (bias_kind == 2)
        y = __fadd_rn(y, __bfloat162float(
                             static_cast<const __nv_bfloat16*>(bias)[n]));
    store(out, i, y);
}

template <typename T, int MT>
int launch_partial(const void* x, const void* w, void* ws, int M, int K,
                   int N, int rows, cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((size_t)MT * rows
                                         + (size_t)WARPS * MT * BN);
    const bool vector = N % VEC == 0
        && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    dim3 grid((N + BN - 1) / BN, (K + rows - 1) / rows);
    if (vector) {
        int8_matmul_partial<T, true, MT><<<grid, THREADS, smem, stream>>>(
            static_cast<const T*>(x), static_cast<const int8_t*>(w),
            static_cast<float*>(ws), M, K, N, rows);
    } else {
        int8_matmul_partial<T, false, MT><<<grid, THREADS, smem, stream>>>(
            static_cast<const T*>(x), static_cast<const int8_t*>(w),
            static_cast<float*>(ws), M, K, N, rows);
    }
    return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           int bias_kind, void* out, void* ws, int M, int K, int N, int rows,
           cudaStream_t stream) {
    const int splits = (K + rows - 1) / rows;
    cudaError_t err = static_cast<cudaError_t>(
        M == 1 ? launch_partial<T, 1>(x, w, ws, M, K, N, rows, stream)
               : launch_partial<T, MT_MAX>(x, w, ws, M, K, N, rows, stream));
    if (err != cudaSuccess) return err;
    const size_t total = (size_t)M * N;
    int8_matmul_epilogue<T><<<(unsigned)((total + THREADS - 1) / THREADS),
                              THREADS, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<const float*>(scale), bias,
        bias_kind, static_cast<T*>(out), M, N, splits);
    return cudaGetLastError();
}

}  // namespace

namespace tc {  // bf16 x on the tensor cores

constexpr int BN = 64;              // weight columns per block: the MMA's M
constexpr int CHUNK = 64;           // weight rows per TMA box and mbarrier
constexpr int MAX_CHUNKS = 16;      // rows per split at most 1024
constexpr int BOX = BN * CHUNK;     // bytes of one box
constexpr int KW = 4;               // consumer warpgroups a block
constexpr int THREADS = 128 * KW;   // consumers; one producer warp more

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n"
        :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one (CHUNK rows, BN columns) box of the weight at (column n, row k) into
// shared memory, 64-byte swizzled, completing on `bar`; rows past K and
// columns past N arrive as zeros
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int n, int k, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(n), "r"(k), "r"(smem_addr(bar))
        : "memory");
}

// 16 bytes from global to shared memory, asynchronously, through L2 only;
// zeros where `valid` is false (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

// byte offset of weight (row k, column c) in a box: the 16-byte piece c / 16
// of a 64-byte row is swizzled with bits 1-2 of the row (TMA's 64B mode)
__device__ __forceinline__ int swizzled(int k, int c) {
    return k * BN + ((((c >> 4) ^ (k >> 1)) & 3) << 4) + (c & 15);
}

// the block's consumer threads (not the producer warp) wait for each other
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Descriptor of a K-major B tile (8 NG rows of x by 16 values) without
// swizzle: core matrices of 8 rows x 16 bytes, 128 bytes apart along K
// (the leading byte offset) and `group` bytes apart along N (the stride
// byte offset).
__device__ __forceinline__ uint64_t b_desc(const void* tile, uint32_t group) {
    const uint64_t addr = smem_addr(tile);
    return ((addr & 0x3FFFFu) >> 4) | (uint64_t(128 >> 4) << 16)
           | (uint64_t((group >> 4) & 0x3FFFu) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t (&a)[4],
                                           uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float* d,
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float* d,
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d,
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d,
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// bytes 0 and 2 (lo) or 1 and 3 of t (int8 values + 128) as two bf16
// values: each byte goes into the mantissa of 2^23, 2^23 + 128 comes off
// (exact), and the float's upper half is the value as a bf16 (exact: at
// most 8 significant bits)
__device__ __forceinline__ uint32_t widen_pair(uint32_t t, int hi) {
    const float f0 = __int_as_float(__byte_perm(t, 0x4B000000u, 0x7440 + hi))
                     - 8388736.0f;
    const float f1 = __int_as_float(
                         __byte_perm(t, 0x4B000000u, 0x7442 + hi))
                     - 8388736.0f;
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The A fragment of k-step `ks` for this thread (warp w of its warpgroup,
// lane 4 r + q): MMA rows 16 w + r and 16 w + r + 8 are weight columns
// 16 w + 2 r and 16 w + 2 r + 1; its k values are 2 q, 2 q + 1, 2 q + 8,
// 2 q + 9 of the step.  All four rows swizzle the same way (piece w ^ q).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const uint8_t* w_s, int ks, int w,
                                       int r, int q) {
    const uint8_t* base = w_s + (16 * ks + 2 * q) * BN + ((w ^ q) << 4)
                          + 2 * r;
    const uint32_t w0 = *reinterpret_cast<const uint16_t*>(base);
    const uint32_t w1 = *reinterpret_cast<const uint16_t*>(base + BN);
    const uint32_t w2 = *reinterpret_cast<const uint16_t*>(base + 8 * BN);
    const uint32_t w3 = *reinterpret_cast<const uint16_t*>(base + 9 * BN);
    const uint32_t t01 = __byte_perm(w0, w1, 0x5410) ^ 0x80808080u;
    const uint32_t t23 = __byte_perm(w2, w3, 0x5410) ^ 0x80808080u;
    a[0] = widen_pair(t01, 0);
    a[1] = widen_pair(t01, 1);
    a[2] = widen_pair(t23, 0);
    a[3] = widen_pair(t23, 1);
}

__device__ __forceinline__ float bias_at(const void* bias, int kind, int n) {
    if (kind == 1) return static_cast<const float*>(bias)[n];
    if (kind == 2)
        return __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
    return 0.0f;
}

__device__ __forceinline__ __nv_bfloat16 finish(float sum, const float* scale,
                                                const void* bias, int kind,
                                                int n) {
    return __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(sum, scale[n]), bias_at(bias, kind, n)));
}

// The last block's reduction (N % 4 == 0): out[m, n0 + j] for the
// tile's columns = finish(sum over splits s in order of ws[s, m, n0 + j]).
// Four columns a thread, ITEMS of them with LOADS splits each in flight
// (a round trip to L2 each): the reduction is bound by this one block's
// loads.
template <int ITEMS, int LOADS>
__device__ __forceinline__ void add_splits(const float* __restrict__ ws,
                                           const float* scale,
                                           const void* bias, int bias_kind,
                                           __nv_bfloat16* __restrict__ out,
                                           int M, int N, int S, int n0,
                                           int width) {
    const size_t split = (size_t)M * N;
    const int quads = width / 4;
    const int items = M * quads;
    for (int base = threadIdx.x; base < items; base += THREADS * ITEMS) {
        float4 sum[ITEMS];
        for (int s0 = 0; s0 < S; s0 += LOADS) {
            float4 part[ITEMS][LOADS];
#pragma unroll
            for (int u = 0; u < ITEMS; ++u) {
                const int it = base + u * THREADS;
                const float* p = ws + (size_t)(it / quads) * N + n0
                                 + 4 * (it % quads);
#pragma unroll
                for (int s = 0; s < LOADS; ++s)
                    part[u][s] = it < items && s0 + s < S
                        ? __ldcg(reinterpret_cast<const float4*>(
                              p + (s0 + s) * split))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < ITEMS; ++u)
#pragma unroll
                for (int s = 0; s < LOADS; ++s) {
                    const float4 v = part[u][s];
                    if (s0 + s == 0) {
                        sum[u] = v;
                    } else if (s0 + s < S) {
                        sum[u].x = __fadd_rn(sum[u].x, v.x);
                        sum[u].y = __fadd_rn(sum[u].y, v.y);
                        sum[u].z = __fadd_rn(sum[u].z, v.z);
                        sum[u].w = __fadd_rn(sum[u].w, v.w);
                    }
                }
        }
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
            const int it = base + u * THREADS;
            if (it >= items) continue;
            const int m = it / quads;
            const int n = n0 + 4 * (it % quads);
            const __nv_bfloat162 lo = __halves2bfloat162(
                finish(sum[u].x, scale, bias, bias_kind, n),
                finish(sum[u].y, scale, bias, bias_kind, n + 1));
            const __nv_bfloat162 hi = __halves2bfloat162(
                finish(sum[u].z, scale, bias, bias_kind, n + 2),
                finish(sum[u].w, scale, bias, bias_kind, n + 3));
            uint2 packed;
            packed.x = *reinterpret_cast<const uint32_t*>(&lo);
            packed.y = *reinterpret_cast<const uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = packed;
        }
    }
}

// bytes of x_s, or of red where that is larger
template <int NG>
__host__ __device__ constexpr size_t xr_bytes(int rows) {
    return (size_t)8 * NG * rows * 2 > (size_t)(KW - 1) * NG * 4 * 128 * 4
        ? (size_t)8 * NG * rows * 2 : (size_t)(KW - 1) * NG * 4 * 128 * 4;
}

// Grid (ceil(N / BN), S); block (tile, split) owns weight columns
// [BN tile, BN tile + BN) and rows [rows split, rows split + rows), and
// has KW warpgroups: warpgroup g takes the split's chunks g, g + KW, ...
// and their partial products are added in the order of g.
// Shared memory: w_s, the split's boxes (rows, BN) bytes, 1024-aligned |
// x_s, the pass's 8 NG rows of x over the split's rows in core matrices:
// value (j, k) at ((j / 8) (rows / 8) + k / 8) 64 + (j % 8) 8 + k % 8,
// and in the same place after the products red, (KW - 1, NG, 4, 128)
// floats of the other warpgroups' products | MAX_CHUNKS mbarriers.
// ws: (S, M, N) float32 partial sums; counters: one per tile, 0 between
// launches.  tma: N % 16 == 0 and w 16-byte aligned (`map` describes w);
// x_vec: x 16-byte aligned and K % 8 == 0.
template <int NG>
__global__ void __launch_bounds__(THREADS + 32)
int8_matmul_bf16(const __grid_constant__ CUtensorMap map,
                 const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w, const float* __restrict__ scale,
                 const void* __restrict__ bias, int bias_kind,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                 unsigned* __restrict__ counters, int M, int K, int N,
                 int rows, int tma, int x_vec) {
    constexpr int MP = 8 * NG;                   // rows of x per pass
    extern __shared__ __align__(16) uint8_t smem_raw[];
    __shared__ int is_last;
    // the boxes' swizzle repeats every 512 bytes of shared memory address
    uint8_t* w_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(
        w_s + (size_t)rows * BN);
    float* red = reinterpret_cast<float*>(x_s);  // once x_s is done
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        w_s + (size_t)rows * BN + xr_bytes<NG>(rows));
    const int tid = threadIdx.x;
    const int wg = tid >> 7;                     // warpgroup
    const int t128 = tid & 127;
    const int warp = t128 >> 5;
    const int lane = tid & 31;
    const int r = lane >> 2;
    const int q = lane & 3;
    const int S = gridDim.y;
    const int n0 = blockIdx.x * BN;
    const int k0 = blockIdx.y * rows;
    const int kn = min(rows, K - k0);           // weight rows of this split
    const int n_chunks = (kn + CHUNK - 1) / CHUNK;
    const int kg_n = rows / 8;                   // core matrices along K
    const int col = 16 * warp + 2 * r;           // this thread's column pair

    // the split's weight slice: one TMA box per chunk, all issued at once
    // by the producer warp (the last one) while the consumers stage x; the
    // block barrier after the consumers' first copies orders the
    // mbarriers' initialisation before any wait
    if (tid >= THREADS) {
        if (tid == THREADS) {
            if (tma)
                asm volatile("prefetch.tensormap [%0];\n"
                             :: "l"(reinterpret_cast<uint64_t>(&map))
                             : "memory");
            for (int c = 0; c < n_chunks; ++c) mbar_init(&bars[c], 1);
            asm volatile("fence.mbarrier_init.release.cluster;\n"
                         ::: "memory");
            if (tma) {
                for (int c = 0; c < n_chunks; ++c) {
                    mbar_arrive_expect_tx(&bars[c], BOX);
                    tma_box(w_s + c * BOX, &map, n0, k0 + c * CHUNK,
                            &bars[c]);
                }
            }
        }
        __syncthreads();
        return;
    }

    for (int m0 = 0; m0 < M; m0 += MP) {
        // stage the pass's rows of x (zero past M and past K)
        if (x_vec) {
            for (int i = tid; i < MP * kg_n; i += THREADS) {
                const int j = (i >> 3) / kg_n * 8 + (i & 7);
                const int kg = (i >> 3) % kg_n;
                const int m = m0 + j;
                const int k = k0 + 8 * kg;
                const bool valid = m < M && k < K;
                cp_async16(x_s + 8 * i, valid ? x + (size_t)m * K + k : x,
                           valid);
            }
            asm volatile("cp.async.wait_all;\n" ::: "memory");
        } else {
            for (int i = tid; i < MP * rows; i += THREADS) {
                const int e = i & 7;
                const int j = (i >> 6) / kg_n * 8 + ((i >> 3) & 7);
                const int kg = (i >> 6) % kg_n;
                const int m = m0 + j;
                const int k = k0 + 8 * kg + e;
                x_s[i] = m < M && k < K
                    ? x[(size_t)m * K + k] : __float2bfloat16_rn(0.0f);
            }
        }
        if (m0 == 0) {
            __syncthreads();   // with the producer warp: mbarriers ready
            if (!tma) {
                // a weight whose rows are not 16-byte aligned: byte loads
                // into the same swizzled layout, zeros past the split, K
                // and N
                for (int i = tid; i < n_chunks * CHUNK * BN; i += THREADS) {
                    const int k = i / BN;
                    const int c = i % BN;
                    w_s[swizzled(k, c)] = k < kn && n0 + c < N
                        ? static_cast<uint8_t>(
                              w[(size_t)(k0 + k) * N + n0 + c])
                        : 0;
                }
                consumers_sync();
                if (tid == 0)
                    for (int c = 0; c < n_chunks; ++c) mbar_arrive(&bars[c]);
            }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();

        float acc[NG][4];
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[g][v] = 0.0f;

        // this warpgroup's k-steps: chunks wg, wg + KW, ...; one m64n(8 NG)
        // instruction a step, whose A fragment is widened two steps ahead
        // (four fragments in turn, two steps' products in flight)
        const int my_chunks = (n_chunks - wg + KW - 1) / KW;
        const int steps = my_chunks * (CHUNK / 16);
        const auto step_of = [&](int mine) {
            return ((mine >> 2) * KW + wg) * (CHUNK / 16) + (mine & 3);
        };
        if (steps > 0) {
            uint32_t a[4][4];
            mbar_wait(&bars[wg], 0);
            load_a(a[0], w_s, step_of(0), warp, r, q);
            load_a(a[1], w_s, step_of(1), warp, r, q);
            for (int i = 0; i < steps; i += 4) {
#pragma unroll
                for (int h = 0; h < 4; ++h) {
                    const int mine = i + h;
                    wgmma_fence();
                    wgmma_bf16<8 * NG>(&acc[0][0], a[h], b_desc(
                        x_s + (size_t)2 * step_of(mine) * 64, kg_n * 128));
                    wgmma_commit();
                    if (mine + 2 < steps) {
                        wgmma_wait<2>();   // step mine - 2 is done with a
                        if (((mine + 2) & 3) == 0)
                            mbar_wait(&bars[((mine + 2) >> 2) * KW + wg], 0);
                        load_a(a[(h + 2) & 3], w_s, step_of(mine + 2), warp,
                               r, q);
                    }
                }
            }
            wgmma_wait<0>();
        }
        // the other warpgroups' products meet warpgroup 0's in order
        consumers_sync();   // every warpgroup is done with x_s
        if (wg > 0) {
#pragma unroll
            for (int g = 0; g < NG; ++g)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                    red[(((size_t)(wg - 1) * NG + g) * 4 + v) * 128
                        + t128] = acc[g][v];
        }
        consumers_sync();
        if (wg == 0) {
            for (int o = 0; o < KW - 1; ++o)
#pragma unroll
                for (int g = 0; g < NG; ++g)
#pragma unroll
                    for (int v = 0; v < 4; ++v)
                        acc[g][v] = __fadd_rn(
                            acc[g][v],
                            red[(((size_t)o * NG + g) * 4 + v) * 128
                                + t128]);
        }

        if (wg == 0) {
            // acc[g][dm] is row m0 + 8 g + 2 q + dm of x for column n,
            // acc[g][2 + dm] the same row for column n + 1
            const int n = n0 + col;
#pragma unroll
            for (int g = 0; g < NG; ++g) {
#pragma unroll
                for (int dm = 0; dm < 2; ++dm) {
                    const int m = m0 + 8 * g + 2 * q + dm;
                    if (m >= M) continue;
                    const float v0 = acc[g][dm];
                    const float v1 = acc[g][2 + dm];
                    const bool pair = n + 1 < N && N % 2 == 0;
                    if (S == 1) {
                        __nv_bfloat16* o = out + (size_t)m * N + n;
                        if (pair) {
                            *reinterpret_cast<__nv_bfloat162*>(o) =
                                __halves2bfloat162(
                                    finish(v0, scale, bias, bias_kind, n),
                                    finish(v1, scale, bias, bias_kind,
                                           n + 1));
                        } else {
                            if (n < N)
                                o[0] = finish(v0, scale, bias, bias_kind, n);
                            if (n + 1 < N)
                                o[1] = finish(v1, scale, bias, bias_kind,
                                              n + 1);
                        }
                    } else {
                        float* p = ws + ((size_t)blockIdx.y * M + m) * N + n;
                        if (pair) {
                            *reinterpret_cast<float2*>(p) =
                                make_float2(v0, v1);
                        } else {
                            if (n < N) p[0] = v0;
                            if (n + 1 < N) p[1] = v1;
                        }
                    }
                }
            }
        }
        consumers_sync();   // the pass is done with x_s and red
    }
    if (S == 1) return;

    // the last block of this tile adds the splits in order: after the
    // consumers' barrier, thread 0's count releases the block's partial
    // sums and acquires the other blocks'
    if (tid == 0) {
        unsigned prev;
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                     : "=r"(prev) : "l"(counters + blockIdx.x) : "memory");
        is_last = prev == static_cast<unsigned>(S - 1);
        if (is_last) counters[blockIdx.x] = 0;   // ready for the next launch
    }
    consumers_sync();
    if (!is_last) return;
    const int width = min(BN, N - n0);
    if (N % 4 == 0) {
        if (S > 4)
            add_splits<2, 8>(ws, scale, bias, bias_kind, out, M, N, S, n0,
                             width);
        else
            add_splits<4, 4>(ws, scale, bias, bias_kind, out, M, N, S, n0,
                             width);
        return;
    }
    const size_t split = (size_t)M * N;
    for (int i = tid; i < M * width; i += THREADS) {
        const int m = i / width;
        const int n = n0 + i % width;
        const float* p = ws + (size_t)m * N + n;
        float sum = 0.0f;
        for (int s = 0; s < S; ++s) {
            const float v = __ldcg(p + s * split);
            sum = s == 0 ? v : __fadd_rn(sum, v);
        }
        out[(size_t)m * N + n] = finish(sum, scale, bias, bias_kind, n);
    }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor map of an int8 weight (K, N) in boxes of CHUNK rows x BN
// columns, kept per (address, K, N): a weight's map never changes.
cudaError_t weight_map(const void* w, int K, int N, CUtensorMap* map) {
    struct Entry { const void* w; int K, N; CUtensorMap map; };
    static std::mutex lock;
    static std::vector<Entry> cache;
    static EncodeTiled encode = nullptr;
    std::lock_guard<std::mutex> guard(lock);
    for (const Entry& e : cache) {
        if (e.w == w && e.K == K && e.N == N) {
            *map = e.map;
            return cudaSuccess;
        }
    }
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return cudaErrorNotSupported;
        encode = reinterpret_cast<EncodeTiled>(fn);
    }
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)N};
    const cuuint32_t box[2] = {BN, CHUNK};
    const cuuint32_t steps[2] = {1, 1};
    CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                          const_cast<void*>(w), dims, strides, box, steps,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
    if (cache.size() >= 4096) cache.clear();
    cache.push_back({w, K, N, *map});
    return cudaSuccess;
}

template <int NG>
cudaError_t launch(const CUtensorMap& map, int tma, const void* x,
                   const void* w, const void* scale, const void* bias,
                   int bias_kind, void* out, void* ws, void* counters, int M,
                   int K, int N, int rows, int device, cudaStream_t stream) {
    const auto kernel = int8_matmul_bf16<NG>;
    const auto need = [](int rows) {
        return (size_t)rows * BN + xr_bytes<NG>(rows) + 8 * MAX_CHUNKS
               + 1024;
    };
    // the largest need (rows = 1024) is set once per device
    static bool ready[64] = {};
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (!ready[device]) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)need(CHUNK * MAX_CHUNKS));
        if (err != cudaSuccess) return err;
        ready[device] = true;
    }
    const int x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    dim3 grid((N + BN - 1) / BN, (K + rows - 1) / rows);
    kernel<<<grid, THREADS + 32, need(rows), stream>>>(
        map, static_cast<const __nv_bfloat16*>(x),
        static_cast<const int8_t*>(w), static_cast<const float*>(scale),
        bias, bias_kind, static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(ws), static_cast<unsigned*>(counters), M, K, N,
        rows, tma, x_vec);
    return cudaGetLastError();
}

cudaError_t launch_rows(const void* x, const void* w, const void* scale,
                        const void* bias, int bias_kind, void* out, void* ws,
                        void* counters, int M, int K, int N, int rows,
                        int device, cudaStream_t stream) {
    CUtensorMap map;
    std::memset(&map, 0, sizeof(map));
    const int tma = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (tma) {
        cudaError_t err = weight_map(w, K, N, &map);
        if (err != cudaSuccess) return err;
    }
    // passes of 8, 16, 32 or 64 rows of x: the instructions are the same
    if (M <= 8)
        return launch<1>(map, tma, x, w, scale, bias, bias_kind, out, ws,
                             counters, M, K, N, rows, device, stream);
    if (M <= 16)
        return launch<2>(map, tma, x, w, scale, bias, bias_kind, out, ws,
                             counters, M, K, N, rows, device, stream);
    if (M <= 32)
        return launch<4>(map, tma, x, w, scale, bias, bias_kind, out, ws,
                             counters, M, K, N, rows, device, stream);
    return launch<8>(map, tma, x, w, scale, bias, bias_kind, out, ws,
                         counters, M, K, N, rows, device, stream);
}

}  // namespace tc


extern "C" {

// float32 x: x (M, K), w (K, N) int8, scale (N,) float32, bias (N,) or
// nullptr (bias_kind 0 none, 1 float32, 2 bf16), out (M, N) float32, ws
// (ceil(K / rows), M, N) float32 scratch.  `rows`, the weight rows per
// split, is a multiple of 32 from 32 to 1024.  Returns cudaGetLastError()
// after the two launches.
int int8_matmul_fwd(const void* x, const void* w, const void* scale,
                    const void* bias, int bias_kind, void* out, void* ws,
                    int M, int K, int N, int rows, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (M < 1 || K < 1 || N < 1 || rows < K_LANES || rows > 1024
        || rows % K_LANES != 0 || (K + rows - 1) / rows > 65535
        || bias_kind < 0 || bias_kind > 2)
        return cudaErrorInvalidValue;
    return launch<float>(x, w, scale, bias, bias_kind, out, ws, M, K, N,
                         rows, static_cast<cudaStream_t>(stream));
}

// bf16 x, one launch: x (M, K) bf16, w, scale, bias as above, out (M, N)
// bf16; ws (S, M, N) float32 scratch and counters (ceil(N / 64),) unsigned,
// all 0 before the first launch (each launch leaves them 0), both unused
// when S = ceil(K / rows) is 1.  `rows` is a multiple of 64 from 64 to
// 1024.  Two launches that may run at once must not share counters (the
// wrapper keeps one buffer per device and stream, and gives a launch
// captured into a CUDA graph its own).  Returns cudaGetLastError().
int int8_matmul_bf16_fwd(const void* x, const void* w, const void* scale,
                         const void* bias, int bias_kind, void* out,
                         void* ws, void* counters, int M, int K, int N,
                         int rows, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (M < 1 || K < 1 || N < 1 || rows < tc::CHUNK
        || rows > tc::CHUNK * tc::MAX_CHUNKS || rows % tc::CHUNK != 0
        || (K + rows - 1) / rows > 65535 || bias_kind < 0 || bias_kind > 2)
        return cudaErrorInvalidValue;
    return tc::launch_rows(x, w, scale, bias, bias_kind, out, ws, counters,
                           M, K, N, rows, device,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
