// Weight-only int8 matrix product: out = cast((x @ w_q) * scale + bias).
//
// Replaces: padertorch_tpu/ops/pallas/int8_matmul.py, `int8_matmul`
// through `_int8_matmul_2d` (kernel `_kernel`), the product inside
// `QuantizedLinear.forward` (padertorch_tpu/quantize.py).
//
// What bounds it on the card: the bytes of the int8 weights.  Decoding
// runs it at M = 1 to 32 rows of x, where it does 2 M operations per
// weight byte; the card needs about 20 float32 operations per byte before
// the arithmetic and not the memory is the limit.  K * N bytes over
// 3.35 TB/s is 0.31 us for a (1024, 1024) weight and 1.25 us for
// (1024, 4096): below the cost of a launch, so at the decoder's shapes a
// call costs its launches.
//
// What the TPU kernel does and what changes here.  The TPU kernel walks a
// grid over N in order, keeps x resident and converts one (K, block_n)
// weight tile at a time on chip.  A card needs many blocks in flight: N =
// 1024 in tiles of 128 columns is 8 blocks for 132 SMs.  So the weight is
// cut in both directions: block (tile, split) reads columns
// [128 tile, 128 tile + 128) of rows [rows split, rows (split + 1)) and
// writes the partial sums of every row of x for those columns; a second
// kernel adds the splits, multiplies by the scale and adds the bias.
// Both kernels are launched by one call.  The rows per split are chosen by
// the wrapper from (K, N) alone, so that about two blocks are in flight on
// each SM.
//
// Determinism.  Every output element is summed in one fixed order, which
// depends neither on M nor on the launch: inside a block each thread adds
// its rows in increasing order with fmaf, the 32 threads that share a
// column are added by a fixed butterfly of shuffles and a fixed order over
// the warps, and the second kernel adds the splits in increasing order.
// No float atomics.  Rows of x are taken MT at a time; a row's arithmetic
// is the same whichever other rows share its pass, so a row of a batch of
// 8 equals the same row alone, bit for bit.
//
// Loads.  A thread owns 16 neighbouring columns: one 16-byte load of a
// weight row (eight threads cover 128 bytes of a row, four rows per warp
// instruction), widened in registers by the 2^23 trick (byte permute into
// a float's mantissa, one subtraction: exact) instead of the
// quarter-rate integer conversion.  The weights are the only form of the
// weights the kernel reads.  x's rows for the block sit in shared memory
// as float32 (bf16 widened on load) and are read as broadcasts.  A ragged
// N (not a multiple of 16, or a weight not 16-byte aligned) takes byte
// loads with the same arithmetic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* out, size_t i, float v) {
    out[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
    out[i] = __float2bfloat16_rn(v);
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

extern "C" {

// x (M, K) float32 (x_bf16 = 0) or bf16 (1), w (K, N) int8, scale (N,)
// float32, bias (N,) or nullptr (bias_kind 0 none, 1 float32, 2 bf16), out
// (M, N) in x's type, ws (ceil(K / rows), M, N) float32 scratch.  `rows`,
// the weight rows per split, is a multiple of 32 from 32 to 1024.
// Returns cudaGetLastError() after the two launches.
int int8_matmul_fwd(const void* x, int x_bf16, const void* w,
                    const void* scale, const void* bias, int bias_kind,
                    void* out, void* ws, int M, int K, int N, int rows,
                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (M < 1 || K < 1 || N < 1 || rows < K_LANES || rows > 1024
        || rows % K_LANES != 0 || (K + rows - 1) / rows > 65535
        || bias_kind < 0 || bias_kind > 2)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16)
        return launch<__nv_bfloat16>(x, w, scale, bias, bias_kind, out, ws,
                                     M, K, N, rows, s);
    return launch<float>(x, w, scale, bias, bias_kind, out, ws, M, K, N,
                         rows, s);
}

}  // extern "C"
