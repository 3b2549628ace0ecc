// Fused framing -> windowed DFT -> power -> mel -> log front end.
//
// Replaces: padertorch_tpu/ops/pallas/logmel.py, `_fused_logmel` (kernel
// `_logmel_kernel`).
//
// What bounds it on the card: the arithmetic.  Per frame 2 * L * F
// multiply-adds for the real and imaginary DFT products and F * M for the
// mel product (0.56 MFLOP at L=512, F=257, M=64) against `shift` new
// samples read and M values written; the bases (2 x L x F and F x M
// floats, 1.1 MB) are shared by all frames and stay in L2.
//
// Design: the TPU kernel frames with aligned rolls of a (rows, shift)
// reshape, which needs shift | window_length; here a frame is read at its
// own offset, so any shift works.  One block takes one batch row and a
// tile of FT frames.  It loads the tile's span of the padded signal,
// (FT - 1) * shift + L samples, into shared memory once.  The DFT is one
// product of the (FT, L) frames with the (L, 2 F) basis [re, im per bin],
// tiled for registers: a thread owns eight frames x four bins (64
// accumulators) and per window position reads eight samples (broadcast
// within a warp) and its eight basis values (two 16-byte loads, contiguous
// over a warp) from shared memory for 64 FMAs: the shared-memory pipe and
// the FMA units are about equally busy.  The basis streams through shared
// memory in tiles of KT rows, copied asynchronously one tile ahead.  The
// power |X|^2 of the tile goes to shared memory and never to device memory;
// the mel product reads it there (two mel bins x eight frames per thread),
// and only log(mel + eps) is written.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT_MAX = 576;  // threads per block, at most (96 registers)
constexpr int FR = 8;        // frames per thread
constexpr int BR = 4;        // bins per thread: 2 * BR basis columns
constexpr int KT = 16;       // basis rows per shared-memory stage

// sig: (B, Tp) padded signal; basis: (L, NB), NB = 2 * F rounded up to a
// multiple of 2 * BR (zeros beyond F); a row holds, for each group of BR
// bins, [re, im] of its first two bins, and in its second half [re, im] of
// each group's last two (so that a warp's 16-byte loads are contiguous);
// fb: (F, M) filterbank; out: (B, n_frames, M).  FT = FR * GF frames per
// block, blockDim.x >= GF * NB / (2 * BR).
// Shared memory: sig_s (span + KT rounded up to 4), b_s (2, KT, NB),
// pow_s (FT, F).
__global__ void __launch_bounds__(NT_MAX) fused_logmel_kernel(
        const float* __restrict__ sig, const float* __restrict__ basis,
        const float* __restrict__ fb, float* __restrict__ out, int Tp,
        int n_frames, int L, int F, int NB, int M, int shift, int GF,
        float eps) {
    extern __shared__ __align__(16) float smem[];
    const int FT = GF * FR;
    const int span = (FT - 1) * shift + L;
    float* sig_s = smem;
    const int span_s = (span + KT + 3) / 4 * 4;   // zeros beyond the span
    float* b_s = sig_s + span_s;
    float* pow_s = b_s + 2 * KT * NB;
    const int b = blockIdx.y;
    const int frame0 = blockIdx.x * FT;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;

    // basis rows k0 ... k0 + KT - 1 into a stage; rows beyond L are zeros
    auto copy_tile = [&](int k0, float* stage) {
        const int n4 = KT * NB / 4;
        for (int i = tid; i < n4; i += nt) {
            const int row = k0 + 4 * i / NB;
            float4* dst = reinterpret_cast<float4*>(stage) + i;
            if (row < L)
                __pipeline_memcpy_async(
                    dst, reinterpret_cast<const float4*>(
                             basis + (size_t)k0 * NB) + i, sizeof(float4));
            else
                *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        __pipeline_commit();
    };
    copy_tile(0, b_s);

    const size_t start = (size_t)frame0 * shift;
    const float* row = sig + (size_t)b * Tp;
    for (int i = tid; i < span_s; i += nt)
        sig_s[i] = i < span && start + i < (size_t)Tp ? row[start + i] : 0.0f;

    const int GB = NB / (2 * BR);
    const int bg = tid % GB;          // bins bg * BR ... + BR - 1
    const int fg = tid / GB;          // frames fg * FR ... + FR - 1
    const bool active = fg < GF;
    float acc[FR][2 * BR];
#pragma unroll
    for (int j = 0; j < FR; ++j)
#pragma unroll
        for (int c = 0; c < 2 * BR; ++c) acc[j][c] = 0.0f;

    const int n_tiles = (L + KT - 1) / KT;
    for (int kt = 0; kt < n_tiles; ++kt) {
        if (kt + 1 < n_tiles) {
            copy_tile((kt + 1) * KT, b_s + ((kt + 1) & 1) * KT * NB);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        if (active) {
            const float* a = sig_s + (size_t)fg * FR * shift + kt * KT;
            const float* bt = b_s + (kt & 1) * KT * NB + bg * BR;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
                const float4 b0 =
                    *reinterpret_cast<const float4*>(bt + kk * NB);
                const float4 b1 = *reinterpret_cast<const float4*>(
                    bt + kk * NB + NB / 2);
#pragma unroll
                for (int j = 0; j < FR; ++j) {
                    // (positions beyond the window meet zero basis rows)
                    const float s = a[j * shift + kk];
                    acc[j][0] = fmaf(s, b0.x, acc[j][0]);
                    acc[j][1] = fmaf(s, b0.y, acc[j][1]);
                    acc[j][2] = fmaf(s, b0.z, acc[j][2]);
                    acc[j][3] = fmaf(s, b0.w, acc[j][3]);
                    acc[j][4] = fmaf(s, b1.x, acc[j][4]);
                    acc[j][5] = fmaf(s, b1.y, acc[j][5]);
                    acc[j][6] = fmaf(s, b1.z, acc[j][6]);
                    acc[j][7] = fmaf(s, b1.w, acc[j][7]);
                }
            }
        }
        __syncthreads();
    }
    if (active) {
#pragma unroll
        for (int j = 0; j < FR; ++j) {
            float* p = pow_s + (size_t)(fg * FR + j) * F;
#pragma unroll
            for (int c = 0; c < BR; ++c) {
                const int bin = bg * BR + c;
                if (bin < F)
                    p[bin] = acc[j][2 * c] * acc[j][2 * c]
                        + acc[j][2 * c + 1] * acc[j][2 * c + 1];
            }
        }
    }
    __syncthreads();

    // mel bins mp and mp + MH, frames g * FR ... g * FR + FR - 1
    const int MH = (M + 1) / 2;
    for (int item = tid; item < MH * GF; item += nt) {
        const int mp = item % MH;
        const int g = item / MH;
        const int m2 = mp + MH < M ? mp + MH : mp;   // odd M: a repeat
        const float* p0 = pow_s + (size_t)g * FR * F;
        float a1[FR], a2[FR];
#pragma unroll
        for (int j = 0; j < FR; ++j) a1[j] = a2[j] = 0.0f;
        // eight filterbank rows' loads are issued before the first is used
        constexpr int FB = 8;
        for (int f0 = 0; f0 < F; f0 += FB) {
            float w1[FB], w2[FB];
#pragma unroll
            for (int i = 0; i < FB; ++i) {
                const int f = min(f0 + i, F - 1);
                w1[i] = __ldg(fb + (size_t)f * M + mp);
                w2[i] = __ldg(fb + (size_t)f * M + m2);
            }
#pragma unroll
            for (int i = 0; i < FB; ++i) {
                if (f0 + i < F) {
#pragma unroll
                    for (int j = 0; j < FR; ++j) {
                        const float p = p0[(size_t)j * F + f0 + i];
                        a1[j] = fmaf(p, w1[i], a1[j]);
                        a2[j] = fmaf(p, w2[i], a2[j]);
                    }
                }
            }
        }
#pragma unroll
        for (int j = 0; j < FR; ++j) {
            const int frame = frame0 + g * FR + j;
            if (frame < n_frames) {
                float* o = out + ((size_t)b * n_frames + frame) * M;
                o[mp] = logf(a1[j] + eps);
                o[m2] = logf(a2[j] + eps);
            }
        }
    }
}

}  // namespace

extern "C" {

// Launch over (ceil(n_frames / FT), B) blocks of GF * NB / 8 threads
// (rounded up to a warp), FT = 8 GF frames each.  A thread's work does not
// depend on GF, so a block's time grows with its threads: GF is the one of
// 1 ... 8 that fits the block size and the card's shared memory and needs
// the fewest thread-groups on the busiest SM (blocks over SMs, rounded up,
// times GF); of equal ones the largest, which streams the basis least
// often.  Returns cudaGetLastError() after the launch.
int fused_logmel_fwd(const void* sig, const void* basis, const void* fb,
                     void* out, int B, int Tp, int n_frames, int L, int F,
                     int NB, int M, int shift, float eps, int device,
                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int GB = NB / (2 * BR);
    if (B < 1 || B > 65535 || n_frames < 1 || L < 1 || F < 1 || M < 1 ||
        shift < 1 || NB % (2 * BR) || NB < 2 * F || GB > NT_MAX ||
        (size_t)(n_frames - 1) * shift + L > (size_t)Tp)
        return cudaErrorInvalidValue;
    int max_smem = 0;
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    int n_sm = 1;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    int best_gf = 0;
    size_t best_smem = 0;
    long best_cost = 0;
    int gf_cap = NT_MAX / GB < 8 ? NT_MAX / GB : 8;
    if ((n_frames + FR - 1) / FR < gf_cap) gf_cap = (n_frames + FR - 1) / FR;
    for (int gf = gf_cap; gf >= 1; --gf) {
        const int ft = gf * FR;
        const size_t span = (size_t)(ft - 1) * shift + L;
        const size_t smem = sizeof(float)
            * ((span + KT + 3) / 4 * 4 + 2 * (size_t)KT * NB
               + (size_t)ft * F);
        if (smem > (size_t)max_smem) continue;
        const long blocks = (long)((n_frames + ft - 1) / ft) * B;
        const long cost = (blocks + n_sm - 1) / n_sm * gf;
        if (best_gf == 0 || cost < best_cost) {
            best_cost = cost;
            best_gf = gf;
            best_smem = smem;
        }
    }
    if (best_gf == 0) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(fused_logmel_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)best_smem);
    if (err != cudaSuccess) return err;
    const int ft = best_gf * FR;
    const int threads = (best_gf * GB + 31) / 32 * 32;
    dim3 grid((n_frames + ft - 1) / ft, B);
    fused_logmel_kernel<<<grid, threads, best_smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sig), static_cast<const float*>(basis),
        static_cast<const float*>(fb), static_cast<float*>(out), Tp, n_frames,
        L, F, NB, M, shift, best_gf, eps);
    return cudaGetLastError();
}

}  // extern "C"
