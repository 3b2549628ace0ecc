// Fused mask multiply + inverse STFT (synthesis matmul + overlap-add).
//
// Replaces: padertorch_tpu/ops/pallas/masked_istft.py, `masked_istft`
// through `_masked_istft_rows` (kernel `_kernel`).
//
// What bounds it on the card: the arithmetic, 2 * F * L FMAs per frame
// (two onesided synthesis matrices Sr, Si of shape (F, L)), against a
// read of 3 * F floats per frame (re, im, mask) and a write of `shift`
// samples per frame.  The TPU kernel streams frame blocks in order and
// carries the (ratio - 1, shift) overlap tail from one grid step to the
// next; blocks on a GPU run in no order, so that carry cannot be kept.
//
// Design, output-centric: output row r (the `shift` samples starting at
// r * shift) is the sum over k < ratio of frame (r - k)'s segment columns
// [k * shift, (k + 1) * shift).  One block takes one signal row and a
// tile of ROWS output rows, loads the ROWS + ratio - 1 frames it needs
// into shared memory with the mask multiplied in on load (the masked
// spectrogram never exists in device memory), and each thread forms one
// sample position of every row in the tile:
//   y[r, s] = sum_k sum_f (re * m)[r - k, f] * Sr[f, k * shift + s]
//                       + (im * m)[r - k, f] * Si[f, k * shift + s].
// No carry, no atomics, every sample is written once; the FMA count is
// the frame-centric one.  Sr and Si come interleaved, (F, L, 2), so one
// 8-byte load serves both, and each load is reused for ROWS outputs.
// Per-source masks on one mixture do not copy the spectrogram: signal row
// n reads spectrogram row n % spec_rows, so it is stored and read once
// per mixture however many sources share it.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;

// re, im: (spec_rows, T, F); mask: (N, T, F) or nullptr (then
// spec_rows == N); s_ri: (F, L, 2) with L = ratio * shift;
// out: (N, T + ratio - 1, shift).
// Shared memory: x_s (ROWS + ratio - 1, F) of (re * m, im * m).
__global__ void masked_istft_kernel(
        const float* __restrict__ re, const float* __restrict__ im,
        const float* __restrict__ mask, const float2* __restrict__ s_ri,
        float* __restrict__ out, int T, int F, int shift, int ratio,
        int spec_rows) {
    extern __shared__ float2 x_s[];
    const int n = blockIdx.y;
    const int r0 = blockIdx.x * ROWS;
    const int n_rows = T + ratio - 1;
    const int n_frames = ROWS + ratio - 1;
    const int t_first = r0 - (ratio - 1);
    const int L = ratio * shift;
    const size_t base = (size_t)n * T * F;
    const size_t spec_base = (size_t)(n % spec_rows) * T * F;

    for (int idx = threadIdx.x; idx < n_frames * F; idx += blockDim.x) {
        const int i = idx / F;
        const int f = idx % F;
        const int t = t_first + i;
        float2 v = make_float2(0.0f, 0.0f);
        if (t >= 0 && t < T) {
            const size_t at = (size_t)t * F + f;
            const float m = mask != nullptr ? mask[base + at] : 1.0f;
            v = make_float2(re[spec_base + at] * m, im[spec_base + at] * m);
        }
        x_s[idx] = v;
    }
    __syncthreads();

    for (int s = threadIdx.x; s < shift; s += blockDim.x) {
        float acc[ROWS];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) acc[rr] = 0.0f;
        for (int k = 0; k < ratio; ++k) {
            const float2* col = s_ri + (size_t)k * shift + s;
            // output row r0 + rr reads frame r0 + rr - k, which sits at
            // shared row rr + ratio - 1 - k
            const float2* xk = x_s + (size_t)(ratio - 1 - k) * F;
            for (int f = 0; f < F; ++f) {
                const float2 sv = col[(size_t)f * L];
#pragma unroll
                for (int rr = 0; rr < ROWS; ++rr) {
                    const float2 xv = xk[(size_t)rr * F + f];
                    acc[rr] = fmaf(xv.x, sv.x, acc[rr]);
                    acc[rr] = fmaf(xv.y, sv.y, acc[rr]);
                }
            }
        }
        float* o = out + (size_t)n * n_rows * shift;
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
            const int r = r0 + rr;
            if (r < n_rows) o[(size_t)r * shift + s] = acc[rr];
        }
    }
}

}  // namespace

extern "C" {

// Launch over (ceil((T + ratio - 1) / ROWS), N) blocks.  Returns
// cudaGetLastError() after the launch.
int masked_istft_fwd(const void* re, const void* im, const void* mask,
                     const void* s_ri, void* out, int N, int spec_rows,
                     int T, int F, int shift, int ratio, int device,
                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const size_t smem = sizeof(float2) * (size_t)(ROWS + ratio - 1) * F;
    int max_smem = 0;
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (smem > (size_t)max_smem || N > 65535 || spec_rows < 1 ||
        N % spec_rows != 0)
        return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(masked_istft_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const int n_rows = T + ratio - 1;
    int threads = shift < 32 ? 32 : (shift > 256 ? 256 : (shift + 31) / 32 * 32);
    dim3 grid((n_rows + ROWS - 1) / ROWS, N);
    masked_istft_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        static_cast<const float*>(mask), static_cast<const float2*>(s_ri),
        static_cast<float*>(out), T, F, shift, ratio, spec_rows);
    return cudaGetLastError();
}

}  // extern "C"
