// Fused mask multiply + inverse STFT (synthesis and overlap-add), two
// routes chosen by the wrapper from the geometry before the launch.
//
// Replaces: padertorch_tpu/ops/pallas/masked_istft.py, `masked_istft`
// through `_masked_istft_rows` (kernel `_kernel`).  The TPU kernel forms
// each frame's time segment as two MXU matmuls against (F, L) synthesis
// matrices, 2 * F * L multiply-adds a frame, and carries the overlap tail
// from one grid step to the next.  The MXU makes those products cheap; on
// this card they run on the CUDA cores, and an inverse real FFT computes
// the same function with about 1/20 of the operations.
//
// Route `fft` (power-of-two size 16 to 8192, window_length <= size).  For
// n < L one frame's segment is
//     seg[n] = w[n] * sum_{f < size} X_full[f] e^{+2 pi i f n / size},
// w the biorthogonal synthesis window over size (the stft's synthesis
// kernel at f = 0), X_full the Hermitian extension of the onesided X with
// the imaginary parts of DC and Nyquist dropped (they meet sin = 0 in the
// synthesis kernels).  The sum is a real inverse DFT of size N, computed
// as a complex inverse FFT of M = N / 2 points on
//     Z[k] = (X[k] + conj X[M-k]) + i W^k (X[k] - conj X[M-k]),
// W = e^{2 pi i / N},
// whose result z[m] holds y[2m] + i y[2m+1].  The FFT is Stockham autosort
// (a radix-2 pass first where log2 M is odd, then radix-4 passes): each
// thread keeps its butterflies' values in registers, the passes exchange
// them through shared memory (float2, one pad word pair every 16 values
// against bank conflicts), and the first pass reads Z straight from the
// spectrogram with the mask multiplied in (the masked spectrogram never
// exists in device memory).  Twiddles come from a table e^{2 pi i q / N},
// q < N, that the host computes in float64 and rounds once; nothing calls
// sincosf (a `fast_twiddles` flag, for measurement only, takes them from
// __sincosf instead).  Every product and sum is pinned with _rn
// intrinsics, so a frame's values do not depend on the launch's shape.
//
// Overlap-add by output ownership: output row r (the `shift` samples from
// r * shift) is the sum over k < ratio of frame (r - k)'s chunk k.  A
// block owns R output rows of one signal row and transforms the
// R + ratio - 1 frames they need (the ratio - 1 at its edge are also
// transformed by the block before), G frames at a time in increasing
// order; after each group, every owned sample the group reaches adds the
// group's frames in increasing order into a row buffer in shared memory,
// which is written once at the end.  No atomics and no carry, and each
// output sums its terms in one order (frames increasing) whatever R and G
// are: a signal's output is the same bits alone, in any batch and under
// any plan.  The loop over a group's frames inside the loop over samples
// is kept rolled (`#pragma unroll 1`): unrolled by ptxas it hung the card
// or read out of bounds, while the same source ran at -O0, rolled, and in
// a CPU emulation of the CUDA threads; the cause was not found.
//
// What bounds it: bytes.  At the uPIT request (K=2 masks, T=127, F=257,
// size 512, shift 128) the spectrogram, masks and output are about 0.66
// MB, 0.0002 ms at 3.35 TB/s, so the launch and one chain of passes bound
// it; at (32, 500, 257) about 25.7 MB, 0.0077 ms, against about 0.003 ms
// of the FFT's float32 operations at 67 TFLOP/s.
//
// Route `dft` (every other size): the direct synthesis product per frame
// against the folded onesided matrices (F, L, 2), one block per tile of
// 16 output rows and one thread per sample position, each thread summing
// its tile's rows over k and the bins.  Bins are staged in shared memory
// in chunks, so any F fits; rows are on gridDim.x with the tiles.  It is
// bound by its 2 * F * L multiply-adds a frame.
//
// Signal row n reads spectrogram row n % spec_rows: per-source masks on
// one mixture store and read the spectrogram once.
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- fft ---

constexpr float TWO_PI_F = 6.283185307179586f;
constexpr int FFT_MAX_THREADS = 256;  // ops/kernels/masked_istft.py

__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

// a * w, each part one fused multiply-add on a rounded product
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
    return make_float2(__fmaf_rn(a.x, w.x, -__fmul_rn(a.y, w.y)),
                       __fmaf_rn(a.x, w.y, __fmul_rn(a.y, w.x)));
}

// i * a
__device__ __forceinline__ float2 times_i(float2 a) {
    return make_float2(-a.y, a.x);
}

struct Twiddles {
    const float2* __restrict__ table;  // e^{2 pi i q / N}, q < N
    int n;
    int fast;
    __device__ __forceinline__ float2 operator()(int q) const {
        if (fast) {
            float s, c;
            __sincosf(TWO_PI_F * (float)q / (float)n, &s, &c);
            return make_float2(c, s);
        }
        return __ldg(table + q);
    }
};

// The masked onesided spectrum of one frame, bin f, with the imaginary
// parts of DC and Nyquist dropped.
struct Spectrum {
    const float* __restrict__ re;
    const float* __restrict__ im;
    const float* __restrict__ mask;
    int m;
    __device__ __forceinline__ float2 operator()(int f) const {
        const float g = mask != nullptr ? __ldg(mask + f) : 1.0f;
        const float r = __fmul_rn(__ldg(re + f), g);
        const float i =
            (f == 0 || f == m) ? 0.0f : __fmul_rn(__ldg(im + f), g);
        return make_float2(r, i);
    }
};

// Z[k] of the packed half-size transform.
__device__ __forceinline__ float2 packed(const Spectrum& x, const Twiddles& tw,
                                         int k) {
    const float2 a = x(k);
    const float2 c = x(x.m - k);
    const float2 b = make_float2(c.x, -c.y);
    return cadd(cadd(a, b), times_i(cmul(csub(a, b), tw(k))));
}

// One Stockham pass of radix RADIX over M points: butterfly j (of M /
// RADIX) reads values j + r M / RADIX, twiddles them by W_{Ns RADIX}^{(j %
// Ns) r}, transforms them and writes them at (j / Ns) Ns RADIX + j % Ns + s
// Ns.  A thread takes butterflies lane + b P, b < E / RADIX.  In place:
// every thread has read before any writes.  FIRST reads Z from the
// spectrum instead of the buffer.
template <int E, int RADIX, bool FIRST>
__device__ __forceinline__ void stockham_pass(float2* buf, const Spectrum& x,
                                              const Twiddles& tw, int m,
                                              int ns, int lane, int p) {
    constexpr int NB = E / RADIX;
    const int quarter = m / RADIX;
    const int span = quarter / ns;  // M / (Ns RADIX)
    float2 v[E];
    float2 w[E];  // the twiddles, loaded before the barrier
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const int j = lane + b * p;
        // W_{Ns R}^{k r} = e^{2 pi i (k r M / (Ns R)) / M}: table index
        // twice that, the table being over N = 2 M
        const int step = 2 * (j & (ns - 1)) * span;
#pragma unroll
        for (int r = 0; r < RADIX; ++r) {
            const int at = j + r * quarter;
            v[b * RADIX + r] = FIRST ? packed(x, tw, at) : buf[padded(at)];
            if (!FIRST && r > 0) w[b * RADIX + r] = tw(r * step);
        }
    }
    if (!FIRST) __syncthreads();
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        const int j = lane + b * p;
        const int k = j & (ns - 1);
        float2* u = v + b * RADIX;
        if (!FIRST) {
#pragma unroll
            for (int r = 1; r < RADIX; ++r)
                u[r] = cmul(u[r], w[b * RADIX + r]);
        }
        if (RADIX == 2) {
            const float2 a = u[0], c = u[1];
            u[0] = cadd(a, c);
            u[1] = csub(a, c);
        } else {
            const float2 t0 = cadd(u[0], u[2]), t1 = csub(u[0], u[2]);
            const float2 t2 = cadd(u[1], u[3]);
            const float2 t3 = times_i(csub(u[1], u[3]));
            u[0] = cadd(t0, t2);
            u[1] = cadd(t1, t3);
            u[2] = csub(t0, t2);
            u[3] = csub(t1, t3);
        }
        const int dst = (j - k) * RADIX + k;
#pragma unroll
        for (int s = 0; s < RADIX; ++s) buf[padded(dst + s * ns)] = u[s];
    }
    __syncthreads();
}

// re, im: (spec_rows, T, M + 1); mask: (N, T, M + 1) or nullptr (then
// spec_rows == N); tw: (2 M,) float2; win: (L,); out: (N, T + ratio - 1,
// shift).  Block: G frames of P = M / E threads.  Shared memory: the row
// buffer (R * shift floats, rounded up to 4) and G frame buffers of
// padded(M) float2.
// At 4 values a thread, 64 registers: four blocks of 256 threads an SM.
template <int E>
__global__ void __launch_bounds__(FFT_MAX_THREADS, E == 4 ? 4 : 1)
masked_istft_fft_kernel(
        const float* __restrict__ re, const float* __restrict__ im,
        const float* __restrict__ mask, const float2* __restrict__ tw_table,
        const float* __restrict__ win, float* __restrict__ out, int T, int m,
        int log2m, int shift, int ratio, int spec_rows, int R, int G,
        int tiles, int fast_twiddles) {
    extern __shared__ float4 smem4[];
    float* acc = reinterpret_cast<float*>(smem4);
    const int p = m / E;
    const int g = threadIdx.x / p;
    const int lane = threadIdx.x % p;
    const int n = blockIdx.x / tiles;
    const int r0 = (blockIdx.x % tiles) * R;
    const int n_rows = T + ratio - 1;
    const int rows_here = min(R, n_rows - r0);
    const int f_len = m + 1;
    const int buf_len = padded(m);
    float2* bufs = reinterpret_cast<float2*>(acc + ((R * shift + 3) & ~3));
    float2* buf = bufs + g * buf_len;
    const Twiddles tw{tw_table, 2 * m, fast_twiddles};
    const size_t spec_row = (size_t)(n % spec_rows) * T;
    const size_t mask_row = (size_t)n * T;

    for (int i = threadIdx.x; i < rows_here * shift; i += blockDim.x)
        acc[i] = 0.0f;
    const int d_row = blockDim.x / shift;
    const int d_s = blockDim.x - d_row * shift;
    const int t_lo = max(0, r0 - (ratio - 1));
    const int t_hi = min(T - 1, r0 + rows_here - 1);
    for (int t0 = t_lo; t0 <= t_hi; t0 += G) {
        // the threads of a group past the tile's last frame transform that
        // frame again (they take part in every barrier); nothing of theirs
        // is added
        const int t = min(t0 + g, t_hi);
        const size_t at = (spec_row + t) * f_len;
        const Spectrum x{re + at, im + at,
                         mask != nullptr
                             ? mask + (mask_row + t) * f_len : nullptr,
                         m};
        int ns = 1;
        if (log2m & 1) {
            stockham_pass<E, 2, true>(buf, x, tw, m, ns, lane, p);
            ns = 2;
        } else {
            stockham_pass<E, 4, true>(buf, x, tw, m, ns, lane, p);
            ns = 4;
        }
        for (; ns < m; ns *= 4)
            stockham_pass<E, 4, false>(buf, x, tw, m, ns, lane, p);

        // every owned sample the group reaches adds the group's frames in
        // increasing order, one thread a sample (the mapping is the group's
        // own: the barrier below ends it)
        const int t_last = min(t0 + G - 1, t_hi);
        const int ra = max(r0, t0);
        const int rb = min(r0 + rows_here - 1, t_last + ratio - 1);
        const int e_end = (rb - r0 + 1) * shift;
        int e = (ra - r0) * shift + threadIdx.x;
        int row = r0 + e / shift;
        int s = e - (row - r0) * shift;
        for (; e < e_end; e += blockDim.x) {
            float a = acc[e];
            const int f_hi = min(t_last, row);
            // kept rolled: see the note on the overlap-add at the top
#pragma unroll 1
            for (int tf = max(t0, row - (ratio - 1)); tf <= f_hi; ++tf) {
                const int pos = (row - tf) * shift + s;
                const float2 z = bufs[(tf - t0) * buf_len + padded(pos >> 1)];
                a = __fmaf_rn(__ldg(win + pos), (pos & 1) ? z.y : z.x, a);
            }
            acc[e] = a;
            row += d_row;
            s += d_s;
            if (s >= shift) {
                s -= shift;
                ++row;
            }
        }
        __syncthreads();
    }
    float* o = out + ((size_t)n * n_rows + r0) * shift;
    for (int i = threadIdx.x; i < rows_here * shift; i += blockDim.x)
        o[i] = acc[i];
}

// ---------------------------------------------------------------- dft ---

constexpr int DFT_ROWS = 16;

// Stage bins [f0, f0 + fc) of the tile's DFT_ROWS + ratio - 1 frames, mask
// multiplied in, into x_s (frames, fc); frames outside [0, T) are zero.
__device__ __forceinline__ void dft_stage(
        float2* x_s, const float* __restrict__ re,
        const float* __restrict__ im,
        const float* __restrict__ mask, size_t spec_base, size_t base,
        int t_first, int n_frames, int T, int F, int f0, int fc) {
    for (int idx = threadIdx.x; idx < n_frames * fc; idx += blockDim.x) {
        const int i = idx / fc;
        const int f = f0 + idx % fc;
        const int t = t_first + i;
        float2 v = make_float2(0.0f, 0.0f);
        if (t >= 0 && t < T) {
            const size_t at = (size_t)t * F + f;
            const float m = mask != nullptr ? mask[base + at] : 1.0f;
            v = make_float2(re[spec_base + at] * m, im[spec_base + at] * m);
        }
        x_s[idx] = v;
    }
}

// acc[rr] += the staged bins' share of output row r0 + rr, sample s: output
// row r0 + rr reads frame r0 + rr - k, which sits at staged row
// rr + ratio - 1 - k.
__device__ __forceinline__ void dft_accumulate(
        float (&acc)[DFT_ROWS], const float2* x_s,
        const float2* __restrict__ s_ri, int s, int shift, int ratio, int f0,
        int fc) {
    const int L = ratio * shift;
    for (int k = 0; k < ratio; ++k) {
        const float2* col = s_ri + (size_t)f0 * L + (size_t)k * shift + s;
        const float2* xk = x_s + (size_t)(ratio - 1 - k) * fc;
        for (int f = 0; f < fc; ++f) {
            const float2 sv = col[(size_t)f * L];
#pragma unroll
            for (int rr = 0; rr < DFT_ROWS; ++rr) {
                const float2 xv = xk[(size_t)rr * fc + f];
                acc[rr] = fmaf(xv.x, sv.x, acc[rr]);
                acc[rr] = fmaf(xv.y, sv.y, acc[rr]);
            }
        }
    }
}

// re, im: (spec_rows, T, F); mask: (N, T, F) or nullptr; s_ri: (F, L, 2)
// with L = ratio * shift; out: (N, T + ratio - 1, shift).  Shared memory:
// x_s (DFT_ROWS + ratio - 1, chunk) of (re * m, im * m).  CHUNKED where
// chunk < F: the bins are staged a chunk at a time, and each sample's sum
// runs chunk by chunk.  Where all F bins fit, the unchunked instantiation
// stages them once: on an H100 (700 W) at STFT(400, 100), 2 rows of 127
// frames, it took 0.102 ms against 0.189 for the chunked kernel with
// chunk = F, which also lost when it staged once under a runtime branch
// (0.196), by CUDA-graph replays of compare_istft.py.
template <bool CHUNKED>
__global__ void masked_istft_dft_kernel(
        const float* __restrict__ re, const float* __restrict__ im,
        const float* __restrict__ mask, const float2* __restrict__ s_ri,
        float* __restrict__ out, int T, int F, int shift, int ratio,
        int spec_rows, int tiles, int chunk) {
    extern __shared__ float2 x_s[];
    const int n = blockIdx.x / tiles;
    const int r0 = (blockIdx.x % tiles) * DFT_ROWS;
    const int n_rows = T + ratio - 1;
    const int n_frames = DFT_ROWS + ratio - 1;
    const int t_first = r0 - (ratio - 1);
    const size_t base = (size_t)n * T * F;
    const size_t spec_base = (size_t)(n % spec_rows) * T * F;
    float* o = out + (size_t)n * n_rows * shift;

    if (!CHUNKED) {
        dft_stage(x_s, re, im, mask, spec_base, base, t_first, n_frames, T, F,
                  0, F);
        __syncthreads();
    }
    for (int s0 = 0; s0 < shift; s0 += blockDim.x) {
        const int s = s0 + threadIdx.x;
        float acc[DFT_ROWS];
#pragma unroll
        for (int rr = 0; rr < DFT_ROWS; ++rr) acc[rr] = 0.0f;
        if (CHUNKED) {
            for (int f0 = 0; f0 < F; f0 += chunk) {
                const int fc = min(chunk, F - f0);
                __syncthreads();
                dft_stage(x_s, re, im, mask, spec_base, base, t_first,
                          n_frames, T, F, f0, fc);
                __syncthreads();
                if (s < shift)
                    dft_accumulate(acc, x_s, s_ri, s, shift, ratio, f0, fc);
            }
        } else if (s < shift) {
            dft_accumulate(acc, x_s, s_ri, s, shift, ratio, 0, F);
        }
        if (s >= shift) continue;
#pragma unroll
        for (int rr = 0; rr < DFT_ROWS; ++rr) {
            const int r = r0 + rr;
            if (r < n_rows) o[(size_t)r * shift + s] = acc[rr];
        }
    }
}

// The largest dynamic shared memory set on each kernel (the fft route's
// three instantiations, then the dft route's two), per device: the
// attribute is set once per device and size, not on every call (nor during
// a CUDA graph's capture after a first eager call).
int configured[5][64];

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int which, int smem, int device) {
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (smem <= configured[which][device]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) configured[which][device] = smem;
    return err;
}

}  // namespace

extern "C" {

// Route fft: the wrapper's plan (ops/kernels/masked_istft.py `fft_plan`)
// gives R rows a block, G frames at a time, E values a thread (4, 8 or
// 16), and the shared memory.  Launch over N * ceil((T + ratio - 1) / R)
// blocks of G * M / E threads.  Returns cudaGetLastError() after the
// launch.
int masked_istft_fft(const void* re, const void* im, const void* mask,
                     const void* tw, const void* win, void* out, int N,
                     int spec_rows, int T, int M, int shift, int ratio, int R,
                     int G, int E, int smem, int fast_twiddles, int device,
                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    int log2m = 0;
    while ((1 << log2m) < M) ++log2m;
    if ((1 << log2m) != M || M < 8 || M % E || spec_rows < 1 ||
        N % spec_rows != 0 || R < 1 || G < 1 || G * (M / E) > FFT_MAX_THREADS)
        return cudaErrorInvalidValue;
    const int n_rows = T + ratio - 1;
    const int tiles = (n_rows + R - 1) / R;
    const long long blocks = (long long)N * tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    auto launch = [&](auto kernel, int which) -> cudaError_t {
        cudaError_t e = prepare(kernel, which, smem, device);
        if (e != cudaSuccess) return e;
        kernel<<<(unsigned)blocks, G * (M / E), smem,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(re), static_cast<const float*>(im),
            static_cast<const float*>(mask), static_cast<const float2*>(tw),
            static_cast<const float*>(win), static_cast<float*>(out), T, M,
            log2m, shift, ratio, spec_rows, R, G, tiles, fast_twiddles);
        return cudaGetLastError();
    };
    switch (E) {
        case 4: return launch(masked_istft_fft_kernel<4>, 0);
        case 8: return launch(masked_istft_fft_kernel<8>, 1);
        case 16: return launch(masked_istft_fft_kernel<16>, 2);
        default: return cudaErrorInvalidValue;
    }
}

// Route dft: bins staged `chunk` at a time (the wrapper's `dft_plan`).
// Launch over N * ceil((T + ratio - 1) / 16) blocks of `threads`.
int masked_istft_dft(const void* re, const void* im, const void* mask,
                     const void* s_ri, void* out, int N, int spec_rows, int T,
                     int F, int shift, int ratio, int chunk, int threads,
                     int smem, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (spec_rows < 1 || N % spec_rows != 0 || chunk < 1 || threads < 32 ||
        threads > 1024)
        return cudaErrorInvalidValue;
    const int n_rows = T + ratio - 1;
    const int tiles = (n_rows + DFT_ROWS - 1) / DFT_ROWS;
    const long long blocks = (long long)N * tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    auto launch = [&](auto kernel, int which) -> cudaError_t {
        cudaError_t e = prepare(kernel, which, smem, device);
        if (e != cudaSuccess) return e;
        kernel<<<(unsigned)blocks, threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(re), static_cast<const float*>(im),
            static_cast<const float*>(mask), static_cast<const float2*>(s_ri),
            static_cast<float*>(out), T, F, shift, ratio, spec_rows, tiles,
            chunk);
        return cudaGetLastError();
    };
    return chunk < F ? launch(masked_istft_dft_kernel<true>, 4)
                     : launch(masked_istft_dft_kernel<false>, 3);
}

}  // extern "C"
