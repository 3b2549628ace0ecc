// Fused framing -> windowed DFT -> power -> mel -> log front end.
//
// Replaces: padertorch_tpu/ops/pallas/logmel.py, `_fused_logmel` (kernel
// `_logmel_kernel`).
//
// What bounds it on the card: the arithmetic.  Per frame 2 * L * F
// multiply-adds for the real and imaginary DFT products and, for the mel
// product, one per nonzero of the filterbank (a band's filter covers a
// few neighbouring bins), against `shift` new samples read and M values
// written; the basis (2 x L x F floats, 1.1 MB at L = 512) is shared by
// all frames and stays in L2.
//
// Design.  The DFT product, (frames x L) @ (L x 2F), runs on the tensor
// cores as 3xTF32 `wgmma.mma_async.m64n64k8.f32.tf32.tf32`: each operand
// is split into hi, its value rounded to TF32, and lo, the rest rounded to
// TF32 (`cvt.rna`), and lo*hi + hi*lo + hi*hi keep about 22 of float32's
// 24 bits (the dropped lo*lo is at most 2^-22 of a product, of either
// sign).  `mma.sync` runs TF32 on this card at about a quarter of the
// tensor cores' rate, which made a first version of this design slower
// than the CUDA-core kernel it replaced; `wgmma` runs at the full rate.
// The basis interleaves the bins' real and imaginary columns ([re, im] of
// bin b at columns 2b, 2b + 1), so a thread's accumulator pair is one
// bin's (re, im) and the power never leaves registers but for shared
// memory.  Each stage of 32 window positions sums into an accumulator of
// its own from zero, which is added to the bin's sum in float32 on the
// CUDA cores: the tensor core's own float32 sums round toward zero, and
// over all 512 positions in one accumulator their error grows with the
// sum, which the DFT cancels (a bin's value is far smaller than the sum
// of its terms' sizes).
// tests/test_torch_logmel_tf32.py emulates this arithmetic.
//
// A CTA is one warpgroup and takes FT = 64 frames of one batch row (the
// TPU kernel frames with aligned rolls, which needs shift | window_length;
// here a frame is read at its own offset, so any shift works) and chunks
// of 32 bins (64 basis columns, the product's N).  The CTAs of a
// thread-block cluster of CS (1 to 16, from the host planner,
// `logmel_plan` in ops/kernels/logmel.py) share a frame tile and split its
// chunks (rank c takes chunks c, c + CS, ...), so that the small inputs of
// the recipes, a few dozen frame tiles, still put work on most of the 132
// SMs.  A CTA loads its frames' span of the signal into shared memory once,
// with the fading pad folded in (zeros outside the signal: one launch per
// call), in segments of `shift` samples padded to SS = 4 mod 8 floats, so
// that a warp's 32 loads of an A fragment (8 frames x 4 samples) fall on
// 32 banks whatever the shift; A comes from registers, split there.  The
// basis arrives from the host split into its hi and lo planes, in the
// layout B takes from shared memory (K-major core matrices of 8 columns x
// 4 positions, no swizzle), stages of 32 positions copied asynchronously
// one stage ahead; the signal's span arrives the same way, with the first
// stage.  After a chunk's K loop the power
// goes to shared memory and the chunk's mel partial sums are formed on the
// CUDA cores: a band's sum over the chunk runs over the bins of its range
// there (`bands`, from the host), which gives the same bits as the dense
// product (a zero weight adds an exact zero).  A frame keeps one partial
// sum for each (band, chunk the band meets) in shared memory, and a band's
// sum adds them in chunk order, each read from the CTA of the cluster that
// owns the chunk (distributed shared memory, after a cluster barrier).  So
// every output is the same sum in the same order whatever CS and the
// batch: a row's features are the same bits in any batch, and two runs
// give the same bits.  log(mel + eps) is all that is written.
//
// Long hops (the `sliced` route, `SLICED`): where a tile's span does not
// fit one block (1600/800 with 80 mels needs 288,656 bytes, 1024/1024
// 332,544), the samples come with each stage instead: stage s brings the
// (64 frames x 32 positions) slice of the window it multiplies, sample k
// of frame f at f * shift + k of the span, into one of two (64, 36)
// tiles (rows padded to 36 floats, so an A fragment's loads fall on 32
// banks), in the stage's copy group.  The operands are the span route's,
// so the two routes give the same bits; the host takes the span route
// wherever it fits (`logmel_plan`).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;    // one warpgroup: four warps of 16 frames
constexpr int FT = 64;          // frames of a CTA: the product's M
constexpr int NC = 64;          // basis columns of a chunk: 32 bins, N
constexpr int BINS = NC / 2;
constexpr int KT = 32;          // window positions of a stage
constexpr int STAGE = KT * NC;  // floats of a stage (one plane)
constexpr int PSTR = BINS + 1;  // floats a power row
constexpr int MAX_CS = 16;

// The launch's geometry.  T: samples of a signal row; lo: the fading
// pad's zeros before it; LK: L rounded up to KT; SS: floats of a signal
// segment (shift, padded to 4 mod 8); NSEG: segments of a CTA's span;
// NCH: chunks of 32 bins; CS: CTAs of a cluster; E: a frame's mel partial
// sums, one for each (band, chunk the band's bins meet); sliced: the
// signal staged a stage's slice at a time.
struct Geometry {
    int T, lo, n_frames, L, LK, F, M, shift, SS, NSEG, NCH, CS, E, sliced;
};

constexpr int TSTR = KT + 4;    // floats a frame's row of a sliced tile

__host__ __device__ inline int round_up(int x, int to) {
    return (x + to - 1) / to * to;
}

// Floats of dynamic shared memory of a CTA: two basis stages, each a hi
// and a lo plane | the signal span (NSEG, SS), or on the sliced route two
// tiles (FT, TSTR) | the power (FT, PSTR) | the mel partial sums (FT, E) |
// on the span route the span offsets of the window positions (LK ints).
inline size_t smem_floats(const Geometry& g) {
    const size_t signal = g.sliced ? 2 * (size_t)FT * TSTR
                                   : round_up(g.NSEG * g.SS, 4);
    return 4 * (size_t)STAGE + signal + (size_t)FT * PSTR
           + (size_t)FT * g.E + (g.sliced ? 0 : g.LK);
}

// hi: x rounded to TF32; lo: the rest rounded to TF32 (the tensor core
// would cut its low bits); the host splits the basis the same way
__device__ __forceinline__ void split_rn(float x, uint32_t& hi,
                                         uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;\n"
        : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, or zeros where `valid` is false (nothing is read then)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Descriptor of one k-step of a K-major B plane without swizzle: core
// matrices of 8 columns x 16 bytes (4 positions), the two along K 128
// bytes apart (the leading byte offset), the eight along N 256 apart (the
// stride byte offset).
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
    const uint64_t addr = smem_addr(tile);
    return ((addr & 0x3FFFFu) >> 4) | (uint64_t(128 >> 4) << 16)
           | (uint64_t(256 >> 4) << 32);
}

// d (64 x 64 over the warpgroup) += A (64 x 8, registers) B (8 x 64,
// `desc`)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
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

// sig: (B, T) unpadded signal; basis: per chunk c and stage (32 window
// positions; LK / 32 of them), the hi plane and then the lo plane, each
// four k-steps (8 positions) of 512 floats: B's core matrices for columns
// 64 c ... 64 c + 63 ([re, im] of bin b at columns 2b, 2b + 1, zeros
// beyond bin F - 1) and the k-step's positions (zeros beyond L), in the
// order (column group of 8, position group of 4, column, position); fb:
// (F, M) filterbank; bands: (M, 3) ints, band m's bins [lo, hi) (every
// nonzero of its column of fb; lo = hi for none) and the index of its
// first partial sum, which belongs to chunk lo / 32 (one for each chunk
// through (hi - 1) / 32), then (NCH, 2) ints, the bands [first, last]
// that meet each chunk; out: (B, n_frames, M).  Grid (CS * ceil(n_frames
// / FT), B), clusters of CS along x: blockIdx.x / CS is the frame tile,
// blockIdx.x % CS the rank.  SLICED: the sliced route (see the top).
template <bool SLICED>
__global__ void __launch_bounds__(THREADS) fused_logmel_kernel(
        const float* __restrict__ sig, const float* __restrict__ basis,
        const float* __restrict__ fb, const int* __restrict__ bands,
        float* __restrict__ out, Geometry g, float eps) {
    extern __shared__ __align__(128) float smem[];
    const int cs = g.CS;
    const int rank = blockIdx.x % cs;
    const int frame0 = blockIdx.x / cs * FT;
    const int b = blockIdx.y;
    const int n_kt = g.LK / KT;
    float* b_s = smem;                       // two stages of two planes
    float* sig_s = b_s + 4 * STAGE;
    float* pow_s = sig_s + (SLICED ? 2 * FT * TSTR
                                   : round_up(g.NSEG * g.SS, 4));
    float* part_s = pow_s + FT * PSTR;
    int* koff_s = reinterpret_cast<int*>(part_s + (size_t)FT * g.E);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;                // frames 16 warp ...
    const int q = lane & 3;
    const int rr = lane >> 2;
    const int n_stages = (g.NCH - rank + cs - 1) / cs * n_kt;

    const long base = (long)frame0 * g.shift - g.lo;
    const float* row = sig + (size_t)b * g.T;
    // stage s: positions KT (s % n_kt) ... of the chunk rank + (s / n_kt)
    // CS, both planes contiguous in `basis`; on the sliced route also the
    // samples those positions of the tile's frames multiply (zeros outside
    // the signal), into tile s % 2
    auto copy_stage = [&](int s, float* dst) {
        const float* src = basis
            + ((size_t)(rank + s / n_kt * cs) * n_kt + s % n_kt) * 2 * STAGE;
        for (int i = 4 * tid; i < 2 * STAGE; i += 4 * THREADS) {
            flash::cp_async16(dst + i, src + i);
        }
        if constexpr (SLICED) {
            float* tile = sig_s + (s & 1) * FT * TSTR;
            const long k0 = base + s % n_kt * KT;
            for (int i = tid; i < FT * KT; i += THREADS) {
                const int f = i / KT, k = i % KT;
                const long p = k0 + (long)f * g.shift + k;
                const bool inside = p >= 0 && p < g.T;
                cp_async4(tile + f * TSTR + k, inside ? row + p : row,
                          inside);
            }
        }
        flash::cp_async_commit();
    };

    // the span route: the span of the tile's frames, segment by segment
    // (a warp a segment), with the fading pad folded in: zeros outside
    // the signal; it arrives with the first stage
    for (int seg = tid >> 5; !SLICED && seg < g.NSEG; seg += THREADS / 32) {
        for (int off = lane; off < g.shift; off += 32) {
            const long p = base + (long)seg * g.shift + off;
            const bool inside = p >= 0 && p < g.T;
            cp_async4(sig_s + seg * g.SS + off, inside ? row + p : row,
                      inside);
        }
    }
    copy_stage(0, b_s);
    // sample k of frame f lies at f * SS + koff[k]
    for (int k = tid; !SLICED && k < g.LK; k += THREADS) {
        koff_s[k] = k / g.shift * g.SS + k % g.shift;
    }

    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    const float* a_row = sig_s + (16 * warp + rr) * (SLICED ? TSTR : g.SS);

    for (int s = 0; s < n_stages; ++s) {
        // the next stage goes into the buffer whose products (the
        // previous stage's, waited for by the whole warpgroup) are done
        if (s + 1 < n_stages) {
            copy_stage(s + 1, b_s + ((s + 1) & 1) * 2 * STAGE);
            flash::cp_async_wait<1>();
        } else {
            flash::cp_async_wait<0>();
        }
        // the stage's copies, visible to the tensor cores' reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        const float* hi_s = b_s + (s & 1) * 2 * STAGE;
        const float* lo_s = hi_s + STAGE;

        // the stage's A fragments: frames 16 warp + rr (+ 8), positions
        // q (+ 4) of each k-step
        const int kb = s % n_kt * KT;
        uint32_t ah[KT / 8][4], al[KT / 8][4];
        // the stage's tile (sliced) or the span (rows SS apart)
        const float* a_s = SLICED ? a_row + (s & 1) * FT * TSTR : a_row;
        const int a_str = SLICED ? TSTR : g.SS;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
            const int ko0 = SLICED ? 8 * j + q : koff_s[kb + 8 * j + q];
            const int ko4 = SLICED ? 8 * j + q + 4
                                   : koff_s[kb + 8 * j + q + 4];
            split_rn(a_s[ko0], ah[j][0], al[j][0]);
            split_rn(a_s[8 * a_str + ko0], ah[j][1], al[j][1]);
            split_rn(a_s[ko4], ah[j][2], al[j][2]);
            split_rn(a_s[8 * a_str + ko4], ah[j][3], al[j][3]);
        }
        // the stage's sums from zero, the small terms first
        float st[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) st[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
            wgmma_tf32(st, al[j], b_desc(hi_s + 512 * j));
            wgmma_tf32(st, ah[j], b_desc(lo_s + 512 * j));
            wgmma_tf32(st, ah[j], b_desc(hi_s + 512 * j));
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] += st[e];

        if (s % n_kt == n_kt - 1) {
            // the chunk's power: a thread's accumulator pairs (4 j, 4 j +
            // 1) and (4 j + 2, 4 j + 3) are bin 4 j + q of frames rr and
            // rr + 8 of its warp's 16
            const int f = 16 * warp + rr;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int bin = 4 * j + q;
                pow_s[f * PSTR + bin] =
                    acc[4 * j] * acc[4 * j] + acc[4 * j + 1] * acc[4 * j + 1];
                pow_s[(f + 8) * PSTR + bin] = acc[4 * j + 2] * acc[4 * j + 2]
                    + acc[4 * j + 3] * acc[4 * j + 3];
            }
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[e] = 0.f;
            __syncthreads();
            // the chunk's mel partial sums on the CUDA cores: for each
            // frame and each mel band that overlaps the chunk, the sum
            // over the band's bins in the chunk, in bin order (threads
            // take consecutive frames of a band)
            const int chunk = rank + s / n_kt * cs;
            const int c0 = chunk * BINS;
            const int m0 = bands[3 * g.M + 2 * chunk];
            const int n_m = bands[3 * g.M + 2 * chunk + 1] + 1 - m0;
            for (int i = tid; i < FT * n_m; i += THREADS) {
                const int m = m0 + i / FT;
                const int fr = i % FT;
                const int lo = bands[3 * m];
                const int hi = bands[3 * m + 1];
                const int b0 = max(lo, c0);
                const int b1 = min(hi, c0 + BINS);
                if (b0 >= b1) continue;
                float sum = 0.f;
                for (int bin = b0; bin < b1; ++bin) {
                    sum = fmaf(pow_s[fr * PSTR + bin - c0],
                               __ldg(fb + (size_t)bin * g.M + m), sum);
                }
                part_s[fr * g.E + bands[3 * m + 2] + chunk - lo / BINS] =
                    sum;
            }
        }
    }

    // a band's sum: its chunks' partial sums in chunk order, read from
    // the CTA of the cluster that owns each chunk (this one when CS = 1);
    // rank c adds up frames [c * FPC, (c + 1) * FPC) of the tile
    cg::cluster_group cluster = cg::this_cluster();
    if (cs > 1) {
        cluster.sync();
    } else {
        __syncthreads();
    }
    const int fpc = (FT + cs - 1) / cs;
    const int f_lo = rank * fpc;
    const int f_hi = min(FT, f_lo + fpc);
    for (int i = tid; i < (f_hi - f_lo) * g.M; i += THREADS) {
        const int f = f_lo + i / g.M;
        const int m = i % g.M;
        const int lo = bands[3 * m];
        const int hi = bands[3 * m + 1];
        const float* entry = part_s + f * g.E + bands[3 * m + 2];
        float sum = 0.f;
        if (lo < hi) {
            for (int c = lo / BINS; c <= (hi - 1) / BINS; ++c) {
                const float* src = cs == 1
                    ? entry : cluster.map_shared_rank(entry, c % cs);
                sum += src[c - lo / BINS];
            }
        }
        const int frame = frame0 + f;
        if (frame < g.n_frames) {
            out[((size_t)b * g.n_frames + frame) * g.M + m] =
                logf(sum + eps);
        }
    }
    // no CTA leaves while a peer may still read its shared memory
    if (cs > 1) cluster.sync();
}

// The largest dynamic shared memory set on each route's kernel, per
// device: the attributes are set once per device and size, not on every
// call.
int configured[2][64];

template <bool SLICED>
cudaError_t launch(const float* sig, const float* basis, const float* fb,
                   const int* bands, float* out, const Geometry& g, int B,
                   int smem, float eps, int device, cudaStream_t stream) {
    if (smem > configured[SLICED][device]) {
        cudaError_t err = cudaFuncSetAttribute(
            fused_logmel_kernel<SLICED>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(
                fused_logmel_kernel<SLICED>,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        }
        if (err != cudaSuccess) return err;
        configured[SLICED][device] = smem;
    }
    const dim3 grid(g.CS * ((g.n_frames + FT - 1) / FT), B);
    if (g.CS == 1) {
        fused_logmel_kernel<SLICED><<<grid, THREADS, smem, stream>>>(
            sig, basis, fb, bands, out, g, eps);
        return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = g.CS;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, fused_logmel_kernel<SLICED>,
                                         sig, basis, fb, bands, out, g, eps);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on the host's plan (`logmel_plan`): tiles of 64 frames,
// clusters of CS CTAs (1 to 16, at most one per chunk of 32 bins), the
// span route (sliced = 0) or the sliced one, `smem` bytes of dynamic
// shared memory, which must equal what the kernel lays out.  sig is the
// unpadded (B, T) signal; `lo` zeros of the fading pad precede it, and
// n_frames frames of L samples every `shift` are taken.
// NCH = ceil(F / 32) chunks; the basis has NCH * LK * 64 floats in the
// kernel's layout (LK: L rounded up to 32).  bands: (M, 3) as the kernel
// takes them, E partial sums a frame.  A plan the kernel does not take is
// refused with cudaErrorInvalidValue before anything runs.  Returns
// cudaGetLastError() after the launch.
int fused_logmel_fwd(const void* sig, const void* basis, const void* fb,
                     const void* bands, void* out, int B, int T, int lo,
                     int n_frames, int L, int F, int M, int E, int shift,
                     int CS, int sliced, int smem, float eps, int device,
                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    Geometry g;
    g.T = T;
    g.lo = lo;
    g.n_frames = n_frames;
    g.L = L;
    g.LK = round_up(L, KT);
    g.F = F;
    g.M = M;
    g.shift = shift;
    g.SS = shift + (12 - shift % 8) % 8;
    g.NSEG = FT + (g.LK - 1) / (shift > 0 ? shift : 1);
    g.NCH = (F + BINS - 1) / BINS;
    g.CS = CS;
    g.E = E;
    g.sliced = sliced != 0;
    if (B < 1 || B > 65535 || T < 1 || lo < 0 || n_frames < 1 || L < 1
        || F < 1 || M < 1 || E < 0 || shift < 1 || device < 0
        || device >= 64 || CS < 1 || CS > MAX_CS || CS > g.NCH || smem < 0
        || (size_t)smem != sizeof(float) * smem_floats(g)) {
        return cudaErrorInvalidValue;
    }
    return (g.sliced ? launch<true> : launch<false>)(
        static_cast<const float*>(sig), static_cast<const float*>(basis),
        static_cast<const float*>(fb), static_cast<const int*>(bands),
        static_cast<float*>(out), g, B, smem, eps, device,
        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
