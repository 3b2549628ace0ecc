// LSTM cell recurrence over time, forward, in one cooperative launch per
// layer (both directions of a bidirectional layer together).  Two variants
// of one kernel: the lean inference forward, and the training forward,
// which also stores what the backward needs (the activated gates and
// c_{t-1} of every step).
//
// Replaces: padertorch_tpu/ops/pallas/lstm.py, `_fwd_kernel` through
// `_fwd_call(..., with_residuals=False)` (inference, `lstm_cell_scan`) and
// through `_fwd_call(..., with_residuals=True)` (training, `_vjp_fwd`).
//
// What bounds it on the card: the T steps are sequential, and each step
// is a (rows, H) @ (H, 4H) product that is small (rows = batch of one
// direction).  Reading W_hh from device memory every step would move
// D * H * 4H * 4 bytes per step (11.5 MB at H=600, D=2), so the weights
// have to stay on chip, but one SM holds at most 227 KB of shared memory.
// What is left per step is latency: reading h_{t-1}, which other blocks
// wrote, a chain of dependent FMAs per gate, and one grid-wide sync.
//
// Design (the GRU kernels' grid, gru_cell_scan.cu): a block owns one
// direction d, a slice of U hidden units with that slice's four gate
// columns of W_hh[d] in shared memory for the whole launch (H * U * 4
// floats), and a range of RB rows of its direction, whose c it keeps in
// shared memory (RB * U floats; c never leaves the block).  The host
// (`pick_scan_grid`, lstm_common.cuh) prefers wide unit slices, since
// every block of a row range stages the same rows of h, and splits the
// rows until the grid has about one block per SM.  With many rows and a
// small H (a dual-path RNN's chunk batches: 260 or 400 rows of H = 128 per
// direction) that spreads the rows over 128 blocks where unit slices alone
// gave 64 blocks walking 17 chunks of 16 rows one after another per step;
// with few rows and a large H (uPIT: 16 rows of H = 600) it is the grid
// the unit slices alone give.  Per step and chunk of RS rows of its range,
// a block copies h_{t-1} of those rows into shared memory with
// asynchronous L2-only copies (other blocks wrote it; L1 is not coherent)
// and loads its gate inputs while the copies fly.  The product's K loop
// (over H) is split into KS slices, one per group of threads, so that each
// thread's chain of dependent FMAs is H / KS long; a thread owns one (row,
// unit) pair of one slice, the slices' partial gates meet in shared
// memory, and the first slice's thread applies the cell and the mask
// freeze.  out[t] and h_t go to device memory, h_t through a ping-pong
// buffer.  Then the whole grid syncs once.  The product stays float32 on
// the CUDA cores (the limits tell TF32 from float32).  The training
// variant adds two stores per (row, unit) and step: the four activated
// gates as computed (also on a masked step) and c_{t-1} (on a masked step
// the frozen c); its residual layout is the backward kernel's
// (lstm_cell_scan_bwd.cu).  The inference variant is compiled without
// them, so it writes a third of the bytes.
//
// Streamed route (`STREAM`): where no grid that stages W_hh is
// co-resident (two directions of float32 W_hh at H = 1024 are 33.5 MB,
// the 132 SMs' shared memory about 30 MB), the same grid, chosen by the
// same rule with shared memory for everything but the weights, reads each
// block's weights from device memory every step (33.5 MB a step stays in
// the 50 MB L2), as the slots it would stage, packed once a launch
// (`pack_slots`, lstm_common.cuh: one load a slot; bf16 slots rounded
// once, half the bytes).  The arithmetic and its order are the resident route's,
// so a row's bits do not depend on the route.  The host tries the
// resident route first (`pick_route`, lstm_common.cuh), so every layer
// that fits keeps its grid.
//
// bf16 (`BF16`, the JAX package's `compute_dtype='bfloat16'` with bf16
// streams): gx is read, and out, the gates and c_seq are written, as bf16
// (`ScanTypes<true>`, lstm_common.cuh: widened on load, rounded to nearest
// even on store); the block's slice of W_hh[d] is rounded to bf16 as it
// is staged, so it takes half the shared memory and a block can hold
// twice the units; h_{t-1} stays float32 in shared memory and in the
// ping-pong buffer and is rounded to bf16 as the product reads it; the
// products of bf16 values are exact in float32, summed in float32 FMAs on
// the CUDA cores.  c, h and the final states stay float32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// gx: (T, R, 4H), R = D * Bd rows, row block d belongs to direction d.
// w: (D, H, 4H) (h @ w layout, gate column blocks i, f, g, o).
// mask: (T, R) or nullptr.  h0, c0: (R, H).
// out: (T, R, H); hT, cT: (R, H); hbuf: (2, R, H) scratch.
// TRAIN only: c_seq (T, R, H) gets c_{t-1}, gates (T, R, 4H) the activated
// gates in column blocks i, f, g, o.
// Block b: unit block ub = b % n_ub, row block rb = b / n_ub % n_rb,
// direction d = b / (n_ub * n_rb); rows [rb * RB, min(Bd, (rb + 1) * RB))
// of its direction.  Thread tid: K slice ks = tid / P, pair p = tid % P
// (row p / U of the chunk, unit p % U), P = RS * U.
// Shared memory: w_s (H, U) of W4 (the four gates' weights) | red
// (KS - 1, P) of float4 partial gates | h_s (RS, H) | c_s (RB, U).
// vec: H % 4 == 0 and h0, hbuf 16-byte aligned, so rows of h copy as
// float4.  BF16: gx, out, c_seq and gates are bf16 (see the top).
// STREAM: the streamed route (see the top): w_s is empty, w holds the
// packed slots (D, H, H) of W4, and the product reads the block's slots
// from device memory every step.
template <bool TRAIN, bool BF16, bool STREAM>
__global__ void __launch_bounds__(1024) lstm_fwd_kernel(
        const typename ScanTypes<BF16>::S* __restrict__ gx,
        const float* __restrict__ w,
        const float* __restrict__ mask, const float* __restrict__ h0,
        const float* __restrict__ c0,
        typename ScanTypes<BF16>::S* __restrict__ out,
        typename ScanTypes<BF16>::S* __restrict__ c_seq,
        typename ScanTypes<BF16>::S* __restrict__ gates,
        float* __restrict__ hT, float* __restrict__ cT,
        float* hbuf, int T, int Bd, int H, int U, int n_ub, int n_rb,
        int RB, int RS, int KS, int vec) {
    using Ty = ScanTypes<BF16>;
    using S = typename Ty::S;
    using W4 = typename Ty::W4;
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float4 smem4[];
    const int ub = blockIdx.x % n_ub;
    const int rb = blockIdx.x / n_ub % n_rb;
    const int d = blockIdx.x / (n_ub * n_rb);
    const int R = gridDim.x / (n_ub * n_rb) * Bd;
    const int G = 4 * H;
    const int P = RS * U;
    const int r_lo = rb * RB;
    const int r_hi = min(Bd, r_lo + RB);
    W4* w_s = reinterpret_cast<W4*>(smem4);           // (H, U) of 4 gates
    float4* red = reinterpret_cast<float4*>(w_s + (STREAM ? 0 : (size_t)H * U));
    float* h_s = reinterpret_cast<float*>(red + (size_t)(KS - 1) * P);
    float* c_s = h_s + (size_t)RS * H;                // (RB, U)
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int row0 = d * Bd;
    const int ks = tid / P;
    const int p = tid % P;
    const int u = p % U;
    const int j = ub * U + u;
    const int k_len = (H + KS - 1) / KS;
    const int k_lo = min(H, ks * k_len);
    const int k_hi = min(H, k_lo + k_len);

    // stage this block's slice of W_hh[d]; units past H are zero
    const float* wd = w + (size_t)d * H * G;
    for (int idx = tid; !STREAM && idx < H * U * 4; idx += nthreads) {
        const int k = idx / (4 * U);
        const int q = idx % (4 * U);
        const int g = q / U;
        const int uu = q % U;
        const int jj = ub * U + uu;
        const float v = jj < H ? wd[(size_t)k * G + g * H + jj] : 0.0f;
        Ty::set(w_s + (size_t)k * U + uu, g, v);
    }
    for (int q = tid; q < (r_hi - r_lo) * U; q += nthreads) {
        const int jj = ub * U + q % U;
        c_s[q] = jj < H ? c0[(size_t)(row0 + r_lo + q / U) * H + jj] : 0.0f;
    }

    for (int t = 0; t < T; ++t) {
        const float* h_prev = t == 0 ? h0 : hbuf + (size_t)((t - 1) & 1) * R * H;
        float* h_next = hbuf + (size_t)(t & 1) * R * H;
        for (int rc = r_lo; rc < r_hi; rc += RS) {
            const int nr = min(RS, r_hi - rc);
            const float* src = h_prev + (size_t)(row0 + rc) * H;
            if (rc > r_lo) __syncthreads();  // the previous chunk's readers
            if (vec) {
                for (int idx = tid; idx < nr * H / 4; idx += nthreads) {
                    cp_async16_cg(h_s + 4 * idx, src + 4 * idx);
                }
            } else {
                for (int idx = tid; idx < nr * H; idx += nthreads) {
                    h_s[idx] = __ldcg(src + idx);
                }
            }
            const int r = rc + p / U;
            const int row = row0 + r;
            const bool active = ks < KS && p < nr * U && j < H;
            const bool first = active && ks == 0;
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
            float m = 1.f;
            if (first) {
                const S* gxr = gx + ((size_t)t * R + row) * G;
                acc = make_float4(Ty::ld(gxr + j), Ty::ld(gxr + H + j),
                                  Ty::ld(gxr + 2 * H + j),
                                  Ty::ld(gxr + 3 * H + j));
                if (mask != nullptr) m = mask[(size_t)t * R + row];
            }
            if (vec) cp_async_wait_all();
            __syncthreads();
            const float* hr = h_s + (size_t)(r - rc) * H;
            if (active) {
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k) {
                    const float hk = Ty::operand(hr[k]);
                    float4 wk;
                    if constexpr (STREAM) {
                        // the staged slot, packed in device memory
                        wk = Ty::unpack(__ldg(
                            reinterpret_cast<const W4*>(w)
                            + ((size_t)d * H + k) * H + j));
                    } else {
                        wk = Ty::unpack(w_s[(size_t)k * U + u]);
                    }
                    acc.x = fmaf(hk, wk.x, acc.x);
                    acc.y = fmaf(hk, wk.y, acc.y);
                    acc.z = fmaf(hk, wk.z, acc.z);
                    acc.w = fmaf(hk, wk.w, acc.w);
                }
                if (ks > 0) red[(size_t)(ks - 1) * P + p] = acc;
            }
            __syncthreads();
            if (!first) continue;
            for (int s = 0; s < KS - 1; ++s) {
                const float4 v = red[(size_t)s * P + p];
                acc.x += v.x;
                acc.y += v.y;
                acc.z += v.z;
                acc.w += v.w;
            }
            const float i_ = sigmoidf_(acc.x);
            const float f_ = sigmoidf_(acc.y);
            const float g_ = tanhf(acc.z);
            const float o_ = sigmoidf_(acc.w);
            float* cp = c_s + (size_t)(r - r_lo) * U + u;
            const float c_old = *cp;
            float c_new = f_ * c_old + i_ * g_;
            float h_new = o_ * tanhf(c_new);
            float h_out = h_new;
            if (TRAIN) {
                S* gr = gates + ((size_t)t * R + row) * G;
                Ty::st(gr + j, i_);
                Ty::st(gr + H + j, f_);
                Ty::st(gr + 2 * H + j, g_);
                Ty::st(gr + 3 * H + j, o_);
                Ty::st(c_seq + ((size_t)t * R + row) * H + j, c_old);
            }
            if (mask != nullptr) {
                if (!(m > 0.0f)) {
                    h_new = hr[j];
                    c_new = c_old;
                }
                h_out = h_new * m;
            }
            *cp = c_new;
            Ty::st(out + ((size_t)t * R + row) * H + j, h_out);
            __stcg(h_next + (size_t)row * H + j, h_new);
            if (t == T - 1) {
                hT[(size_t)row * H + j] = h_new;
                cT[(size_t)row * H + j] = c_new;
            }
        }
        grid.sync();
    }
}

// The grid of a launch (`pick_route`, lstm_common.cuh): resident or
// streamed, with the LSTM's shared memory (the weights' four gate columns,
// in the variant's element type, on the resident route only; the partial
// gates of KS - 1 slices, h of RS rows and c of the block's RB rows).
template <bool TRAIN, bool BF16>
cudaError_t pick_grid(int D, int Bd, int H, int device, ScanGrid* best,
                      int* streamed) {
    using W4 = typename ScanTypes<BF16>::W4;
    int n_sm = 0, max_smem = 0, coop = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (!coop) return cudaErrorNotSupported;
    const auto rest = [H](int U, int RB, int RS, int KS) {
        return sizeof(float) * ((size_t)(KS - 1) * RS * U * 4
                                + (size_t)RS * H + (size_t)RB * U);
    };
    return pick_route((const void*)lstm_fwd_kernel<TRAIN, BF16, false>,
                      (const void*)lstm_fwd_kernel<TRAIN, BF16, true>, D, Bd,
                      H, H, n_sm, max_smem, sizeof(W4) * (size_t)H, rest,
                      best, streamed);
}

// Launch the whole recurrence on the grid `pick_grid` chooses (on the
// streamed route W_hh packed into `wpack`, packed_slots_bytes of the
// forward; it may be null on the resident route).  Fails
// with cudaErrorCooperativeLaunchTooLarge when no grid is co-resident on
// either route.  Returns cudaGetLastError() after the launch.
template <bool TRAIN, bool BF16>
int launch_fwd(const void* gx, const void* w, void* wpack, const void* mask,
               const void* h0, const void* c0, void* out, void* c_seq,
               void* gates, void* hT, void* cT, void* hbuf, int T, int D,
               int Bd, int H, int device, void* stream) {
    using S = typename ScanTypes<BF16>::S;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid best;
    int streamed = 0;
    err = pick_grid<TRAIN, BF16>(D, Bd, H, device, &best, &streamed);
    if (err != cudaSuccess) return err;
    if (best.blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
    const void* kernel =
        streamed ? (const void*)lstm_fwd_kernel<TRAIN, BF16, true>
                 : (const void*)lstm_fwd_kernel<TRAIN, BF16, false>;
    int vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0
              && reinterpret_cast<uintptr_t>(hbuf) % 16 == 0;
    const S* gx_ = static_cast<const S*>(gx);
    const float* w_ = static_cast<const float*>(w);
    if (streamed) {
        err = pack_slots<BF16>(w_, wpack, D, H, 4, true,
                               static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return err;
        w_ = static_cast<const float*>(wpack);
    }
    const float* mask_ = static_cast<const float*>(mask);
    const float* h0_ = static_cast<const float*>(h0);
    const float* c0_ = static_cast<const float*>(c0);
    S* out_ = static_cast<S*>(out);
    S* c_seq_ = static_cast<S*>(c_seq);
    S* gates_ = static_cast<S*>(gates);
    float* hT_ = static_cast<float*>(hT);
    float* cT_ = static_cast<float*>(cT);
    float* hbuf_ = static_cast<float*>(hbuf);
    void* args[] = {&gx_, &w_, &mask_, &h0_, &c0_, &out_, &c_seq_, &gates_,
                    &hT_, &cT_, &hbuf_, &T, &Bd, &H, &best.U, &best.n_ub,
                    &best.n_rb, &best.RB, &best.RS, &best.KS, &vec};
    err = cudaLaunchCooperativeKernel(
        kernel, dim3(best.blocks), dim3(best.threads), args, best.smem,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Inference forward: out, h_T, c_T.  `wpack`: scratch of
// packed_slots_bytes(bf16, D, H, 4, fwd) for the streamed route's packed
// weights, null where the card takes the resident route.
int lstm_cell_scan_fwd(const void* gx, const void* w, void* wpack,
                       const void* mask, const void* h0, const void* c0,
                       void* out, void* hT, void* cT, void* hbuf, int T,
                       int D, int Bd, int H, int device, void* stream) {
    return launch_fwd<false, false>(gx, w, wpack, mask, h0, c0, out,
                                    nullptr, nullptr, hT, cT, hbuf, T, D, Bd,
                                    H, device, stream);
}

// Training forward: also c_seq (T, R, H) and gates (T, R, 4H).
int lstm_cell_scan_fwd_train(const void* gx, const void* w, void* wpack,
                             const void* mask, const void* h0,
                             const void* c0, void* out, void* c_seq,
                             void* gates, void* hT, void* cT, void* hbuf,
                             int T, int D, int Bd, int H, int device,
                             void* stream) {
    return launch_fwd<true, false>(gx, w, wpack, mask, h0, c0, out, c_seq,
                                   gates, hT, cT, hbuf, T, D, Bd, H, device,
                                   stream);
}

// The bf16 variants: gx, out (and c_seq, gates) bf16; w, mask, h0, c0,
// hT, cT float32; products of bf16-rounded operands summed in float32.
int lstm_cell_scan_fwd_bf16(const void* gx, const void* w, void* wpack,
                            const void* mask, const void* h0,
                            const void* c0, void* out, void* hT, void* cT,
                            void* hbuf, int T, int D, int Bd, int H,
                            int device, void* stream) {
    return launch_fwd<false, true>(gx, w, wpack, mask, h0, c0, out, nullptr,
                                   nullptr, hT, cT, hbuf, T, D, Bd, H,
                                   device, stream);
}

int lstm_cell_scan_fwd_train_bf16(const void* gx, const void* w,
                                  void* wpack, const void* mask,
                                  const void* h0, const void* c0, void* out,
                                  void* c_seq, void* gates, void* hT,
                                  void* cT, void* hbuf, int T, int D, int Bd,
                                  int H, int device, void* stream) {
    return launch_fwd<true, true>(gx, w, wpack, mask, h0, c0, out, c_seq,
                                  gates, hT, cT, hbuf, T, D, Bd, H, device,
                                  stream);
}

// A measurement aid for the streamed route: an L2 access-policy window
// that marks `bytes` from `ptr` as persisting for the kernels launched on
// `stream` (hit ratio: the share of the window the card's persisting L2
// holds, which is set to its largest), or with `bytes` 0 clears the
// window and the persisting lines.  out[0..1] = the persisting L2's bytes
// and the window's.
int scan_l2_window(const void* ptr, size_t bytes, int device, void* stream,
                   void* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    int max_persist = 0, max_window = 0;
    cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize,
                           device);
    cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize,
                           device);
    const size_t window = bytes < (size_t)max_window ? bytes
                                                     : (size_t)max_window;
    cudaStreamAttrValue attr = {};
    attr.accessPolicyWindow.base_ptr = const_cast<void*>(ptr);
    attr.accessPolicyWindow.num_bytes = window;
    attr.accessPolicyWindow.hitRatio =
        window == 0 ? 0.0f
                    : (max_persist >= (int)window ? 1.0f
                                                  : (float)max_persist / window);
    attr.accessPolicyWindow.hitProp = window == 0 ? cudaAccessPropertyNormal
                                                  : cudaAccessPropertyPersisting;
    attr.accessPolicyWindow.missProp = window == 0 ? cudaAccessPropertyNormal
                                                   : cudaAccessPropertyStreaming;
    if (window > 0) {
        err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, max_persist);
        if (err != cudaSuccess) return err;
    }
    err = cudaStreamSetAttribute(static_cast<cudaStream_t>(stream),
                                 cudaStreamAttributeAccessPolicyWindow, &attr);
    if (err != cudaSuccess) return err;
    if (window == 0) {
        err = cudaCtxResetPersistingL2Cache();
        if (err != cudaSuccess) return err;
        err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
        if (err != cudaSuccess) return err;
    }
    int* o = static_cast<int*>(out);
    o[0] = max_persist;
    o[1] = (int)window;
    return cudaSuccess;
}

// The grid a launch of the lean (train = 0) or training forward, float32
// (bf16 = 0) or bf16, at (D, Bd, H) takes: out[0..6] = U, n_rb, RB, RS,
// KS, blocks (0 when no grid is co-resident), streamed (1: the streamed
// route).
int lstm_cell_scan_fwd_grid(int D, int Bd, int H, int bf16, int train,
                            int device, void* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid g;
    int streamed = 0;
    err = bf16 ? (train ? pick_grid<true, true>(D, Bd, H, device, &g,
                                                &streamed)
                        : pick_grid<false, true>(D, Bd, H, device, &g,
                                                 &streamed))
               : (train ? pick_grid<true, false>(D, Bd, H, device, &g,
                                                 &streamed)
                        : pick_grid<false, false>(D, Bd, H, device, &g,
                                                  &streamed));
    if (err != cudaSuccess) return err;
    int* o = static_cast<int*>(out);
    o[0] = g.U;
    o[1] = g.n_rb;
    o[2] = g.RB;
    o[3] = g.RS;
    o[4] = g.KS;
    o[5] = g.blocks;
    o[6] = streamed;
    return cudaSuccess;
}

}  // extern "C"
