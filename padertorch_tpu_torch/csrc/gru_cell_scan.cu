// GRU cell recurrence over time, forward, in one cooperative launch per
// layer (both directions of a bidirectional layer together).  Two variants
// of one kernel: the lean inference forward, and the training forward,
// which also stores what the backward needs (the gates r, z, n, the n
// block of h_{t-1} @ W_hh, and h_{t-1} itself).
//
// Replaces: padertorch_tpu/ops/pallas/gru.py, `_fwd_kernel` through
// `_fwd_call(..., with_residuals=False)` (inference, `gru_cell_scan`) and
// through `_fwd_call(..., with_residuals=True)` (training, `_vjp_fwd`).
//
// What bounds it on the card: as for the LSTM (lstm_cell_scan.cu) the T
// steps are sequential and each holds a (rows, H) @ (H, 3H) product too
// small to fill the card, so W_hh has to stay on chip for the whole launch
// and what is left per step is latency: reading h_{t-1}, which other
// blocks wrote, a chain of dependent FMAs, and one grid-wide sync.
//
// Design: the LSTM kernel's, with two changes.  (1) The three products
// gh_r, gh_z, gh_n start from zero and the input gates are added
// afterwards, because the n gate is tanh(gx_n + r * gh_n): gh_n must stay
// apart from gx_n (and is a residual).  (2) The GRU carries no second
// state, so a block needs nothing from one step to the next but W_hh:
// the rows of a direction are split over blocks too.  A block owns a
// direction d, a slice of U hidden units with their three gate columns of
// W_hh[d] in shared memory (float4 per (k, unit), one lane unused), and a
// range of RB rows.  The host prefers wide unit slices (every block of a
// row range stages the same rows of h, so wide slices stage less) and
// splits the rows until the grid has about one block per SM; with many
// rows and a small H (a dual-path RNN's chunk batches) that fills the
// card where unit slices alone would not.  Per step and chunk of RS rows a
// block copies h_{t-1} of those rows into shared memory with asynchronous
// L2-only copies and loads its input gates while the copies fly; the K
// loop is split into KS slices, one per group of threads, a thread owns
// one (row, unit) pair of one slice, the partial sums meet in shared
// memory and the first slice's thread applies the cell and the mask
// freeze.  out[t] and h_t go to device memory, h_t through a ping-pong
// buffer, then the grid syncs once.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// gx: (T, R, 3H), R = D * Bd rows, row block d belongs to direction d.
// w: (D, H, 3H) (h @ w layout, gate column blocks r, z, n).
// mask: (T, R) or nullptr.  h0: (R, H).
// out: (T, R, H); hT: (R, H); hbuf: (2, R, H) scratch.
// TRAIN only: acts (T, R, 3H) gets r, z, n; ghn (T, R, H) the n block of
// h_{t-1} @ w; hprev (T, R, H) gets h_{t-1}.
// Block b: unit block ub = b % n_ub, row block rb = b / n_ub % n_rb,
// direction d = b / (n_ub * n_rb); rows [rb * RB, min(Bd, (rb + 1) * RB))
// of its direction.  Thread tid: K slice ks = tid / P, pair p = tid % P
// (row p / U of the chunk, unit p % U), P = RS * U.
// Shared memory: w_s (H, U) of float4 | red (KS - 1, P) of float4 |
// h_s (RS, H).
// vec: H % 4 == 0 and h0, hbuf 16-byte aligned, so rows of h copy as
// float4.
template <bool TRAIN>
__global__ void __launch_bounds__(1024) gru_fwd_kernel(
        const float* __restrict__ gx, const float* __restrict__ w,
        const float* __restrict__ mask, const float* __restrict__ h0,
        float* __restrict__ out, float* __restrict__ acts,
        float* __restrict__ ghn, float* __restrict__ hprev,
        float* __restrict__ hT, float* hbuf, int T, int Bd, int H, int U,
        int n_ub, int n_rb, int RB, int RS, int KS, int vec) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int ub = blockIdx.x % n_ub;
    const int rb = blockIdx.x / n_ub % n_rb;
    const int d = blockIdx.x / (n_ub * n_rb);
    const int R = gridDim.x / (n_ub * n_rb) * Bd;
    const int G = 3 * H;
    const int P = RS * U;
    const int r_lo = rb * RB;
    const int r_hi = min(Bd, r_lo + RB);
    const float4* w_s = smem4;                        // (H, U) of 3 gates
    float4* red = smem4 + (size_t)H * U;              // (KS - 1, P)
    float* h_s = reinterpret_cast<float*>(red + (size_t)(KS - 1) * P);
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
    for (int idx = tid; idx < H * U * 3; idx += nthreads) {
        const int k = idx / (3 * U);
        const int q = idx % (3 * U);
        const int g = q / U;
        const int uu = q % U;
        const int jj = ub * U + uu;
        const float v = jj < H ? wd[(size_t)k * G + g * H + jj] : 0.0f;
        smem[((size_t)k * U + uu) * 4 + g] = v;
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
            float gx_r = 0.f, gx_z = 0.f, gx_n = 0.f, m = 1.f;
            if (first) {
                const float* gxr = gx + ((size_t)t * R + row) * G;
                gx_r = gxr[j];
                gx_z = gxr[H + j];
                gx_n = gxr[2 * H + j];
                if (mask != nullptr) m = mask[(size_t)t * R + row];
            }
            if (vec) cp_async_wait_all();
            __syncthreads();
            const float* hr = h_s + (size_t)(r - rc) * H;
            float acc_r = 0.f, acc_z = 0.f, acc_n = 0.f;
            if (active) {
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k) {
                    const float hk = hr[k];
                    const float4 wk = w_s[(size_t)k * U + u];
                    acc_r = fmaf(hk, wk.x, acc_r);
                    acc_z = fmaf(hk, wk.y, acc_z);
                    acc_n = fmaf(hk, wk.z, acc_n);
                }
                if (ks > 0) {
                    red[(size_t)(ks - 1) * P + p] =
                        make_float4(acc_r, acc_z, acc_n, 0.f);
                }
            }
            __syncthreads();
            if (!first) continue;
            for (int s = 0; s < KS - 1; ++s) {
                const float4 v = red[(size_t)s * P + p];
                acc_r += v.x;
                acc_z += v.y;
                acc_n += v.z;
            }
            const float h_old = hr[j];
            const float r_ = sigmoidf_(gx_r + acc_r);
            const float z_ = sigmoidf_(gx_z + acc_z);
            const float n_ = tanhf(gx_n + r_ * acc_n);
            float h_new = (1.0f - z_) * n_ + z_ * h_old;
            float h_out = h_new;
            const size_t at = (size_t)t * R + row;
            if (TRAIN) {
                float* ar = acts + at * G;
                ar[j] = r_;
                ar[H + j] = z_;
                ar[2 * H + j] = n_;
                ghn[at * H + j] = acc_n;
                hprev[at * H + j] = h_old;
            }
            if (mask != nullptr) {
                if (!(m > 0.0f)) h_new = h_old;
                h_out = h_new * m;
            }
            out[at * H + j] = h_out;
            __stcg(h_next + (size_t)row * H + j, h_new);
            if (t == T - 1) hT[(size_t)row * H + j] = h_new;
        }
        grid.sync();
    }
}

// Launch the whole recurrence on the grid `pick_scan_grid` chooses.  Fails
// with cudaErrorCooperativeLaunchTooLarge when no grid is co-resident.
// Returns cudaGetLastError() after the launch.
template <bool TRAIN>
int launch_fwd(const void* gx, const void* w, const void* mask,
               const void* h0, void* out, void* acts, void* ghn,
               void* hprev, void* hT, void* hbuf, int T, int D, int Bd,
               int H, int device, void* stream) {
    const void* kernel = (const void*)gru_fwd_kernel<TRAIN>;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    int n_sm = 0, max_smem = 0, coop = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (!coop) return cudaErrorNotSupported;
    const auto smem_bytes = [H](int U, int RB, int RS, int KS) {
        return sizeof(float) * ((size_t)H * U * 4
                                + (size_t)(KS - 1) * RS * U * 4
                                + (size_t)RS * H);
    };
    ScanGrid best;
    err = pick_scan_grid(kernel, D, Bd, H, H, n_sm, max_smem, smem_bytes,
                         &best);
    if (err != cudaSuccess) return err;
    if (best.blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
    int vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0
              && reinterpret_cast<uintptr_t>(hbuf) % 16 == 0;
    const float* gx_ = static_cast<const float*>(gx);
    const float* w_ = static_cast<const float*>(w);
    const float* mask_ = static_cast<const float*>(mask);
    const float* h0_ = static_cast<const float*>(h0);
    float* out_ = static_cast<float*>(out);
    float* acts_ = static_cast<float*>(acts);
    float* ghn_ = static_cast<float*>(ghn);
    float* hprev_ = static_cast<float*>(hprev);
    float* hT_ = static_cast<float*>(hT);
    float* hbuf_ = static_cast<float*>(hbuf);
    void* args[] = {&gx_, &w_, &mask_, &h0_, &out_, &acts_, &ghn_, &hprev_,
                    &hT_, &hbuf_, &T, &Bd, &H, &best.U, &best.n_ub,
                    &best.n_rb, &best.RB, &best.RS, &best.KS, &vec};
    err = cudaLaunchCooperativeKernel(
        kernel, dim3(best.blocks), dim3(best.threads), args,
        best.smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Inference forward: out, h_T.
int gru_cell_scan_fwd(const void* gx, const void* w, const void* mask,
                      const void* h0, void* out, void* hT, void* hbuf,
                      int T, int D, int Bd, int H, int device,
                      void* stream) {
    return launch_fwd<false>(gx, w, mask, h0, out, nullptr, nullptr, nullptr,
                             hT, hbuf, T, D, Bd, H, device, stream);
}

// Training forward: also acts (T, R, 3H), ghn and hprev (T, R, H).
int gru_cell_scan_fwd_train(const void* gx, const void* w, const void* mask,
                            const void* h0, void* out, void* acts, void* ghn,
                            void* hprev, void* hT, void* hbuf, int T, int D,
                            int Bd, int H, int device, void* stream) {
    return launch_fwd<true>(gx, w, mask, h0, out, acts, ghn, hprev, hT, hbuf,
                            T, D, Bd, H, device, stream);
}

}  // extern "C"
