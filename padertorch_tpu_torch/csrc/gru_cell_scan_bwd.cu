// GRU cell recurrence, backward: the adjoint recurrence in reverse time,
// in one cooperative launch per layer (both directions together).
//
// Replaces: padertorch_tpu/ops/pallas/gru.py, `_bwd_kernel` through
// `_bwd_call` (`_vjp_bwd`).  As there, dW_hh is a matrix product outside
// the kernel; the kernel emits two streams of pre-activation adjoints per
// step, dgx = (da_r, dz_pre, da_n) for the input projection and
// dgh = (da_r, dz_pre, da_n * r) for the recurrent product and dW_hh, and
// the adjoint of the initial state.
//
// What bounds it on the card: as in the forward the T steps are
// sequential and each holds a small product, here dh_{t-1} = dgh_t @
// W_hh[d]^T + dh_t * z_t, (rows, 3H) x (3H, H).  The weights must stay on
// chip for the whole launch; what is left per step is latency: a round
// through L2 for dgh_t (a block needs all 3H columns of its rows, other
// blocks wrote them), a chain of dependent FMAs, and one grid-wide sync.
//
// Design: the LSTM backward's (lstm_cell_scan_bwd.cu) on the GRU forward's
// grid.  Everything but the product is elementwise in (row, unit), so a
// block owns a direction d, U units and a range of RB rows, keeps the
// carry dh of its (row, unit) pairs in shared memory, and the rows
// W_hh[d][j, :] of its units there too (as float4 over four neighbouring
// columns, the 3H columns padded with zeros to a multiple of four).  A
// step has two parts.  "cell": from the stored gates, gh_n, h_{t-1},
// d_out[t] and the carry, a thread per (row, unit) forms the adjoints,
// writes dgx[t] and dgh[t] (outputs anyway) and keeps dh * z.  After one
// grid sync, "product": for chunks of RS rows a block copies dgh[t] of
// those rows, all 3H columns, from L2 into shared memory (asynchronous
// copies that bypass L1) and forms dh_{t-1} for its own units; the sum is
// split into KS slices, one per group of threads, which meet in shared
// memory.  The cell part of step t-1 follows without another grid sync: it
// writes dgh[t-1] while slower blocks may still read dgh[t].
//
// Masked steps (mask 0): dgx and dgh are 0 and dh passes through unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// acts: (T, R, 3H) gates r, z, n; ghn, hprev: (T, R, H); w: (D, H, 3H);
// mask: (T, R) or nullptr; dout: (T, R, H); dhT: (R, H).
// dgx, dgh: (T, R, 3H) out; dh0: (R, H) out.  R = D * Bd.
// Block b: unit block ub = b % n_ub, row block rb = b / n_ub % n_rb,
// direction d = b / (n_ub * n_rb); rows [rb * RB, min(Bd, (rb + 1) * RB))
// of its direction.  In the product, thread tid: K slice ks = tid / P, pair
// p = tid % P (row p / U of the chunk, unit p % U), P = RS * U.
// G4 = ceil(3H / 4).  Shared memory: w_s (G4, U) of float4 (columns
// 4k..4k+3 of unit u's row) | dgh_s (RS, G4) of float4 | red (KS - 1, P) |
// dh_s (RB, U) | dhz_s (RB, U).
// vec: H % 4 == 0 and dgh 16-byte aligned, so rows of dgh copy as float4.
__global__ void __launch_bounds__(1024) gru_bwd_kernel(
        const float* __restrict__ acts, const float* __restrict__ ghn,
        const float* __restrict__ hprev, const float* __restrict__ w,
        const float* __restrict__ mask, const float* __restrict__ dout,
        const float* __restrict__ dhT, float* __restrict__ dgx, float* dgh,
        float* __restrict__ dh0, int T, int Bd, int H, int U, int n_ub,
        int n_rb, int RB, int RS, int KS, int vec) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float4 smem4[];
    const int ub = blockIdx.x % n_ub;
    const int rb = blockIdx.x / n_ub % n_rb;
    const int d = blockIdx.x / (n_ub * n_rb);
    const int R = gridDim.x / (n_ub * n_rb) * Bd;
    const int G = 3 * H;
    const int G4 = (G + 3) / 4;
    const int P = RS * U;
    const int r_lo = rb * RB;
    const int r_hi = min(Bd, r_lo + RB);
    const int n_own = (r_hi - r_lo) * U;                  // (row, unit) pairs
    float4* w_s = smem4;                                  // (G4, U)
    float4* dgh_s = smem4 + (size_t)G4 * U;               // (RS, G4)
    float* red = reinterpret_cast<float*>(dgh_s + (size_t)RS * G4);
    float* dh_s = red + (size_t)(KS - 1) * P;             // (RB, U)
    float* dhz_s = dh_s + (size_t)RB * U;                 // (RB, U)
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int row0 = d * Bd;
    const int ks = tid / P;
    const int p = tid % P;
    const int u = p % U;
    const int j = ub * U + u;
    const int k_len = (G4 + KS - 1) / KS;
    const int k_lo = min(G4, ks * k_len);
    const int k_hi = min(G4, k_lo + k_len);

    // zero the weights and the staging buffer once (the columns past 3H
    // stay zero), then stage the rows of W_hh[d] that belong to this
    // block's units; units past H are zero
    for (int idx = tid; idx < G4 * (U + RS); idx += nthreads) {
        smem4[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const float* wd = w + (size_t)d * H * G;
    float* w_sf = reinterpret_cast<float*>(w_s);
    for (int idx = tid; idx < U * G; idx += nthreads) {
        const int uu = idx / G;
        const int c = idx % G;
        const int jj = ub * U + uu;
        if (jj < H) {
            w_sf[((size_t)(c / 4) * U + uu) * 4 + c % 4] =
                wd[(size_t)jj * G + c];
        }
    }
    for (int q = tid; q < n_own; q += nthreads) {
        const int jj = ub * U + q % U;
        dh_s[q] = jj < H
            ? dhT[(size_t)(row0 + r_lo + q / U) * H + jj] : 0.0f;
    }
    __syncthreads();

    // the elementwise part of step t: dgx[t], dgh[t] for this block's
    // (row, unit) pairs, and dh * z for the product's epilogue
    auto cell = [&](int t) {
        for (int q = tid; q < n_own; q += nthreads) {
            const int jj = ub * U + q % U;
            if (jj >= H) continue;
            const size_t at = (size_t)t * R + row0 + r_lo + q / U;
            const float* ar = acts + at * G;
            const float r_ = ar[jj];
            const float z_ = ar[H + jj];
            const float n_ = ar[2 * H + jj];
            const float gh_n = ghn[at * H + jj];
            const float h_prev = hprev[at * H + jj];
            const float m = mask != nullptr ? mask[at] : 1.0f;
            const float dh = dh_s[q] + dout[at * H + jj];
            const float dz_pre = dh * (h_prev - n_) * z_ * (1.0f - z_);
            const float da_n = dh * (1.0f - z_) * (1.0f - n_ * n_);
            const float da_r = da_n * gh_n * r_ * (1.0f - r_);
            float* xr = dgx + at * G;
            xr[jj] = da_r * m;
            xr[H + jj] = dz_pre * m;
            xr[2 * H + jj] = da_n * m;
            float* hr = dgh + at * G;
            __stcg(hr + jj, da_r * m);
            __stcg(hr + H + jj, dz_pre * m);
            __stcg(hr + 2 * H + jj, da_n * r_ * m);
            dhz_s[q] = dh * z_;
        }
    };

    cell(T - 1);
    for (int t = T - 1; t >= 0; --t) {
        grid.sync();  // dgh[t] of every block is in L2
        for (int rc = r_lo; rc < r_hi; rc += RS) {
            const int nr = min(RS, r_hi - rc);
            const float* src = dgh + ((size_t)t * R + row0 + rc) * G;
            if (rc > r_lo) __syncthreads();  // the previous chunk's readers
            if (vec) {
                // G % 4 == 0: rows are G4 float4 long, back to back
                const float4* src4 = reinterpret_cast<const float4*>(src);
                for (int idx = tid; idx < nr * G4; idx += nthreads) {
                    cp_async16_cg(dgh_s + idx, src4 + idx);
                }
            } else {
                float* dst = reinterpret_cast<float*>(dgh_s);
                for (int idx = tid; idx < nr * G; idx += nthreads) {
                    dst[(size_t)(idx / G) * 4 * G4 + idx % G] =
                        __ldcg(src + idx);
                }
            }
            const int r = rc + p / U;
            const bool active = ks < KS && p < nr * U && j < H;
            const bool first = active && ks == 0;
            float m = 1.f;
            if (first && mask != nullptr) {
                m = mask[(size_t)t * R + row0 + r];
            }
            if (vec) cp_async_wait_all();
            __syncthreads();
            float acc = 0.f;
            if (active) {
                const float4* dr = dgh_s + (size_t)(r - rc) * G4;
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k) {
                    const float4 z = dr[k];
                    const float4 wk = w_s[(size_t)k * U + u];
                    acc = fmaf(z.x, wk.x, acc);
                    acc = fmaf(z.y, wk.y, acc);
                    acc = fmaf(z.z, wk.z, acc);
                    acc = fmaf(z.w, wk.w, acc);
                }
                if (ks > 0) red[(size_t)(ks - 1) * P + p] = acc;
            }
            __syncthreads();
            if (!first) continue;
            for (int s = 0; s < KS - 1; ++s) acc += red[(size_t)s * P + p];
            const int q = (r - r_lo) * U + u;
            if (m > 0.0f) dh_s[q] = acc + dhz_s[q];
        }
        __syncthreads();  // dh_s complete before the cell part reads it
        if (t > 0) cell(t - 1);
    }
    for (int q = tid; q < n_own; q += nthreads) {
        const int jj = ub * U + q % U;
        if (jj >= H) continue;
        dh0[(size_t)(row0 + r_lo + q / U) * H + jj] = dh_s[q];
    }
}

}  // namespace

extern "C" {

// Launch the whole adjoint recurrence on the grid `pick_scan_grid`
// chooses.  Fails with cudaErrorCooperativeLaunchTooLarge when no grid is
// co-resident.  Returns cudaGetLastError() after the launch.
int gru_cell_scan_bwd(const void* acts, const void* ghn, const void* hprev,
                      const void* w, const void* mask, const void* dout,
                      const void* dhT, void* dgx, void* dgh, void* dh0,
                      int T, int D, int Bd, int H, int device,
                      void* stream) {
    const void* kernel = (const void*)gru_bwd_kernel;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    int n_sm = 0, max_smem = 0, coop = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (!coop) return cudaErrorNotSupported;
    const int G4 = (3 * H + 3) / 4;
    const auto smem_bytes = [G4](int U, int RB, int RS, int KS) {
        return sizeof(float) * ((size_t)G4 * U * 4 + (size_t)RS * G4 * 4
                                + (size_t)(KS - 1) * RS * U
                                + 2 * (size_t)RB * U);
    };
    ScanGrid best;
    err = pick_scan_grid(kernel, D, Bd, H, G4, n_sm, max_smem, smem_bytes,
                         &best);
    if (err != cudaSuccess) return err;
    if (best.blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
    int vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(dgh) % 16 == 0;
    const float* acts_ = static_cast<const float*>(acts);
    const float* ghn_ = static_cast<const float*>(ghn);
    const float* hprev_ = static_cast<const float*>(hprev);
    const float* w_ = static_cast<const float*>(w);
    const float* mask_ = static_cast<const float*>(mask);
    const float* dout_ = static_cast<const float*>(dout);
    const float* dhT_ = static_cast<const float*>(dhT);
    float* dgx_ = static_cast<float*>(dgx);
    float* dgh_ = static_cast<float*>(dgh);
    float* dh0_ = static_cast<float*>(dh0);
    void* args[] = {&acts_, &ghn_, &hprev_, &w_, &mask_, &dout_, &dhT_,
                    &dgx_, &dgh_, &dh0_, &T, &Bd, &H, &best.U, &best.n_ub,
                    &best.n_rb, &best.RB, &best.RS, &best.KS, &vec};
    err = cudaLaunchCooperativeKernel(
        kernel, dim3(best.blocks), dim3(best.threads), args, best.smem,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // extern "C"
