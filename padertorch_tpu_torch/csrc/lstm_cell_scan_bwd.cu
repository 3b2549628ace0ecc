// LSTM cell recurrence, backward: the adjoint recurrence in reverse time,
// in one cooperative launch per layer (both directions together).
//
// Replaces: padertorch_tpu/ops/pallas/lstm.py, `_bwd_kernel` through
// `_bwd_call` (`_vjp_bwd`).  As there, dW_hh is a matrix product outside
// the kernel; the kernel emits the gate pre-activation adjoints dz
// (= dgates_x) per step and the adjoints of the initial state.
//
// What bounds it on the card: as in the forward the T steps are
// sequential and each holds a small product, here dh_{t-1} = dz_t @
// W_hh[d]^T, (rows, 4H) x (4H, H).  The weights must stay on chip for the
// whole launch; what is left per step is latency: a round through L2 for
// dz_t (every block needs all 4H columns of it, other blocks wrote them),
// a chain of dependent FMAs, and one grid-wide sync.
//
// Design: everything but the product is elementwise in the hidden unit,
// so the forward's ownership carries over.  A block owns one direction d
// and U units, keeps the carries dh and dc of its units in shared memory,
// and keeps the rows W_hh[d][j, :] of its units there too (U * 4H floats,
// as many bytes as the forward's slice, read along the other axis; stored
// as float4 over four neighbouring columns).  A step has two parts.
// "cell": from the stored gates, c_{t-1}, d_out[t] and the carries, a
// thread per (row, unit) forms dz for its unit's four gates, writes them
// to dgx[t] (an output anyway) and updates dc.  After one grid sync,
// "product": for chunks of RS rows a block copies dz[t] of those rows, all
// 4H columns, from L2 into shared memory (asynchronous copies that bypass
// L1) and forms dh_{t-1} for its own units; the 4H-long sum is split into
// KS slices, one per group of threads, which meet in shared memory.  The
// cell part of step t-1 follows without another grid sync: it writes
// dgx[t-1] while slower blocks may still read dgx[t].
//
// Masked steps (mask 0): dz is 0 and dh, dc pass through unchanged.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_ROWS = 16;  // at most this many rows of dz staged at once

// gates: (T, R, 4H) activated gates i, f, g, o; c_seq: (T, R, H) c_{t-1};
// w: (D, H, 4H); mask: (T, R) or nullptr; dout: (T, R, H); dhT, dcT: (R, H).
// dgx: (T, R, 4H) out; dh0, dc0: (R, H) out.  R = D * Bd.
// Block b: direction d = b / n_ub, unit block ub = b % n_ub.  In the
// product, thread tid: K slice ks = tid / P, pair p = tid % P (row p / U of
// the chunk, unit p % U), P = RS * U.
// Shared memory: w_s (H, U) of float4 (columns 4k..4k+3 of unit u's row) |
// dz_s (RS, H) of float4 | red (KS - 1, P) | dh_s (Bd, U) | dc_s (Bd, U).
__global__ void __launch_bounds__(1024) lstm_bwd_kernel(
        const float* __restrict__ gates, const float* __restrict__ c_seq,
        const float* __restrict__ w, const float* __restrict__ mask,
        const float* __restrict__ dout, const float* __restrict__ dhT,
        const float* __restrict__ dcT, float* dgx,
        float* __restrict__ dh0, float* __restrict__ dc0,
        int T, int Bd, int H, int U, int n_ub, int KS, int RS) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float4 smem4[];
    const int d = blockIdx.x / n_ub;
    const int ub = blockIdx.x % n_ub;
    const int R = gridDim.x / n_ub * Bd;
    const int G = 4 * H;
    const int P = RS * U;
    float4* w_s = smem4;                                  // (H, U)
    float4* dz_s = smem4 + (size_t)H * U;                 // (RS, H)
    float* red = reinterpret_cast<float*>(dz_s + (size_t)RS * H);
    float* dh_s = red + (size_t)(KS - 1) * P;             // (Bd, U)
    float* dc_s = dh_s + (size_t)Bd * U;                  // (Bd, U)
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

    // stage the rows of W_hh[d] that belong to this block's units; units
    // past H are zero
    const float* wd = w + (size_t)d * H * G;
    float* w_sf = reinterpret_cast<float*>(w_s);
    for (int idx = tid; idx < U * G; idx += nthreads) {
        const int uu = idx / G;
        const int c = idx % G;
        const int jj = ub * U + uu;
        const float v = jj < H ? wd[(size_t)jj * G + c] : 0.0f;
        w_sf[((size_t)(c / 4) * U + uu) * 4 + c % 4] = v;
    }
    for (int q = tid; q < Bd * U; q += nthreads) {
        const int jj = ub * U + q % U;
        const size_t at = (size_t)(row0 + q / U) * H + jj;
        dh_s[q] = jj < H ? dhT[at] : 0.0f;
        dc_s[q] = jj < H ? dcT[at] : 0.0f;
    }
    __syncthreads();

    // the elementwise part of step t: dz[t] for this block's units, dc
    auto cell = [&](int t) {
        for (int q = tid; q < Bd * U; q += nthreads) {
            const int jj = ub * U + q % U;
            if (jj >= H) continue;
            const size_t at = (size_t)t * R + row0 + q / U;
            const float* gr = gates + at * G;
            const float i_ = gr[jj];
            const float f_ = gr[H + jj];
            const float g_ = gr[2 * H + jj];
            const float o_ = gr[3 * H + jj];
            const float c_prev = c_seq[at * H + jj];
            const float m = mask != nullptr ? mask[at] : 1.0f;
            const float c_t = f_ * c_prev + i_ * g_;
            const float tanh_c = tanhf(c_t);
            const float dh = dh_s[q] + dout[at * H + jj];
            const float dc_in = dc_s[q];
            const float d_o = dh * tanh_c;
            const float dc = dc_in + dh * o_ * (1.0f - tanh_c * tanh_c);
            const float dzi = dc * g_ * i_ * (1.0f - i_) * m;
            const float dzf = dc * c_prev * f_ * (1.0f - f_) * m;
            const float dzg = dc * i_ * (1.0f - g_ * g_) * m;
            const float dzo = d_o * o_ * (1.0f - o_) * m;
            float* dr = dgx + at * G;
            __stcg(dr + jj, dzi);
            __stcg(dr + H + jj, dzf);
            __stcg(dr + 2 * H + jj, dzg);
            __stcg(dr + 3 * H + jj, dzo);
            dc_s[q] = m > 0.0f ? dc * f_ : dc_in;
        }
    };

    cell(T - 1);
    for (int t = T - 1; t >= 0; --t) {
        grid.sync();  // dz[t] of every block is in L2
        for (int rc = 0; rc < Bd; rc += RS) {
            const int nr = min(RS, Bd - rc);
            const float4* src = reinterpret_cast<const float4*>(
                dgx + ((size_t)t * R + row0 + rc) * G);
            if (rc > 0) __syncthreads();  // the previous chunk's readers
            for (int idx = tid; idx < nr * H; idx += nthreads) {
                cp_async16_cg(dz_s + idx, src + idx);
            }
            const int r = rc + p / U;
            const bool active = ks < KS && p < nr * U && j < H;
            const bool first = active && ks == 0;
            float m = 1.f;
            if (first && mask != nullptr) {
                m = mask[(size_t)t * R + row0 + r];
            }
            cp_async_wait_all();
            __syncthreads();
            float acc = 0.f;
            if (active) {
                const float4* dzr = dz_s + (size_t)(r - rc) * H;
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k) {
                    const float4 z = dzr[k];
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
            if (m > 0.0f) dh_s[(size_t)r * U + u] = acc;
        }
        __syncthreads();  // dh_s complete before the cell part reads it
        if (t > 0) cell(t - 1);
    }
    for (int q = tid; q < Bd * U; q += nthreads) {
        const int jj = ub * U + q % U;
        if (jj >= H) continue;
        const size_t at = (size_t)(row0 + q / U) * H + jj;
        dh0[at] = dh_s[q];
        dc0[at] = dc_s[q];
    }
}

size_t smem_bytes(int Bd, int H, int U, int KS, int RS) {
    return sizeof(float) * ((size_t)H * U * 4 + (size_t)RS * H * 4
                            + (size_t)(KS - 1) * RS * U + 2 * (size_t)Bd * U);
}

}  // namespace

extern "C" {

// Launch the whole adjoint recurrence.  For each unit slice U, smallest
// first, the rows staged at once (RS) are as many as shared memory holds
// beside the weights, evened out over the chunks; the first U whose grid
// (D * ceil(H / U) blocks) is co-resident on the card is taken.  Fails with
// cudaErrorCooperativeLaunchTooLarge when none is, and with
// cudaErrorInvalidValue when dgx is not 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
int lstm_cell_scan_bwd(const void* gates, const void* c_seq, const void* w,
                       const void* mask, const void* dout, const void* dhT,
                       const void* dcT, void* dgx, void* dh0, void* dc0,
                       int T, int D, int Bd, int H, int device,
                       void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (reinterpret_cast<uintptr_t>(dgx) % 16 != 0) {
        return cudaErrorInvalidValue;
    }
    int n_sm = 0, max_smem = 0, coop = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (!coop) return cudaErrorNotSupported;
    const int units[] = {4, 8, 12, 16, 24, 32};
    int U = 0, threads = 0, KS = 1, RS = 1;
    size_t smem = 0;
    for (int cand : units) {
        // most rows that fit beside the weights (KS <= 8 slices assumed)
        int rs = Bd < MAX_ROWS ? Bd : MAX_ROWS;
        while (rs > 0 && smem_bytes(Bd, H, cand, 8, rs) > (size_t)max_smem) {
            --rs;
        }
        if (rs == 0) break;
        const int chunks = (Bd + rs - 1) / rs;
        rs = (Bd + chunks - 1) / chunks;
        const int P = rs * cand;
        if (P > 1024) break;
        const int ks = k_slices(P, H);
        const size_t s = smem_bytes(Bd, H, cand, ks, rs);
        const int th = (ks * P + 31) / 32 * 32;
        err = cudaFuncSetAttribute(lstm_bwd_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)s);
        if (err != cudaSuccess) return err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, lstm_bwd_kernel, th, s);
        if (err != cudaSuccess) return err;
        const int blocks = D * ((H + cand - 1) / cand);
        if (per_sm > 0 && blocks <= per_sm * n_sm) {
            U = cand;
            KS = ks;
            RS = rs;
            threads = th;
            smem = s;
            break;
        }
    }
    if (U == 0) return cudaErrorCooperativeLaunchTooLarge;
    int n_ub = (H + U - 1) / U;
    const float* gates_ = static_cast<const float*>(gates);
    const float* c_seq_ = static_cast<const float*>(c_seq);
    const float* w_ = static_cast<const float*>(w);
    const float* mask_ = static_cast<const float*>(mask);
    const float* dout_ = static_cast<const float*>(dout);
    const float* dhT_ = static_cast<const float*>(dhT);
    const float* dcT_ = static_cast<const float*>(dcT);
    float* dgx_ = static_cast<float*>(dgx);
    float* dh0_ = static_cast<float*>(dh0);
    float* dc0_ = static_cast<float*>(dc0);
    void* args[] = {&gates_, &c_seq_, &w_, &mask_, &dout_, &dhT_, &dcT_,
                    &dgx_, &dh0_, &dc0_, &T, &Bd, &H, &U, &n_ub, &KS, &RS};
    err = cudaLaunchCooperativeKernel(
        (const void*)lstm_bwd_kernel, dim3(D * n_ub), dim3(threads), args,
        smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // extern "C"
