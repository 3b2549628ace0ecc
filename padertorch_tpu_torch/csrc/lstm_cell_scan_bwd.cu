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
// dz_t (a block needs all 4H columns of its rows, other blocks wrote
// them), a chain of dependent FMAs, and one grid-wide sync.
//
// Design: the grid of the LSTM forward and the GRU backward
// (`pick_scan_grid`, lstm_common.cuh).  Everything but the product is
// elementwise in (row, unit), so a block owns a direction d, U units and a
// range of RB rows of its direction, keeps the carries dh and dc of its own
// (row, unit) pairs in shared memory, and the rows W_hh[d][j, :] of its units
// there too (U * 4H floats, stored as float4 over four neighbouring columns).
// With many rows and a small H (a dual-path RNN's 260 or 400 rows of H = 128
// per direction) the rows spread over about one block per SM, where unit
// slices alone gave 64 blocks that each walked all rows in 17 chunks per step.
// A step has two parts.  "cell": from the stored gates, c_{t-1}, d_out[t] and
// the carries, a thread per (row, unit) forms dz for its unit's four gates,
// writes them to dgx[t] (an output anyway) and updates dc.  After one grid
// sync, "product": for chunks of RS of its own rows a block copies dz[t] of
// those rows, all 4H columns, from L2 into shared memory (asynchronous copies
// that bypass L1) and forms dh_{t-1} for its own units; the 4H-long sum is
// split into KS slices, one per group of threads, which meet in shared memory
// in slice order.  The cell part of step t-1 follows without another grid
// sync: it writes dgx[t-1] while slower blocks may still read dgx[t].
//
// Streamed route (`STREAM`, where no grid that stages W_hh is
// co-resident: the forward's rule, lstm_cell_scan.cu): the same grid and
// arithmetic, each thread reading its unit's row of W_hh[d] from device
// memory every step, as the slots it would stage (four columns rounded to
// the variant's element type), packed once a launch (`pack_slots`,
// lstm_common.cuh: one load a slot; bf16 slots half the bytes).
//
// Masked steps (mask 0): dz is 0 and dh, dc pass through unchanged.
//
// bf16 (`BF16`, the JAX package's `compute_dtype='bfloat16'` with bf16
// streams): the gates, c_seq and d_out are read as bf16 and widened
// (`ScanTypes<true>`, lstm_common.cuh); dz is stored to dgx rounded to
// bf16, and the product reads that bf16 dz back, so dh_{t-1} =
// bf16(dz) @ bf16(W_hh)^T, each product exact in float32 and summed in
// float32, as the Pallas kernel's `_dir_matmul(..., cast=bf16)`; W_hh's
// rows are rounded to bf16 as they are staged (half the shared memory), as
// are the staged dz rows (four columns in 8 bytes; 16-byte copies when H is
// even, 8-byte loads through L2 otherwise).  dh, dc and dh0, dc0 stay
// float32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// gates: (T, R, 4H) activated gates i, f, g, o; c_seq: (T, R, H) c_{t-1};
// w: (D, H, 4H); mask: (T, R) or nullptr; dout: (T, R, H); dhT, dcT: (R, H).
// dgx: (T, R, 4H) out; dh0, dc0: (R, H) out.  R = D * Bd.
// Block b: unit block ub = b % n_ub, row block rb = b / n_ub % n_rb,
// direction d = b / (n_ub * n_rb); rows [rb * RB, min(Bd, (rb + 1) * RB))
// of its direction.  In the product, thread tid: K slice ks = tid / P, pair
// p = tid % P (row p / U of the chunk, unit p % U), P = RS * U.
// Shared memory: w_s (H, U) of W4 (columns 4k..4k+3 of unit u's row) |
// dz_s (RS, H) of W4 | red (KS - 1, P) | dh_s (RB, U) | dc_s (RB, U).
// vec: dz rows copy 16 bytes at a time (always for float32; for bf16 when
// H is even and dgx 16-byte aligned), else 8 bytes (one W4) at a time.
// STREAM: the streamed route (see the top): w_s is empty, w holds the
// packed slots (D, H, H) of W4 (slot (d, c, j): columns 4c ... 4c + 3 of
// row j), and the product reads row j's slots from device memory.
template <bool BF16, bool STREAM>
__global__ void __launch_bounds__(1024) lstm_bwd_kernel(
        const typename ScanTypes<BF16>::S* __restrict__ gates,
        const typename ScanTypes<BF16>::S* __restrict__ c_seq,
        const float* __restrict__ w, const float* __restrict__ mask,
        const typename ScanTypes<BF16>::S* __restrict__ dout,
        const float* __restrict__ dhT,
        const float* __restrict__ dcT, typename ScanTypes<BF16>::S* dgx,
        float* __restrict__ dh0, float* __restrict__ dc0,
        int T, int Bd, int H, int U, int n_ub, int n_rb, int RB, int RS,
        int KS, int vec) {
    using Ty = ScanTypes<BF16>;
    using S = typename Ty::S;
    using W4 = typename Ty::W4;
    // W4 slots per 16-byte copy
    constexpr int kPerCopy = 16 / sizeof(W4);
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
    const int n_own = (r_hi - r_lo) * U;                  // (row, unit) pairs
    W4* w_s = reinterpret_cast<W4*>(smem4);               // (H, U)
    W4* dz_s = w_s + (STREAM ? 0 : (size_t)H * U);        // (RS, H)
    float* red = reinterpret_cast<float*>(dz_s + (size_t)RS * H);
    float* dh_s = red + (size_t)(KS - 1) * P;             // (RB, U)
    float* dc_s = dh_s + (size_t)RB * U;                  // (RB, U)
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int row0 = d * Bd + r_lo;                       // first own row
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
    for (int idx = tid; !STREAM && idx < U * G; idx += nthreads) {
        const int uu = idx / G;
        const int c = idx % G;
        const int jj = ub * U + uu;
        const float v = jj < H ? wd[(size_t)jj * G + c] : 0.0f;
        Ty::set(w_s + (size_t)(c / 4) * U + uu, c % 4, v);
    }
    for (int q = tid; q < n_own; q += nthreads) {
        const int jj = ub * U + q % U;
        const size_t at = (size_t)(row0 + q / U) * H + jj;
        dh_s[q] = jj < H ? dhT[at] : 0.0f;
        dc_s[q] = jj < H ? dcT[at] : 0.0f;
    }
    __syncthreads();

    // the elementwise part of step t: dz[t] for this block's (row, unit)
    // pairs, dc
    auto cell = [&](int t) {
        for (int q = tid; q < n_own; q += nthreads) {
            const int jj = ub * U + q % U;
            if (jj >= H) continue;
            const size_t at = (size_t)t * R + row0 + q / U;
            const S* gr = gates + at * G;
            const float i_ = Ty::ld(gr + jj);
            const float f_ = Ty::ld(gr + H + jj);
            const float g_ = Ty::ld(gr + 2 * H + jj);
            const float o_ = Ty::ld(gr + 3 * H + jj);
            const float c_prev = Ty::ld(c_seq + at * H + jj);
            const float m = mask != nullptr ? mask[at] : 1.0f;
            const float c_t = f_ * c_prev + i_ * g_;
            const float tanh_c = tanhf(c_t);
            const float dh = dh_s[q] + Ty::ld(dout + at * H + jj);
            const float dc_in = dc_s[q];
            const float d_o = dh * tanh_c;
            const float dc = dc_in + dh * o_ * (1.0f - tanh_c * tanh_c);
            const float dzi = dc * g_ * i_ * (1.0f - i_) * m;
            const float dzf = dc * c_prev * f_ * (1.0f - f_) * m;
            const float dzg = dc * i_ * (1.0f - g_ * g_) * m;
            const float dzo = d_o * o_ * (1.0f - o_) * m;
            S* dr = dgx + at * G;
            Ty::stcg(dr + jj, dzi);
            Ty::stcg(dr + H + jj, dzf);
            Ty::stcg(dr + 2 * H + jj, dzg);
            Ty::stcg(dr + 3 * H + jj, dzo);
            dc_s[q] = m > 0.0f ? dc * f_ : dc_in;
        }
    };

    cell(T - 1);
    for (int t = T - 1; t >= 0; --t) {
        grid.sync();  // dz[t] of every block is in L2
        for (int rc = 0; rc < r_hi - r_lo; rc += RS) {
            const int nr = min(RS, r_hi - r_lo - rc);
            const W4* src = reinterpret_cast<const W4*>(
                dgx + ((size_t)t * R + row0 + rc) * G);
            if (rc > 0) __syncthreads();  // the previous chunk's readers
            if (vec) {
                for (int idx = tid; idx < nr * H / kPerCopy;
                     idx += nthreads) {
                    cp_async16_cg(dz_s + kPerCopy * idx,
                                  src + kPerCopy * idx);
                }
            } else {
                for (int idx = tid; idx < nr * H; idx += nthreads) {
                    dz_s[idx] = __ldcg(src + idx);
                }
            }
            const int r = rc + p / U;                     // own row index
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
                // four independent chains (the four columns of a float4),
                // summed in a fixed order
                const W4* dzr = dz_s + (size_t)(r - rc) * H;
                // row j's packed slots (STREAM), H apart
                const W4* wr = reinterpret_cast<const W4*>(w)
                               + (size_t)d * H * H + j;
                float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k) {
                    const float4 z = Ty::unpack(dzr[k]);
                    float4 wk;
                    if constexpr (STREAM) {
                        // the staged slot, packed in device memory
                        wk = Ty::unpack(__ldg(wr + (size_t)k * H));
                    } else {
                        wk = Ty::unpack(w_s[(size_t)k * U + u]);
                    }
                    a4.x = fmaf(z.x, wk.x, a4.x);
                    a4.y = fmaf(z.y, wk.y, a4.y);
                    a4.z = fmaf(z.z, wk.z, a4.z);
                    a4.w = fmaf(z.w, wk.w, a4.w);
                }
                acc = (a4.x + a4.y) + (a4.z + a4.w);
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
    for (int q = tid; q < n_own; q += nthreads) {
        const int jj = ub * U + q % U;
        if (jj >= H) continue;
        const size_t at = (size_t)(row0 + q / U) * H + jj;
        dh0[at] = dh_s[q];
        dc0[at] = dc_s[q];
    }
}

// The grid of a launch: `pick_route` (lstm_common.cuh), resident or
// streamed, as the forward's, with this kernel's shared memory: W_hh's
// rows for U units (4H columns; resident route only) and dz of RS rows,
// both in the variant's element type, the partial sums of KS - 1 slices,
// and dh, dc of the block's RB rows.
template <bool BF16>
cudaError_t pick_grid(int D, int Bd, int H, int device, ScanGrid* best,
                      int* streamed) {
    using W4 = typename ScanTypes<BF16>::W4;
    int n_sm = 0, max_smem = 0, coop = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (!coop) return cudaErrorNotSupported;
    const auto rest = [H](int U, int RB, int RS, int KS) {
        return sizeof(W4) * (size_t)RS * H
               + sizeof(float) * ((size_t)(KS - 1) * RS * U
                                  + 2 * (size_t)RB * U);
    };
    return pick_route((const void*)lstm_bwd_kernel<BF16, false>,
                      (const void*)lstm_bwd_kernel<BF16, true>, D, Bd, H, H,
                      n_sm, max_smem, sizeof(W4) * (size_t)H, rest, best,
                      streamed);
}

// Launch the whole adjoint recurrence on the grid `pick_grid` chooses.
// Fails with cudaErrorCooperativeLaunchTooLarge when no grid is
// co-resident on either route, and with cudaErrorInvalidValue when dgx is
// not aligned to a W4 slot (float32: 16 bytes, as its copies need; bf16:
// 8 bytes).  Returns cudaGetLastError() after the launch.
template <bool BF16>
int launch_bwd(const void* gates, const void* c_seq, const void* w,
               void* wpack, const void* mask, const void* dout,
               const void* dhT,
               const void* dcT, void* dgx, void* dh0, void* dc0, int T,
               int D, int Bd, int H, int device, void* stream) {
    using S = typename ScanTypes<BF16>::S;
    using W4 = typename ScanTypes<BF16>::W4;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const uintptr_t at = reinterpret_cast<uintptr_t>(dgx);
    if (at % sizeof(W4) != 0) return cudaErrorInvalidValue;
    int vec = at % 16 == 0 && (4 * H * sizeof(S)) % 16 == 0;
    ScanGrid best;
    int streamed = 0;
    err = pick_grid<BF16>(D, Bd, H, device, &best, &streamed);
    if (err != cudaSuccess) return err;
    if (best.blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
    const S* gates_ = static_cast<const S*>(gates);
    const S* c_seq_ = static_cast<const S*>(c_seq);
    const float* w_ = static_cast<const float*>(w);
    if (streamed) {
        err = pack_slots<BF16>(w_, wpack, D, H, 4, false,
                               static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return err;
        w_ = static_cast<const float*>(wpack);
    }
    const float* mask_ = static_cast<const float*>(mask);
    const S* dout_ = static_cast<const S*>(dout);
    const float* dhT_ = static_cast<const float*>(dhT);
    const float* dcT_ = static_cast<const float*>(dcT);
    S* dgx_ = static_cast<S*>(dgx);
    float* dh0_ = static_cast<float*>(dh0);
    float* dc0_ = static_cast<float*>(dc0);
    void* args[] = {&gates_, &c_seq_, &w_, &mask_, &dout_, &dhT_, &dcT_,
                    &dgx_, &dh0_, &dc0_, &T, &Bd, &H, &best.U, &best.n_ub,
                    &best.n_rb, &best.RB, &best.RS, &best.KS, &vec};
    err = cudaLaunchCooperativeKernel(
        streamed ? (const void*)lstm_bwd_kernel<BF16, true>
                 : (const void*)lstm_bwd_kernel<BF16, false>,
        dim3(best.blocks), dim3(best.threads), args, best.smem,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The grid a launch of the float32 (bf16 = 0) or bf16 variant at
// (D, Bd, H) takes: out[0..6] = U, n_rb, RB, RS, KS, blocks (blocks 0
// when no grid is co-resident), streamed (1: the streamed route).
int lstm_cell_scan_bwd_grid(int D, int Bd, int H, int bf16, int device,
                            void* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid best;
    int streamed = 0;
    err = bf16 ? pick_grid<true>(D, Bd, H, device, &best, &streamed)
               : pick_grid<false>(D, Bd, H, device, &best, &streamed);
    if (err != cudaSuccess) return err;
    int* o = static_cast<int*>(out);
    o[0] = best.U;
    o[1] = best.n_rb;
    o[2] = best.RB;
    o[3] = best.RS;
    o[4] = best.KS;
    o[5] = best.blocks;
    o[6] = streamed;
    return cudaSuccess;
}

// The adjoint recurrence, float32 streams.  `wpack`: scratch of
// packed_slots_bytes(bf16, D, H, 4, bwd) for the streamed route's packed
// weights, null where the card takes the resident route.
int lstm_cell_scan_bwd(const void* gates, const void* c_seq, const void* w,
                       void* wpack, const void* mask, const void* dout,
                       const void* dhT, const void* dcT, void* dgx,
                       void* dh0, void* dc0, int T, int D, int Bd, int H,
                       int device, void* stream) {
    return launch_bwd<false>(gates, c_seq, w, wpack, mask, dout, dhT, dcT,
                             dgx, dh0, dc0, T, D, Bd, H, device, stream);
}

// The bf16 variant: gates, c_seq, dout and dgx bf16; w, mask, dhT, dcT,
// dh0, dc0 float32.
int lstm_cell_scan_bwd_bf16(const void* gates, const void* c_seq,
                            const void* w, void* wpack, const void* mask,
                            const void* dout, const void* dhT,
                            const void* dcT, void* dgx, void* dh0,
                            void* dc0, int T, int D, int Bd, int H,
                            int device, void* stream) {
    return launch_bwd<true>(gates, c_seq, w, wpack, mask, dout, dhT, dcT,
                            dgx, dh0, dc0, T, D, Bd, H, device, stream);
}

}  // extern "C"
