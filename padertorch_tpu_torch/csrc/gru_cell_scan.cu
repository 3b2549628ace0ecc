// GRU cell recurrence over time, forward, in one launch per layer (both
// directions of a bidirectional layer together).  Two variants of each
// kernel: the lean inference forward, and the training forward, which also
// stores what the backward needs (the gates r, z, n, the n block of
// h_{t-1} @ W_hh, and h_{t-1} itself).  Two routes, chosen by shape before
// the launch (`resident_plan` in ops/kernels/gru.py): the resident kernel
// where one direction's whole W_hh fits one block's shared memory beside
// what the block stages (H <= 138 on an H100, 195 in bf16), the
// cooperative kernel otherwise.
//
// Replaces: padertorch_tpu/ops/pallas/gru.py, `_fwd_kernel` through
// `_fwd_call(..., with_residuals=False)` (inference, `gru_cell_scan`) and
// through `_fwd_call(..., with_residuals=True)` (training, `_vjp_fwd`).
//
// What bounds it on the card: the T steps are sequential and each holds a
// (rows, H) @ (H, 3H) product too small to fill the card (at a DPRNN's
// H = 128 and 520 rows, 25.6 M multiply-adds a step, under 1 us of the
// card's float32 rate), so W_hh has to stay on chip for the whole launch
// and what is left per step is latency and shared-memory traffic.
//
// Resident route.  In a GRU the rows are independent: a row's h_t needs
// only its own h_{t-1} and W_hh[d].  So a block owns one direction d and a
// range of RB rows of it, with all of W_hh[d] in shared memory, packed as
// it lies in device memory ((k, gate, unit): a warp's load of one gate's
// 32 units is 128 contiguous bytes; 196,608 bytes at H = 128).  Its rows
// run all T steps without a word from other blocks: a plain launch, no
// grid sync, and h never leaves the block but as out[t].  The host spreads
// the rows so that the grid has at most one block per SM (520 rows: 130
// blocks of 4; 800 rows: 116 blocks of 7).  A block takes its rows RS at
// a time (chunks, one after another, each through all T steps).  A thread
// owns one hidden unit (its three gate columns) of every row of the chunk
// and keeps 3 * RS sums in registers, so each weight loaded from shared
// memory serves RS rows; h_{t-1} of the chunk lies in shared memory
// transposed, (H, RS padded to 4), so one broadcast float4 load gives four
// rows' h[k] (the float32 carry of a cell stays in the registers of the
// thread that applies it).  The K loop is split into KS = 1, 2 or 4
// slices (a template parameter; at H = 128 one slice leaves one warp per
// scheduler, and the step waits on shared-memory latency): with KS > 1 a
// block has four
// groups of H threads, the first KS run the product, the slices' sums
// meet in shared memory and are added in slice order, and all four groups
// apply the cells (row r by group r % 4), so a step's transcendental chain
// is spread over the whole block.  A thread's cells' input gates and mask
// are loaded into registers at the start of the step and fly while the
// product runs (shared memory is full with W at H = 128).  Per step a
// block syncs twice: after the product and after the cell
// (chip_smoke.py phase 8 prints each shape's route, plan and time).
//
// Cooperative route (H too large for one block's shared memory).  A block
// owns a direction d, a slice of U hidden units with their three gate
// columns of W_hh[d] in shared memory (float4 per (k, unit), one lane
// unused), and a range of RB rows.  The host (`pick_scan_grid`,
// lstm_common.cuh) prefers wide unit slices (every block of a row range
// stages the same rows of h, so wide slices stage less) and splits the
// rows until the grid has about one block per SM.  Per step and chunk of
// RS rows a block copies h_{t-1} of those rows into shared memory with
// asynchronous L2-only copies and loads its input gates while the copies
// fly; the K loop is split into KS slices, one per group of threads, a
// thread owns one (row, unit) pair of one slice, the partial sums meet in
// shared memory and the first slice's thread applies the cell and the mask
// freeze.  out[t] and h_t go to device memory, h_t through a ping-pong
// buffer, then the grid syncs once.  Where no such grid is co-resident
// (two directions of float32 W_hh at H = 2048 are 100 MB), the streamed
// variant (`STREAM`) runs the same grid and arithmetic with the weights
// read from device memory every step, as the slots it would stage packed
// once a launch (`pack_slots`, lstm_common.cuh: one load a slot; bf16
// slots half the bytes), and shared memory for the rest (`pick_route`,
// lstm_common.cuh, tries the staged grid first).
//
// Both routes: float32 on the CUDA cores (the limits tell TF32 from
// float32); the products gh_r, gh_z, gh_n start from zero and the input
// gates are added afterwards, because the n gate is tanh(gx_n + r * gh_n):
// gh_n stays apart from gx_n (and is a residual); on a masked step h keeps
// its value and the output is 0.  No atomics: each sum is in a fixed
// order, so two runs give the same bits.
//
// bf16 (`BF16`, the JAX package's `compute_dtype='bfloat16'` with bf16
// streams), both routes: gx is read, and out, acts, ghn and hprev are
// written, as bf16 (`ScanTypes<true>`, lstm_common.cuh: widened on load,
// rounded to nearest even on store; hprev is bf16(h_{t-1}), what the JAX
// backward rebuilds from its bf16 out); W_hh is rounded to bf16 as it is
// staged, so it takes half the shared memory: the resident route holds a
// direction's W_hh up to H = 195 on an H100 (3 * 195^2 * 2 bytes beside
// one row's staging), the cooperative one twice the units a block.  h is
// rounded to bf16 as the product's operand: the resident kernel stages
// the rounded h of its chunk and keeps each cell's float32 carry in the
// registers of the thread that applies the cell; the cooperative kernel
// rounds h as it reads it.  The products of bf16 values are exact in
// float32 and summed in float32 FMAs; the carry and h_T stay float32.
//
// The bf16 training forward's `mma` route (`gru_fwd_mma_kernel`), taken
// where the bf16 resident plan exists and H <= GRU_MMA_MAX_H (128): on the
// resident route each bf16 weight is read from shared memory and widened
// every step, and the product runs as float32 FMAs on the CUDA cores (3.2
// us a step at the DPRNN's intra shape on an H100).  Here the product is
// bf16 `mma.sync.m16n8k16` with float32 sums (the Pallas kernel's
// `_dir_matmul(..., cast=bf16)`) on the resident grid: a block owns a
// direction and a range of rows with all H units (`gru_mma_plan`,
// lstm_common.cuh), so a step needs no grid sync and no exchange through
// L2.  W_hh[d] rounded to bf16 (A = W_hh^T: M = the 3H gate columns, K = H)
// is held in the 16 warps' registers for the whole launch: a warp owns the
// three gates' M tiles of 16 units and a chunk of the k-steps (at H = 128
// two warps a tile, 48 registers a thread), so one B fragment feeds three
// products.  The chunk's rows (one N tile of 8) are the B operand,
// bf16(h_{t-1}) staged in shared memory and read with `ldmatrix`.  Each
// warp sums its chunk from zero and writes the three gates' partial sums
// as one float4 a (row, unit) pair; after one sync the pair's thread adds
// the chunks in chunk order in float32, applies the cell, keeps the float32
// carry in its registers, stores out, the gates, gh_n and bf16(h_{t-1}),
// and stages bf16(h_t) for the next product; a second sync ends the step.
// A step's gx and mask are loaded as bf16 bits a step ahead (two where a
// warp holds one k-step: H <= 32), and into L2 GRU_MMA_AHEAD steps ahead
// where the streams do not stay in L2 anyway (`gru_mma_ahead`).  The lean
// bf16 forward takes the same route (`TRAIN` false): the same cell, carry,
// sigmoids, chunk order and stores of out and h_T, without the residual
// stores, so that its out and h_T are the training forward's bits; its
// streams are gx and out alone (8H bytes a row and step against 18H),
// which the L2 rule counts.  Above H = 128 the lean bf16 forward takes the
// cluster route of gru_cell_scan_cluster.cu.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

// the probes' cycles (lstm_common.cuh), in -DLSTM_PROBE builds only
#ifdef LSTM_PROBE
__device__ long long gru_fwd_probe_cycles[4];
#define PROBE_CYCLES gru_fwd_probe_cycles
#endif

namespace {

// gx: (T, R, 3H), R = D * Bd rows, row block d belongs to direction d.
// w: (D, H, 3H) (h @ w layout, gate column blocks r, z, n).
// mask: (T, R) or nullptr.  h0: (R, H).
// out: (T, R, H); hT: (R, H); hbuf: (2, R, H) scratch.
// TRAIN only: acts (T, R, 3H) gets r, z, n; ghn (T, R, H) the n block of
// h_{t-1} @ w; hprev (T, R, H) gets h_{t-1}.
// BF16: gx, out, acts, ghn and hprev are bf16 (see the top).
// Block b: unit block ub = b % n_ub, row block rb = b / n_ub % n_rb,
// direction d = b / (n_ub * n_rb); rows [rb * RB, min(Bd, (rb + 1) * RB))
// of its direction.  Thread tid: K slice ks = tid / P, pair p = tid % P
// (row p / U of the chunk, unit p % U), P = RS * U.
// Shared memory: w_s (H, U) of W4 (the three gates' weights, one lane
// unused) | red (KS - 1, P) of float4 | h_s (RS, H).
// vec: H % 4 == 0 and h0, hbuf 16-byte aligned, so rows of h copy as
// float4.  STREAM: the streamed route (see the top): w_s is empty, w holds
// the packed slots (D, H, H) of W4, and the product reads the block's
// slots from device memory every step.
template <bool TRAIN, bool BF16, bool STREAM>
__global__ void __launch_bounds__(1024) gru_fwd_kernel(
        const typename ScanTypes<BF16>::S* __restrict__ gx,
        const float* __restrict__ w,
        const float* __restrict__ mask, const float* __restrict__ h0,
        typename ScanTypes<BF16>::S* __restrict__ out,
        typename ScanTypes<BF16>::S* __restrict__ acts,
        typename ScanTypes<BF16>::S* __restrict__ ghn,
        typename ScanTypes<BF16>::S* __restrict__ hprev,
        float* __restrict__ hT, float* hbuf, int T, int Bd, int H, int U,
        int n_ub, int n_rb, int RB, int RS, int KS, int vec) {
    using Ty = ScanTypes<BF16>;
    using S = typename Ty::S;
    using W4 = typename Ty::W4;
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float4 smem4[];
    const int ub = blockIdx.x % n_ub;
    const int rb = blockIdx.x / n_ub % n_rb;
    const int d = blockIdx.x / (n_ub * n_rb);
    const int R = gridDim.x / (n_ub * n_rb) * Bd;
    const int G = 3 * H;
    const int P = RS * U;
    const int r_lo = rb * RB;
    const int r_hi = min(Bd, r_lo + RB);
    W4* w_s = reinterpret_cast<W4*>(smem4);           // (H, U) of 3 gates
    float4* red = reinterpret_cast<float4*>(w_s + (STREAM ? 0 : (size_t)H * U));
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
    for (int idx = tid; !STREAM && idx < H * U * 3; idx += nthreads) {
        const int k = idx / (3 * U);
        const int q = idx % (3 * U);
        const int g = q / U;
        const int uu = q % U;
        const int jj = ub * U + uu;
        const float v = jj < H ? wd[(size_t)k * G + g * H + jj] : 0.0f;
        Ty::set(w_s + (size_t)k * U + uu, g, v);
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
                const S* gxr = gx + ((size_t)t * R + row) * G;
                gx_r = Ty::ld(gxr + j);
                gx_z = Ty::ld(gxr + H + j);
                gx_n = Ty::ld(gxr + 2 * H + j);
                if (mask != nullptr) m = mask[(size_t)t * R + row];
            }
            if (vec) cp_async_wait_all();
            __syncthreads();
            const float* hr = h_s + (size_t)(r - rc) * H;
            float acc_r = 0.f, acc_z = 0.f, acc_n = 0.f;
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
                S* ar = acts + at * G;
                Ty::st(ar + j, r_);
                Ty::st(ar + H + j, z_);
                Ty::st(ar + 2 * H + j, n_);
                Ty::st(ghn + at * H + j, acc_n);
                Ty::st(hprev + at * H + j, h_old);
            }
            if (mask != nullptr) {
                if (!(m > 0.0f)) h_new = h_old;
                h_out = h_new * m;
            }
            Ty::st(out + at * H + j, h_out);
            __stcg(h_next + (size_t)row * H + j, h_new);
            if (t == T - 1) hT[(size_t)row * H + j] = h_new;
        }
        grid.sync();
    }
}

// The cooperative kernel's grid (`pick_route`, lstm_common.cuh): W_hh's
// slots in the variant's element type staged (resident) or, where no such
// grid is co-resident, read from device memory every step (streamed).
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
                                + (size_t)RS * H);
    };
    return pick_route((const void*)gru_fwd_kernel<TRAIN, BF16, false>,
                      (const void*)gru_fwd_kernel<TRAIN, BF16, true>, D, Bd,
                      H, H, n_sm, max_smem, sizeof(W4) * (size_t)H, rest,
                      best, streamed);
}

// Launch the whole recurrence on the grid `pick_grid` chooses (on the
// streamed route W_hh packed into `wpack`, packed_slots_bytes of the
// forward).  Fails with cudaErrorCooperativeLaunchTooLarge when no grid is
// co-resident on either route.  Returns cudaGetLastError() after the
// launch.
template <bool TRAIN, bool BF16>
int launch_fwd(const void* gx, const void* w, void* wpack, const void* mask,
               const void* h0, void* out, void* acts, void* ghn,
               void* hprev, void* hT, void* hbuf, int T, int D, int Bd,
               int H, int device, void* stream) {
    using S = typename ScanTypes<BF16>::S;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid best;
    int streamed = 0;
    err = pick_grid<TRAIN, BF16>(D, Bd, H, device, &best, &streamed);
    if (err != cudaSuccess) return err;
    if (best.blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
    int vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0
              && reinterpret_cast<uintptr_t>(hbuf) % 16 == 0;
    const S* gx_ = static_cast<const S*>(gx);
    const float* w_ = static_cast<const float*>(w);
    if (streamed) {
        err = pack_slots<BF16>(w_, wpack, D, H, 3, true,
                               static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return err;
        w_ = static_cast<const float*>(wpack);
    }
    const float* mask_ = static_cast<const float*>(mask);
    const float* h0_ = static_cast<const float*>(h0);
    S* out_ = static_cast<S*>(out);
    S* acts_ = static_cast<S*>(acts);
    S* ghn_ = static_cast<S*>(ghn);
    S* hprev_ = static_cast<S*>(hprev);
    float* hT_ = static_cast<float*>(hT);
    float* hbuf_ = static_cast<float*>(hbuf);
    void* args[] = {&gx_, &w_, &mask_, &h0_, &out_, &acts_, &ghn_, &hprev_,
                    &hT_, &hbuf_, &T, &Bd, &H, &best.U, &best.n_ub,
                    &best.n_rb, &best.RB, &best.RS, &best.KS, &vec};
    err = cudaLaunchCooperativeKernel(
        streamed ? (const void*)gru_fwd_kernel<TRAIN, BF16, true>
                 : (const void*)gru_fwd_kernel<TRAIN, BF16, false>,
        dim3(best.blocks), dim3(best.threads), args, best.smem,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// Resident route.  gx, w, mask, h0, out, hT, acts, ghn, hprev as above.
// Block b: direction d = b / n_rb, rows [rb * RB, min(Bd, (rb + 1) * RB))
// of it, rb = b % n_rb, n_rb = ceil(Bd / RB); taken RS at a time.
// Thread tid: group cg = tid / Hp of CG (1 when KS = 1, else 4; Hp: H
// rounded up to 32, at most 128 when KS > 1), unit u = tid % Hp (units
// past H only take part in the syncs).  Groups cg < KS run the product,
// each over its K slice; every group applies the cell to the chunk's rows
// cg, cg + CG, ..., and keeps their float32 carries h in registers.
// Shared memory: h_s (H, RSP) floats, the product's operand h (bf16(h) in
// the BF16 variant) | red (KS, RS, 3, Hp) floats when KS > 1 | w_s
// (H, 3H) of S.  RSP: RS rounded up to 4, so h_s rows are float4-aligned.
constexpr int RESIDENT_MAX_RS = 8;
constexpr int RESIDENT_MAX_THREADS = 512;

__host__ __device__ inline int round_up(int x, int to) {
    return (x + to - 1) / to * to;
}

// The resident kernel's dynamic shared memory in bytes, W_hh at `elem`
// bytes an element (the host planner in ops/kernels/gru.py computes the
// same number and passes it in).
inline size_t resident_smem_bytes(int H, int RS, int KS, size_t elem) {
    const size_t red = KS > 1 ? (size_t)KS * RS * 3 * round_up(H, 32) : 0;
    return sizeof(float) * ((size_t)H * round_up(RS, 4) + red)
           + elem * 3 * (size_t)H * H;
}

template <bool TRAIN, bool BF16, int RS, int KS>
__global__ void __launch_bounds__(RESIDENT_MAX_THREADS, 1)
gru_fwd_resident_kernel(
        const typename ScanTypes<BF16>::S* __restrict__ gx,
        const float* __restrict__ w,
        const float* __restrict__ mask, const float* __restrict__ h0,
        typename ScanTypes<BF16>::S* __restrict__ out,
        typename ScanTypes<BF16>::S* __restrict__ acts,
        typename ScanTypes<BF16>::S* __restrict__ ghn,
        typename ScanTypes<BF16>::S* __restrict__ hprev,
        float* __restrict__ hT, int T, int Bd, int H, int RB) {
    using Ty = ScanTypes<BF16>;
    using S = typename Ty::S;
    constexpr int RSP = (RS + 3) / 4 * 4;
    constexpr int CG = KS == 1 ? 1 : 4;
    constexpr int NJ = (RS + CG - 1) / CG;  // cells a thread applies a step
    extern __shared__ float4 smem4[];
    const int Hp = round_up(H, 32);
    const int G = 3 * H;
    const int n_rb = (Bd + RB - 1) / RB;
    const int d = blockIdx.x / n_rb;
    const int r_lo = blockIdx.x % n_rb * RB;
    const int r_hi = min(Bd, r_lo + RB);
    const int R = gridDim.x / n_rb * Bd;
    const int row0 = d * Bd;
    float* h_s = reinterpret_cast<float*>(smem4);
    float* red = h_s + H * RSP;
    S* w_s = reinterpret_cast<S*>(red + (KS > 1 ? KS * RS * 3 * Hp : 0));
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int cg = tid / Hp;
    const int u = tid % Hp;
    const bool active = u < H;
    const int k_len = (H + KS - 1) / KS;
    const int k_lo = min(H, cg * k_len);
    const int k_hi = cg < KS ? min(H, k_lo + k_len) : k_lo;

    // all of W_hh[d], as it lies in device memory (rounded to bf16 in the
    // BF16 variant: w_s is 16-byte aligned, so four bf16 store as 8 bytes)
    const float* wd = w + (size_t)d * H * G;
    if ((H * G) % 4 == 0 && reinterpret_cast<uintptr_t>(wd) % 16 == 0) {
        const float4* src = reinterpret_cast<const float4*>(wd);
        for (int i = tid; i < H * G / 4; i += nthreads) {
            const float4 v = __ldg(src + i);
            if constexpr (BF16) {
                uint2 packed;
                Ty::set(&packed, 0, v.x);
                Ty::set(&packed, 1, v.y);
                Ty::set(&packed, 2, v.z);
                Ty::set(&packed, 3, v.w);
                reinterpret_cast<uint2*>(w_s)[i] = packed;
            } else {
                reinterpret_cast<float4*>(w_s)[i] = v;
            }
        }
    } else {
        for (int i = tid; i < H * G; i += nthreads) {
            Ty::st(w_s + i, __ldg(wd + i));
        }
    }

    for (int rc = r_lo; rc < r_hi; rc += RS) {
        const int nr = min(RS, r_hi - rc);
        // the product's operand h0 of the chunk, transposed; rows past nr
        // stay zero (the last step's second sync, or the first chunk's,
        // orders this after every read of h_s)
        for (int i = tid; i < H * RSP; i += nthreads) {
            const int k = i / RSP;
            const int r = i % RSP;
            h_s[i] = r < nr
                ? Ty::operand(h0[(size_t)(row0 + rc + r) * H + k]) : 0.f;
        }
        // the float32 carries of this thread's cells, rows cg + j * CG
        float carry[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int r = cg + j * CG;
            if (!active || r >= nr) break;
            carry[j] = h0[(size_t)(row0 + rc + r) * H + u];
        }
        __syncthreads();

        for (int t = 0; t < T; ++t) {
            // this thread's cells: rows cg + j * CG; their input gates and
            // mask fly while the product runs
            float g_x[NJ][3], m[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int r = cg + j * CG;
                if (!active || r >= nr) break;
                const size_t at = (size_t)t * R + row0 + rc + r;
                const S* gxr = gx + at * G;
                g_x[j][0] = Ty::ld(gxr + u);
                g_x[j][1] = Ty::ld(gxr + H + u);
                g_x[j][2] = Ty::ld(gxr + 2 * H + u);
                m[j] = mask != nullptr ? mask[at] : 1.f;
            }
            float acc[RS][3];
#pragma unroll
            for (int r = 0; r < RS; ++r) {
                acc[r][0] = 0.f;
                acc[r][1] = 0.f;
                acc[r][2] = 0.f;
            }
            if (active && cg < KS) {
                const S* wk = w_s + k_lo * G + u;
                const float4* hk =
                    reinterpret_cast<const float4*>(h_s) + k_lo * (RSP / 4);
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k, wk += G, hk += RSP / 4) {
                    const float w_r = Ty::ld(wk);
                    const float w_z = Ty::ld(wk + H);
                    const float w_n = Ty::ld(wk + 2 * H);
#pragma unroll
                    for (int q = 0; q < RSP / 4; ++q) {
                        const float4 hv = hk[q];
                        const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const int r = 4 * q + i;
                            if (r >= RS) break;
                            acc[r][0] = fmaf(h4[i], w_r, acc[r][0]);
                            acc[r][1] = fmaf(h4[i], w_z, acc[r][1]);
                            acc[r][2] = fmaf(h4[i], w_n, acc[r][2]);
                        }
                    }
                }
                if (KS > 1) {
#pragma unroll
                    for (int r = 0; r < RS; ++r) {
                        float* dst = red + ((cg * RS + r) * 3) * Hp + u;
                        dst[0] = acc[r][0];
                        dst[Hp] = acc[r][1];
                        dst[2 * Hp] = acc[r][2];
                    }
                }
            }
            __syncthreads();
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int r = cg + j * CG;
                if (!active || r >= nr) break;
                // the K slices' sums in slice order
                float gh_r, gh_z, gh_n;
                if (KS == 1) {
                    gh_r = acc[j][0];  // CG == 1: j == r
                    gh_z = acc[j][1];
                    gh_n = acc[j][2];
                } else {
                    gh_r = gh_z = gh_n = 0.f;
#pragma unroll
                    for (int s = 0; s < KS; ++s) {
                        const float* src = red + ((s * RS + r) * 3) * Hp + u;
                        gh_r += src[0];
                        gh_z += src[Hp];
                        gh_n += src[2 * Hp];
                    }
                }
                const int row = row0 + rc + r;
                const float h_old = carry[j];
                const float r_ = sigmoidf_(g_x[j][0] + gh_r);
                const float z_ = sigmoidf_(g_x[j][1] + gh_z);
                const float n_ = tanhf(g_x[j][2] + r_ * gh_n);
                float h_new = (1.0f - z_) * n_ + z_ * h_old;
                float h_out = h_new;
                const size_t at = (size_t)t * R + row;
                if (TRAIN) {
                    S* ar = acts + at * G;
                    Ty::st(ar + u, r_);
                    Ty::st(ar + H + u, z_);
                    Ty::st(ar + 2 * H + u, n_);
                    Ty::st(ghn + at * H + u, gh_n);
                    Ty::st(hprev + at * H + u, h_old);
                }
                if (mask != nullptr) {
                    if (!(m[j] > 0.0f)) h_new = h_old;
                    h_out = h_new * m[j];
                }
                Ty::st(out + at * H + u, h_out);
                carry[j] = h_new;
                h_s[u * RSP + r] = Ty::operand(h_new);
                if (t == T - 1) hT[(size_t)row * H + u] = h_new;
            }
            __syncthreads();
        }
    }
}

template <bool TRAIN, bool BF16, int RS, int KS>
cudaError_t launch_resident_ks(const typename ScanTypes<BF16>::S* gx,
                               const float* w, const float* mask,
                               const float* h0,
                               typename ScanTypes<BF16>::S* out,
                               typename ScanTypes<BF16>::S* acts,
                               typename ScanTypes<BF16>::S* ghn,
                               typename ScanTypes<BF16>::S* hprev, float* hT,
                               int T, int blocks, int Bd, int H, int RB,
                               int threads, size_t smem,
                               cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_fwd_resident_kernel<TRAIN, BF16, RS, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gru_fwd_resident_kernel<TRAIN, BF16, RS, KS>
        <<<blocks, threads, smem, stream>>>(
            gx, w, mask, h0, out, acts, ghn, hprev, hT, T, Bd, H, RB);
    return cudaGetLastError();
}

template <bool TRAIN, bool BF16, int RS>
cudaError_t launch_resident_rs(const typename ScanTypes<BF16>::S* gx,
                               const float* w, const float* mask,
                               const float* h0,
                               typename ScanTypes<BF16>::S* out,
                               typename ScanTypes<BF16>::S* acts,
                               typename ScanTypes<BF16>::S* ghn,
                               typename ScanTypes<BF16>::S* hprev, float* hT,
                               int T, int blocks, int Bd, int H, int RB,
                               int KS, int threads, size_t smem,
                               cudaStream_t stream) {
    switch (KS) {
    case 1:
        return launch_resident_ks<TRAIN, BF16, RS, 1>(
            gx, w, mask, h0, out, acts, ghn, hprev, hT, T, blocks, Bd, H, RB,
            threads, smem, stream);
    case 2:
        return launch_resident_ks<TRAIN, BF16, RS, 2>(
            gx, w, mask, h0, out, acts, ghn, hprev, hT, T, blocks, Bd, H, RB,
            threads, smem, stream);
    case 4:
        return launch_resident_ks<TRAIN, BF16, RS, 4>(
            gx, w, mask, h0, out, acts, ghn, hprev, hT, T, blocks, Bd, H, RB,
            threads, smem, stream);
    }
    return cudaErrorInvalidValue;
}

// Launch the resident kernel on the host's plan (RB rows a block, RS at a
// time, KS K slices of 1, 2 or 4, `threads`: one group of H rounded up to
// 32 with KS = 1, four groups otherwise; `smem` bytes, W_hh at the
// variant's element size).  A plan that does not agree with the kernel's
// own layout is refused with cudaErrorInvalidValue before anything runs.
// Returns cudaGetLastError() after the launch.
template <bool TRAIN, bool BF16>
int launch_resident(const void* gx, const void* w, const void* mask,
                    const void* h0, void* out, void* acts, void* ghn,
                    void* hprev, void* hT, int T, int D, int Bd, int H,
                    int RB, int RS, int KS, int threads, int smem,
                    int device, void* stream) {
    using S = typename ScanTypes<BF16>::S;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int Hp = round_up(H, 32);
    if (T < 1 || D < 1 || Bd < 1 || H < 1 || RS < 1
        || RS > RESIDENT_MAX_RS || RB < RS || KS > H
        || threads != (KS == 1 ? 1 : 4) * Hp
        || threads > RESIDENT_MAX_THREADS
        || (size_t)smem != resident_smem_bytes(H, RS, KS, sizeof(S))) {
        return cudaErrorInvalidValue;
    }
    const int blocks = D * ((Bd + RB - 1) / RB);
    const auto* gx_ = static_cast<const S*>(gx);
    const auto* w_ = static_cast<const float*>(w);
    const auto* mask_ = static_cast<const float*>(mask);
    const auto* h0_ = static_cast<const float*>(h0);
    auto* out_ = static_cast<S*>(out);
    auto* acts_ = static_cast<S*>(acts);
    auto* ghn_ = static_cast<S*>(ghn);
    auto* hprev_ = static_cast<S*>(hprev);
    auto* hT_ = static_cast<float*>(hT);
    auto* s = static_cast<cudaStream_t>(stream);
#define PTT_GRU_RS(n)                                                       \
    case n:                                                                 \
        return launch_resident_rs<TRAIN, BF16, n>(                          \
            gx_, w_, mask_, h0_, out_, acts_, ghn_, hprev_, hT_, T, blocks, \
            Bd, H, RB, KS, threads, smem, s);
    switch (RS) {
        PTT_GRU_RS(1)
        PTT_GRU_RS(2)
        PTT_GRU_RS(3)
        PTT_GRU_RS(4)
        PTT_GRU_RS(5)
        PTT_GRU_RS(6)
        PTT_GRU_RS(7)
        PTT_GRU_RS(8)
    }
#undef PTT_GRU_RS
    return cudaErrorInvalidValue;
}

// ---- the bf16 `mma` route of the training forward (see the top)

// a warp's k-steps of each gate's M tile in registers, at most: the
// instantiations
constexpr int FWD_MMA_KC[] = {1, 2, 4};

// One (row, unit) pair's inputs to the cell part of a step: its three gate
// inputs as loaded (bf16 bits) and its mask.
struct GruFwdIn {
    unsigned short x[3];
    float m;
};

// The training forward's arguments as gru_fwd_resident_kernel's (the lean
// one, TRAIN false, takes null acts, ghn and hprev and stores none); the
// plan's fields (GruMmaPlan, lstm_common.cuh).  Block b: direction d = b /
// n_rb, rows [rb * RB, min(Bd, (rb + 1) * RB)) of it, rb = b % n_rb, taken
// RS at a time.  Warp w: unit tile w / KCH (the warps past n_ut tiles idle
// in the product), K chunk w % KCH (k-steps [KC chunk, ...)).  Thread tid
// applies the cells of the chunk's pairs q = tid and tid + 512 (row q / H,
// unit q % H: at most 8 rows of at most 128 units) and keeps their float32
// carries in registers.  Shared memory: h_s (8, 16 KT + 8) bf16, the
// product's B operand bf16(h_{t-1}) of the chunk's rows | red (KCH, 8,
// 16 n_ut + 1) float4, the chunks' partial sums of r, z, n.
template <bool TRAIN, int KCR>
__global__ void __launch_bounds__(MMA_THREADS, 1) gru_fwd_mma_kernel(
        const __nv_bfloat16* __restrict__ gx, const float* __restrict__ w,
        const float* __restrict__ mask, const float* __restrict__ h0,
        __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ acts,
        __nv_bfloat16* __restrict__ ghn, __nv_bfloat16* __restrict__ hprev,
        float* __restrict__ hT, int T, int Bd, int H, int RB, int RS, int KT,
        int KC, int KCH, int ahead) {
    using Ty = ScanTypes<true>;
    using bf16 = __nv_bfloat16;
    constexpr int NT = MMA_THREADS;
    constexpr bool DEEP = KCR == 1;
    extern __shared__ float4 smem4[];
    const int n_rb = (Bd + RB - 1) / RB;
    const int d = blockIdx.x / n_rb;
    const int r_lo = blockIdx.x % n_rb * RB;
    const int r_hi = min(Bd, r_lo + RB);
    const int R = gridDim.x / n_rb * Bd;
    const int G = 3 * H;
    const int row0 = d * Bd;
    const int n_ut = (H + 15) / 16;
    const int SK = 16 * KT + 8;           // a staged row's elements
    const int SR = 16 * n_ut + 1;         // a partial-sum row's float4s
    bf16* h_s = reinterpret_cast<bf16*>(smem4);
    float4* red = reinterpret_cast<float4*>(h_s + GRU_MMA_ROWS * SK);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int ut = warp / KCH;
    const int chunk = warp % KCH;
    const bool in_product = ut < n_ut;
    const int ks_lo = chunk * KC;
    const int kc = min(KC, KT - ks_lo);   // this chunk's k-steps

    // this warp's A fragments: W_hh[d][k][g H + j] for the tile's units j
    // of each gate g and the chunk's k, rounded to bf16; units and k past H
    // are zero
    uint32_t a[3][KCR][4];
    {
        const float* wd = w + (size_t)d * H * G;
        const int ja = ut * 16 + (lane >> 2), jb = ja + 8;
        const auto wv = [&](int g, int j, int k) {
            return j < H && k < H ? __ldg(wd + (size_t)k * G + g * H + j)
                                  : 0.0f;
        };
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
            for (int kk = 0; kk < KCR; ++kk) {
                const int k0 = 16 * (ks_lo + kk) + 2 * (lane & 3);
                const bool on = in_product && kk < kc;
                a[g][kk][0] = on ? pack_bf16x2(wv(g, ja, k0),
                                               wv(g, ja, k0 + 1)) : 0u;
                a[g][kk][1] = on ? pack_bf16x2(wv(g, jb, k0),
                                               wv(g, jb, k0 + 1)) : 0u;
                a[g][kk][2] = on ? pack_bf16x2(wv(g, ja, k0 + 8),
                                               wv(g, ja, k0 + 9)) : 0u;
                a[g][kk][3] = on ? pack_bf16x2(wv(g, jb, k0 + 8),
                                               wv(g, jb, k0 + 9)) : 0u;
            }
        }
    }

    for (int rc = r_lo; rc < r_hi; rc += RS) {
        const int nr = min(RS, r_hi - rc);
        const int first = row0 + rc;   // the chunk's first row
        // this thread's pairs q = tid + 512 p: row pn of the chunk (< 0:
        // no pair) and unit q % H, at og = row * 3H + unit in a (T, R, 3H)
        // stream's step (the launch keeps R * 3H below 2^31)
        int pn[2], og[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const int q = tid + p * NT;
            pn[p] = q < nr * H ? q / H : -1;
            og[p] = (first + pn[p]) * G + q % H;
        }
        // the unit of pair p, and its place in a (T, R, H) stream's step
        const auto unit = [&](int p) { return og[p] - (first + pn[p]) * G; };
        const auto at_h = [&](int p) { return og[p] - 2 * H * (first + pn[p]); };
        // pair p's gate inputs of step t and its mask: loaded into
        // registers as bf16 bits (`fetch`) one step ahead, into L2
        // (`prefetch`) `ahead` steps ahead; the step's place in the streams
        // is common to the block's threads
        const auto fetch = [&](int t, int p) {
            GruFwdIn in = {{0, 0, 0}, 1.f};
            const size_t at = (size_t)t * R;
            const unsigned short* gr =
                reinterpret_cast<const unsigned short*>(gx + at * G) + og[p];
            in.x[0] = __ldg(gr);
            in.x[1] = __ldg(gr + H);
            in.x[2] = __ldg(gr + 2 * H);
            if (mask != nullptr) in.m = __ldg(mask + at + first + pn[p]);
            return in;
        };
        const auto prefetch = [&](int t, int p) {
            const size_t at = (size_t)t * R;
            const bf16* gr = gx + at * G + og[p];
            prefetch_l2(gr);
            prefetch_l2(gr + H);
            prefetch_l2(gr + 2 * H);
            if (mask != nullptr) prefetch_l2(mask + at + first);
        };
        // the staged tile: bf16(h0) of the chunk's rows, zero past them
        // and past H (the K padding, never written again); the previous
        // chunk's last step ended with a sync after its last read
        for (int i = tid; i < GRU_MMA_ROWS * SK; i += NT) {
            const int n = i / SK, k = i % SK;
            h_s[i] = __float2bfloat16_rn(
                n < nr && k < H ? h0[(size_t)(first + n) * H + k] : 0.f);
        }
        float carry[2] = {0.f, 0.f};
        // the inputs of this step and, with DEEP, of the next (loaded two
        // steps ahead where the registers allow: a warp's W_hh of one
        // k-step a gate)
        GruFwdIn in[2] = {}, nx[2] = {};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            if (pn[p] < 0) continue;
            carry[p] = h0[at_h(p)];
            in[p] = fetch(0, p);
            if (DEEP && T > 1) nx[p] = fetch(1, p);
            for (int t = 1; t <= ahead && t < T; ++t) prefetch(t, p);
        }
        __syncthreads();

        PROBE_INIT();
        for (int t = 0; t < T; ++t) {
            if (in_product) {
                // the chunk's partial sums of the tile's three gates, each
                // an independent chain from zero
                float c[3][4] = {};
                const bf16* b_row = h_s + (size_t)(lane & 7) * SK
                                    + 16 * ks_lo + ((lane >> 3) & 1) * 8;
#pragma unroll
                for (int kk = 0; kk < KCR; ++kk) {
                    if (kk < kc) {
                        uint32_t b0, b1;
                        ldsm_x2(b_row + 16 * kk, b0, b1);
#pragma unroll
                        for (int g = 0; g < 3; ++g)
                            mma_bf16(c[g], a[g][kk], b0, b1);
                    }
                }
                // c[g]: units lane / 4 (+ 8) of the tile, rows
                // 2 (lane % 4) (+ 1)
                const int n = 2 * (lane & 3), m = ut * 16 + (lane >> 2);
                float4* rn = red + ((size_t)chunk * GRU_MMA_ROWS + n) * SR + m;
                rn[0] = make_float4(c[0][0], c[1][0], c[2][0], 0.f);
                rn[SR] = make_float4(c[0][1], c[1][1], c[2][1], 0.f);
                rn[8] = make_float4(c[0][2], c[1][2], c[2][2], 0.f);
                rn[SR + 8] = make_float4(c[0][3], c[1][3], c[2][3], 0.f);
            }
            PROBE(PROBE_PRODUCT);
            __syncthreads();
            PROBE(PROBE_SYNC);
            // each own pair: for each gate the chunks in chunk order (both
            // pairs' sums read before anything is stored), then the cell;
            // then the pair's inputs of the next step are loaded.  The
            // step's streams as bases common to the block's threads
            float4 acc[2];
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                if (pn[p] < 0) continue;
                const float4* rp = red + pn[p] * SR + unit(p);
                acc[p] = rp[0];
                // (bounded by MMA_WARPS, not by GRU_MMA_FWD_CHUNKS: ptxas
                // then keeps the H = 128 instantiation in 124 registers
                // without a spill)
#pragma unroll
                for (int c = 1; c < MMA_WARPS; ++c) {
                    if (c >= KCH) break;
                    const float4 v = rp[c * GRU_MMA_ROWS * SR];
                    acc[p].x += v.x;
                    acc[p].y += v.y;
                    acc[p].z += v.z;
                }
            }
            bf16* const out_t = out + (size_t)t * R * H;
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                if (pn[p] < 0) continue;
                const float r_ = sigmoidf_(
                    __uint_as_float((unsigned)in[p].x[0] << 16) + acc[p].x);
                const float z_ = sigmoidf_(
                    __uint_as_float((unsigned)in[p].x[1] << 16) + acc[p].y);
                const float n_ = tanhf(
                    __uint_as_float((unsigned)in[p].x[2] << 16)
                    + r_ * acc[p].z);
                const float h_old = carry[p];
                float h_new = (1.0f - z_) * n_ + z_ * h_old;
                float h_out = h_new;
                const int oh = at_h(p);
                if constexpr (TRAIN) {
                    bf16* ar = acts + (size_t)t * R * G + og[p];
                    Ty::st(ar, r_);
                    Ty::st(ar + H, z_);
                    Ty::st(ar + 2 * H, n_);
                    Ty::st(ghn + (size_t)t * R * H + oh, acc[p].z);
                    Ty::st(hprev + (size_t)t * R * H + oh, h_old);
                }
                if (mask != nullptr) {
                    if (!(in[p].m > 0.0f)) h_new = h_old;
                    h_out = h_new * in[p].m;
                }
                Ty::st(out_t + oh, h_out);
                carry[p] = h_new;
                h_s[pn[p] * SK + unit(p)] = __float2bfloat16_rn(h_new);
                if (t == T - 1) hT[oh] = h_new;
                if (DEEP) {
                    in[p] = nx[p];
                    if (t + 2 < T) nx[p] = fetch(t + 2, p);
                } else if (t + 1 < T) {
                    in[p] = fetch(t + 1, p);
                }
                if (ahead > 0 && t + 1 + ahead < T) prefetch(t + 1 + ahead, p);
            }
            PROBE(PROBE_CELL);
            __syncthreads();
            PROBE(PROBE_SYNC);
        }
    }
}

// The kernel of a plan: the instantiation that holds its KC k-steps.
template <bool TRAIN>
const void* fwd_mma_kernel(const GruMmaPlan& p) {
    if (p.KC <= FWD_MMA_KC[0])
        return (const void*)gru_fwd_mma_kernel<TRAIN, 1>;
    if (p.KC <= FWD_MMA_KC[1])
        return (const void*)gru_fwd_mma_kernel<TRAIN, 2>;
    return (const void*)gru_fwd_mma_kernel<TRAIN, 4>;
}

// Launch the training forward (acts non-null) or the lean one (acts, ghn
// and hprev null) on its `mma` plan (`gru_mma_plan` at the card's limits),
// the step's inputs prefetched into L2 `ahead` steps ahead (< 0: as
// `gru_mma_ahead` says for the kernel).  A shape the plan does not take is
// refused with cudaErrorInvalidConfiguration before anything runs.
// Returns cudaGetLastError() after the launch.
int launch_fwd_mma(const void* gx, const void* w, const void* mask,
                   const void* h0, void* out, void* acts, void* ghn,
                   void* hprev, void* hT, int T, int D, int Bd, int H,
                   int device, void* stream, int ahead) {
    const bool train = acts != nullptr;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    GruMmaLimits limits;
    err = gru_mma_limits(device, &limits);
    if (err != cudaSuccess) return err;
    GruMmaPlan plan =
        gru_mma_plan(0, D, Bd, H, limits.n_sm, limits.max_smem);
    if (T < 1 || plan.blocks == 0 || plan.KC > FWD_MMA_KC[2])
        return cudaErrorInvalidConfiguration;
    if ((size_t)D * Bd * 3 * H >= (size_t)1 << 31)  // a step's offsets: int
        return cudaErrorInvalidValue;
    const void* kernel = train ? fwd_mma_kernel<true>(plan)
                               : fwd_mma_kernel<false>(plan);
    err = gru_mma_allow_smem(kernel, device, plan.smem);
    if (err != cudaSuccess) return err;
    const auto* gx_ = static_cast<const __nv_bfloat16*>(gx);
    const auto* w_ = static_cast<const float*>(w);
    const auto* mask_ = static_cast<const float*>(mask);
    const auto* h0_ = static_cast<const float*>(h0);
    auto* out_ = static_cast<__nv_bfloat16*>(out);
    auto* acts_ = static_cast<__nv_bfloat16*>(acts);
    auto* ghn_ = static_cast<__nv_bfloat16*>(ghn);
    auto* hprev_ = static_cast<__nv_bfloat16*>(hprev);
    auto* hT_ = static_cast<float*>(hT);
    if (ahead < 0)
        ahead = gru_mma_ahead(train ? GRU_MMA_TRAIN : GRU_MMA_LEAN, T, D, Bd,
                              H, limits.l2_bytes);
    void* args[] = {&gx_, &w_, &mask_, &h0_, &out_, &acts_, &ghn_, &hprev_,
                    &hT_, &T, &Bd, &H, &plan.RB, &plan.RS, &plan.KT,
                    &plan.KC, &plan.KCH, &ahead};
    err = cudaLaunchKernel(kernel, dim3(plan.blocks), dim3(MMA_THREADS),
                           args, plan.smem,
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Inference forward: out, h_T.  `wpack`: scratch of
// packed_slots_bytes(bf16, D, H, 3, fwd) for the streamed route's packed
// weights, null where the card takes the cooperative grid that stages
// them.
int gru_cell_scan_fwd(const void* gx, const void* w, void* wpack,
                      const void* mask, const void* h0, void* out, void* hT,
                      void* hbuf, int T, int D, int Bd, int H, int device,
                      void* stream) {
    return launch_fwd<false, false>(gx, w, wpack, mask, h0, out, nullptr,
                                    nullptr, nullptr, hT, hbuf, T, D, Bd, H,
                                    device, stream);
}

// Training forward: also acts (T, R, 3H), ghn and hprev (T, R, H).
int gru_cell_scan_fwd_train(const void* gx, const void* w, void* wpack,
                            const void* mask, const void* h0, void* out,
                            void* acts, void* ghn, void* hprev, void* hT,
                            void* hbuf, int T, int D, int Bd, int H,
                            int device, void* stream) {
    return launch_fwd<true, false>(gx, w, wpack, mask, h0, out, acts, ghn,
                                   hprev, hT, hbuf, T, D, Bd, H, device,
                                   stream);
}

// Resident route (see the header): the plan from ops/kernels/gru.py.
int gru_cell_scan_fwd_resident(const void* gx, const void* w,
                               const void* mask, const void* h0, void* out,
                               void* hT, int T, int D, int Bd, int H, int RB,
                               int RS, int KS, int threads, int smem,
                               int device, void* stream) {
    return launch_resident<false, false>(gx, w, mask, h0, out, nullptr,
                                         nullptr, nullptr, hT, T, D, Bd, H,
                                         RB, RS, KS, threads, smem, device,
                                         stream);
}

int gru_cell_scan_fwd_train_resident(const void* gx, const void* w,
                                     const void* mask, const void* h0,
                                     void* out, void* acts, void* ghn,
                                     void* hprev, void* hT, int T, int D,
                                     int Bd, int H, int RB, int RS, int KS,
                                     int threads, int smem, int device,
                                     void* stream) {
    return launch_resident<true, false>(gx, w, mask, h0, out, acts, ghn,
                                        hprev, hT, T, D, Bd, H, RB, RS, KS,
                                        threads, smem, device, stream);
}

// The bf16 variants of the cooperative forwards and the resident training
// forward: gx, out (and acts, ghn, hprev) bf16; w, mask, h0, hT, hbuf
// float32; products of bf16-rounded operands summed in float32.  The lean
// bf16 forward has no resident entry: it takes `mma` up to H = 128 and the
// cluster route above (gru_cell_scan_cluster.cu).
int gru_cell_scan_fwd_bf16(const void* gx, const void* w, void* wpack,
                           const void* mask, const void* h0, void* out,
                           void* hT, void* hbuf, int T, int D, int Bd,
                           int H, int device, void* stream) {
    return launch_fwd<false, true>(gx, w, wpack, mask, h0, out, nullptr,
                                   nullptr, nullptr, hT, hbuf, T, D, Bd, H,
                                   device, stream);
}

int gru_cell_scan_fwd_train_bf16(const void* gx, const void* w,
                                 void* wpack, const void* mask,
                                 const void* h0, void* out, void* acts,
                                 void* ghn, void* hprev, void* hT,
                                 void* hbuf, int T, int D, int Bd, int H,
                                 int device, void* stream) {
    return launch_fwd<true, true>(gx, w, wpack, mask, h0, out, acts, ghn,
                                  hprev, hT, hbuf, T, D, Bd, H, device,
                                  stream);
}

int gru_cell_scan_fwd_train_resident_bf16(const void* gx, const void* w,
                                          const void* mask, const void* h0,
                                          void* out, void* acts, void* ghn,
                                          void* hprev, void* hT, int T,
                                          int D, int Bd, int H, int RB,
                                          int RS, int KS, int threads,
                                          int smem, int device,
                                          void* stream) {
    return launch_resident<true, true>(gx, w, mask, h0, out, acts, ghn,
                                       hprev, hT, T, D, Bd, H, RB, RS, KS,
                                       threads, smem, device, stream);
}

// The bf16 training forward on its `mma` route (see the top), the plan
// `gru_mma_plan` at the card's limits.
int gru_cell_scan_fwd_train_mma_bf16(const void* gx, const void* w,
                                     const void* mask, const void* h0,
                                     void* out, void* acts, void* ghn,
                                     void* hprev, void* hT, int T, int D,
                                     int Bd, int H, int device,
                                     void* stream) {
    return launch_fwd_mma(gx, w, mask, h0, out, acts, ghn, hprev, hT, T, D,
                          Bd, H, device, stream, -1);
}

// The lean bf16 forward on the same route: out and h_T alone.
int gru_cell_scan_fwd_mma_bf16(const void* gx, const void* w,
                               const void* mask, const void* h0, void* out,
                               void* hT, int T, int D, int Bd, int H,
                               int device, void* stream) {
    return launch_fwd_mma(gx, w, mask, h0, out, nullptr, nullptr, nullptr,
                          hT, T, D, Bd, H, device, stream, -1);
}

// The `mma` plan of the bf16 training forward (bwd 0) or backward (bwd 1)
// at (D, Bd, H) on the card: out[0..7] = n_rb, RB, RS, KT, KC, KCH,
// blocks (0 where none fits), smem.
int gru_cell_scan_mma_plan(int bwd, int D, int Bd, int H, int device,
                           void* out) {
    GruMmaPlan p;
    cudaError_t err = gru_mma_device_plan(bwd, D, Bd, H, device, &p);
    if (err != cudaSuccess) return err;
    int* o = static_cast<int*>(out);
    o[0] = p.n_rb;
    o[1] = p.RB;
    o[2] = p.RS;
    o[3] = p.KT;
    o[4] = p.KC;
    o[5] = p.KCH;
    o[6] = p.blocks;
    o[7] = (int)p.smem;
    return cudaSuccess;
}

// The card's SM count and the shared memory one block may opt in to, for
// the host planner: out[0], out[1].
// The cooperative forwards' grid at (D, Bd, H), float32 (bf16 = 0) or
// bf16, lean (train = 0) or training: out[0..6] = U, n_rb, RB, RS, KS,
// blocks (0 when no grid is co-resident), streamed (1: the streamed
// route).
int gru_cell_scan_fwd_grid(int D, int Bd, int H, int bf16, int train,
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

#ifdef LSTM_PROBE
// The probes' cycles of the `mma` route's steps (PROBE_CELL ...
// PROBE_PRODUCT; lstm_bwd_probe.py), read and zeroed.
int gru_fwd_probe_take(long long* out) {
    return probe_take(gru_fwd_probe_cycles, out);
}
#endif

int gru_cell_scan_device_limits(int device, void* out) {
    int* limits = static_cast<int*>(out);
    cudaError_t err = cudaDeviceGetAttribute(
        &limits[0], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(
        &limits[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // extern "C"
