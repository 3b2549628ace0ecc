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
// even on store); the product is bf16(h_{t-1}) @ bf16(W_hh[d]) with
// float32 sums, as the Pallas kernel's `_dir_matmul(..., cast=bf16)`.  c,
// h and the final states stay float32.  Where the grid above would stage
// W_hh, the bf16 variants take the `mma` route (below); the streamed route
// is the grid above with W_hh's slots packed as bf16, h_{t-1} float32 in
// the ping-pong buffer and rounded to bf16 as the product reads it, float32
// FMAs on the CUDA cores.
//
// The `mma` route (`lstm_fwd_mma_kernel`).  On the grid above the bf16
// product was float32 FMAs on widened operands, each reading a slot of
// W_hh from shared memory: about 11.5 us a step at the uPIT layer (H =
// 600, 16 rows a direction) on an H100.  Here it is bf16
// `mma.sync.m16n8k16` with float32 sums: the four gates' columns of 16
// units along M (four M tiles), rows along N, K = H.  A block owns a
// direction, 16 units and a range of RB rows (`mma_plan`, lstm_common.cuh);
// its slice of W_hh[d] (H rows of the four gates' 16 columns, rounded to
// bf16) is the A operand, held in registers for the whole launch: each of
// the 16 warps owns a chunk of KC k-steps of 16 of all four M tiles, so one
// B fragment feeds four products and no weight is read from shared memory
// again.  The exchange is bf16: the cell writes bf16(h_t) (what the JAX
// product reads) to a ping-pong buffer of bf16 rows, the float32 h of the
// block's own pairs stays in shared memory beside c (the masked freeze and
// h_T read it); each warp stages by cp.async.cg only its chunk's columns
// of its own row tiles (k-contiguous rows padded by 16 bytes for
// `ldmatrix`, K zero-padded to a multiple of 16; rows that are not 16-byte
// aligned copy 8, 4 or 2 bytes at a time), so no barrier of the block
// stands between the copies and the products.  Each warp sums its chunk on
// the tensor cores from zero and writes the partial sums to shared memory;
// the thread of each (row, unit) pair adds, for each gate, the chunks in
// chunk order in float32, then gx: the tensor cores' own sums never run
// over more than one chunk, and two runs give the same bits.  A step's gx
// and mask loads are issued as the step before begins, so that they land
// while it runs.  Warps that share a chunk split its row tiles (NG groups)
// where the chunks are fewer than the warps.  What is left of a step (4.3
// us at the uPIT layer on an H100, `lstm_bwd_probe.py forward`) is mostly
// the h exchange through L2, the grid sync and the cell; the product is an
// eighth of it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

// the probes' cycles (lstm_common.cuh), in -DLSTM_PROBE builds only
#ifdef LSTM_PROBE
__device__ long long lstm_fwd_probe_cycles[4];
#define PROBE_CYCLES lstm_fwd_probe_cycles
#endif

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

    PROBE_INIT();
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
            PROBE(PROBE_EXCHANGE);
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
            PROBE(PROBE_PRODUCT);
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
        PROBE(PROBE_CELL);
        grid.sync();
        PROBE(PROBE_SYNC);
    }
}

// ---- the bf16 `mma` route

// a warp's k-steps of W_hh (of each of the four M tiles) in registers, at
// most: the instantiations
constexpr int FWD_MMA_KC[] = {1, 3, 5};
constexpr int FWD_MMA_KC_MAX = 5;
constexpr int FWD_MMA_TILES = 4;        // M tiles: the gates i, f, g, o
// float4s a partial-sum row: a unit's four gates, 16 units and one of
// padding, so that neither the fragments' stores nor the pairs' loads meet
// a bank conflict
constexpr int FWD_MMA_RED = MMA_UNITS + 1;

// One (row, unit) pair's inputs to the cell part of a step: its four gate
// inputs as loaded (bf16 bits, widened where the cell reads them, so that
// no instruction waits for the load before then) and its mask.
struct FwdIn {
    unsigned short z[4];
    float m;
};

// The bf16 variants' arguments as lstm_fwd_kernel's, but hbuf (2, R, H)
// bf16; the plan's fields.  Block b: unit slice ub = b % n_ub, row range
// rb = b / n_ub % n_rb, direction d = b / (n_ub * n_rb).  Warp w: K chunk
// w % KCH (k-steps [KC chunk, ...)), row-tile group w / KCH (< NG; the
// others idle in the product).  Shared memory: h_s (RSP, 16 KT + 8) bf16 |
// red (KCH, RSP, FWD_MMA_RED) float4 (the four gates) | c_s (RB, 16) |
// hf_s (RB, 16), the float32 h.
// piece: bf16 values a copy of h (8: 16-byte asynchronous copies; 4, 2, 1
// where rows of H are not 16-byte aligned).
template <bool TRAIN, int KCR>
__global__ void __launch_bounds__(MMA_THREADS, 1) lstm_fwd_mma_kernel(
        const __nv_bfloat16* __restrict__ gx, const float* __restrict__ w,
        const float* __restrict__ mask, const float* __restrict__ h0,
        const float* __restrict__ c0, __nv_bfloat16* __restrict__ out,
        __nv_bfloat16* __restrict__ c_seq, __nv_bfloat16* __restrict__ gates,
        float* __restrict__ hT, float* __restrict__ cT, __nv_bfloat16* hbuf,
        int T, int Bd, int H, int n_ub, int n_rb, int RB, int RS, int KT,
        int KC, int KCH, int NG, int piece) {
    using Ty = ScanTypes<true>;
    using bf16 = __nv_bfloat16;
    constexpr int U = MMA_UNITS, NT = MMA_THREADS;
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float4 smem4[];
    const int ub = blockIdx.x % n_ub;
    const int rb = blockIdx.x / n_ub % n_rb;
    const int d = blockIdx.x / (n_ub * n_rb);
    const int R = gridDim.x / (n_ub * n_rb) * Bd;
    const int G = 4 * H;
    const int SK = 16 * KT + 8;            // a staged row's elements
    const int RSP = (RS + 7) / 8 * 8;
    const int r_lo = rb * RB;
    const int nrows = min(Bd, r_lo + RB) - r_lo;
    const int n_own = nrows * U;           // (row, unit) pairs
    const int row0 = d * Bd + r_lo;        // first own row
    bf16* h_s = reinterpret_cast<bf16*>(smem4);
    float4* red = reinterpret_cast<float4*>(h_s + (size_t)RSP * SK);
    float* c_s = reinterpret_cast<float*>(red + (size_t)KCH * RSP
                                          * FWD_MMA_RED);
    float* hf_s = c_s + (size_t)RB * U;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int chunk = warp % KCH;
    const bool in_product = warp / KCH < NG;
    const int ks_lo = chunk * KC;
    const int kc = min(KC, KT - ks_lo);    // this chunk's k-steps

    // the staged rows start zero: K's padding (columns H ... 16 KT) is
    // never written again
    for (int i = tid; i < RSP * SK / 8; i += NT)
        reinterpret_cast<uint4*>(h_s)[i] = make_uint4(0u, 0u, 0u, 0u);
    // this warp's A fragments: W_hh[d][k][g H + j] for the block's units j
    // of each gate g and the chunk's k, rounded to bf16; units and k past H
    // are zero
    uint32_t a[FWD_MMA_TILES][KCR][4];
    {
        const float* wd = w + (size_t)d * H * G;
        const int ja = ub * U + (lane >> 2), jb = ja + 8;
        const auto wv = [&](int g, int j, int k) {
            return j < H && k < H ? wd[(size_t)k * G + g * H + j] : 0.0f;
        };
#pragma unroll
        for (int g = 0; g < FWD_MMA_TILES; ++g) {
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
    // the carries of the own pairs, and bf16(h0) in the buffer step 0
    // reads
    for (int q = tid; q < n_own; q += NT) {
        const int jj = ub * U + q % U;
        if (jj >= H) continue;
        const size_t at = (size_t)(row0 + q / U) * H + jj;
        hf_s[q] = h0[at];
        c_s[q] = c0[at];
        __stcg(hbuf + (size_t)R * H + at, __float2bfloat16_rn(h0[at]));
    }

    const auto fetch = [&](int t, int q) {
        FwdIn x = {{0, 0, 0, 0}, 1.f};
        const int jj = ub * U + q % U;
        if (jj < H) {
            const size_t at = (size_t)t * R + row0 + q / U;
            const unsigned short* gr =
                reinterpret_cast<const unsigned short*>(gx) + at * G + jj;
            x.z[0] = gr[0];
            x.z[1] = gr[H];
            x.z[2] = gr[2 * H];
            x.z[3] = gr[3 * H];
            if (mask != nullptr) x.m = mask[at];
        }
        return x;
    };
    // a thread's first two pairs take their inputs from registers: the
    // loads of step t + 1 are issued as step t begins and move into place
    // as it ends, so they land while the step runs; further pairs (more
    // than 1024 a block) load in place
    FwdIn pf0 = {}, pf1 = {}, nx0 = {}, nx1 = {};
    if (tid < n_own) pf0 = fetch(0, tid);
    if (tid + NT < n_own) pf1 = fetch(0, tid + NT);
    grid.sync();  // bf16(h0) of every block is in L2

    // this warp's columns of h: k_lo ... in per_row copies a row
    const int k_lo = 16 * ks_lo;
    const int per_row = (min(H, 16 * (ks_lo + kc)) - k_lo) / piece;

    PROBE_INIT();
    for (int t = 0; t < T; ++t) {
        const bf16* h_prev = hbuf + (size_t)((t + 1) & 1) * R * H;
        bf16* h_next = hbuf + (size_t)(t & 1) * R * H;
        if (t + 1 < T) {
            if (tid < n_own) nx0 = fetch(t + 1, tid);
            if (tid + NT < n_own) nx1 = fetch(t + 1, tid + NT);
        }
        for (int rc = 0; rc < nrows; rc += RS) {
            const int nr = min(RS, nrows - rc);
            if (rc > 0) __syncthreads();  // the previous chunk's readers
            const bf16* src = h_prev + (size_t)(row0 + rc) * H;
            if (in_product) {
                // h of this warp's row tiles in its chunk's columns, staged
                // by the warp alone: no barrier of the block between the
                // copies and the products
                for (int nt = warp / KCH; 8 * nt < nr; nt += NG) {
                    const int rows = min(8, nr - 8 * nt);
                    for (int i = lane; i < rows * per_row; i += 32) {
                        const int r = 8 * nt + i / per_row;
                        const int c = k_lo + piece * (i % per_row);
                        bf16* dst = h_s + (size_t)r * SK + c;
                        const bf16* from = src + (size_t)r * H + c;
                        if (piece == 8) {
                            cp_async16_cg(dst, from);
                        } else if (piece == 4) {
                            *reinterpret_cast<uint2*>(dst) = __ldcg(
                                reinterpret_cast<const uint2*>(from));
                        } else if (piece == 2) {
                            *reinterpret_cast<unsigned*>(dst) = __ldcg(
                                reinterpret_cast<const unsigned*>(from));
                        } else {
                            *reinterpret_cast<unsigned short*>(dst) =
                                __ldcg(reinterpret_cast<const unsigned short*>(
                                    from));
                        }
                    }
                }
            }
            if (in_product) {
                if (piece == 8) cp_async_wait_all();
                __syncwarp();
            }
            PROBE(PROBE_EXCHANGE);
            if (in_product) {
                // the chunk's partial sums of row tiles w / KCH, + NG, ...
                float4* red_c = red + (size_t)chunk * RSP * FWD_MMA_RED;
                for (int nt = warp / KCH; 8 * nt < nr; nt += NG) {
                    float c[FWD_MMA_TILES][4] = {};
                    const bf16* b_row = h_s
                        + (size_t)(8 * nt + (lane & 7)) * SK + 16 * ks_lo
                        + ((lane >> 3) & 1) * 8;
#pragma unroll
                    for (int kk = 0; kk < KCR; ++kk) {
                        if (kk < kc) {
                            uint32_t b0, b1;
                            ldsm_x2(b_row + 16 * kk, b0, b1);
#pragma unroll
                            for (int g = 0; g < FWD_MMA_TILES; ++g)
                                mma_bf16(c[g], a[g][kk], b0, b1);
                        }
                    }
                    // c[g]: units lane / 4 (+ 8), rows 2 (lane % 4) (+ 1)
                    const int n = 8 * nt + 2 * (lane & 3), m = lane >> 2;
                    float4* rn = red_c + n * FWD_MMA_RED + m;
                    rn[0] = make_float4(c[0][0], c[1][0], c[2][0], c[3][0]);
                    rn[FWD_MMA_RED] = make_float4(c[0][1], c[1][1], c[2][1],
                                                  c[3][1]);
                    rn[8] = make_float4(c[0][2], c[1][2], c[2][2], c[3][2]);
                    rn[FWD_MMA_RED + 8] = make_float4(c[0][3], c[1][3],
                                                      c[2][3], c[3][3]);
                }
            }
            __syncthreads();
            PROBE(PROBE_PRODUCT);
            // each own pair of these rows: for each gate the chunks in chunk
            // order, then gx; the cell
            for (int q = tid; q < n_own; q += NT) {
                const int r = q / U - rc;
                const int u = q % U;
                const int jj = ub * U + u;
                if (r < 0 || r >= nr || jj >= H) continue;
                const FwdIn x = q == tid ? pf0
                                : q == tid + NT ? pf1 : fetch(t, q);
                // the four gates' sums side by side, several chunks' loads
                // in flight at once; each gate adds the chunks in chunk
                // order
                const float4* rp = red + (size_t)r * FWD_MMA_RED + u;
                const size_t step = (size_t)RSP * FWD_MMA_RED;  // a chunk's
                float4 acc = rp[0];
#pragma unroll 4
                for (int c = 1; c < KCH; ++c) {
                    const float4 v = rp[c * step];
                    acc.x += v.x;
                    acc.y += v.y;
                    acc.z += v.z;
                    acc.w += v.w;
                }
                const float z[FWD_MMA_TILES] = {
                    __uint_as_float((unsigned)x.z[0] << 16) + acc.x,
                    __uint_as_float((unsigned)x.z[1] << 16) + acc.y,
                    __uint_as_float((unsigned)x.z[2] << 16) + acc.z,
                    __uint_as_float((unsigned)x.z[3] << 16) + acc.w};
                const float i_ = sigmoidf_(z[0]);
                const float f_ = sigmoidf_(z[1]);
                const float g_ = tanhf(z[2]);
                const float o_ = sigmoidf_(z[3]);
                const float c_old = c_s[q];
                float c_new = f_ * c_old + i_ * g_;
                float h_new = o_ * tanhf(c_new);
                float h_out = h_new;
                const size_t row = row0 + q / U;
                const size_t at = (size_t)t * R + row;
                if (TRAIN) {
                    bf16* gr = gates + at * G + jj;
                    Ty::st(gr, i_);
                    Ty::st(gr + H, f_);
                    Ty::st(gr + 2 * H, g_);
                    Ty::st(gr + 3 * H, o_);
                    Ty::st(c_seq + at * H + jj, c_old);
                }
                if (mask != nullptr) {
                    if (!(x.m > 0.0f)) {
                        h_new = hf_s[q];
                        c_new = c_old;
                    }
                    h_out = h_new * x.m;
                }
                c_s[q] = c_new;
                hf_s[q] = h_new;
                Ty::st(out + at * H + jj, h_out);
                Ty::stcg(h_next + row * H + jj, h_new);
                if (t == T - 1) {
                    hT[row * H + jj] = h_new;
                    cT[row * H + jj] = c_new;
                }
            }
        }
        pf0 = nx0;
        pf1 = nx1;
        PROBE(PROBE_CELL);
        grid.sync();  // h_t of every block is in L2
        PROBE(PROBE_SYNC);
    }
}

// The kernel of a plan: the instantiation that holds its KC k-steps.
template <bool TRAIN>
const void* fwd_mma_kernel(const MmaPlan& p) {
    if (p.KC <= FWD_MMA_KC[0])
        return (const void*)lstm_fwd_mma_kernel<TRAIN, FWD_MMA_KC[0]>;
    if (p.KC <= FWD_MMA_KC[1])
        return (const void*)lstm_fwd_mma_kernel<TRAIN, FWD_MMA_KC[1]>;
    return (const void*)lstm_fwd_mma_kernel<TRAIN, FWD_MMA_KC[2]>;
}

// The staged search's kernel: the variant's own.  For bf16, whose staged
// grid only says that W_hh need not stream (the `mma` route then runs,
// and the bf16 FMA grid is built only for the probes), the float32 kernel:
// the same launch bound, so the same registers at most.
template <bool TRAIN, bool BF16>
const void* staged_kernel() {
#ifdef LSTM_PROBE
    return (const void*)lstm_fwd_kernel<TRAIN, BF16, false>;
#else
    return (const void*)lstm_fwd_kernel<TRAIN, false, false>;
#endif
}

// The LSTM forward's shared memory beside the staged weights: the partial
// gates of KS - 1 slices, h of RS rows and c of the block's RB rows.
inline size_t grid_rest(int H, int U, int RB, int RS, int KS) {
    return sizeof(float) * ((size_t)(KS - 1) * RS * U * 4 + (size_t)RS * H
                            + (size_t)RB * U);
}

// The grid of the staged search (`pick_route`, lstm_common.cuh): resident
// or streamed, with the LSTM's shared memory (the weights' four gate
// columns, in the variant's element type, on the resident route only, and
// `grid_rest`).
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
        return grid_rest(H, U, RB, RS, KS);
    };
    return pick_route(staged_kernel<TRAIN, BF16>(),
                      (const void*)lstm_fwd_kernel<TRAIN, BF16, true>, D, Bd,
                      H, H, n_sm, max_smem, sizeof(W4) * (size_t)H, rest,
                      best, streamed);
}

// The route of a launch.  float32: `pick_grid`'s.  bf16: streamed where
// `pick_grid` streams, or where the `mma` plan does not fit (on an H100
// two directions' slices of 16 units outnumber the SMs from H = 1057);
// else `mma` (*mma 1, `plan`).  With FMA (probe builds only) the bf16
// variant keeps the FMA grid, as the float32 kernel does.
template <bool TRAIN, bool BF16, bool FMA = false>
cudaError_t pick_fwd_route(int D, int Bd, int H, int device, ScanGrid* best,
                           int* streamed, MmaPlan* plan, int* mma) {
    *mma = 0;
    *plan = MmaPlan{};
    cudaError_t err = pick_grid<TRAIN, BF16>(D, Bd, H, device, best,
                                             streamed);
    if (err != cudaSuccess || !BF16 || FMA || *streamed || best->blocks == 0)
        return err;
    int n_sm = 0, max_smem = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    *plan = mma_plan(D, Bd, H, H, FWD_MMA_TILES * FWD_MMA_RED,
                     FWD_MMA_KC_MAX, n_sm, max_smem);
    if (plan->blocks > 0) {
        err = fit_mma(fwd_mma_kernel<TRAIN>(*plan), n_sm, plan);
        if (err != cudaSuccess) return err;
    }
    if (plan->blocks > 0) {
        *mma = 1;
        return cudaSuccess;
    }
    *streamed = 1;
    return pick_streamed(
        (const void*)lstm_fwd_kernel<TRAIN, BF16, true>, D, Bd, H, H, n_sm,
        max_smem,
        [H](int U, int RB, int RS, int KS) {
            return grid_rest(H, U, RB, RS, KS);
        },
        best);
}

// Launch the whole recurrence on the route `pick_fwd_route` chooses (on
// the streamed route W_hh packed into `wpack`, packed_slots_bytes of the
// forward; it may be null on the other routes; on the `mma` route hbuf
// holds bf16 rows and must be 16-byte aligned).  Fails with
// cudaErrorCooperativeLaunchTooLarge when no grid is co-resident on any
// route.  Returns cudaGetLastError() after the launch.
template <bool TRAIN, bool BF16, bool FMA = false>
int launch_fwd(const void* gx, const void* w, void* wpack, const void* mask,
               const void* h0, const void* c0, void* out, void* c_seq,
               void* gates, void* hT, void* cT, void* hbuf, int T, int D,
               int Bd, int H, int device, void* stream) {
    using S = typename ScanTypes<BF16>::S;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid best;
    MmaPlan plan;
    int streamed = 0, mma = 0;
    err = pick_fwd_route<TRAIN, BF16, FMA>(D, Bd, H, device, &best,
                                           &streamed, &plan, &mma);
    if (err != cudaSuccess) return err;
    if (best.blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
    const S* gx_ = static_cast<const S*>(gx);
    const float* w_ = static_cast<const float*>(w);
    const float* mask_ = static_cast<const float*>(mask);
    const float* h0_ = static_cast<const float*>(h0);
    const float* c0_ = static_cast<const float*>(c0);
    S* out_ = static_cast<S*>(out);
    S* c_seq_ = static_cast<S*>(c_seq);
    S* gates_ = static_cast<S*>(gates);
    float* hT_ = static_cast<float*>(hT);
    float* cT_ = static_cast<float*>(cT);
    if (mma) {
        if (reinterpret_cast<uintptr_t>(hbuf) % 16 != 0)
            return cudaErrorInvalidValue;
        int piece = H % 8 == 0 ? 8 : (H % 4 == 0 ? 4 : (H % 2 == 0 ? 2 : 1));
        __nv_bfloat16* hbuf_ = static_cast<__nv_bfloat16*>(hbuf);
        void* args[] = {&gx_, &w_, &mask_, &h0_, &c0_, &out_, &c_seq_,
                        &gates_, &hT_, &cT_, &hbuf_, &T, &Bd, &H, &plan.n_ub,
                        &plan.n_rb, &plan.RB, &plan.RS, &plan.KT, &plan.KC,
                        &plan.KCH, &plan.NG, &piece};
        err = cudaLaunchCooperativeKernel(
            fwd_mma_kernel<TRAIN>(plan), dim3(plan.blocks),
            dim3(MMA_THREADS), args, plan.smem,
            static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return err;
        return cudaGetLastError();
    }
    const void* kernel =
        streamed ? (const void*)lstm_fwd_kernel<TRAIN, BF16, true>
                 : staged_kernel<TRAIN, BF16>();
    int vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(h0) % 16 == 0
              && reinterpret_cast<uintptr_t>(hbuf) % 16 == 0;
    if (streamed) {
        err = pack_slots<BF16>(w_, wpack, D, H, 4, true,
                               static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return err;
        w_ = static_cast<const float*>(wpack);
    }
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
// weights, null where the card takes another route.  hbuf: (2, R, H)
// float32 scratch (the bf16 `mma` route uses its first half as bf16).
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

#ifdef LSTM_PROBE
// Probe builds: the bf16 training forward on the FMA grid (the route the
// `mma` route replaced), and the probes' cycles (PROBE_CELL ...
// PROBE_PRODUCT), read and zeroed.
int lstm_cell_scan_fwd_train_bf16_fma(
        const void* gx, const void* w, void* wpack, const void* mask,
        const void* h0, const void* c0, void* out, void* c_seq, void* gates,
        void* hT, void* cT, void* hbuf, int T, int D, int Bd, int H,
        int device, void* stream) {
    return launch_fwd<true, true, true>(gx, w, wpack, mask, h0, c0, out,
                                        c_seq, gates, hT, cT, hbuf, T, D, Bd,
                                        H, device, stream);
}

int lstm_fwd_probe_take(long long* out) {
    return probe_take(lstm_fwd_probe_cycles, out);
}
#endif

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
// (bf16 = 0) or bf16, at (D, Bd, H) takes: out[0..7] = U, n_rb, RB, RS,
// KS, blocks (0 when no grid is co-resident), streamed (1: the streamed
// route), mma (1: the bf16 `mma` route, whose U is 16 and KS its K
// chunks).
int lstm_cell_scan_fwd_grid(int D, int Bd, int H, int bf16, int train,
                            int device, void* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid g;
    MmaPlan plan;
    int streamed = 0, mma = 0;
    err = bf16 ? (train ? pick_fwd_route<true, true>(D, Bd, H, device, &g,
                                                     &streamed, &plan, &mma)
                        : pick_fwd_route<false, true>(D, Bd, H, device, &g,
                                                      &streamed, &plan, &mma))
               : (train ? pick_fwd_route<true, false>(D, Bd, H, device, &g,
                                                      &streamed, &plan, &mma)
                        : pick_fwd_route<false, false>(D, Bd, H, device, &g,
                                                       &streamed, &plan,
                                                       &mma));
    if (err != cudaSuccess) return err;
    int* o = static_cast<int*>(out);
    o[0] = mma ? MMA_UNITS : g.U;
    o[1] = mma ? plan.n_rb : g.n_rb;
    o[2] = mma ? plan.RB : g.RB;
    o[3] = mma ? plan.RS : g.RS;
    o[4] = mma ? plan.KCH : g.KS;
    o[5] = mma ? plan.blocks : g.blocks;
    o[6] = streamed;
    o[7] = mma;
    return cudaSuccess;
}

}  // extern "C"
