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
// float32, as the Pallas kernel's `_dir_matmul(..., cast=bf16)`.  dh, dc
// and dh0, dc0 stay float32.  Where the grid above would stage W_hh, the
// bf16 variant takes the `mma` route instead (below); the streamed route
// is the grid above with W_hh's rows packed as bf16 slots.
//
// The `mma` route (`lstm_bwd_mma_kernel`).  On the route above the
// product is float32 FMAs on widened bf16 operands, each reading a slot
// of W_hh and one of dz from shared memory: about 4 bytes a multiply-add,
// some 7 of a 13.7 us step at the uPIT layer (H = 600, 16 rows a
// direction) on an H100.  Here it is bf16 `mma.sync.m16n8k16` with
// float32 sums: units along M, rows along N, K = 4H.  A block owns a
// direction, 16 units (one M tile) and a range of RB rows (`mma_plan`);
// its slice of W_hh[d] (16 rows of 4H columns, rounded to bf16) is the A
// operand, held in registers for the whole launch: each of the 16 warps
// owns a chunk of KC k-steps of 16 (its A fragments, at most KC_MAX), so
// no weight is read from shared memory again.  The step's dz rows are the
// B operand (k-contiguous rows in shared memory, padded by 16 bytes so that
// `ldmatrix` meets no bank conflict, K zero-padded to a multiple of 16):
// each warp stages by cp.async.cg only its chunk's columns of its own row
// tiles, so no barrier of the block stands between the copies and the
// products.  Each warp sums its chunk on the tensor cores from zero (a
// chunk's NG warps split its row tiles), writes the partial sums to shared
// memory, and the thread of each (row, unit) pair adds the chunks in chunk
// order in float32: the tensor cores' own sums never run over more than
// one chunk, and two runs give the same bits.  The cell
// part of step t-1 runs in the same threads (no barrier between the sum
// and the cell), and its global loads (gates, c_seq, d_out, mask) for the
// next step are issued before the grid sync, so they land while the grid
// waits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

// the probes' cycles (lstm_common.cuh), in -DLSTM_PROBE builds only
#ifdef LSTM_PROBE
__device__ long long lstm_bwd_probe_cycles[4];
#define PROBE_CYCLES lstm_bwd_probe_cycles
#endif

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

    PROBE_INIT();
    cell(T - 1);
    for (int t = T - 1; t >= 0; --t) {
        PROBE(PROBE_CELL);
        grid.sync();  // dz[t] of every block is in L2
        PROBE(PROBE_SYNC);
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
            PROBE(PROBE_EXCHANGE);
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
        PROBE(PROBE_PRODUCT);
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

// ---- the bf16 `mma` route

// a warp's k-steps of W_hh in registers, at most: the instantiations
constexpr int MMA_KC[] = {2, 10, 18};
constexpr int MMA_KC_MAX = 18;

// One (row, unit) pair's inputs to the cell part of a step.
struct CellIn {
    float i, f, g, o, c_prev, d_out, m;
};

// The bf16 variant's arguments as lstm_bwd_kernel's; the plan's fields.
// Block b: unit slice ub = b % n_ub, row range rb = b / n_ub % n_rb,
// direction d = b / (n_ub * n_rb).  Warp w: K chunk w % KCH (k-steps
// [KC chunk, ...)), row-tile group w / KCH (< NG; the others idle in the
// product).  Shared memory: dz_s (RSP, 16 KT + 8) bf16 | red (KCH, RSP,
// MMA_RED) | dh_s (RB, 16) | dc_s (RB, 16).  vec: dz by 16-byte copies
// (H even), else 8 bytes.
template <int KCR>
__global__ void __launch_bounds__(MMA_THREADS, 1) lstm_bwd_mma_kernel(
        const __nv_bfloat16* __restrict__ gates,
        const __nv_bfloat16* __restrict__ c_seq,
        const float* __restrict__ w, const float* __restrict__ mask,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ dhT, const float* __restrict__ dcT,
        __nv_bfloat16* dgx, float* __restrict__ dh0,
        float* __restrict__ dc0, int T, int Bd, int H, int n_ub, int n_rb,
        int RB, int RS, int KT, int KC, int KCH, int NG, int vec) {
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
    bf16* dz_s = reinterpret_cast<bf16*>(smem4);
    float* red = reinterpret_cast<float*>(dz_s + (size_t)RSP * SK);
    float* dh_s = red + (size_t)KCH * RSP * MMA_RED;
    float* dc_s = dh_s + (size_t)RB * U;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int chunk = warp % KCH;
    const bool in_product = warp / KCH < NG;
    const int ks_lo = chunk * KC;
    const int kc = min(KC, KT - ks_lo);    // this chunk's k-steps

    // the staged rows start zero: K's padding (columns 4H ... 16 KT) is
    // never written again
    for (int i = tid; i < RSP * SK / 8; i += NT)
        reinterpret_cast<uint4*>(dz_s)[i] = make_uint4(0u, 0u, 0u, 0u);
    // this warp's A fragments: W_hh[d][j][k] for the block's units j and
    // the chunk's k, rounded to bf16; units past H and k past 4H are zero
    uint32_t a[KCR][4];
    {
        const float* wd = w + (size_t)d * H * G;
        const int ja = ub * U + (lane >> 2), jb = ja + 8;
        const auto wv = [&](int j, int k) {
            return j < H && k < G ? wd[(size_t)j * G + k] : 0.0f;
        };
#pragma unroll
        for (int kk = 0; kk < KCR; ++kk) {
            const int k0 = 16 * (ks_lo + kk) + 2 * (lane & 3);
            const bool on = in_product && kk < kc;
            a[kk][0] = on ? pack_bf16x2(wv(ja, k0), wv(ja, k0 + 1)) : 0u;
            a[kk][1] = on ? pack_bf16x2(wv(jb, k0), wv(jb, k0 + 1)) : 0u;
            a[kk][2] = on ? pack_bf16x2(wv(ja, k0 + 8), wv(ja, k0 + 9)) : 0u;
            a[kk][3] = on ? pack_bf16x2(wv(jb, k0 + 8), wv(jb, k0 + 9)) : 0u;
        }
    }
    for (int q = tid; q < n_own; q += NT) {
        const int jj = ub * U + q % U;
        const size_t at = (size_t)(row0 + q / U) * H + jj;
        dh_s[q] = jj < H ? dhT[at] : 0.0f;
        dc_s[q] = jj < H ? dcT[at] : 0.0f;
    }

    const auto fetch = [&](int t, int q) {
        CellIn x = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const int jj = ub * U + q % U;
        if (jj < H) {
            const size_t at = (size_t)t * R + row0 + q / U;
            const bf16* gr = gates + at * G;
            x.i = Ty::ld(gr + jj);
            x.f = Ty::ld(gr + H + jj);
            x.g = Ty::ld(gr + 2 * H + jj);
            x.o = Ty::ld(gr + 3 * H + jj);
            x.c_prev = Ty::ld(c_seq + at * H + jj);
            x.d_out = Ty::ld(dout + at * H + jj);
            x.m = mask != nullptr ? mask[at] : 1.0f;
        }
        return x;
    };
    // the elementwise part of step t for pair q: dz[t] to dgx, dc
    const auto cell = [&](int t, int q, const CellIn& x) {
        const int jj = ub * U + q % U;
        if (jj >= H) return;
        const size_t at = (size_t)t * R + row0 + q / U;
        const float c_t = x.f * x.c_prev + x.i * x.g;
        const float tanh_c = tanhf(c_t);
        const float dh = dh_s[q] + x.d_out;
        const float dc_in = dc_s[q];
        const float d_o = dh * tanh_c;
        const float dc = dc_in + dh * x.o * (1.0f - tanh_c * tanh_c);
        const float dzi = dc * x.g * x.i * (1.0f - x.i) * x.m;
        const float dzf = dc * x.c_prev * x.f * (1.0f - x.f) * x.m;
        const float dzg = dc * x.i * (1.0f - x.g * x.g) * x.m;
        const float dzo = d_o * x.o * (1.0f - x.o) * x.m;
        bf16* dr = dgx + at * G;
        Ty::stcg(dr + jj, dzi);
        Ty::stcg(dr + H + jj, dzf);
        Ty::stcg(dr + 2 * H + jj, dzg);
        Ty::stcg(dr + 3 * H + jj, dzo);
        dc_s[q] = x.m > 0.0f ? dc * x.f : dc_in;
    };
    // a thread's first two pairs take their inputs from registers, loaded
    // a step ahead; further pairs (more than 1024 a block) load in place
    CellIn pf0 = {}, pf1 = {};
    float m0 = 1.0f, m1 = 1.0f;            // their masks at the current step
    const auto prefetch = [&](int t) {
        if (tid < n_own) pf0 = fetch(t, tid);
        if (tid + NT < n_own) pf1 = fetch(t, tid + NT);
    };
    const auto cells = [&](int t) {
        if (tid < n_own) {
            cell(t, tid, pf0);
            m0 = pf0.m;
        }
        if (tid + NT < n_own) {
            cell(t, tid + NT, pf1);
            m1 = pf1.m;
        }
        for (int q = tid + 2 * NT; q < n_own; q += NT) cell(t, q, fetch(t, q));
    };
    const auto mask_of = [&](int t, int q) {
        if (q == tid) return m0;
        if (q == tid + NT) return m1;
        return mask != nullptr ? mask[(size_t)t * R + row0 + q / U] : 1.0f;
    };
    __syncthreads();

    PROBE_INIT();
    prefetch(T - 1);
    cells(T - 1);
    if (T > 1) prefetch(T - 2);
    for (int t = T - 1; t >= 0; --t) {
        PROBE(PROBE_CELL);
        grid.sync();  // dz[t] of every block is in L2
        PROBE(PROBE_SYNC);
        for (int rc = 0; rc < nrows; rc += RS) {
            const int nr = min(RS, nrows - rc);
            if (rc > 0) __syncthreads();  // the previous chunk's readers
            const bf16* src = dgx + ((size_t)t * R + row0 + rc) * G;
            if (in_product) {
                // the dz of this warp's row tiles in its chunk's columns,
                // staged by the warp alone: no barrier of the block
                // between the copies and the products
                const int k_lo = 16 * ks_lo;
                const int k_hi = min(G, 16 * (ks_lo + kc));
                const int piece = vec ? 8 : 4;   // bf16 values a copy
                const int per_row = (k_hi - k_lo) / piece;
                for (int nt = warp / KCH; 8 * nt < nr; nt += NG) {
                    const int rows = min(8, nr - 8 * nt);
                    for (int i = lane; i < rows * per_row; i += 32) {
                        const int r = 8 * nt + i / per_row;
                        const int c = k_lo + piece * (i % per_row);
                        if (vec) {
                            cp_async16_cg(dz_s + (size_t)r * SK + c,
                                          src + (size_t)r * G + c);
                        } else {
                            *reinterpret_cast<uint2*>(dz_s + (size_t)r * SK
                                                      + c) =
                                __ldcg(reinterpret_cast<const uint2*>(
                                    src + (size_t)r * G + c));
                        }
                    }
                }
                if (vec) cp_async_wait_all();
                __syncwarp();
            }
            PROBE(PROBE_EXCHANGE);
            if (in_product) {
                // the chunk's partial sums of row tiles w / KCH, + NG, ...
                float* red_c = red + (size_t)chunk * RSP * MMA_RED;
                for (int nt = warp / KCH; 8 * nt < nr; nt += NG) {
                    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    const bf16* b_row = dz_s
                        + (size_t)(8 * nt + (lane & 7)) * SK + 16 * ks_lo
                        + ((lane >> 3) & 1) * 8;
#pragma unroll
                    for (int kk = 0; kk < KCR; ++kk) {
                        if (kk < kc) {
                            uint32_t b0, b1;
                            ldsm_x2(b_row + 16 * kk, b0, b1);
                            mma_bf16(c, a[kk], b0, b1);
                        }
                    }
                    // c: units lane / 4 (+ 8), rows 2 (lane % 4) (+ 1)
                    const int n = 8 * nt + 2 * (lane & 3), m = lane >> 2;
                    red_c[n * MMA_RED + m] = c[0];
                    red_c[(n + 1) * MMA_RED + m] = c[1];
                    red_c[n * MMA_RED + m + 8] = c[2];
                    red_c[(n + 1) * MMA_RED + m + 8] = c[3];
                }
            }
            __syncthreads();
            // each own pair of these rows: the chunks in chunk order
            for (int q = tid; q < n_own; q += NT) {
                const int r = q / U - rc;
                const int u = q % U;
                if (r < 0 || r >= nr || ub * U + u >= H) continue;
                float acc = red[(size_t)r * MMA_RED + u];
                for (int c = 1; c < KCH; ++c)
                    acc += red[((size_t)c * RSP + r) * MMA_RED + u];
                if (mask_of(t, q) > 0.0f) dh_s[q] = acc;
            }
        }
        PROBE(PROBE_PRODUCT);
        // the cell part of step t - 1 in the threads that summed its pairs
        if (t > 0) {
            cells(t - 1);
            if (t > 1) prefetch(t - 2);
        }
    }
    for (int q = tid; q < n_own; q += NT) {
        const int jj = ub * U + q % U;
        if (jj >= H) continue;
        const size_t at = (size_t)(row0 + q / U) * H + jj;
        dh0[at] = dh_s[q];
        dc0[at] = dc_s[q];
    }
}

// The kernel of a plan: the instantiation that holds its KC k-steps.
inline const void* mma_kernel(const MmaPlan& p) {
    if (p.KC <= MMA_KC[0]) return (const void*)lstm_bwd_mma_kernel<MMA_KC[0]>;
    if (p.KC <= MMA_KC[1]) return (const void*)lstm_bwd_mma_kernel<MMA_KC[1]>;
    return (const void*)lstm_bwd_mma_kernel<MMA_KC[2]>;
}

// The `mma` plan on `device`, its kernel's dynamic shared memory limit
// set; blocks 0 where none fits or the grid is not co-resident.
cudaError_t pick_mma(int D, int Bd, int H, int device, MmaPlan* plan) {
    int n_sm = 0, max_smem = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    *plan = mma_plan(D, Bd, H, 4 * H, MMA_RED, MMA_KC_MAX, n_sm, max_smem);
    if (plan->blocks == 0) return cudaSuccess;
    return fit_mma(mma_kernel(*plan), n_sm, plan);
}

// The grid of a launch: `pick_route` (lstm_common.cuh), resident or
// streamed, as the forward's, with this kernel's shared memory: W_hh's
// rows for U units (4H columns; resident route only) and dz of RS rows,
// both in the variant's element type, the partial sums of KS - 1 slices,
// and dh, dc of the block's RB rows.  `rest` of a grid, the bytes beside
// W_hh's rows.
template <bool BF16>
size_t grid_rest(int H, int U, int RB, int RS, int KS) {
    using W4 = typename ScanTypes<BF16>::W4;
    return sizeof(W4) * (size_t)RS * H
           + sizeof(float) * ((size_t)(KS - 1) * RS * U + 2 * (size_t)RB * U);
}

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
        return grid_rest<BF16>(H, U, RB, RS, KS);
    };
    return pick_route((const void*)lstm_bwd_kernel<BF16, false>,
                      (const void*)lstm_bwd_kernel<BF16, true>, D, Bd, H, H,
                      n_sm, max_smem, sizeof(W4) * (size_t)H, rest, best,
                      streamed);
}

// The route of a launch.  float32: `pick_grid`'s.  bf16: streamed where
// `pick_grid` streams, or where the `mma` plan does not fit (on an H100
// one direction's slices of 16 units outnumber the SMs only from H =
// 1057); else `mma` (*mma 1, `plan`).  With FMA (probe builds only) the
// bf16 variant keeps the float32 FMA grid as the float32 kernel does.
template <bool BF16, bool FMA = false>
cudaError_t pick_bwd_route(int D, int Bd, int H, int device, ScanGrid* best,
                           int* streamed, MmaPlan* plan, int* mma) {
    *mma = 0;
    *plan = MmaPlan{};
    cudaError_t err = pick_grid<BF16>(D, Bd, H, device, best, streamed);
    if (err != cudaSuccess || !BF16 || FMA || *streamed || best->blocks == 0)
        return err;
    err = pick_mma(D, Bd, H, device, plan);
    if (err != cudaSuccess) return err;
    if (plan->blocks > 0) {
        *mma = 1;
        return cudaSuccess;
    }
    int n_sm = 0, max_smem = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    *streamed = 1;
    return pick_streamed(
        (const void*)lstm_bwd_kernel<BF16, true>, D, Bd, H, H, n_sm,
        max_smem,
        [H](int U, int RB, int RS, int KS) {
            return grid_rest<BF16>(H, U, RB, RS, KS);
        },
        best);
}

// Launch the whole adjoint recurrence on the route `pick_bwd_route`
// chooses.  Fails with cudaErrorCooperativeLaunchTooLarge when no grid is
// co-resident on any route, and with cudaErrorInvalidValue when dgx is
// not aligned to a W4 slot (float32: 16 bytes, as its copies need; bf16:
// 8 bytes).  Returns cudaGetLastError() after the launch.
template <bool BF16, bool FMA = false>
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
    MmaPlan plan;
    int streamed = 0, mma = 0;
    err = pick_bwd_route<BF16, FMA>(D, Bd, H, device, &best, &streamed,
                                    &plan, &mma);
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
    if (mma) {
        void* args[] = {&gates_, &c_seq_, &w_, &mask_, &dout_, &dhT_, &dcT_,
                        &dgx_, &dh0_, &dc0_, &T, &Bd, &H, &plan.n_ub,
                        &plan.n_rb, &plan.RB, &plan.RS, &plan.KT, &plan.KC,
                        &plan.KCH, &plan.NG, &vec};
        err = cudaLaunchCooperativeKernel(
            mma_kernel(plan), dim3(plan.blocks), dim3(MMA_THREADS), args,
            plan.smem, static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return err;
        return cudaGetLastError();
    }
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
// (D, Bd, H) takes: out[0..7] = U, n_rb, RB, RS, KS, blocks (blocks 0
// when no grid is co-resident), streamed (1: the streamed route), mma (1:
// the bf16 `mma` route, whose U is 16 and KS its K chunks).
int lstm_cell_scan_bwd_grid(int D, int Bd, int H, int bf16, int device,
                            void* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid best;
    MmaPlan plan;
    int streamed = 0, mma = 0;
    err = bf16 ? pick_bwd_route<true>(D, Bd, H, device, &best, &streamed,
                                      &plan, &mma)
               : pick_bwd_route<false>(D, Bd, H, device, &best, &streamed,
                                       &plan, &mma);
    if (err != cudaSuccess) return err;
    int* o = static_cast<int*>(out);
    o[0] = mma ? MMA_UNITS : best.U;
    o[1] = mma ? plan.n_rb : best.n_rb;
    o[2] = mma ? plan.RB : best.RB;
    o[3] = mma ? plan.RS : best.RS;
    o[4] = mma ? plan.KCH : best.KS;
    o[5] = mma ? plan.blocks : best.blocks;
    o[6] = streamed;
    o[7] = mma;
    return cudaSuccess;
}

// The adjoint recurrence, float32 streams.  `wpack`: scratch of
// packed_slots_bytes(bf16, D, H, 4, bwd) for the streamed route's packed
// weights, null where the card takes another route.
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

#ifdef LSTM_PROBE
// Probe builds: the bf16 variant on the float32 FMA grid (the route the
// `mma` route replaced), and the probes' cycles (PROBE_CELL ...
// PROBE_PRODUCT), read and zeroed.
int lstm_cell_scan_bwd_bf16_fma(const void* gates, const void* c_seq,
                                const void* w, void* wpack, const void* mask,
                                const void* dout, const void* dhT,
                                const void* dcT, void* dgx, void* dh0,
                                void* dc0, int T, int D, int Bd, int H,
                                int device, void* stream) {
    return launch_bwd<true, true>(gates, c_seq, w, wpack, mask, dout, dhT,
                                  dcT, dgx, dh0, dc0, T, D, Bd, H, device,
                                  stream);
}

int lstm_bwd_probe_take(long long* out) {
    return probe_take(lstm_bwd_probe_cycles, out);
}
#endif

}  // extern "C"
