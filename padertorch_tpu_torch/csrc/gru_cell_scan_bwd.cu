// GRU cell recurrence, backward: the adjoint recurrence in reverse time,
// in one launch per layer (both directions together).  Two routes, chosen
// by shape before the launch (`resident_bwd_plan` in ops/kernels/gru.py),
// as for the forwards (gru_cell_scan.cu): the resident kernel where one
// direction's whole W_hh fits one block's shared memory beside what the
// block stages (H <= 137 on an H100, 192 in bf16), the cooperative kernel
// otherwise.
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
// chip for the whole launch; what is left per step is latency.
//
// Resident route.  A row's adjoint needs only its own carry and W_hh[d],
// as its forward needs only its own h and W_hh[d].  So a block owns one
// direction d and a range of RB rows of it, with all of W_hh[d] in shared
// memory for the whole launch, stored transposed, (3H, H): a thread owns
// one unit j and sums over the 3H columns of row j of W_hh[d], and a
// warp's 32 loads of one column are then 128 contiguous bytes (in the
// (H, 3H) layout they would all fall on one bank, the stride 3H = 384
// being a multiple of 32).  Its rows run all T steps in reverse with a
// plain launch: no grid sync, and dgh never makes a round trip through
// L2.  The host spreads the rows so that the grid has at most one block
// per SM (520 rows: 130 blocks of 4; 800 rows: 116 blocks of 7) and a
// block takes its rows RS at a time (chunks, each through all T steps).
// Per step: "cell", a thread per (row, unit) of the chunk forms the
// adjoints from the stored gates, gh_n, h_{t-1}, d_out[t] and its carry
// (kept in registers), writes dgx[t] and dgh[t] (outputs anyway; dgh feeds
// dW_hh) and stages dgh[t] of the chunk in shared memory transposed,
// (3H, RS padded to 4), so that one broadcast float4 load gives four
// rows; one __syncthreads; "product", each thread sums its unit's dh_{t-1}
// for every row of the chunk (RS sums in registers, each weight loaded
// once for RS rows).  The K range 3H is split into KS = 1, 2 or 4 slices
// (a template parameter): with KS > 1 the block has four groups of H
// threads, the first KS run the product, the slices' sums meet in shared
// memory and are added in slice order, and all four groups apply the
// cells (row r by group r % 4).  A step's inputs (gates, gh_n, h_{t-1},
// d_out and the mask of step t-1) do not depend on the carry: their loads
// are issued before step t's product and fly while it runs.  Two
// __syncthreads a step.  At H = 128 W takes 196,608 bytes, an 8-row stage
// 12,288 and four slices' sums 16,384: 225,280 of the 232,448 a block may
// opt in to.
//
// Cooperative route (H too large for one block's shared memory): the LSTM
// backward's design (lstm_cell_scan_bwd.cu) on the GRU forward's grid.
// Everything but the product is elementwise in (row, unit), so a block
// owns a direction d, U units and a range of RB rows, keeps the carry dh
// of its (row, unit) pairs in shared memory, and the rows W_hh[d][j, :] of
// its units there too (as float4 over four neighbouring columns, the 3H
// columns padded with zeros to a multiple of four).  A step has two parts.
// "cell": as above, and it keeps dh * z.  After one grid sync, "product":
// for chunks of RS rows a block copies dgh[t] of those rows, all 3H
// columns, from L2 into shared memory (asynchronous copies that bypass L1)
// and forms dh_{t-1} for its own units; the sum is split into KS slices,
// one per group of threads, which meet in shared memory.  The cell part of
// step t-1 follows without another grid sync: it writes dgh[t-1] while
// slower blocks may still read dgh[t].  Where no such grid is co-resident
// (two directions of float32 W_hh at H = 2048 are 100 MB), the streamed
// variant (`STREAM`) runs the same grid and arithmetic, each thread
// reading its unit's row of W_hh[d] from device memory every step, as the
// slots it would stage packed once a launch (`pack_slots`,
// lstm_common.cuh: one load a slot; bf16 slots half the bytes)
// (`pick_route`, lstm_common.cuh, tries the staged grid first).
//
// Both routes: float32 on the CUDA cores; masked steps (mask 0): dgx and
// dgh are 0 and dh passes through unchanged.  No atomics: each sum is in a
// fixed order, so two runs give the same bits.
//
// bf16 (`BF16`, the JAX package's `compute_dtype='bfloat16'` with bf16
// streams), both routes: acts, ghn, hprev and dout are read as bf16 and
// widened (`ScanTypes<true>`, lstm_common.cuh); dgx and dgh are written
// rounded to bf16, and the product takes that bf16 dgh, so dh_{t-1} =
// bf16(dgh) @ bf16(W_hh)^T + dh * z, each product exact in float32 and
// summed in float32, as the Pallas kernel's `_dir_matmul(..., cast=bf16)`;
// W_hh is rounded to bf16 as it is staged (half the shared memory: the
// resident route holds a direction's up to H = 192 on an H100).  The
// resident kernel stages bf16(dgh) as float32 values; the cooperative one
// copies the bf16 rows (four columns in 8 bytes; 16-byte copies when
// H % 8 == 0, two bytes at a time through L2 otherwise).  dh and dh0 stay
// float32.
//
// The bf16 backward's `mma` route (`gru_bwd_mma_kernel`), taken where the
// bf16 resident plan exists and H <= GRU_MMA_MAX_H (128), the training
// forward's design (gru_cell_scan.cu) turned around: the product dh_{t-1}
// = bf16(dgh_t) @ bf16(W_hh[d])^T is bf16 `mma.sync.m16n8k16` with float32
// sums on the resident grid (a block owns a direction and a range of rows
// with all H units, `gru_mma_plan`, lstm_common.cuh: no grid sync).  A =
// W_hh[d] rounded to bf16 (M = the H units, K = the 3H gate columns) in
// the 16 warps' registers for the whole launch: a warp owns a tile of 16
// units and a chunk of the k-steps (at H = 128 two warps a tile, 12
// k-steps, 48 registers a thread).  The B operand is bf16(dgh_t) of the
// chunk's rows (one N tile of 8), staged in shared memory by the cells and
// read with `ldmatrix`.  Each warp sums its chunk from zero and writes its
// partial sums; after a sync the thread of each (row, unit) pair adds the
// chunks in chunk order in float32 (plus dh * z, unless the step is
// masked) into the float32 carry it keeps in registers, then forms the
// pair's adjoints of the step before: it writes dgx and dgh and stages
// bf16(dgh) as the next product's B tile; a sync, and the next product
// runs.  Two syncs a step.  The pair's stored inputs (acts, gh_n, h_{t-1},
// d_out, mask) are loaded as bf16 bits a step ahead (two where a warp
// holds three k-steps at most), and into L2 GRU_MMA_AHEAD steps ahead
// where the streams do not stay in L2 anyway (`gru_mma_ahead`).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

// the probes' cycles (lstm_common.cuh), in -DLSTM_PROBE builds only
#ifdef LSTM_PROBE
__device__ long long gru_bwd_probe_cycles[4];
#define PROBE_CYCLES gru_bwd_probe_cycles
#endif

namespace {

// acts: (T, R, 3H) gates r, z, n; ghn, hprev: (T, R, H); w: (D, H, 3H);
// mask: (T, R) or nullptr; dout: (T, R, H); dhT: (R, H).
// dgx, dgh: (T, R, 3H) out; dh0: (R, H) out.  R = D * Bd.
// Block b: unit block ub = b % n_ub, row block rb = b / n_ub % n_rb,
// direction d = b / (n_ub * n_rb); rows [rb * RB, min(Bd, (rb + 1) * RB))
// of its direction.  In the product, thread tid: K slice ks = tid / P, pair
// p = tid % P (row p / U of the chunk, unit p % U), P = RS * U.
// G4 = ceil(3H / 4).  Shared memory: w_s (G4, U) of W4 (columns
// 4k..4k+3 of unit u's row) | dgh_s (RS, G4) of W4 | red (KS - 1, P) |
// dh_s (RB, U) | dhz_s (RB, U).
// vec: rows of dgh copy 16 bytes at a time (float32: H % 4 == 0; bf16:
// H % 8 == 0; dgh 16-byte aligned), else one element at a time.
// BF16: acts, ghn, hprev, dout, dgx and dgh are bf16 (see the top).
// STREAM: the streamed route (see the top): w_s is empty, w holds the
// packed slots (D, G4, H) of W4 (slot (d, c, j): columns 4c ... 4c + 3 of
// row j, zeros past 3H), and the product reads row j's slots from device
// memory every step.
template <bool BF16, bool STREAM>
__global__ void __launch_bounds__(1024) gru_bwd_kernel(
        const typename ScanTypes<BF16>::S* __restrict__ acts,
        const typename ScanTypes<BF16>::S* __restrict__ ghn,
        const typename ScanTypes<BF16>::S* __restrict__ hprev,
        const float* __restrict__ w, const float* __restrict__ mask,
        const typename ScanTypes<BF16>::S* __restrict__ dout,
        const float* __restrict__ dhT,
        typename ScanTypes<BF16>::S* __restrict__ dgx,
        typename ScanTypes<BF16>::S* dgh,
        float* __restrict__ dh0, int T, int Bd, int H, int U, int n_ub,
        int n_rb, int RB, int RS, int KS, int vec) {
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
    const int G = 3 * H;
    const int G4 = (G + 3) / 4;
    const int P = RS * U;
    const int r_lo = rb * RB;
    const int r_hi = min(Bd, r_lo + RB);
    const int n_own = (r_hi - r_lo) * U;                  // (row, unit) pairs
    W4* w_s = reinterpret_cast<W4*>(smem4);               // (G4, U)
    W4* dgh_s = w_s + (STREAM ? 0 : (size_t)G4 * U);      // (RS, G4)
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
    for (int idx = tid; idx < G4 * ((STREAM ? 0 : U) + RS);
         idx += nthreads) {
        w_s[idx] = W4{};
    }
    __syncthreads();
    const float* wd = w + (size_t)d * H * G;
    for (int idx = tid; !STREAM && idx < U * G; idx += nthreads) {
        const int uu = idx / G;
        const int c = idx % G;
        const int jj = ub * U + uu;
        if (jj < H) {
            Ty::set(w_s + (size_t)(c / 4) * U + uu, c % 4,
                    wd[(size_t)jj * G + c]);
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
            const S* ar = acts + at * G;
            const float r_ = Ty::ld(ar + jj);
            const float z_ = Ty::ld(ar + H + jj);
            const float n_ = Ty::ld(ar + 2 * H + jj);
            const float gh_n = Ty::ld(ghn + at * H + jj);
            const float h_prev = Ty::ld(hprev + at * H + jj);
            const float m = mask != nullptr ? mask[at] : 1.0f;
            const float dh = dh_s[q] + Ty::ld(dout + at * H + jj);
            const float dz_pre = dh * (h_prev - n_) * z_ * (1.0f - z_);
            const float da_n = dh * (1.0f - z_) * (1.0f - n_ * n_);
            const float da_r = da_n * gh_n * r_ * (1.0f - r_);
            S* xr = dgx + at * G;
            Ty::st(xr + jj, da_r * m);
            Ty::st(xr + H + jj, dz_pre * m);
            Ty::st(xr + 2 * H + jj, da_n * m);
            S* hr = dgh + at * G;
            Ty::stcg(hr + jj, da_r * m);
            Ty::stcg(hr + H + jj, dz_pre * m);
            Ty::stcg(hr + 2 * H + jj, da_n * r_ * m);
            dhz_s[q] = dh * z_;
        }
    };

    cell(T - 1);
    for (int t = T - 1; t >= 0; --t) {
        grid.sync();  // dgh[t] of every block is in L2
        for (int rc = r_lo; rc < r_hi; rc += RS) {
            const int nr = min(RS, r_hi - rc);
            const S* src = dgh + ((size_t)t * R + row0 + rc) * G;
            if (rc > r_lo) __syncthreads();  // the previous chunk's readers
            if (vec) {
                // G % 4 == 0: rows are G4 slots long, back to back, and
                // a chunk's rows are a whole number of 16-byte copies
                const W4* src4 = reinterpret_cast<const W4*>(src);
                for (int idx = tid; idx < nr * G4 / kPerCopy;
                     idx += nthreads) {
                    cp_async16_cg(dgh_s + kPerCopy * idx,
                                  src4 + kPerCopy * idx);
                }
            } else {
                // element by element (the raw bits); the columns past 3H
                // of each row's last slot stay zero
                using Raw = typename std::conditional<
                    BF16, unsigned short, float>::type;
                const Raw* raw = reinterpret_cast<const Raw*>(src);
                Raw* dst = reinterpret_cast<Raw*>(dgh_s);
                for (int idx = tid; idx < nr * G; idx += nthreads) {
                    dst[(size_t)(idx / G) * 4 * G4 + idx % G] =
                        __ldcg(raw + idx);
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
                const W4* dr = dgh_s + (size_t)(r - rc) * G4;
                // row j's packed slots (STREAM), H apart
                const W4* wr = reinterpret_cast<const W4*>(w)
                               + (size_t)d * G4 * H + j;
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k) {
                    const float4 z = Ty::unpack(dr[k]);
                    float4 wk;
                    if constexpr (STREAM) {
                        // the staged slot, packed in device memory
                        wk = Ty::unpack(__ldg(wr + (size_t)k * H));
                    } else {
                        wk = Ty::unpack(w_s[(size_t)k * U + u]);
                    }
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

// Resident route.  acts, ghn, hprev, w, mask, dout, dhT, dgx, dgh, dh0 as
// above.  Block b: direction d = b / n_rb, rows [rb * RB, min(Bd, (rb + 1)
// * RB)) of it, rb = b % n_rb, n_rb = ceil(Bd / RB); taken RS at a time.
// Thread tid: group cg = tid / Hp of CG (1 when KS = 1, else 4; Hp: H
// rounded up to 32, at most 128 when KS > 1), unit u = tid % Hp (units
// past H only take part in the syncs).  Groups cg < KS run the product,
// each over its slice of the 3H columns; every group applies the cell to
// the chunk's rows cg, cg + CG, ...
// Shared memory: g_s (3H, RSP) floats (the product's operand dgh: bf16(dgh)
// in the BF16 variant) | red (KS, RS, Hp) floats when KS > 1 | wt_s (3H, H)
// of S, wt_s[c * H + j] = W_hh[d][j][c].  RSP: RS rounded up to 4, so g_s
// rows are float4-aligned.
constexpr int RESIDENT_MAX_RS = 8;
constexpr int RESIDENT_MAX_THREADS = 512;

__host__ __device__ inline int round_up(int x, int to) {
    return (x + to - 1) / to * to;
}

// The resident kernel's dynamic shared memory in bytes, W_hh at `elem`
// bytes an element (the host planner in ops/kernels/gru.py computes the
// same number and passes it in).
inline size_t resident_bwd_smem_bytes(int H, int RS, int KS, size_t elem) {
    const size_t red = KS > 1 ? (size_t)KS * RS * round_up(H, 32) : 0;
    return sizeof(float) * ((size_t)3 * H * round_up(RS, 4) + red)
           + elem * 3 * (size_t)H * H;
}

template <bool BF16, int RS, int KS>
__global__ void __launch_bounds__(RESIDENT_MAX_THREADS, 1)
gru_bwd_resident_kernel(
        const typename ScanTypes<BF16>::S* __restrict__ acts,
        const typename ScanTypes<BF16>::S* __restrict__ ghn,
        const typename ScanTypes<BF16>::S* __restrict__ hprev,
        const float* __restrict__ w, const float* __restrict__ mask,
        const typename ScanTypes<BF16>::S* __restrict__ dout,
        const float* __restrict__ dhT,
        typename ScanTypes<BF16>::S* __restrict__ dgx,
        typename ScanTypes<BF16>::S* __restrict__ dgh,
        float* __restrict__ dh0, int T, int Bd, int H, int RB) {
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
    float* g_s = reinterpret_cast<float*>(smem4);
    float* red = g_s + (size_t)G * RSP;
    S* wt_s = reinterpret_cast<S*>(red + (KS > 1 ? KS * RS * Hp : 0));
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int cg = tid / Hp;
    const int u = tid % Hp;
    const bool active = u < H;
    const int k_len = (G + KS - 1) / KS;
    const int k_lo = min(G, cg * k_len);
    const int k_hi = cg < KS ? min(G, k_lo + k_len) : k_lo;

    // all of W_hh[d], transposed: read as it lies in device memory (each
    // warp 128 contiguous bytes), once per launch
    const float* wd = w + (size_t)d * H * G;
    for (int i = tid; i < H * G; i += nthreads) {
        Ty::st(wt_s + (size_t)(i % G) * H + i / G, __ldg(wd + i));
    }

    // a step's inputs of this thread's cells, rows cg + j * CG of the
    // chunk: r, z, n, gh_n, h_{t-1}, d_out, mask
    float x[NJ][7];
    auto load_step = [&](int t, int rc, int nr) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int r = cg + j * CG;
            if (!active || r >= nr) break;
            const size_t at = (size_t)t * R + row0 + rc + r;
            const S* ar = acts + at * G;
            x[j][0] = Ty::ld(ar + u);
            x[j][1] = Ty::ld(ar + H + u);
            x[j][2] = Ty::ld(ar + 2 * H + u);
            x[j][3] = Ty::ld(ghn + at * H + u);
            x[j][4] = Ty::ld(hprev + at * H + u);
            x[j][5] = Ty::ld(dout + at * H + u);
            x[j][6] = mask != nullptr ? mask[at] : 1.f;
        }
    };

    for (int rc = r_lo; rc < r_hi; rc += RS) {
        const int nr = min(RS, r_hi - rc);
        // rows of the stage past nr stay zero (the previous chunk's last
        // step ended with a sync after its product, the last read of g_s)
        for (int i = tid; i < G * RSP; i += nthreads) g_s[i] = 0.f;
        float carry[NJ];  // dh entering the step, of this thread's cells
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int r = cg + j * CG;
            if (!active || r >= nr) break;
            carry[j] = dhT[(size_t)(row0 + rc + r) * H + u];
        }
        load_step(T - 1, rc, nr);
        __syncthreads();

        for (int t = T - 1; t >= 0; --t) {
            // cell: dgx[t], dgh[t] of this thread's cells, dgh[t] staged
            float dhz[NJ], m[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int r = cg + j * CG;
                if (!active || r >= nr) break;
                const float r_ = x[j][0];
                const float z_ = x[j][1];
                const float n_ = x[j][2];
                const float mj = x[j][6];
                const float dh = carry[j] + x[j][5];
                const float dz_pre = dh * (x[j][4] - n_) * z_ * (1.0f - z_);
                const float da_n = dh * (1.0f - z_) * (1.0f - n_ * n_);
                const float da_r = da_n * x[j][3] * r_ * (1.0f - r_);
                const size_t at = (size_t)t * R + row0 + rc + r;
                S* xr = dgx + at * G;
                Ty::st(xr + u, da_r * mj);
                Ty::st(xr + H + u, dz_pre * mj);
                Ty::st(xr + 2 * H + u, da_n * mj);
                const float g_r = da_r * mj;
                const float g_z = dz_pre * mj;
                const float g_n = da_n * r_ * mj;
                S* hr = dgh + at * G;
                Ty::st(hr + u, g_r);
                Ty::st(hr + H + u, g_z);
                Ty::st(hr + 2 * H + u, g_n);
                g_s[(size_t)u * RSP + r] = Ty::operand(g_r);
                g_s[(size_t)(H + u) * RSP + r] = Ty::operand(g_z);
                g_s[(size_t)(2 * H + u) * RSP + r] = Ty::operand(g_n);
                dhz[j] = dh * z_;
                m[j] = mj;
            }
            __syncthreads();
            // the next step's inputs fly while the product runs
            if (t > 0) load_step(t - 1, rc, nr);
            float acc[RS];
#pragma unroll
            for (int r = 0; r < RS; ++r) acc[r] = 0.f;
            if (active && cg < KS) {
                const S* wk = wt_s + (size_t)k_lo * H + u;
                const float4* gk =
                    reinterpret_cast<const float4*>(g_s) + k_lo * (RSP / 4);
#pragma unroll 4
                for (int k = k_lo; k < k_hi; ++k, wk += H, gk += RSP / 4) {
                    const float wv = Ty::ld(wk);
#pragma unroll
                    for (int q = 0; q < RSP / 4; ++q) {
                        const float4 gv = gk[q];
                        const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const int r = 4 * q + i;
                            if (r >= RS) break;
                            acc[r] = fmaf(g4[i], wv, acc[r]);
                        }
                    }
                }
                if (KS > 1) {
#pragma unroll
                    for (int r = 0; r < RS; ++r) {
                        red[(size_t)(cg * RS + r) * Hp + u] = acc[r];
                    }
                }
            }
            __syncthreads();
            // dh_{t-1} of this thread's cells: the slices' sums in slice
            // order, plus dh * z; a masked step passes dh through
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int r = cg + j * CG;
                if (!active || r >= nr) break;
                float sum;
                if (KS == 1) {
                    sum = acc[j];  // CG == 1: j == r
                } else {
                    sum = 0.f;
#pragma unroll
                    for (int s = 0; s < KS; ++s) {
                        sum += red[(size_t)(s * RS + r) * Hp + u];
                    }
                }
                if (m[j] > 0.0f) carry[j] = sum + dhz[j];
            }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int r = cg + j * CG;
            if (!active || r >= nr) break;
            dh0[(size_t)(row0 + rc + r) * H + u] = carry[j];
        }
    }
}

template <bool BF16, int RS, int KS>
cudaError_t launch_resident_ks(const typename ScanTypes<BF16>::S* acts,
                               const typename ScanTypes<BF16>::S* ghn,
                               const typename ScanTypes<BF16>::S* hprev,
                               const float* w, const float* mask,
                               const typename ScanTypes<BF16>::S* dout,
                               const float* dhT,
                               typename ScanTypes<BF16>::S* dgx,
                               typename ScanTypes<BF16>::S* dgh, float* dh0,
                               int T, int blocks, int Bd, int H, int RB,
                               int threads, size_t smem,
                               cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_resident_kernel<BF16, RS, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gru_bwd_resident_kernel<BF16, RS, KS><<<blocks, threads, smem, stream>>>(
        acts, ghn, hprev, w, mask, dout, dhT, dgx, dgh, dh0, T, Bd, H, RB);
    return cudaGetLastError();
}

template <bool BF16, int RS>
cudaError_t launch_resident_rs(const typename ScanTypes<BF16>::S* acts,
                               const typename ScanTypes<BF16>::S* ghn,
                               const typename ScanTypes<BF16>::S* hprev,
                               const float* w, const float* mask,
                               const typename ScanTypes<BF16>::S* dout,
                               const float* dhT,
                               typename ScanTypes<BF16>::S* dgx,
                               typename ScanTypes<BF16>::S* dgh, float* dh0,
                               int T, int blocks, int Bd, int H, int RB,
                               int KS, int threads, size_t smem,
                               cudaStream_t stream) {
    switch (KS) {
    case 1:
        return launch_resident_ks<BF16, RS, 1>(
            acts, ghn, hprev, w, mask, dout, dhT, dgx, dgh, dh0, T, blocks,
            Bd, H, RB, threads, smem, stream);
    case 2:
        return launch_resident_ks<BF16, RS, 2>(
            acts, ghn, hprev, w, mask, dout, dhT, dgx, dgh, dh0, T, blocks,
            Bd, H, RB, threads, smem, stream);
    case 4:
        return launch_resident_ks<BF16, RS, 4>(
            acts, ghn, hprev, w, mask, dout, dhT, dgx, dgh, dh0, T, blocks,
            Bd, H, RB, threads, smem, stream);
    }
    return cudaErrorInvalidValue;
}

// The cooperative kernel's grid (`pick_route`, lstm_common.cuh): W_hh's
// rows staged in the variant's element type (resident) or, where no such
// grid is co-resident, read from device memory every step (streamed), and
// the staged dgh rows.
template <bool BF16>
cudaError_t pick_grid(int D, int Bd, int H, int device, ScanGrid* best,
                      int* streamed) {
    using W4 = typename ScanTypes<BF16>::W4;
    int n_sm = 0, max_smem = 0, coop = 0;
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (!coop) return cudaErrorNotSupported;
    const int G4 = (3 * H + 3) / 4;
    const auto rest = [G4](int U, int RB, int RS, int KS) {
        return sizeof(W4) * (size_t)RS * G4
               + sizeof(float) * ((size_t)(KS - 1) * RS * U
                                  + 2 * (size_t)RB * U);
    };
    return pick_route((const void*)gru_bwd_kernel<BF16, false>,
                      (const void*)gru_bwd_kernel<BF16, true>, D, Bd, H, G4,
                      n_sm, max_smem, sizeof(W4) * (size_t)G4, rest, best,
                      streamed);
}

// Cooperative route: launch the whole adjoint recurrence on the grid
// `pick_grid` chooses (on the streamed route W_hh packed into `wpack`,
// packed_slots_bytes of the backward).  Fails with
// cudaErrorCooperativeLaunchTooLarge when no grid is co-resident on either
// route.  Returns cudaGetLastError() after the launch.
template <bool BF16>
int launch_bwd(const void* acts, const void* ghn, const void* hprev,
               const void* w, void* wpack, const void* mask,
               const void* dout,
               const void* dhT, void* dgx, void* dgh, void* dh0, int T,
               int D, int Bd, int H, int device, void* stream) {
    using S = typename ScanTypes<BF16>::S;
    using W4 = typename ScanTypes<BF16>::W4;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid best;
    int streamed = 0;
    err = pick_grid<BF16>(D, Bd, H, device, &best, &streamed);
    if (err != cudaSuccess) return err;
    if (best.blocks == 0) return cudaErrorCooperativeLaunchTooLarge;
    int vec = H % (16 / sizeof(W4) * 4) == 0
              && reinterpret_cast<uintptr_t>(dgh) % 16 == 0;
    const S* acts_ = static_cast<const S*>(acts);
    const S* ghn_ = static_cast<const S*>(ghn);
    const S* hprev_ = static_cast<const S*>(hprev);
    const float* w_ = static_cast<const float*>(w);
    if (streamed) {
        err = pack_slots<BF16>(w_, wpack, D, H, 3, false,
                               static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return err;
        w_ = static_cast<const float*>(wpack);
    }
    const float* mask_ = static_cast<const float*>(mask);
    const S* dout_ = static_cast<const S*>(dout);
    const float* dhT_ = static_cast<const float*>(dhT);
    S* dgx_ = static_cast<S*>(dgx);
    S* dgh_ = static_cast<S*>(dgh);
    float* dh0_ = static_cast<float*>(dh0);
    void* args[] = {&acts_, &ghn_, &hprev_, &w_, &mask_, &dout_, &dhT_,
                    &dgx_, &dgh_, &dh0_, &T, &Bd, &H, &best.U, &best.n_ub,
                    &best.n_rb, &best.RB, &best.RS, &best.KS, &vec};
    err = cudaLaunchCooperativeKernel(
        streamed ? (const void*)gru_bwd_kernel<BF16, true>
                 : (const void*)gru_bwd_kernel<BF16, false>,
        dim3(best.blocks), dim3(best.threads), args, best.smem,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// Resident route (see the header): the plan from ops/kernels/gru.py, RB
// rows a block, RS at a time, KS K slices of 1, 2 or 4, `threads` (one
// group of H rounded up to 32 with KS = 1, four groups otherwise), `smem`
// bytes (W_hh at the variant's element size).  A plan that does not agree
// with the kernel's own layout is refused with cudaErrorInvalidValue
// before anything runs.  Returns cudaGetLastError() after the launch.
template <bool BF16>
int launch_bwd_resident(const void* acts, const void* ghn, const void* hprev,
                        const void* w, const void* mask, const void* dout,
                        const void* dhT, void* dgx, void* dgh, void* dh0,
                        int T, int D, int Bd, int H, int RB, int RS, int KS,
                        int threads, int smem, int device, void* stream) {
    using S = typename ScanTypes<BF16>::S;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int Hp = round_up(H, 32);
    if (T < 1 || D < 1 || Bd < 1 || H < 1 || RS < 1
        || RS > RESIDENT_MAX_RS || RB < RS || KS > 3 * H
        || threads != (KS == 1 ? 1 : 4) * Hp
        || threads > RESIDENT_MAX_THREADS
        || (size_t)smem != resident_bwd_smem_bytes(H, RS, KS, sizeof(S))) {
        return cudaErrorInvalidValue;
    }
    const int blocks = D * ((Bd + RB - 1) / RB);
    const auto* acts_ = static_cast<const S*>(acts);
    const auto* ghn_ = static_cast<const S*>(ghn);
    const auto* hprev_ = static_cast<const S*>(hprev);
    const auto* w_ = static_cast<const float*>(w);
    const auto* mask_ = static_cast<const float*>(mask);
    const auto* dout_ = static_cast<const S*>(dout);
    const auto* dhT_ = static_cast<const float*>(dhT);
    auto* dgx_ = static_cast<S*>(dgx);
    auto* dgh_ = static_cast<S*>(dgh);
    auto* dh0_ = static_cast<float*>(dh0);
    auto* s = static_cast<cudaStream_t>(stream);
#define PTT_GRU_BWD_RS(n)                                                   \
    case n:                                                                 \
        return launch_resident_rs<BF16, n>(                                 \
            acts_, ghn_, hprev_, w_, mask_, dout_, dhT_, dgx_, dgh_, dh0_,  \
            T, blocks, Bd, H, RB, KS, threads, smem, s);
    switch (RS) {
        PTT_GRU_BWD_RS(1)
        PTT_GRU_BWD_RS(2)
        PTT_GRU_BWD_RS(3)
        PTT_GRU_BWD_RS(4)
        PTT_GRU_BWD_RS(5)
        PTT_GRU_BWD_RS(6)
        PTT_GRU_BWD_RS(7)
        PTT_GRU_BWD_RS(8)
    }
#undef PTT_GRU_BWD_RS
    return cudaErrorInvalidValue;
}

// ---- the bf16 `mma` route (see the top)

// a warp's k-steps of W_hh in registers, at most: the instantiations
constexpr int BWD_MMA_KC[] = {1, 3, 6, 12};

// One (row, unit) pair's stored inputs to the cell part of a step, as
// loaded (bf16 bits): r, z, n, gh_n, h_{t-1}, d_out; and its mask.
struct GruBwdIn {
    unsigned short x[6];
    float m;
};

__device__ __forceinline__ float widen(unsigned short bits) {
    return __uint_as_float((unsigned)bits << 16);
}

// The backward's arguments as gru_bwd_resident_kernel's; the plan's fields
// (GruMmaPlan, lstm_common.cuh).  Block b: direction d = b / n_rb, rows
// [rb * RB, min(Bd, (rb + 1) * RB)) of it, rb = b % n_rb, taken RS at a
// time.  Warp w: unit tile w / KCH (the warps past n_ut tiles idle in the
// product), K chunk w % KCH (k-steps [KC chunk, ...) of the 3H columns).
// Thread tid owns the chunk's pairs q = tid and tid + 512 (row q / H, unit
// q % H) and keeps their float32 carries dh in registers.  Shared memory:
// g_s (8, 16 KT + 8) bf16, the product's B operand bf16(dgh_t) of the
// chunk's rows | red (KCH, 8, 16 n_ut + 4) floats, the chunks' partial
// sums.
template <int KCR>
__global__ void __launch_bounds__(MMA_THREADS, 1) gru_bwd_mma_kernel(
        const __nv_bfloat16* __restrict__ acts,
        const __nv_bfloat16* __restrict__ ghn,
        const __nv_bfloat16* __restrict__ hprev,
        const float* __restrict__ w, const float* __restrict__ mask,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ dhT, __nv_bfloat16* __restrict__ dgx,
        __nv_bfloat16* __restrict__ dgh, float* __restrict__ dh0, int T,
        int Bd, int H, int RB, int RS, int KT, int KC, int KCH, int ahead) {
    using Ty = ScanTypes<true>;
    using bf16 = __nv_bfloat16;
    constexpr int NT = MMA_THREADS;
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
    const int SR = 16 * n_ut + 4;         // a partial-sum row's floats
    constexpr bool DEEP = KCR <= 3;
    bf16* g_s = reinterpret_cast<bf16*>(smem4);
    float* red = reinterpret_cast<float*>(g_s + GRU_MMA_ROWS * SK);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int ut = warp / KCH;
    const int chunk = warp % KCH;
    const bool in_product = ut < n_ut;
    const int ks_lo = chunk * KC;
    const int kc = min(KC, KT - ks_lo);   // this chunk's k-steps

    // this warp's A fragments: W_hh[d][j][k] for the tile's units j and
    // the chunk's columns k, rounded to bf16; units past H and columns
    // past 3H are zero
    uint32_t a[KCR][4];
    {
        const float* wd = w + (size_t)d * H * G;
        const int ja = ut * 16 + (lane >> 2), jb = ja + 8;
        const auto wv = [&](int j, int k) {
            return j < H && k < G ? __ldg(wd + (size_t)j * G + k) : 0.0f;
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

    for (int rc = r_lo; rc < r_hi; rc += RS) {
        const int nr = min(RS, r_hi - rc);
        const int first = row0 + rc;   // the chunk's first row
        // this thread's pairs q = tid + 512 p: row pn of the chunk (< 0:
        // no pair) and unit q % H, at og = row * 3H + unit in a (T, R, 3H)
        // stream's step and oh = row * H + unit in a (T, R, H) one's (the
        // launch keeps R * 3H below 2^31)
        int pn[2], og[2], oh[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const int q = tid + p * NT;
            pn[p] = q < nr * H ? q / H : -1;
            og[p] = (first + pn[p]) * G + q % H;
            oh[p] = (first + pn[p]) * H + q % H;
        }
        const auto unit = [&](int p) { return oh[p] - (first + pn[p]) * H; };
        // pair p's stored inputs of step t: loaded into registers as bf16
        // bits (`fetch`) one step ahead, into L2 (`prefetch`) `ahead` steps
        // ahead
        const auto fetch = [&](int t, int p) {
            GruBwdIn in = {{0, 0, 0, 0, 0, 0}, 1.f};
            const size_t at = (size_t)t * R;
            using u16 = unsigned short;
            const u16* ar = reinterpret_cast<const u16*>(acts + at * G) + og[p];
            in.x[0] = __ldg(ar);
            in.x[1] = __ldg(ar + H);
            in.x[2] = __ldg(ar + 2 * H);
            in.x[3] = __ldg(reinterpret_cast<const u16*>(ghn + at * H) + oh[p]);
            in.x[4] =
                __ldg(reinterpret_cast<const u16*>(hprev + at * H) + oh[p]);
            in.x[5] = __ldg(reinterpret_cast<const u16*>(dout + at * H) + oh[p]);
            if (mask != nullptr) in.m = __ldg(mask + at + first + pn[p]);
            return in;
        };
        const auto prefetch = [&](int t, int p) {
            const size_t at = (size_t)t * R;
            const bf16* ar = acts + at * G + og[p];
            prefetch_l2(ar);
            prefetch_l2(ar + H);
            prefetch_l2(ar + 2 * H);
            prefetch_l2(ghn + at * H + oh[p]);
            prefetch_l2(hprev + at * H + oh[p]);
            prefetch_l2(dout + at * H + oh[p]);
            if (mask != nullptr) prefetch_l2(mask + at + first);
        };
        float carry[2] = {0.f, 0.f}, dhz[2] = {0.f, 0.f}, m[2] = {1.f, 1.f};
        // the inputs of this step and, with DEEP, of the one before (loaded
        // two steps ahead where the registers allow: a warp's W_hh of
        // three k-steps at most)
        GruBwdIn in[2] = {}, nx[2] = {};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            if (pn[p] < 0) continue;
            carry[p] = dhT[oh[p]];
            in[p] = fetch(T - 1, p);
            if (DEEP && T > 1) nx[p] = fetch(T - 2, p);
            for (int t = T - 2; t >= T - 1 - ahead && t >= 0; --t)
                prefetch(t, p);
        }
        // the staged tile starts zero: rows past nr and columns past 3H
        // (the K padding) are never written; the previous chunk's last
        // step ended with a sync after its last read
        for (int i = tid; i < GRU_MMA_ROWS * SK / 8; i += NT)
            reinterpret_cast<uint4*>(g_s)[i] = make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();

        // the cell part of step t for the own pairs: dgx[t], dgh[t], and
        // bf16(dgh[t]) staged; dh * z and the mask kept for the product's
        // epilogue; then the pairs' inputs of step t - 1 are loaded
        const auto cell = [&](int t) {
            bf16* const dgx_t = dgx + (size_t)t * R * G;
            bf16* const dgh_t = dgh + (size_t)t * R * G;
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                if (pn[p] < 0) continue;
                const float r_ = widen(in[p].x[0]);
                const float z_ = widen(in[p].x[1]);
                const float n_ = widen(in[p].x[2]);
                const float mj = in[p].m;
                const float dh = carry[p] + widen(in[p].x[5]);
                const float dz_pre = dh * (widen(in[p].x[4]) - n_) * z_
                                     * (1.0f - z_);
                const float da_n = dh * (1.0f - z_) * (1.0f - n_ * n_);
                const float da_r = da_n * widen(in[p].x[3]) * r_
                                   * (1.0f - r_);
                bf16* xr = dgx_t + og[p];
                Ty::st(xr, da_r * mj);
                Ty::st(xr + H, dz_pre * mj);
                Ty::st(xr + 2 * H, da_n * mj);
                const bf16 g_r = __float2bfloat16_rn(da_r * mj);
                const bf16 g_z = __float2bfloat16_rn(dz_pre * mj);
                const bf16 g_n = __float2bfloat16_rn(da_n * r_ * mj);
                bf16* hr = dgh_t + og[p];
                hr[0] = g_r;
                hr[H] = g_z;
                hr[2 * H] = g_n;
                bf16* gs = g_s + pn[p] * SK + unit(p);
                gs[0] = g_r;
                gs[H] = g_z;
                gs[2 * H] = g_n;
                dhz[p] = dh * z_;
                m[p] = mj;
                if (DEEP) {
                    in[p] = nx[p];
                    if (t > 1) nx[p] = fetch(t - 2, p);
                } else if (t > 0) {
                    in[p] = fetch(t - 1, p);
                }
                if (ahead > 0 && t - 1 - ahead >= 0)
                    prefetch(t - 1 - ahead, p);
            }
        };

        PROBE_INIT();
        cell(T - 1);
        for (int t = T - 1; t >= 0; --t) {
            PROBE(PROBE_CELL);
            __syncthreads();   // dgh[t] staged
            PROBE(PROBE_SYNC);
            if (in_product) {
                float c[4] = {0.f, 0.f, 0.f, 0.f};
                const bf16* b_row = g_s + (size_t)(lane & 7) * SK
                                    + 16 * ks_lo + ((lane >> 3) & 1) * 8;
#pragma unroll
                for (int kk = 0; kk < KCR; ++kk) {
                    if (kk < kc) {
                        uint32_t b0, b1;
                        ldsm_x2(b_row + 16 * kk, b0, b1);
                        mma_bf16(c, a[kk], b0, b1);
                    }
                }
                // c: units lane / 4 (+ 8) of the tile, rows 2 (lane % 4)
                // (+ 1)
                const int n = 2 * (lane & 3), mu = ut * 16 + (lane >> 2);
                float* rn = red + ((size_t)chunk * GRU_MMA_ROWS + n) * SR + mu;
                rn[0] = c[0];
                rn[SR] = c[1];
                rn[8] = c[2];
                rn[SR + 8] = c[3];
            }
            PROBE(PROBE_PRODUCT);
            __syncthreads();   // the chunks' partial sums
            PROBE(PROBE_SYNC);
            // dh_{t-1} of the own pairs: the chunks in chunk order, plus
            // dh * z; a masked step passes dh through
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                if (pn[p] < 0) continue;
                const float* rp = red + pn[p] * SR + unit(p);
                float sum = rp[0];
#pragma unroll 1
                for (int c = 1; c < KCH; ++c)
                    sum += rp[c * GRU_MMA_ROWS * SR];
                if (m[p] > 0.0f) carry[p] = sum + dhz[p];
            }
            if (t > 0) cell(t - 1);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            if (pn[p] >= 0) dh0[oh[p]] = carry[p];
        }
        __syncthreads();   // the last reads of red before the next chunk
    }
}

// The kernel of a plan: the instantiation that holds its KC k-steps.
const void* bwd_mma_kernel(const GruMmaPlan& p) {
    if (p.KC <= BWD_MMA_KC[0]) return (const void*)gru_bwd_mma_kernel<1>;
    if (p.KC <= BWD_MMA_KC[1]) return (const void*)gru_bwd_mma_kernel<3>;
    if (p.KC <= BWD_MMA_KC[2]) return (const void*)gru_bwd_mma_kernel<6>;
    return (const void*)gru_bwd_mma_kernel<12>;
}

// Launch the backward on its `mma` plan (`gru_mma_plan` at the card's
// limits), the step's inputs prefetched into L2 `ahead` steps ahead (< 0:
// as `gru_mma_ahead` says).  A shape the plan does not take is refused
// with cudaErrorInvalidConfiguration before anything runs.  Returns
// cudaGetLastError() after the launch.
int launch_bwd_mma(const void* acts, const void* ghn, const void* hprev,
                   const void* w, const void* mask, const void* dout,
                   const void* dhT, void* dgx, void* dgh, void* dh0, int T,
                   int D, int Bd, int H, int device, void* stream,
                   int ahead) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    GruMmaLimits limits;
    err = gru_mma_limits(device, &limits);
    if (err != cudaSuccess) return err;
    GruMmaPlan plan =
        gru_mma_plan(1, D, Bd, H, limits.n_sm, limits.max_smem);
    if (T < 1 || plan.blocks == 0 || plan.KC > BWD_MMA_KC[3])
        return cudaErrorInvalidConfiguration;
    if ((size_t)D * Bd * 3 * H >= (size_t)1 << 31)  // a step's offsets: int
        return cudaErrorInvalidValue;
    const void* kernel = bwd_mma_kernel(plan);
    err = gru_mma_allow_smem(kernel, device, plan.smem);
    if (err != cudaSuccess) return err;
    using bf16 = __nv_bfloat16;
    const auto* acts_ = static_cast<const bf16*>(acts);
    const auto* ghn_ = static_cast<const bf16*>(ghn);
    const auto* hprev_ = static_cast<const bf16*>(hprev);
    const auto* w_ = static_cast<const float*>(w);
    const auto* mask_ = static_cast<const float*>(mask);
    const auto* dout_ = static_cast<const bf16*>(dout);
    const auto* dhT_ = static_cast<const float*>(dhT);
    auto* dgx_ = static_cast<bf16*>(dgx);
    auto* dgh_ = static_cast<bf16*>(dgh);
    auto* dh0_ = static_cast<float*>(dh0);
    if (ahead < 0)
        ahead = gru_mma_ahead(GRU_MMA_BWD, T, D, Bd, H, limits.l2_bytes);
    void* args[] = {&acts_, &ghn_, &hprev_, &w_, &mask_, &dout_, &dhT_,
                    &dgx_, &dgh_, &dh0_, &T, &Bd, &H, &plan.RB, &plan.RS,
                    &plan.KT, &plan.KC, &plan.KCH, &ahead};
    err = cudaLaunchKernel(kernel, dim3(plan.blocks), dim3(MMA_THREADS),
                           args, plan.smem,
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The cooperative backward's grid at (D, Bd, H), float32 (bf16 = 0) or
// bf16: out[0..6] = U, n_rb, RB, RS, KS, blocks (0 when no grid is
// co-resident), streamed (1: the streamed route).
int gru_cell_scan_bwd_grid(int D, int Bd, int H, int bf16, int device,
                           void* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    ScanGrid g;
    int streamed = 0;
    err = bf16 ? pick_grid<true>(D, Bd, H, device, &g, &streamed)
               : pick_grid<false>(D, Bd, H, device, &g, &streamed);
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

// The adjoint recurrence, float32 streams, on the cooperative route.
// `wpack`: scratch of packed_slots_bytes(bf16, D, H, 3, bwd) for the
// streamed route's packed weights, null where the card takes the grid
// that stages them.
int gru_cell_scan_bwd(const void* acts, const void* ghn, const void* hprev,
                      const void* w, void* wpack, const void* mask,
                      const void* dout, const void* dhT, void* dgx,
                      void* dgh, void* dh0, int T, int D, int Bd, int H,
                      int device, void* stream) {
    return launch_bwd<false>(acts, ghn, hprev, w, wpack, mask, dout, dhT,
                             dgx, dgh, dh0, T, D, Bd, H, device, stream);
}

// ... and on the resident route.
int gru_cell_scan_bwd_resident(const void* acts, const void* ghn,
                               const void* hprev, const void* w,
                               const void* mask, const void* dout,
                               const void* dhT, void* dgx, void* dgh,
                               void* dh0, int T, int D, int Bd, int H,
                               int RB, int RS, int KS, int threads, int smem,
                               int device, void* stream) {
    return launch_bwd_resident<false>(acts, ghn, hprev, w, mask, dout, dhT,
                                      dgx, dgh, dh0, T, D, Bd, H, RB, RS, KS,
                                      threads, smem, device, stream);
}

// The bf16 variants of the two: acts, ghn, hprev, dout, dgx and dgh bf16;
// w, mask, dhT and dh0 float32; dh_{t-1} from bf16(dgh) @ bf16(W_hh)^T
// summed in float32.
int gru_cell_scan_bwd_bf16(const void* acts, const void* ghn,
                           const void* hprev, const void* w, void* wpack,
                           const void* mask, const void* dout,
                           const void* dhT, void* dgx, void* dgh, void* dh0,
                           int T, int D, int Bd, int H, int device,
                           void* stream) {
    return launch_bwd<true>(acts, ghn, hprev, w, wpack, mask, dout, dhT,
                            dgx, dgh, dh0, T, D, Bd, H, device, stream);
}

int gru_cell_scan_bwd_resident_bf16(const void* acts, const void* ghn,
                                    const void* hprev, const void* w,
                                    const void* mask, const void* dout,
                                    const void* dhT, void* dgx, void* dgh,
                                    void* dh0, int T, int D, int Bd, int H,
                                    int RB, int RS, int KS, int threads,
                                    int smem, int device, void* stream) {
    return launch_bwd_resident<true>(acts, ghn, hprev, w, mask, dout, dhT,
                                     dgx, dgh, dh0, T, D, Bd, H, RB, RS, KS,
                                     threads, smem, device, stream);
}

// ... and on the `mma` route (see the top), the plan `gru_mma_plan` at the
// card's limits.
int gru_cell_scan_bwd_mma_bf16(const void* acts, const void* ghn,
                               const void* hprev, const void* w,
                               const void* mask, const void* dout,
                               const void* dhT, void* dgx, void* dgh,
                               void* dh0, int T, int D, int Bd, int H,
                               int device, void* stream) {
    return launch_bwd_mma(acts, ghn, hprev, w, mask, dout, dhT, dgx, dgh,
                          dh0, T, D, Bd, H, device, stream, -1);
}

#ifdef LSTM_PROBE
// The probes' cycles of the `mma` route's steps (PROBE_CELL ...
// PROBE_PRODUCT; lstm_bwd_probe.py), read and zeroed.
int gru_bwd_probe_take(long long* out) {
    return probe_take(gru_bwd_probe_cycles, out);
}
#endif

}  // extern "C"
