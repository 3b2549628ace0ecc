// GRU cell recurrence over time, the lean bf16 forward above H = 128: a
// thread-block cluster route.
//
// Replaces: padertorch_tpu/ops/pallas/gru.py, `_fwd_kernel` through
// `_fwd_call(..., with_residuals=False)` with `compute_dtype='bfloat16'`
// (`gru_cell_scan`, inference), at the widths where the `mma` route of
// gru_cell_scan.cu cannot hold W_hh (H above GRU_MMA_MAX_H): the speaker
// classifier's class defaults, H = 256.
//
// What bounds it on the card: the T steps are sequential and each holds a
// (rows, H) @ (H, 3H) product far too small to fill the card (at H = 256
// and 16 rows, 3.1 M multiply-adds a step), so what counts is the latency
// of a step.  The resident route it replaces reads W_hh from shared memory
// every step as float32 FMAs, and at H = 256 one block's shared memory
// cannot hold W_hh[d] at all (393 KB in bf16): the cooperative FMA grid
// ran there, with a grid sync and an exchange of h through L2 each step
// (2.9 us a step on an H100).
//
// Design.  A cluster of C CTAs (2, 4 or 8, portable sizes;
// `gru_cluster_plan`, lstm_common.cuh) owns one direction d and a range of
// rows; CTA c owns the unit tiles [c n_ut / C, (c + 1) n_ut / C) of 16
// units, with their three gates.  The gates' columns of W_hh[d] over all
// of K, rounded to bf16, are held in the CTA's 16 warps' registers for the
// whole launch as `mma.sync.m16n8k16` A fragments, as the `mma` route's
// block holds all of them: a warp holds a unit tile's three gates and a K
// chunk of at most GRU_CLUSTER_KC k-steps (at H = 256 and C = 4, 4 tiles x
// 4 chunks of 4 k-steps: 48 registers a thread).  Every CTA stages
// bf16(h_{t-1}) of its rows, all of K, as the B operand (one N tile of 8
// rows, `ldmatrix`); each warp sums its chunk from zero, and the thread of
// each (row, unit) pair adds the chunks in float32 in chunk order, applies
// the cell (exact sigmoids, the float32 carry in its registers) and stores
// out as bf16, as the `mma` route does.  Then each CTA sends bf16(h_t) of
// its own units into every CTA's staged tile, its own included
// (cluster_common.cuh: `mapa` + `st.async` of 16 bytes, eight units,
// counted on the receiver's mbarrier): two staged tiles and two mbarriers
// in turn, by step parity.  A peer can send h_t only after it has all of
// h_{t-1}, so no write lands on a tile still being read, and each CTA
// waits on its own mbarrier alone: no grid sync and no cluster barrier a
// step.  The partial sums take two sets by step parity too, so the block
// syncs once a step (between the product and the cell): the next writer
// of a set has passed the wait for h_{t+1}, which this block's cells sent
// after reading it.  A cluster barrier at the start (the mbarriers' init),
// between chunks of rows and before the exit, so that no CTA leaves while
// others may still write into it.  A step's gx and mask are loaded as
// bf16 bits a step ahead.  No atomics: every sum is in a fixed order, so
// two runs give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "cluster_common.cuh"
#include "lstm_common.cuh"

namespace cg = cooperative_groups;

// the probes' cycles (lstm_common.cuh), in -DLSTM_PROBE builds only
#ifdef LSTM_PROBE
__device__ long long gru_cluster_probe_cycles[4];
#define PROBE_CYCLES gru_cluster_probe_cycles
#endif

namespace {

// One (row, unit) pair's inputs to the cell part of a step: its three gate
// inputs as loaded (bf16 bits) and its mask.
struct ClusterIn {
    unsigned short x[3];
    float m;
};

// gx: (T, R, 3H) bf16, R = D * Bd rows, row block d belongs to direction
// d.  w: (D, H, 3H) float32 (h @ w layout, gate column blocks r, z, n).
// mask: (T, R) or nullptr.  h0: (R, H) float32.  out: (T, R, H) bf16;
// hT: (R, H) float32.  The plan's fields (GruClusterPlan; C the
// cluster's CTAs, as launched).  Cluster k = blockIdx.x / C: direction
// d = k / n_rb, rows [rb * RB, min(Bd, (rb + 1) * RB)) of it, rb = k %
// n_rb, taken RS at a time; CTA c = its rank.
// Thread tid applies the cells of the chunk's pairs q = tid and tid + 512
// (row q / U, local unit q % U: U = 16 tiles of this CTA).  Shared memory:
// bars[2] | h_s (2, 8, 16 KT + 8) bf16, the staged tiles | red (2, KCH, 8,
// 16 TPC + 1) float4, the chunks' partial sums of r, z, n.
__global__ void __launch_bounds__(MMA_THREADS, 1) gru_fwd_cluster_kernel(
        const __nv_bfloat16* __restrict__ gx, const float* __restrict__ w,
        const float* __restrict__ mask, const float* __restrict__ h0,
        __nv_bfloat16* __restrict__ out, float* __restrict__ hT, int T,
        int Bd, int H, int C, int RB, int RS, int TPC, int KT, int KC,
        int KCH) {
    using Ty = ScanTypes<true>;
    using bf16 = __nv_bfloat16;
    constexpr int NT = MMA_THREADS;
    constexpr int KCR = GRU_CLUSTER_KC;
    extern __shared__ float4 smem4[];
    cg::cluster_group cluster = cg::this_cluster();
    const int c = (int)cluster.block_rank();
    const int k_cl = blockIdx.x / C;
    const int n_rb = (Bd + RB - 1) / RB;
    const int d = k_cl / n_rb;
    const int r_lo = k_cl % n_rb * RB;
    const int r_hi = min(Bd, r_lo + RB);
    const int R = gridDim.x / C / n_rb * Bd;
    const int G = 3 * H;
    const int row0 = d * Bd;
    const int n_ut = KT;
    const int t_lo = c * n_ut / C;
    const int tiles = (c + 1) * n_ut / C - t_lo;  // this CTA's unit tiles
    const int U = 16 * tiles;
    const int u_lo = 16 * t_lo;
    const int SK = 16 * KT + 8;           // a staged row's elements
    const int SR = 16 * TPC + 1;          // a partial-sum row's float4s
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
    bf16* h_s = reinterpret_cast<bf16*>(smem4 + 1);
    float4* red = reinterpret_cast<float4*>(h_s + 2 * GRU_MMA_ROWS * SK);
    const int red_set = KCH * GRU_MMA_ROWS * SR;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wpt = MMA_WARPS / TPC;
    const int lt = warp / wpt;
    const int chunk = warp % wpt;
    const bool in_product = lt < tiles && chunk < KCH;
    const int ks_lo = chunk * KC;
    const int kc = min(KC, KT - ks_lo);   // this chunk's k-steps

    // this warp's A fragments: W_hh[d][k][g H + j] for the tile's units j
    // of each gate g and the chunk's k, rounded to bf16; units and k past H
    // are zero
    uint32_t a[3][KCR][4];
    {
        const float* wd = w + (size_t)d * H * G;
        const int ja = u_lo + lt * 16 + (lane >> 2), jb = ja + 8;
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
    if (tid == 0) {
        bar_init(&bars[0]);
        bar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the phase parity each mbarrier waits for next
    uint32_t parity[2] = {0u, 0u};

    for (int rc = r_lo; rc < r_hi; rc += RS) {
        const int nr = min(RS, r_hi - rc);
        const int first = row0 + rc;   // the chunk's first row
        // every CTA has its mbarriers set up (the first chunk) or is done
        // with the previous chunk's tiles (the others)
        cluster.sync();
        // this thread's pairs q = tid + 512 p: row pn of the chunk (< 0:
        // no pair) and unit j = u_lo + q % U, at og = row * 3H + j in a
        // (T, R, 3H) stream's step
        int pn[2], og[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const int q = tid + p * NT;
            pn[p] = q < nr * U ? q / U : -1;
            og[p] = (first + pn[p]) * G + u_lo + q % U;
        }
        const auto unit = [&](int p) { return og[p] - (first + pn[p]) * G; };
        const auto at_h = [&](int p) {
            return og[p] - 2 * H * (first + pn[p]);
        };
        const auto fetch = [&](int t, int p) {
            ClusterIn in = {{0, 0, 0}, 1.f};
            const size_t at = (size_t)t * R;
            const unsigned short* gr =
                reinterpret_cast<const unsigned short*>(gx + at * G) + og[p];
            in.x[0] = __ldg(gr);
            in.x[1] = __ldg(gr + H);
            in.x[2] = __ldg(gr + 2 * H);
            if (mask != nullptr) in.m = __ldg(mask + at + first + pn[p]);
            return in;
        };
        // the first tile: bf16(h0) of the chunk's rows, zero past them and
        // past H; the second: zero past the rows (the peers' sends fill
        // the rows, which may already be arriving)
        for (int i = tid; i < GRU_MMA_ROWS * SK; i += NT) {
            const int n = i / SK, k = i % SK;
            h_s[i] = __float2bfloat16_rn(
                n < nr && k < H ? h0[(size_t)(first + n) * H + k] : 0.f);
            if (n >= nr) h_s[GRU_MMA_ROWS * SK + i] = __float2bfloat16_rn(0.f);
        }
        float carry[2] = {0.f, 0.f};
        ClusterIn in[2] = {};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            if (pn[p] < 0 || unit(p) >= H) continue;
            carry[p] = h0[at_h(p)];
            in[p] = fetch(0, p);
        }
        __syncthreads();
        // the bytes of bf16(h_t) that every CTA receives a step: the
        // chunk's rows, all 16 n_ut units
        const int step_bytes = nr * 16 * n_ut * (int)sizeof(bf16);

        PROBE_INIT();
        for (int t = 0; t < T; ++t) {
            const int b = t & 1;
            if (t > 0) {
                // h_{t-1} from every CTA of the cluster
                if (tid == 0) bar_expect(&bars[b], step_bytes);
                bar_wait(&bars[b], parity[b]);
                parity[b] ^= 1u;
            }
            PROBE(PROBE_EXCHANGE);
            float4* red_t = red + b * red_set;
            if (in_product) {
                // the chunk's partial sums of the tile's three gates, each
                // an independent chain from zero
                float acc[3][4] = {};
                const bf16* b_row = h_s + (size_t)b * GRU_MMA_ROWS * SK
                                    + (size_t)(lane & 7) * SK + 16 * ks_lo
                                    + ((lane >> 3) & 1) * 8;
#pragma unroll
                for (int kk = 0; kk < KCR; ++kk) {
                    if (kk < kc) {
                        uint32_t b0, b1;
                        ldsm_x2(b_row + 16 * kk, b0, b1);
#pragma unroll
                        for (int g = 0; g < 3; ++g)
                            mma_bf16(acc[g], a[g][kk], b0, b1);
                    }
                }
                // acc[g]: units lane / 4 (+ 8) of the tile, rows
                // 2 (lane % 4) (+ 1)
                const int n = 2 * (lane & 3), m = lt * 16 + (lane >> 2);
                float4* rn =
                    red_t + ((size_t)chunk * GRU_MMA_ROWS + n) * SR + m;
                rn[0] = make_float4(acc[0][0], acc[1][0], acc[2][0], 0.f);
                rn[SR] = make_float4(acc[0][1], acc[1][1], acc[2][1], 0.f);
                rn[8] = make_float4(acc[0][2], acc[1][2], acc[2][2], 0.f);
                rn[SR + 8] = make_float4(acc[0][3], acc[1][3], acc[2][3], 0.f);
            }
            PROBE(PROBE_PRODUCT);
            __syncthreads();
            PROBE(PROBE_SYNC);
            // each own pair: for each gate the chunks in chunk order, then
            // the cell; then the pair's inputs of the next step are loaded
            bf16* const out_t = out + (size_t)t * R * H;
            uint32_t hb[2] = {0u, 0u};   // bf16(h_t) bits, 0 for no unit
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                if (pn[p] < 0 || unit(p) >= H) continue;
                const float4* rp = red_t + pn[p] * SR + (unit(p) - u_lo);
                float4 s = rp[0];
#pragma unroll
                for (int ch = 1; ch < MMA_WARPS; ++ch) {
                    if (ch >= KCH) break;
                    const float4 v = rp[ch * GRU_MMA_ROWS * SR];
                    s.x += v.x;
                    s.y += v.y;
                    s.z += v.z;
                }
                const float r_ = sigmoidf_(
                    __uint_as_float((unsigned)in[p].x[0] << 16) + s.x);
                const float z_ = sigmoidf_(
                    __uint_as_float((unsigned)in[p].x[1] << 16) + s.y);
                const float n_ = tanhf(
                    __uint_as_float((unsigned)in[p].x[2] << 16) + r_ * s.z);
                const float h_old = carry[p];
                float h_new = (1.0f - z_) * n_ + z_ * h_old;
                float h_out = h_new;
                const int oh = at_h(p);
                if (mask != nullptr) {
                    if (!(in[p].m > 0.0f)) h_new = h_old;
                    h_out = h_new * in[p].m;
                }
                Ty::st(out_t + oh, h_out);
                carry[p] = h_new;
                hb[p] = __bfloat16_as_ushort(__float2bfloat16_rn(h_new));
                if (t == T - 1) hT[oh] = h_new;
                else in[p] = fetch(t + 1, p);
            }
            if (t + 1 < T) {
                // bf16(h_t) of this CTA's units into every CTA's other
                // tile: a group of eight lanes holds eight units of one
                // row (16-byte aligned there); its lane i < C sends them
                // to CTA i
                bf16* const next = h_s + (size_t)(b ^ 1) * GRU_MMA_ROWS * SK;
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const int q0 = warp * 32 + p * NT;   // the warp's first
                    if (q0 >= nr * U) break;
                    const uint32_t pair =
                        hb[p] | (__shfl_down_sync(0xffffffffu, hb[p], 1)
                                 << 16);
                    const int base = lane & ~7;
                    uint4 v;
                    v.x = __shfl_sync(0xffffffffu, pair, base);
                    v.y = __shfl_sync(0xffffffffu, pair, base + 2);
                    v.z = __shfl_sync(0xffffffffu, pair, base + 4);
                    v.w = __shfl_sync(0xffffffffu, pair, base + 6);
                    const int q = q0 + base;
                    const int to = lane & 7;
                    if (to < C && q < nr * U) {
                        send4(next + (size_t)(q / U) * SK + u_lo + q % U, to,
                              v, &bars[b ^ 1]);
                    }
                }
            }
            PROBE(PROBE_CELL);
        }
    }
    // no CTA leaves while another may still send into it
    cluster.sync();
}

cudaLaunchConfig_t cluster_config(int blocks, int C, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(MMA_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// How many clusters of C CTAs with `smem` bytes each the card runs at
// once (cudaOccupancyMaxActiveClusters), queried once a (device, C, smem).
cudaError_t max_clusters(int device, int C, size_t smem, int* out) {
    static std::mutex lock;
    static std::map<std::tuple<int, int, size_t>, int> known;
    std::lock_guard<std::mutex> hold(lock);
    const auto key = std::make_tuple(device, C, smem);
    auto it = known.find(key);
    if (it == known.end()) {
        cudaError_t err = gru_mma_allow_smem(
            (const void*)gru_fwd_cluster_kernel, device, smem);
        if (err != cudaSuccess) return err;
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg = cluster_config(C, C, smem, 0, &attr);
        int n = 0;
        err = cudaOccupancyMaxActiveClusters(
            &n, (const void*)gru_fwd_cluster_kernel, &cfg);
        if (err != cudaSuccess) return err;
        it = known.emplace(key, n).first;
    }
    *out = it->second;
    return cudaSuccess;
}

// The plan at the card's limits, and the clusters of its C the card runs
// at once.
cudaError_t device_plan(int D, int Bd, int H, int device,
                        GruClusterPlan* plan, int* clusters) {
    GruMmaLimits l;
    cudaError_t err = gru_mma_limits(device, &l);
    if (err != cudaSuccess) return err;
    *clusters = 0;
    *plan = gru_cluster_shape(H, l.max_smem);
    if (plan->C != 0) {
        err = max_clusters(device, plan->C, plan->smem, clusters);
        if (err != cudaSuccess) return err;
    }
    *plan = gru_cluster_plan(D, Bd, H, l.max_smem, *clusters);
    return cudaSuccess;
}

// Launch the lean bf16 forward on its cluster plan.  A shape the plan
// does not take is refused with cudaErrorInvalidConfiguration before
// anything runs.  Returns cudaGetLastError() after the launch.
int launch_fwd_cluster(const void* gx, const void* w, const void* mask,
                       const void* h0, void* out, void* hT, int T, int D,
                       int Bd, int H, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    GruClusterPlan plan;
    int clusters = 0;
    err = device_plan(D, Bd, H, device, &plan, &clusters);
    if (err != cudaSuccess) return err;
    if (T < 1 || plan.blocks == 0 || plan.KC > GRU_CLUSTER_KC)
        return cudaErrorInvalidConfiguration;
    if ((size_t)D * Bd * 3 * H >= (size_t)1 << 31)  // a step's offsets: int
        return cudaErrorInvalidValue;
    const auto* gx_ = static_cast<const __nv_bfloat16*>(gx);
    const auto* w_ = static_cast<const float*>(w);
    const auto* mask_ = static_cast<const float*>(mask);
    const auto* h0_ = static_cast<const float*>(h0);
    auto* out_ = static_cast<__nv_bfloat16*>(out);
    auto* hT_ = static_cast<float*>(hT);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(plan.blocks, plan.C, plan.smem,
                       static_cast<cudaStream_t>(stream), &attr);
    err = cudaLaunchKernelEx(&cfg, gru_fwd_cluster_kernel, gx_, w_, mask_,
                             h0_, out_, hT_, T, Bd, H, plan.C, plan.RB,
                             plan.RS, plan.TPC, plan.KT, plan.KC, plan.KCH);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The lean bf16 forward on its cluster route (see the top): gx, out bf16;
// w, mask, h0, hT float32.
int gru_cell_scan_fwd_cluster_bf16(const void* gx, const void* w,
                                   const void* mask, const void* h0,
                                   void* out, void* hT, int T, int D, int Bd,
                                   int H, int device, void* stream) {
    return launch_fwd_cluster(gx, w, mask, h0, out, hT, T, D, Bd, H, device,
                              stream);
}

// The cluster plan at (D, Bd, H) on the card: out[0..11] = C, TPC, KT,
// KC, KCH, n_rb, RB, RS, clusters, blocks (0 where none fits), smem, and
// the clusters of C CTAs the card runs at once (0 where no C fits).
int gru_cell_scan_cluster_plan(int D, int Bd, int H, int device,
                               void* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    GruClusterPlan p;
    int clusters = 0;
    err = device_plan(D, Bd, H, device, &p, &clusters);
    if (err != cudaSuccess) return err;
    int* o = static_cast<int*>(out);
    const int v[12] = {p.C, p.TPC, p.KT, p.KC, p.KCH, p.n_rb, p.RB, p.RS,
                       p.clusters, p.blocks, (int)p.smem, clusters};
    for (int i = 0; i < 12; ++i) o[i] = v[i];
    return cudaSuccess;
}

#ifdef LSTM_PROBE
// The probes' cycles of the cluster route's steps (PROBE_CELL ...
// PROBE_PRODUCT; lstm_bwd_probe.py gru-cluster), read and zeroed.
int gru_cluster_probe_take(long long* out) {
    return probe_take(gru_cluster_probe_cycles, out);
}
#endif

}  // extern "C"
