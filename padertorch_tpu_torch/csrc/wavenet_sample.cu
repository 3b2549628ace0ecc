// Persistent WaveNet autoregressive sampler: all T steps in one launch.
//
// Replaces: padertorch_tpu/ops/pallas/wavenet.py, `wavenet_sample`
// (kernel `_kernel`).
//
// What bounds it on the card: latency.  A step is a chain of 2 L + 2
// dependent matrix-vector products (1.43 MFLOP per row at full width:
// L=16, R=64, S=256, O=256) with a barrier after each, and step t + 1
// needs the index that step t chose, so nothing overlaps across steps.
// The byte and operation bounds of the whole call are far below what
// such a chain can reach; what counts is the time of one step.
//
// Design: rows are independent.  A row runs on a thread-block cluster of
// N CTAs (N = 1, 2, 4, 8 or 16; one launch has one N, chosen by the
// wrapper: ops/kernels/wavenet.py `cluster_plan`), with no grid
// synchronisation and no atomics.  N = 1 is one block per row: it takes
// many rows at once (`infer(parallel=True)` makes rows out of chunks, which
// fills the 132 SMs).  For few rows a cluster spreads one row over N SMs:
// CTA c owns the columns c, c + N, c + 2N, ... of every product (the
// dilated layers' units, with the tanh and the sigmoid column of a unit
// together; the S + R skip and residual columns; the O columns of w_out
// and of w_end) and the ring-buffer channels and conditioning of its
// units.  Its slices of the weights (2.9 MB / N of f32 at full width) stay
// in its shared memory for the whole call where they fit (N = 16: 176 KB)
// and are otherwise read through L2 every step; the wrapper lays them out
// per CTA, (outputs, K) with K contiguous.  Every CTA keeps its own copy of
// each product's input vector: after a product the owner of a column
// sends its value into every CTA's copy (distributed shared memory), and
// each CTA starts its next product as soon as the values it needs have
// arrived, with no cluster-wide barrier (a step has 34 such waits, and a
// cluster barrier costs many times a block barrier: cluster_sync_cost.py
// measures both beside this exchange; see "the cluster's exchanges"
// below).  The skip sums stay with their owners
// until the last layer.  The argmax is reduced in each CTA, then across
// the cluster the same way, with the lowest index among equal values.
//
// A product y(N) = v(K) @ W(K, N) runs with a group of up to 32 lanes
// along K (the smallest power of two that covers K / 4): each lane loads
// 16 bytes of up to ten output columns' rows before it uses the first
// (and, since the weights do not depend on the step's data, one product
// ahead: they travel while the product before reduces, applies its gate
// and waits at the barrier), multiplies them with its four entries of v,
// and the group adds its lanes' sums by shuffles in a fixed order.  A
// column's sum depends only on K: the routes split columns, never K, so
// every route gives the same bits for a row, and a row's result depends
// neither on the batch size nor on the run.  The group's lanes then share
// out what follows the sums (bias, gate, skip and residual update), one
// column each.  The two products of a dilated layer (past and current
// sample) are one product of the 2R-long vector [x_past, x] with the
// layer's stacked weights; its skip and residual products are one product
// with S + R outputs.  All products are f32 FMAs.  The per-layer ring
// buffers of a row live in shared memory for the whole call (sum of the
// dilations x R floats: 510 x 64 x 4 B = 130.6 KB at full width, split
// over the cluster's CTAs).  The embedding is a gather of one row (the
// TPU's one-hot product is a TPU idiom).  Stochastic sampling is
// Gumbel-max over uniforms from a counter-based generator, three rounds of
// a 32-bit mixer over (seed, step, row, class), mapped to [0, 1) through
// 24 bits as the TPU kernel maps its hardware bits; `wavenet_uniform` in
// ops/kernels/wavenet.py reproduces it bit for bit with integer tensor
// operations.
//
// Every geometry the TPU kernel takes (its rings are VMEM scratch of any
// size): the dilations come through device memory (any number of layers)
// into a table in shared memory; R, S and O that are not multiples of 4
// are zero-padded by the wrapper (a zero residual channel gates to
// tanh(0) sigmoid(0) = 0, a zero skip or hidden channel meets zero rows of
// the next weights, and the argmax and the logits take the first OV of
// the O padded outputs); a ring that one block cannot hold is split over
// a cluster (rows then run in waves of clusters: they are independent),
// and one that no cluster holds lives in device memory, each CTA's own
// slice (`ring_global`), read and written by that CTA alone.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 16;
constexpr int START_INDEX = 128;   // mu-law zero

// RU, CB and CO: a CTA's units, skip/residual columns and output columns
// (ceil(R / N), ceil((S + R) / N), ceil(O / N)); resident: its weight
// slices in shared memory; OV: the outputs that count (O less the
// wrapper's padding); ring_global: the rings in device memory.
struct Sizes {
    int T, B, L, R, S, O, C, slots, RU, CB, CO, resident, OV, ring_global;
};

// Threads per CTA and columns a lane group takes at a time in each
// product (A: the dilated layers', in pairs; B: skip and residual; O:
// w_out and w_end), by cluster size: a CTA's share of the columns at full
// width, so that no lane loads rows of columns nobody needs.  Clusters of
// 8 and 16 run 256 threads a CTA (on an H100 a little faster than 128 or
// 512).
template <int N>
struct Units {
    static constexpr int THREADS = N >= 8 ? 256 : 512;
    static constexpr int A = N == 1 ? 8 : (N == 2 ? 4 : 2);
    static constexpr int B =
        N == 1 ? 10 : (N == 2 ? 5 : (N == 4 || N == 8 ? 3 : 2));
    static constexpr int O = N <= 2 ? 8 : (N == 4 || N == 8 ? 4 : 2);
};

__host__ __device__ __forceinline__ size_t round4(size_t n) {
    return (n + 3) / 4 * 4;
}

// Floats of dynamic shared memory a CTA of a cluster of n needs: the
// layers' dilations and ring offsets (2 L ints), ring (slots, RU; none
// when the rings are in device memory), the step's conditioning (L, 2,
// RU), [x_past, x] (2R), acts (R), skip (S), hid (O), its logits (CO), its
// skip/residual biases (L, CB), on a cluster two buffers of its values of
// a product (the most of RU, CB and CO) and, when resident, its weight
// slices.
__host__ __device__ inline size_t smem_floats(const Sizes& sz, int n) {
    size_t f = round4(2 * (size_t)sz.L)
        + (sz.ring_global ? 0 : round4((size_t)sz.slots * sz.RU))
        + round4((size_t)sz.L * 2 * sz.RU) + 3 * (size_t)sz.R + sz.S + sz.O
        + round4(sz.CO) + round4((size_t)sz.L * sz.CB);
    if (n > 1) {
        const int most = sz.RU > sz.CB ? sz.RU : sz.CB;
        f += 2 * round4(most > sz.CO ? most : sz.CO);
    }
    if (sz.resident)
        f += (size_t)sz.L * 2 * sz.RU * 2 * sz.R
             + (size_t)sz.L * sz.CB * sz.R + (size_t)sz.CO * (sz.S + sz.O);
    return f;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7feb352dU;
    x ^= x >> 15;
    x *= 0x846ca68bU;
    x ^= x >> 16;
    return x;
}

// lanes that share one output column of a product over K (a multiple of
// 4): the smallest power of two that covers K / 4, at most a warp
__host__ __device__ __forceinline__ int group_lanes(int K) {
    int g = 1;
    while (g < 32 && 4 * g < K) g *= 2;
    return g;
}

// 16 bytes of weights: through the read-only path from device memory on
// the one-block route; from shared memory or device memory on a cluster
template <int N>
__device__ __forceinline__ float4 load_w(const float* p) {
    if constexpr (N == 1) {
        return __ldg(reinterpret_cast<const float4*>(p));
    } else {
        return *reinterpret_cast<const float4*>(p);
    }
}

constexpr int UMAX = 10;   // most columns a lane loads before it uses one

// The weights a lane needs first in a product (its 16 bytes of the rows of
// tasks 0 ... U-1) do not depend on the step's data, so they are loaded
// one product ahead, into the registers `w`, and are on their way while
// the product before it reduces, applies its gate and waits at the barrier.
template <int N, int U, class ColOf>
__device__ __forceinline__ void load_ahead(float4 (&w)[UMAX],
                                           const float* Wt, int K, int G,
                                           ColOf col_of) {
    const int k = 4 * (threadIdx.x & (G - 1));
    if (k < K) {
#pragma unroll
        for (int j = 0; j < U; ++j)
            w[j] = load_w<N>(Wt + (size_t)col_of(j) * K + k);
    }
}

template <int U, bool RELU_IN>
__device__ __forceinline__ void multiply_add(float (&acc)[U], const float* v,
                                             int k, const float4* w) {
    float4 x = *reinterpret_cast<const float4*>(v + k);
    if (RELU_IN) {
        x.x = fmaxf(x.x, 0.0f);
        x.y = fmaxf(x.y, 0.0f);
        x.z = fmaxf(x.z, 0.0f);
        x.w = fmaxf(x.w, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < U; ++j)
        acc[j] = fmaf(x.w, w[j].w, fmaf(x.z, w[j].z,
                 fmaf(x.y, w[j].y, fmaf(x.x, w[j].x, acc[j]))));
}

// Products of v (K floats in shared memory) with rows of Wt (row c holds
// output column c's K weights).  A group of G lanes takes `tasks` columns,
// U at a time: column col_of(task) for task = 0 ... (col_of gives a valid
// column for every task up to the next multiple of U; put drops what it
// does not want).  Only the first `groups` groups have columns: a warp
// whose groups are all beyond them only loads ahead.  `w` holds what
// load_ahead fetched for this product; as soon as it is used, ahead() is
// called to fetch the next product's into it.  Further rows (K > 4 G) and
// columns (tasks > U) are loaded here, a lane issuing its U 16-byte loads
// before it uses the first.  The lanes' sums are added by a butterfly of
// shuffles, after which every lane of the group holds all U sums.  What
// follows a sum (bias, gate, skip or residual update) is spread over the
// group's lanes: lane l gets put(task, sum) for the l-th task of the
// batch, or, with PAIR, for the l-th pair of tasks, put(first task of the
// pair, its sum, the next task's sum).  Every thread of the block must
// call this with the same `tasks` and `groups`.
template <int N, int U, bool RELU_IN, bool PAIR, class ColOf, class Ahead,
          class Put>
__device__ __forceinline__ void group_products(
        const float* v, const float* Wt, int K, int G, int tasks, int groups,
        float4 (&w)[UMAX], ColOf col_of, Ahead ahead, Put put) {
    constexpr int ITEMS = PAIR ? U / 2 : U;
    constexpr int STEP = PAIR ? 2 : 1;
    if (N > 1 && (threadIdx.x & ~31) / G >= groups) {
        ahead();
        return;
    }
    const int lane = threadIdx.x & (G - 1);
    for (int base = 0; base < tasks; base += U) {
        float acc[U];
#pragma unroll
        for (int j = 0; j < U; ++j) acc[j] = 0.0f;
        int k = 4 * lane;
        if (base == 0) {
            if (k < K) multiply_add<U, RELU_IN>(acc, v, k, w);
            ahead();
            k += 4 * G;
        }
        for (; k < K; k += 4 * G) {
            float4 more[U];
#pragma unroll
            for (int j = 0; j < U; ++j)
                more[j] = load_w<N>(Wt + (size_t)col_of(base + j) * K + k);
            multiply_add<U, RELU_IN>(acc, v, k, more);
        }
        for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int j = 0; j < U; ++j)
                acc[j] += __shfl_xor_sync(0xffffffffU, acc[j], off);
        }
        // lane l takes item first + l (selected without a branch, so that
        // the lanes run put together and not one after the other)
        for (int first = 0; first < ITEMS; first += G) {
            float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const bool mine = j - first == lane;
                v0 = mine ? acc[STEP * j] : v0;
                if (PAIR) v1 = mine ? acc[STEP * j + 1] : v1;
            }
            if (first + lane < ITEMS)
                put(base + STEP * (first + lane), v0, v1);
        }
    }
}

// ------------------------------------------ the cluster's exchanges
//
// (cluster_common.cuh: smem_addr, bar_init, bar_expect, bar_wait, send.)
// A CTA sends each value it owns to every CTA of the cluster; consecutive
// products' inputs take the two mbarriers in turn, and before a CTA sends
// a product's values, a block barrier makes sure that all its threads have
// read that product's inputs (which the others may overwrite as soon as
// they have its values).

// cond: (T, B, L, 2R).  forced: (T, B) or nullptr.  The CTA c's slices,
// laid out by the wrapper (its unit lu is unit c + N lu, its column lj
// column c + N lj; rows past the last unit or column are zeros):
// wa (N, L, 2 RU, 2R), row 2 lu + h the weights of [x_past, x] for the
// tanh (h = 0) or sigmoid (h = 1) column of unit lu; b_dil (N, L, 2, RU);
// wb (N, L, CB, R), the skip (columns < S) and residual columns' weights
// (none in the last layer); b_sr (N, L, CB); wo (N, CO, S), we (N, CO, O):
// w_out's and w_end's columns.  embed: (C, R); idx_out: (T, B);
// logits_out: (T, B, OV) or nullptr; dil: the L dilations (device
// memory); ring_g: with ring_global, (B N, slots, RU) floats.  R, S and O
// are multiples of 4; on a cluster every CTA owns at least one unit and
// one column of each product (N <= R, S, O).
template <int N>
__global__ void __launch_bounds__(Units<N>::THREADS) wavenet_sample_kernel(
        const float* __restrict__ cond, const int* __restrict__ forced,
        const float* __restrict__ wa, const float* __restrict__ b_dil,
        const float* __restrict__ wb, const float* __restrict__ b_sr,
        const float* __restrict__ wo, const float* __restrict__ we,
        const float* __restrict__ embed, int* __restrict__ idx_out,
        float* __restrict__ logits_out, const int* __restrict__ dil,
        float* __restrict__ ring_g, Sizes sz, int do_sample,
        uint32_t seed) {
    using UN = Units<N>;
    constexpr int NT = UN::THREADS;
    extern __shared__ __align__(16) float smem[];
    const int T = sz.T, B = sz.B, L = sz.L, R = sz.R, S = sz.S, O = sz.O;
    // a CTA's units and columns (all of them on the one-block route)
    const int RU = N == 1 ? R : sz.RU;
    const int CB = N == 1 ? S + R : sz.CB;
    const int CO = N == 1 ? O : sz.CO;
    const int R2 = 2 * R;
    // the layers' dilations, then their first ring slots
    int* dilation = reinterpret_cast<int*>(smem);
    int* offset = dilation + L;
    float* base = smem + round4(2 * (size_t)L);
    float* ring = sz.ring_global
        ? ring_g + (size_t)blockIdx.x * sz.slots * RU : base;
    float* cond_s = base
        + (sz.ring_global ? 0 : round4((size_t)sz.slots * RU));
    float* xin = cond_s + round4((size_t)L * 2 * RU);
    float* x = xin + R;
    float* acts = x + R;
    float* skip = acts + R;
    float* hid = skip + S;
    float* logit_s = hid + O;
    float* bsr_s = logit_s + round4(CO);
    // on a cluster: the CTA's values of a product before they are sent,
    // two buffers used in turn
    float* out_s = bsr_s + round4((size_t)L * CB);
    const int out_n = N == 1 ? 0 : (int)round4(max(RU, max(CB, CO)));
    float* w_s = out_s + 2 * out_n;
    __shared__ float red_val[NT / 32];
    __shared__ int red_idx[NT / 32];
    __shared__ float cred_val[MAX_CLUSTER];
    __shared__ int cred_idx[MAX_CLUSTER];
    __shared__ __align__(8) uint64_t bars[2];

    const int tid = threadIdx.x;
    const int c = N == 1 ? 0 : (int)cg::this_cluster().block_rank();
    const int b = blockIdx.x / N;
    const size_t wa_n = (size_t)L * 2 * RU * R2, wb_n = (size_t)L * CB * R;
    const size_t wo_n = (size_t)CO * S, we_n = (size_t)CO * O;
    const float* Wa = wa + c * wa_n;
    const float* Wb = wb + c * wb_n;
    const float* Wo = wo + c * wo_n;
    const float* We = we + c * we_n;
    b_dil += (size_t)c * L * 2 * RU;
    if (N > 1 && sz.resident) {
        const float* src[4] = {Wa, Wb, Wo, We};
        const size_t n[4] = {wa_n, wb_n, wo_n, we_n};
        float* dst = w_s;
        for (int m = 0; m < 4; ++m) {
            for (size_t i = tid; i < n[m] / 4; i += NT)
                reinterpret_cast<float4*>(dst)[i] =
                    reinterpret_cast<const float4*>(src[m])[i];
            dst += n[m];
        }
        Wa = w_s;
        Wb = Wa + wa_n;
        Wo = Wb + wb_n;
        We = Wo + wo_n;
    }
    for (int i = tid; i < L; i += NT) dilation[i] = dil[i];
    if (tid == 0) {
        int first = 0;
        for (int i = 0; i < L; ++i) {
            offset[i] = first;
            first += dil[i];
        }
    }
    for (size_t i = tid; i < (size_t)sz.slots * RU; i += NT) ring[i] = 0.0f;
    for (int i = tid; i < R; i += NT) xin[i] = 0.0f;
    for (int i = tid; i < L * CB; i += NT) bsr_s[i] = b_sr[c * L * CB + i];
    if (N > 1 && tid == 0) {
        bar_init(&bars[0]);
        bar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    int prev = START_INDEX;

    // lanes per column, groups, this thread's group, and the groups that
    // have columns, for each product
    const int ga = group_lanes(R2), gb = group_lanes(R);
    const int go = group_lanes(S), ge = group_lanes(O);
    const int na = NT / ga, nb = NT / gb, no = NT / go, ne = NT / ge;
    const int grp_a = tid / ga, grp_b = tid / gb;
    const int grp_o = tid / go, grp_e = tid / ge;
    const int tasks_a = 2 * ((RU + na - 1) / na);
    const int tasks_b = (CB + nb - 1) / nb;
    const int tasks_o = (CO + no - 1) / no, tasks_e = (CO + ne - 1) / ne;
    const int used_a = min(na, RU), used_b = min(nb, CB);
    const int used_o = min(no, CO), used_e = min(ne, CO);

    // which row of the CTA's weights a group's task is, for each product
    const auto col_a = [=](int task) {
        return 2 * min(grp_a + na * (task >> 1), RU - 1) + (task & 1);
    };
    const auto col_b = [=](int task) { return min(grp_b + nb * task, CB - 1); };
    const auto col_o = [=](int task) { return min(grp_o + no * task, CO - 1); };
    const auto col_e = [=](int task) { return min(grp_e + ne * task, CO - 1); };

    // The exchanges of a cluster.  `use` counts the waits: the values for
    // wait k count on mbarrier k % 2, whose (k / 2)-th phase it is.
    int use = 0, stage = 0;
    const auto wait_for = [&](int bytes) {
        if (tid == 0) bar_expect(&bars[use & 1], bytes);
        bar_wait(&bars[use & 1], (use >> 1) & 1);
        ++use;
    };
    // The values a CTA sends after a product: its values out[lj] of the
    // columns j = c + N lj in [lo, hi) into every CTA's vector dst (at
    // dst[j - lo]), then, with past_layer >= 0, its ring channels of that
    // layer at step t into every CTA's x_past; one (value, CTA) pair per
    // thread.
    const auto share = [&](const float* out, float* dst, int n_local,
                           int lo, int hi, int past_layer, int t) {
        const int first = max(0, (lo - c + N - 1) / N);
        const int cols = max(0, min(n_local, (hi - c + N - 1) / N) - first);
        const int units = past_layer < 0 ? 0 : (R - c + N - 1) / N;
        const float* past = past_layer < 0 ? nullptr : ring
            + (size_t)(offset[past_layer]
                       + t % dilation[past_layer]) * RU;
        for (int e = tid; e < (cols + units) * N; e += NT) {
            const int item = e / N, p = e % N;
            if (item < cols) {
                const int lj = first + item;
                send(dst + c + N * lj - lo, p, __float_as_uint(out[lj]),
                     &bars[use & 1]);
            } else {
                const int lu = item - cols;
                send(xin + c + N * lu, p, __float_as_uint(past[lu]),
                     &bars[use & 1]);
            }
        }
    };
    if constexpr (N == 1) {
        __syncthreads();
    } else {
        // every CTA's buffers and mbarriers are set before a peer sends
        cg::this_cluster().sync();
    }
    float4 w[UMAX];
    load_ahead<N, UN::A>(w, Wa, R2, ga, col_a);

    for (int t = 0; t < T; ++t) {
        const int cur = forced != nullptr ? forced[(size_t)t * B + b] : prev;
        // the conditioning of this CTA's units, plus the dilated biases
        const float* cond_t = cond + ((size_t)t * B + b) * L * R2;
        if constexpr (N == 1) {
            for (int i = tid; i < L * R2 / 4; i += NT) {
                const float4 cv = reinterpret_cast<const float4*>(cond_t)[i];
                const float4 d = reinterpret_cast<const float4*>(b_dil)[i];
                reinterpret_cast<float4*>(cond_s)[i] = make_float4(
                    cv.x + d.x, cv.y + d.y, cv.z + d.z, cv.w + d.w);
            }
        } else {
            for (int i = tid; i < L * 2 * RU; i += NT) {
                const int lu = i % RU, hl = i / RU;   // hl: 2 layer + h
                const int u = c + N * lu;
                cond_s[i] = u < R
                    ? cond_t[(hl >> 1) * R2 + (hl & 1) * R + u] + b_dil[i]
                    : 0.0f;
            }
        }
        for (int r = tid; r < R; r += NT) x[r] = embed[(size_t)cur * R + r];
        for (int lj = tid; lj < CB; lj += NT)
            if (c + N * lj < S) skip[c + N * lj] = 0.0f;
        __syncthreads();

        for (int i = 0; i < L; ++i) {
            float* slot = ring
                + (size_t)(offset[i] + t % dilation[i]) * RU;
            const float* cb = cond_s + (size_t)i * 2 * RU;
            const bool last = i == L - 1;
            // skip (S columns) and, but for the last layer, residual (R
            // columns) products of acts are one product
            const int n2 = S + (last ? 0 : R);
            const float* wb_i = Wb + (size_t)i * CB * R;
            // the residual x and x_past of the layer before
            if (N > 1 && i > 0) wait_for(8 * R);
            float* out = out_s + (stage++ & 1) * out_n;
            // tasks 2u and 2u + 1 are the tanh and the sigmoid column of
            // the CTA's unit u = group + na * (task / 2)
            group_products<N, UN::A, false, true>(
                xin, Wa + (size_t)i * 2 * RU * R2, R2, ga, tasks_a, used_a,
                w, col_a,
                [&]() { load_ahead<N, UN::B>(w, wb_i, R, gb, col_b); },
                [=](int task, float a, float g) {
                    const int lu = grp_a + na * (task >> 1);
                    const int u = c + N * lu;
                    if (task < tasks_a && lu < RU && u < R) {
                        a += cb[lu];
                        g += cb[RU + lu];
                        const float act =
                            tanhf(a) * (1.0f / (1.0f + expf(-g)));
                        if (N == 1) {
                            acts[u] = act;
                        } else {
                            out[lu] = act;
                        }
                        // the ring keeps the layer's input; step 0 is the
                        // phantom position before the shift and leaves
                        // zeros
                        slot[lu] = t > 0 ? x[u] : 0.0f;
                    }
                });
            __syncthreads();
            if constexpr (N > 1) {
                share(out, acts, RU, 0, R, -1, t);
                wait_for(4 * R);
                out = out_s + (stage++ & 1) * out_n;
            }
            const float* bs = bsr_s + (size_t)i * CB;
            group_products<N, UN::B, false, false>(
                acts, wb_i, R, gb, tasks_b, used_b, w, col_b,
                [&]() {
                    if (!last)
                        load_ahead<N, UN::A>(
                            w, Wa + (size_t)(i + 1) * 2 * RU * R2, R2, ga,
                            col_a);
                    else
                        load_ahead<N, UN::O>(w, Wo, S, go, col_o);
                },
                [=](int task, float sum, float) {
                    const int lj = grp_b + nb * task;
                    const int j = c + N * lj;
                    if (j < S) {
                        // the skip sums stay with their owner; on a
                        // cluster the last layer's go to every CTA
                        const float s = skip[j] + (sum + bs[lj]);
                        if (N == 1 || !last) {
                            skip[j] = s;
                        } else {
                            out[lj] = s;
                        }
                    } else if (j < n2) {
                        const float r = x[j - S] + (sum + bs[lj]);
                        if (N == 1) {
                            x[j - S] = r;
                        } else {
                            out[lj] = r;
                        }
                    }
                });
            if (N == 1 && !last) {   // the next layer's x_past
                const float* past = ring
                    + (size_t)(offset[i + 1]
                               + t % dilation[i + 1]) * R;
                for (int r = tid; r < R; r += NT) xin[r] = past[r];
            }
            __syncthreads();
            if constexpr (N > 1) {
                // the last layer's skip sums, or the residual x and the
                // next layer's x_past
                if (last) {
                    share(out, skip, CB, 0, S, -1, t);
                } else {
                    share(out, x, CB, S, S + R, i + 1, t);
                }
            }
        }

        if (N > 1) wait_for(4 * S);
        float* out = out_s + (stage++ & 1) * out_n;
        group_products<N, UN::O, true, false>(
            skip, Wo, S, go, tasks_o, used_o, w, col_o,
            [&]() { load_ahead<N, UN::O>(w, We, O, ge, col_e); },
            [=](int task, float sum, float) {
                const int lj = grp_o + no * task;
                if (c + N * lj < O) {
                    if (N == 1) {
                        hid[lj] = fmaxf(sum, 0.0f);
                    } else {
                        out[lj] = fmaxf(sum, 0.0f);
                    }
                }
            });
        __syncthreads();
        if constexpr (N > 1) {
            share(out, hid, CO, 0, O, -1, t);
            wait_for(4 * O);
        }
        // the weights loaded ahead here are the next step's first
        group_products<N, UN::O, false, false>(
            hid, We, O, ge, tasks_e, used_e, w, col_e,
            [&]() { load_ahead<N, UN::A>(w, Wa, R2, ga, col_a); },
            [=](int task, float sum, float) {
                const int lj = grp_e + ne * task;
                if (c + N * lj < O) logit_s[lj] = sum;
            });
        __syncthreads();

        // this CTA's logits, the choice score, and the lowest index of its
        // maximum
        float best = -INFINITY;
        int best_n = 0x7fffffff;
        uint32_t key = 0;
        if (do_sample) {
            key = mix32(seed ^ ((uint32_t)t * 0x9E3779B1U));
            key = mix32(key ^ ((uint32_t)b * 0x85EBCA77U));
        }
        for (int lj = tid; lj < CO && c + N * lj < sz.OV; lj += NT) {
            const int n = c + N * lj;
            const float logit = logit_s[lj];
            if (logits_out != nullptr)
                logits_out[((size_t)t * B + b) * sz.OV + n] = logit;
            float score = logit;
            if (do_sample) {
                const uint32_t bits = mix32(key ^ ((uint32_t)n * 0xC2B2AE3DU));
                const float u = (float)((bits >> 8) & 0xFFFFFFU)
                    * (1.0f / 16777216.0f);
                score += -logf(-logf(u + 1e-20f) + 1e-20f);
            }
            if (score > best) {
                best = score;
                best_n = n;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffU, best, off);
            const int on = __shfl_down_sync(0xffffffffU, best_n, off);
            if (ov > best || (ov == best && on < best_n)) {
                best = ov;
                best_n = on;
            }
        }
        if ((tid & 31) == 0) {
            red_val[tid >> 5] = best;
            red_idx[tid >> 5] = best_n;
        }
        __syncthreads();
        if (tid < 32) {
            best = tid < NT / 32 ? red_val[tid] : -INFINITY;
            best_n = tid < NT / 32 ? red_idx[tid] : 0x7fffffff;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_down_sync(0xffffffffU, best, off);
                const int on = __shfl_down_sync(0xffffffffU, best_n, off);
                if (ov > best || (ov == best && on < best_n)) {
                    best = ov;
                    best_n = on;
                }
            }
            if constexpr (N == 1) {
                if (tid == 0) {
                    cred_val[0] = best;
                    cred_idx[0] = best_n;
                }
            } else {
                // lane p hands the CTA's choice to CTA p
                best = __shfl_sync(0xffffffffU, best, 0);
                best_n = __shfl_sync(0xffffffffU, best_n, 0);
                if (tid < N) {
                    send(cred_val + c, tid, __float_as_uint(best),
                         &bars[use & 1]);
                    send(cred_idx + c, tid, (uint32_t)best_n,
                         &bars[use & 1]);
                }
            }
        }
        // the next step's x_past of layer 0
        if constexpr (N == 1) {
            const float* past = ring
                + (size_t)(offset[0] + (t + 1) % dilation[0])
                * R;
            for (int r = tid; r < R; r += NT) xin[r] = past[r];
            __syncthreads();
        } else {
            if (t + 1 < T) share(nullptr, nullptr, 0, 0, 0, 0, t + 1);
            wait_for(8 * N + (t + 1 < T ? 4 * R : 0));
        }
        best = cred_val[0];
        best_n = cred_idx[0];
        for (int p = 1; p < N; ++p) {
            if (cred_val[p] > best
                || (cred_val[p] == best && cred_idx[p] < best_n)) {
                best = cred_val[p];
                best_n = cred_idx[p];
            }
        }
        // no score compared greater than -inf (all NaN): index 0
        if (best_n >= sz.OV) best_n = 0;
        if (c == 0 && tid == 0) idx_out[(size_t)t * B + b] = best_n;
        prev = best_n;
    }
    // no CTA leaves while a peer may still write into it
    if constexpr (N > 1) cg::this_cluster().sync();
}

bool valid_cluster(int n) {
    return n == 1 || n == 2 || n == 4 || n == 8 || n == 16;
}

template <int N>
cudaError_t set_attributes(int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        wavenet_sample_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err == cudaSuccess && N > 8)
        err = cudaFuncSetAttribute(
            wavenet_sample_kernel<N>,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
}

template <int N>
cudaLaunchConfig_t cluster_config(dim3 grid, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(Units<N>::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = N;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <int N>
cudaError_t launch(const float* cond, const int* forced, const float* wa,
                   const float* b_dil, const float* wb, const float* b_sr,
                   const float* wo, const float* we, const float* embed,
                   int* idx_out, float* logits_out, const int* dil,
                   float* ring_g, const Sizes& sz, int smem, int do_sample,
                   uint32_t seed, cudaStream_t stream) {
    cudaError_t err = set_attributes<N>(smem);
    if (err != cudaSuccess) return err;
    if constexpr (N == 1) {
        wavenet_sample_kernel<1><<<sz.B, Units<1>::THREADS, smem, stream>>>(
            cond, forced, wa, b_dil, wb, b_sr, wo, we, embed, idx_out,
            logits_out, dil, ring_g, sz, do_sample, seed);
    } else {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg =
            cluster_config<N>(dim3(sz.B * N), smem, stream, &attr);
        err = cudaLaunchKernelEx(&cfg, wavenet_sample_kernel<N>, cond, forced,
                                 wa, b_dil, wb, b_sr, wo, we, embed, idx_out,
                                 logits_out, dil, ring_g, sz, do_sample, seed);
        if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
}

template <int N>
cudaError_t max_clusters(int smem, int* out) {
    cudaError_t err = set_attributes<N>(smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config<N>(dim3(N), smem, 0, &attr);
    return cudaOccupancyMaxActiveClusters(out, wavenet_sample_kernel<N>,
                                          &cfg);
}

}  // namespace

extern "C" {

// How many clusters of n CTAs (2, 4, 8 or 16) with `smem` bytes of dynamic
// shared memory each the card runs at once; into out[0].
int wavenet_sample_max_clusters(int n, int smem, int device, void* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    int* count = static_cast<int*>(out);
    switch (n) {
        case 2: return max_clusters<2>(smem, count);
        case 4: return max_clusters<4>(smem, count);
        case 8: return max_clusters<8>(smem, count);
        case 16: return max_clusters<16>(smem, count);
        default: return cudaErrorInvalidValue;
    }
}

// One row per cluster of n CTAs (n = 1: one block per row), the weights in
// the CTAs' layout (see wavenet_sample_kernel), resident in shared memory
// or not, the rings in shared memory or, with ring_global, in `ring_g`
// ((B n, slots, ceil(R / n)) floats), `smem` bytes of dynamic shared
// memory per CTA (at least what the layout needs).  `dilations` is a host
// array of L ints and `dil` the same ints in device memory.  OV of the O
// outputs count.  Returns cudaGetLastError() after the launch.
int wavenet_sample_fwd(
        const void* cond, const void* forced, const void* wa,
        const void* b_dil, const void* wb, const void* b_sr, const void* wo,
        const void* we, const void* embed, void* idx_out, void* logits_out,
        const void* dilations, const void* dil, void* ring_g, int T, int B,
        int L, int R, int S, int O, int OV, int C, int n, int resident,
        int ring_global, int smem, int do_sample, int seed, int device,
        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (L < 1 || B < 1 || T < 1 || C <= START_INDEX || OV < 1 || OV > O ||
        OV > C || R < 4 || R % 4 || S < 4 || S % 4 || O < 4 || O % 4 ||
        !valid_cluster(n) || (n == 1 && resident) ||
        (n > 1 && (n > R || n > S || n > O)) ||
        (ring_global && ring_g == nullptr))
        return cudaErrorInvalidValue;
    Sizes sz{T, B, L, R, S, O, C, 0, (R + n - 1) / n, (S + R + n - 1) / n,
             (O + n - 1) / n, resident != 0, OV, ring_global != 0};
    const int* d = static_cast<const int*>(dilations);
    for (int i = 0; i < L; ++i) {
        if (d[i] < 1) return cudaErrorInvalidValue;
        sz.slots += d[i];
    }
    int max_smem = 0;
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    if ((size_t)smem < smem_floats(sz, n) * sizeof(float) || smem > max_smem)
        return cudaErrorInvalidValue;
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SAMPLE_ARGS f(cond), static_cast<const int*>(forced), f(wa), \
        f(b_dil), f(wb), f(b_sr), f(wo), f(we), f(embed), \
        static_cast<int*>(idx_out), static_cast<float*>(logits_out), \
        static_cast<const int*>(dil), static_cast<float*>(ring_g), sz, smem, \
        do_sample, static_cast<uint32_t>(seed), st
    switch (n) {
        case 1: return launch<1>(SAMPLE_ARGS);
        case 2: return launch<2>(SAMPLE_ARGS);
        case 4: return launch<4>(SAMPLE_ARGS);
        case 8: return launch<8>(SAMPLE_ARGS);
        default: return launch<16>(SAMPLE_ARGS);
    }
#undef SAMPLE_ARGS
}

}  // extern "C"
