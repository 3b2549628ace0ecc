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
// Design: rows are independent, so one thread block takes one batch row
// and runs its whole loop with block barriers only: no grid
// synchronisation, no atomics.  (The TPU kernel holds all rows in one
// program because a TensorCore is one program; `infer(parallel=True)`
// makes rows out of chunks, which is what fills the 132 SMs here.)  The
// per-layer ring buffers of that row live in shared memory for the whole
// call (sum of the dilations x R floats: 510 x 64 x 4 B = 130.6 KB at full
// width), as do the step's conditioning slice, the skip and residual biases
// and the activations.  The weights (2.9 MB of f32 at full width) do not
// fit beside them and are read through L2 every step.  The wrapper hands
// them over transposed, (outputs, K) with K contiguous, so that a product
// y(N) = v(K) @ W(K, N) runs with a group of up to 32 lanes along K: each
// lane loads 16 bytes of up to ten output columns' rows before it uses the
// first (and, since the weights do not depend on the step's data, one
// product ahead: they travel while the product before reduces, applies its
// gate and waits at the barrier; the profile of a step showed the loads of
// one product, 64 to 80 KB through one SM's path to L2, to take as long as
// everything else in it), multiplies them with its four entries of v, and
// the group adds
// its lanes' sums by shuffles in a fixed order, so a row's result does not
// depend on the batch size or on the run.  The group's lanes then share
// out what follows the sums (bias, gate, skip and residual update), one
// column each, so a layer costs two barriers: after its gated activation and after its
// skip/residual products.  The two products of a dilated layer (past and
// current sample) are one product of the 2R-long vector [x_past, x] with
// the layer's stacked weights; its skip and residual products are one
// product with S + R outputs.  All products are f32 FMAs.
// The embedding is a gather of one row (the TPU's one-hot product is a TPU
// idiom).  The argmax takes the lowest index among equal values, also
// across warps.  Stochastic sampling is Gumbel-max over uniforms from a
// counter-based generator, three rounds of a 32-bit mixer over (seed,
// step, row, class), mapped to [0, 1) through 24 bits as the TPU kernel
// maps its hardware bits; `wavenet_uniform` in ops/kernels/wavenet.py
// reproduces it bit for bit with integer tensor operations.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;            // threads per block
constexpr int MAX_LAYERS = 64;
constexpr int START_INDEX = 128;   // mu-law zero

struct Layers {
    int dilation[MAX_LAYERS];
    int offset[MAX_LAYERS];
};

struct Sizes {
    int T, B, L, R, S, O, C, slots;
};

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

constexpr int UMAX = 10;   // most columns a lane loads before it uses one

// The weights a lane needs first in a product (its 16 bytes of the rows of
// tasks 0 ... U-1) do not depend on the step's data, so they are loaded
// one product ahead, into the registers `w`, and are on their way while
// the product before it reduces, applies its gate and waits at the barrier.
template <int U, class ColOf>
__device__ __forceinline__ void load_ahead(float4 (&w)[UMAX],
                                           const float* __restrict__ Wt,
                                           int K, int G, ColOf col_of) {
    const int k = 4 * (threadIdx.x & (G - 1));
    if (k < K) {
#pragma unroll
        for (int j = 0; j < U; ++j)
            w[j] = __ldg(reinterpret_cast<const float4*>(
                Wt + (size_t)col_of(j) * K + k));
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
// column for every task up to the next multiple of U; emit drops what it
// does not want).  `w` holds what load_ahead fetched for this product; as
// soon as it is used, ahead() is called to fetch the next product's into
// it.  Further rows (K > 4 G) and columns (tasks > U) are loaded here, a
// lane issuing its U 16-byte loads before it uses the first.  The lanes'
// sums are added by a butterfly of shuffles, after which every lane of the
// group holds all U sums.  What follows a sum (bias, gate, update) is
// spread over the group's lanes: lane l gets emit(task, sum) for the l-th
// task of the batch, or, with PAIR, for the l-th pair of tasks,
// emit(first task of the pair, its sum, the next task's sum).  Every
// thread of the block must call this with the same `tasks`.
template <int U, bool RELU_IN, bool PAIR, class ColOf, class Ahead,
          class Emit>
__device__ __forceinline__ void group_products(
        const float* v, const float* __restrict__ Wt, int K, int G, int tasks,
        float4 (&w)[UMAX], ColOf col_of, Ahead ahead, Emit emit) {
    constexpr int ITEMS = PAIR ? U / 2 : U;
    constexpr int STEP = PAIR ? 2 : 1;
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
                more[j] = __ldg(reinterpret_cast<const float4*>(
                    Wt + (size_t)col_of(base + j) * K + k));
            multiply_add<U, RELU_IN>(acc, v, k, more);
        }
        for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int j = 0; j < U; ++j)
                acc[j] += __shfl_xor_sync(0xffffffffU, acc[j], off);
        }
        // lane l takes item first + l (selected without a branch, so that
        // the lanes run emit together and not one after the other)
        for (int first = 0; first < ITEMS; first += G) {
            float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const bool mine = j - first == lane;
                v0 = mine ? acc[STEP * j] : v0;
                if (PAIR) v1 = mine ? acc[STEP * j + 1] : v1;
            }
            if (first + lane < ITEMS)
                emit(base + STEP * (first + lane), v0, v1);
        }
    }
}

// cond: (T, B, L, 2R); forced: (T, B) or nullptr; wd_t: (L, 2R, 2R), row c
// of a layer holds column c's weights for [x_past, x] (w_prev's column,
// then w_curr's); b_dil: (L, 2R); wsr_t: (L, S + R, R), rows 0 ... S-1 of a
// layer are w_skip's columns, rows S ... S+R-1 w_res's (unused in the last
// layer); b_res: (L-1, R); b_skip: (L, S); wo_t: (O, S) and we_t: (O, O),
// w_out and w_end transposed; embed: (C, R); idx_out: (T, B); logits_out:
// (T, B, O) or nullptr.  R, S and O are multiples of 4.
// Shared memory: ring (slots, R), cond_s (L, 2R: conditioning plus b_dil),
// xin (2R: the layer's past input, then its current input x), acts (R),
// skip (S), hid (O), logit_s (O), bskip_s (L, S), bres_s (L, R).
__global__ void __launch_bounds__(NT) wavenet_sample_kernel(
        const float* __restrict__ cond, const int* __restrict__ forced,
        const float* __restrict__ wd_t, const float* __restrict__ b_dil,
        const float* __restrict__ wsr_t, const float* __restrict__ b_res,
        const float* __restrict__ b_skip, const float* __restrict__ wo_t,
        const float* __restrict__ we_t, const float* __restrict__ embed,
        int* __restrict__ idx_out, float* __restrict__ logits_out,
        Layers layers, Sizes sz, int do_sample, uint32_t seed) {
    extern __shared__ __align__(16) float smem[];
    const int T = sz.T, B = sz.B, L = sz.L, R = sz.R, S = sz.S, O = sz.O;
    const int R2 = 2 * R;
    float* ring = smem;
    float* cond_s = ring + (size_t)sz.slots * R;
    float* xin = cond_s + L * R2;
    float* x = xin + R;
    float* acts = x + R;
    float* skip = acts + R;
    float* hid = skip + S;
    float* logit_s = hid + O;
    float* bskip_s = logit_s + O;
    float* bres_s = bskip_s + L * S;
    __shared__ float red_val[NT / 32];
    __shared__ int red_idx[NT / 32];
    __shared__ int chosen;

    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    for (int i = tid; i < sz.slots * R; i += NT) ring[i] = 0.0f;
    for (int i = tid; i < L * S; i += NT) bskip_s[i] = b_skip[i];
    for (int i = tid; i < (L - 1) * R; i += NT) bres_s[i] = b_res[i];
    int prev = START_INDEX;

    // lanes per column and this thread's group, for each product
    const int ga = group_lanes(R2), gb = group_lanes(R);
    const int go = group_lanes(S), ge = group_lanes(O);
    const int na = NT / ga, nb = NT / gb, no = NT / go, ne = NT / ge;
    const int grp_a = tid / ga, grp_b = tid / gb;
    const int grp_o = tid / go, grp_e = tid / ge;
    const int tasks_a = 2 * ((R + na - 1) / na);
    const int tasks_o = (O + no - 1) / no, tasks_e = (O + ne - 1) / ne;
    __syncthreads();

    // which column a group's task is, for each product
    const auto col_a = [=](int task) {
        return min(grp_a + na * (task >> 1), R - 1) + (task & 1) * R;
    };
    const auto col_o = [=](int task) { return min(grp_o + no * task, O - 1); };
    const auto col_e = [=](int task) { return min(grp_e + ne * task, O - 1); };
    float4 w[UMAX];
    load_ahead<8>(w, wd_t, R2, ga, col_a);

    for (int t = 0; t < T; ++t) {
        const int cur = forced != nullptr ? forced[(size_t)t * B + b] : prev;
        const float4* cond_t = reinterpret_cast<const float4*>(
            cond + ((size_t)t * B + b) * L * R2);
        for (int i = tid; i < L * R2 / 4; i += NT) {
            const float4 c = cond_t[i];
            const float4 d = reinterpret_cast<const float4*>(b_dil)[i];
            reinterpret_cast<float4*>(cond_s)[i] =
                make_float4(c.x + d.x, c.y + d.y, c.z + d.z, c.w + d.w);
        }
        for (int r = tid; r < R; r += NT) {
            x[r] = embed[(size_t)cur * R + r];
            xin[r] = ring[(size_t)(layers.offset[0] + t % layers.dilation[0])
                          * R + r];
        }
        for (int n = tid; n < S; n += NT) skip[n] = 0.0f;
        __syncthreads();

        for (int i = 0; i < L; ++i) {
            float* slot = ring
                + (size_t)(layers.offset[i] + t % layers.dilation[i]) * R;
            const float* cb = cond_s + i * R2;
            // skip (S columns) and, but for the last layer, residual (R
            // columns) products of acts are one product
            const int n2 = S + (i < L - 1 ? R : 0);
            const float* wsr = wsr_t + (size_t)i * (S + R) * R;
            const auto col_b = [=](int task) {
                return min(grp_b + nb * task, n2 - 1);
            };
            // tasks 2u and 2u + 1 are the tanh and the sigmoid column of
            // unit u = group + na * (task / 2)
            group_products<8, false, true>(
                xin, wd_t + (size_t)i * R2 * R2, R2, ga, tasks_a, w, col_a,
                [&]() { load_ahead<10>(w, wsr, R, gb, col_b); },
                [=](int task, float a, float g) {
                    const int u = grp_a + na * (task >> 1);
                    if (task < tasks_a && u < R) {
                        a += cb[u];
                        g += cb[R + u];
                        acts[u] = tanhf(a) * (1.0f / (1.0f + expf(-g)));
                        // the ring keeps the layer's input; step 0 is the
                        // phantom position before the shift and leaves
                        // zeros
                        slot[u] = t > 0 ? x[u] : 0.0f;
                    }
                });
            __syncthreads();
            const float* bs = bskip_s + i * S;
            const float* br = bres_s + i * R;
            group_products<10, false, false>(
                acts, wsr, R, gb, (n2 + nb - 1) / nb, w, col_b,
                [&]() {
                    if (i < L - 1)
                        load_ahead<8>(w, wd_t + (size_t)(i + 1) * R2 * R2, R2,
                                      ga, col_a);
                    else
                        load_ahead<8>(w, wo_t, S, go, col_o);
                },
                [=](int task, float sum, float) {
                    const int c = grp_b + nb * task;
                    if (c < S)
                        skip[c] += sum + bs[c];
                    else if (c < n2)
                        x[c - S] += sum + br[c - S];
                });
            if (i < L - 1)   // the next layer's past input
                for (int r = tid; r < R; r += NT)
                    xin[r] = ring[(size_t)(layers.offset[i + 1]
                                           + t % layers.dilation[i + 1]) * R
                                  + r];
            __syncthreads();
        }

        group_products<8, true, false>(
            skip, wo_t, S, go, tasks_o, w, col_o,
            [&]() { load_ahead<8>(w, we_t, O, ge, col_e); },
            [=](int task, float sum, float) {
                const int c = grp_o + no * task;
                if (c < O) hid[c] = fmaxf(sum, 0.0f);
            });
        __syncthreads();
        // the weights loaded ahead here are the next step's first
        group_products<8, false, false>(
            hid, we_t, O, ge, tasks_e, w, col_e,
            [&]() { load_ahead<8>(w, wd_t, R2, ga, col_a); },
            [=](int task, float sum, float) {
                const int c = grp_e + ne * task;
                if (c < O) logit_s[c] = sum;
            });
        __syncthreads();

        // logits, the choice score, and the lowest index of its maximum
        float best = -INFINITY;
        int best_n = 0x7fffffff;
        uint32_t key = 0;
        if (do_sample) {
            key = mix32(seed ^ ((uint32_t)t * 0x9E3779B1U));
            key = mix32(key ^ ((uint32_t)b * 0x85EBCA77U));
        }
        for (int n = tid; n < O; n += NT) {
            const float logit = logit_s[n];
            if (logits_out != nullptr)
                logits_out[((size_t)t * B + b) * O + n] = logit;
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
            if (tid == 0) {
                // no score compared greater than -inf (all NaN): index 0
                if (best_n >= O) best_n = 0;
                chosen = best_n;
                idx_out[(size_t)t * B + b] = best_n;
            }
        }
        __syncthreads();
        prev = chosen;
    }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the wrapper checks it
// against the card's limit before the launch.
int wavenet_sample_smem_bytes(int L, int R, int S, int O, int slots) {
    const size_t floats = (size_t)slots * R + (size_t)L * 2 * R + 3 * R + S
        + 2 * O + (size_t)L * S + (size_t)L * R;
    return (int)(floats * sizeof(float));
}

// One block per batch row.  `dilations` is a host array of L ints.
// Returns cudaGetLastError() after the launch.
int wavenet_sample_fwd(
        const void* cond, const void* forced, const void* wd_t,
        const void* b_dil, const void* wsr_t, const void* b_res,
        const void* b_skip, const void* wo_t, const void* we_t,
        const void* embed,
        void* idx_out, void* logits_out, const void* dilations,
        int T, int B, int L, int R, int S, int O, int C, int do_sample,
        int seed, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (L < 1 || L > MAX_LAYERS || B < 1 || T < 1 || C <= START_INDEX ||
        O > C || R < 4 || R % 4 || S < 4 || S % 4 || O < 4 || O % 4)
        return cudaErrorInvalidValue;
    Layers layers;
    Sizes sz{T, B, L, R, S, O, C, 0};
    const int* d = static_cast<const int*>(dilations);
    for (int i = 0; i < L; ++i) {
        if (d[i] < 1) return cudaErrorInvalidValue;
        layers.dilation[i] = d[i];
        layers.offset[i] = sz.slots;
        sz.slots += d[i];
    }
    const int smem = wavenet_sample_smem_bytes(L, R, S, O, sz.slots);
    int max_smem = 0;
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           device);
    if (smem > max_smem) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(wavenet_sample_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    wavenet_sample_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cond), static_cast<const int*>(forced),
        static_cast<const float*>(wd_t), static_cast<const float*>(b_dil),
        static_cast<const float*>(wsr_t), static_cast<const float*>(b_res),
        static_cast<const float*>(b_skip), static_cast<const float*>(wo_t),
        static_cast<const float*>(we_t), static_cast<const float*>(embed),
        static_cast<int*>(idx_out), static_cast<float*>(logits_out), layers,
        sz, do_sample, static_cast<uint32_t>(seed));
    return cudaGetLastError();
}

}  // extern "C"
