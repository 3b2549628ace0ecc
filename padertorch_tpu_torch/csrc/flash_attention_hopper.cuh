// Hopper parts shared by the bf16 flash-attention kernels (the forward,
// flash_attention_fwd_bf16.cu, and the backward, flash_attention_bwd_bf16.cu):
// `mbarrier`s, TMA boxes of bf16 (BH, T, D) tensors in the swizzled layout
// that `wgmma` reads, shared-memory descriptors of such tiles as K-major and
// MN-major operands, and the bf16 `wgmma` products with float32 sums (B from
// shared memory; A from shared memory or from registers).
//
// A tile is ROWS = 64 rows of a (T, D) matrix; its columns come in boxes of
// at most 64 (a row of a box at most 128 bytes), each box swizzled by its
// rows' width (128-, 64- or 32-byte swizzle) and aligned to ALIGN bytes.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;        // the rows of a tile
constexpr int ALIGN = 1024;     // a swizzled tile's alignment

// the output columns of a block (wgmma's N) and the columns of a TMA box
// (a swizzled row of up to 128 bytes): at most 64
__host__ __device__ constexpr int cols_of(int D) { return D < 64 ? D : 64; }

// A tile's layout: boxes of COLS columns, rows of SW bytes, swizzled in
// 16-byte pieces over 8 rows (SW = 128, 64 or 32: the swizzle of that
// width), a box after another
template <int D>
struct Tile {
    static constexpr int COLS = cols_of(D);
    static constexpr int SW = COLS * 2;
    static constexpr int BOX = ROWS * COLS;      // elements of a box
    // the descriptors' layout type: 1 128-byte, 2 64-byte, 3 32-byte
    static constexpr uint64_t LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first ALIGN-aligned byte of dynamic shared memory (the host asks
// for ALIGN bytes more)
__device__ __forceinline__ bf16* aligned(unsigned char* smem) {
    const uint32_t skip = (ALIGN - (smem_u32(smem) & (ALIGN - 1)))
                          & (ALIGN - 1);
    return reinterpret_cast<bf16*>(smem + skip);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n"
        :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One box of a (T, D) matrix of a (BH, T, D) tensor (`map`: dims {D, T,
// BH}, boxes of Tile<D>::COLS columns and ROWS rows, swizzled), columns
// [col, ...) of rows [row, row + ROWS) of matrix m, into `dst`, completing
// on `bar`; rows past T arrive as zeros.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, int m,
                                        uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(col), "r"(row), "r"(m), "r"(smem_u32(bar))
        : "memory");
}

// A whole (ROWS, D) tile, its boxes one after another
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         int row, int m, uint64_t* bar) {
    using TL = Tile<D>;
#pragma unroll
    for (int b = 0; b < D / TL::COLS; ++b)
        tma_box(dst + b * TL::BOX, map, b * TL::COLS, row, m, bar);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of N registers (an
// accumulator of products in flight) across this point: after a wait, so
// that nothing touches them before the products are done.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a swizzled shared-memory operand of a Tile<D>: its start,
// `lbo` and `sbo` bytes (along K and along M or N, by the major mode).
template <int D>
__device__ __forceinline__ uint64_t desc(const bf16* p, uint32_t lbo,
                                         uint32_t sbo) {
    return ((smem_u32(p) & 0x3FFFFu) >> 4)
           | (uint64_t((lbo >> 4) & 0x3FFFu) << 16)
           | (uint64_t((sbo >> 4) & 0x3FFFu) << 32)
           | (Tile<D>::LAYOUT << 62);
}

// A (ROWS, D) tile as a K-major operand (its rows along M or N, D along
// K), k-step kk (columns [16 kk, 16 kk + 16): in box 16 kk / COLS, 32
// bytes a step along its rows); 8-row groups 8 SW bytes apart.
template <int D>
__device__ __forceinline__ uint64_t k_major(const bf16* tile, int kk) {
    using TL = Tile<D>;
    const int col = 16 * kk;
    return desc<D>(tile + col / TL::COLS * TL::BOX + col % TL::COLS, 16,
                   8 * TL::SW);
}

// The same tile as an MN-major operand (its rows along K, the columns
// [col0, col0 + COLS) of one box along N; the instruction transposes it),
// k-step kk (rows [16 kk, 16 kk + 16)): 8-row groups along K 8 SW bytes
// apart.
template <int D>
__device__ __forceinline__ uint64_t mn_major(const bf16* tile, int col0,
                                             int kk) {
    using TL = Tile<D>;
    return desc<D>(tile + col0 / TL::COLS * TL::BOX + 16 * kk * TL::COLS,
                   TL::BOX * 2, 8 * TL::SW);
}

// d (64 x N) (+)= A (64 x 16, shared memory, K-major) B (16 x N, shared
// memory, K-major); acc 0 starts from zero
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int acc);

// d (64 x N) (+)= A (64 x 16, registers) B (16 x N, shared memory,
// MN-major); acc 0 starts from zero
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d,
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d,
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d,
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        " %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline cudaError_t encoder(EncodeTiled* fn) {
    static EncodeTiled found_fn = nullptr;
    if (found_fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || p == nullptr)
            return cudaErrorNotSupported;
        found_fn = reinterpret_cast<EncodeTiled>(p);
    }
    *fn = found_fn;
    return cudaSuccess;
}

// The map of a (BH, T, D) bf16 tensor in Tile<D>'s boxes of one matrix
// (dims {D, T, BH}; rows past T read as zeros), swizzled by the rows'
// width.
template <int D>
inline cudaError_t tile_map(const void* x, int BH, int T, CUtensorMap* map) {
    using TL = Tile<D>;
    EncodeTiled encode;
    cudaError_t err = encoder(&encode);
    if (err != cudaSuccess) return err;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16),
                                   (cuuint64_t)T * D * sizeof(bf16)};
    const cuuint32_t box[3] = {TL::COLS, ROWS, 1};
    const cuuint32_t steps[3] = {1, 1, 1};
    CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(x), dims, strides, box, steps,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          TL::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : TL::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : CU_TENSOR_MAP_SWIZZLE_32B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
