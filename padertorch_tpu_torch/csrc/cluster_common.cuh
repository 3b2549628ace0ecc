// Exchanges between the CTAs of a thread-block cluster through distributed
// shared memory, shared by the kernels that run on a cluster
// (wavenet_sample.cu, gru_cell_scan_cluster.cu).
//
// A CTA sends each value it owns to every CTA of the cluster with
// st.async, which also counts the value's bytes on the receiver's
// mbarrier; a CTA waits on its own mbarrier until the bytes of all the
// values it needs for its next product have arrived, with no cluster-wide
// barrier.  Consecutive products' inputs take the two mbarriers in turn:
// the values for the product after next can only be sent once the
// receiver has sent what the next product of the others needs, so they
// never fall into the phase still being waited for.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// the bytes that the next phase of `bar` waits for, and this CTA's one
// arrival
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A
// value that never arrives is a fault of the kernel: after 2^36 cycles of
// the SM's clock (about 35 s on an H100; a wait of a correct launch takes
// microseconds, also on a card shared with other contexts) the launch
// traps rather than hang the card.  The trap is only a guard against a
// hang: it ends the process's CUDA context, which a fault of this kind
// leaves unusable anyway.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    const long long start = clock64();
    uint32_t done = 0;
    while (true) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - start > (1LL << 36)) __trap();
    }
}

// Store the 32 bits v at `local` (an address in this CTA's shared memory)
// in CTA p of the cluster, counted on p's mbarrier `bar`
__device__ __forceinline__ void send(const void* local, int p, uint32_t v,
                                     const uint64_t* bar) {
    uint32_t dst, mb;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(dst) : "r"(smem_addr(local)), "r"(p));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(mb) : "r"(smem_addr(bar)), "r"(p));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];\n" :: "r"(dst), "r"(v), "r"(mb) : "memory");
}

// The same for the 16 bytes v (four 32-bit words) at `local`, 16-byte
// aligned, counted on p's mbarrier `bar`
__device__ __forceinline__ void send4(const void* local, int p, uint4 v,
                                      const uint64_t* bar) {
    uint32_t dst, mb;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(dst) : "r"(smem_addr(local)), "r"(p));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(mb) : "r"(smem_addr(bar)), "r"(p));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
        "{%1, %2, %3, %4}, [%5];\n"
        :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(mb)
        : "memory");
}
