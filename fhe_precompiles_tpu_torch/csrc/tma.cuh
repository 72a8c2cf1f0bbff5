// TMA bulk copies and mbarriers (PTX), shared by the NTT kernels of
// ntt.cu and four_step.cu.  Every copy's addresses and size must be
// multiples of 16 bytes.
#pragma once
#include <cuda_runtime.h>

typedef unsigned long long u64;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect_tx(u64* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of this parity has completed.  A wait
// that lasts 2^34 cycles (seconds) means a copy that was never issued:
// trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
    const unsigned addr = smem_u32(bar);
    const long long start = clock64();
    for (;;) {
        unsigned done;
        asm volatile(
            "{\n\t.reg .pred P;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, P;\n\t}"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - start > (1LL << 34)) __trap();
    }
}

// global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, u64* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// shared -> global, tracked by this thread's bulk groups
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until all but the newest N of this thread's stores have read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}
