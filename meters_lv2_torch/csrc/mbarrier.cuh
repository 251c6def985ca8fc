// The shared-memory mbarrier steps of the warp-specialised kernels
// (ballistics.cu, truepeak_fused.cu): producers arrive on a slot's "full"
// barrier, the consumer waits on it, and the other way round on "empty".
// arrive releases and try_wait acquires at CTA scope, so the shared-memory
// writes before an arrive are seen after the matching wait.

#pragma once

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Spins until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned ready = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(ready)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ready);
}
