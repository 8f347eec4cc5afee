// Hopper's 1D bulk copy (cp.async.bulk, the TMA without a tensor map) from
// device memory into shared memory, completed on an mbarrier.  One thread
// arms the barrier with the byte count and issues the copy; every thread of
// the block then waits on the barrier's phase.  Used by the two-stage rings
// of split_sweep.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread initializes the barrier for one arrival (the arming thread's);
// the fence makes the initialization visible to the copy engine.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from src
// in device memory to dst in shared memory; the barrier's current phase
// completes when they have landed.  The proxy fence orders the block's
// earlier reads of dst (behind a __syncthreads) before the copy's writes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

}  // namespace
