// Hopper TMA 1-D bulk copies (cp.async.bulk), shared by the local memory
// kernels hbm_read.cu and hbm_write.cu.
//
// One thread asks the copy engine for a whole piece of contiguous bytes:
//   * global -> shared completes on an mbarrier in shared memory, which the
//     issuing thread arms with the byte count (expect_tx) and waits on by
//     phase parity;
//   * shared -> global joins the thread's current bulk group; commit_group
//     closes the group and wait_group waits for it.
// Both addresses must be 16-byte aligned and the size a multiple of 16.
// These are the Hopper counterparts of the TPU's pltpu.make_async_copy
// DMA with its semaphore.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

constexpr long long kAlign = 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival per phase: the issuing thread's expect_tx.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Global -> shared: `bytes` arrive in `smem` and complete the current phase
// of `bar`.
__device__ __forceinline__ void load(void* smem, const void* gmem,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Spin until the phase with parity `phase` of `bar` has completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  } while (!done);
  // what the copy engine wrote is read by the copy engine next
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared -> global, in the thread's current bulk group.
__device__ __forceinline__ void store(void* gmem, const void* smem,
                                      uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   gmem),
               "r"(smem_addr(smem)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The committed stores are complete in global memory.
__device__ __forceinline__ void wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

inline bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (kAlign - 1)) == 0;
}

}  // namespace bulk
