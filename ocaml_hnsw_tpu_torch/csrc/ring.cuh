// Shared-memory ring helpers of the port's kernels: mbarriers and
// cp.async.bulk (the TMA's linear mode) global -> shared copies.
//
// A stage of a ring is armed by one thread: mbar_arrive_expect_tx with the
// bytes it will receive, then one bulk_load per contiguous run; the copies
// count their bytes on the stage's mbarrier, whose phase completes when the
// arrival and all the bytes are in.  A stage with nothing to fetch is armed
// with a plain mbar_arrive, so no thread ever waits on a copy never issued.
// Before a thread re-arms a stage that threads read with ordinary loads, the
// reads are ordered (__syncwarp or __syncthreads) and the arming thread runs
// `fence.proxy.async.shared::cta` (async_proxy_fence), so the copy cannot
// overwrite bytes still being read.
//
// Included by payload_score.cu (K1) and gather_dist.cu (K2).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's view of earlier generic-proxy accesses to shared
// memory before its next async-proxy (bulk copy) write.
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Global -> shared bulk copy; completion counts `bytes` on `bar`.  dst, src
// and bytes are 16-byte multiples.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bytes at the head of the dynamic shared memory that hold `barriers`
// mbarriers, rounded to 128 so the ring behind them starts aligned.
__host__ __device__ constexpr int header_bytes(int barriers) {
  return (barriers * 8 + 127) / 128 * 128;
}

}  // namespace
