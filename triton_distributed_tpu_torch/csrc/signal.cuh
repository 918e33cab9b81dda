// Flag signalling between blocks of one kernel: the device-side
// counterpart of triton_distributed_tpu/language/primitives.py's wait (:51)
// and notify (:62).
//
// A flag is one 32-bit word in device memory. A producer sets it to the
// call's epoch (a per-call counter the host hands the kernel), so a flag
// never needs a reset between calls: a waiter compares against its own
// epoch, and an older call's value reads as "not yet".
//
// Order: a producer block's threads store their data, meet at
// __syncthreads, and then one thread releases the flag (notify_flag). In a
// consumer block ONE thread waits (acquire), the block meets at
// __syncthreads, and only then does any thread load the data the flag
// guards. Both sides use GPU scope. The spin is bounded: after kSpinCycles
// of clock64 (about one second on an H100) the waiting thread prints the
// flag and traps, so a protocol bug makes the launch fail (the call raises
// at its next synchronisation) instead of hanging the process. That is a
// failure, not a fallback.
//
// A waiter must be able to rely on its producer running: the kernels that
// use these hand out work by ticket in a persistent grid, producers first
// (gemm_tile.cuh take_ticket / persistent_blocks).
#pragma once

#include <stdint.h>
#include <stdio.h>

namespace tdt {
namespace signal {

constexpr long long kSpinCycles = 2000000000LL;  // ~1 s at 1.98 GHz

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Set *p = epoch with release semantics: every write this thread made, or
// saw through a barrier before the call, is visible to a waiter that reads
// the new value.
__device__ __forceinline__ void notify_flag(uint32_t* p, uint32_t epoch) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(epoch) : "memory");
}

// Spin until *p has reached epoch (wrap-safe), or trap after kSpinCycles.
// One thread of the block calls it; the block then meets at a barrier.
__device__ __forceinline__ void wait_flag(const uint32_t* p, uint32_t epoch) {
  const long long t0 = clock64();
  uint32_t v;
  while (static_cast<int32_t>((v = ld_acquire(p)) - epoch) < 0) {
    if (clock64() - t0 > kSpinCycles) {
      printf("tdt wait_flag: timed out at block %d: flag %u, epoch %u\n",
             blockIdx.x, v, epoch);
      __trap();
    }
    __nanosleep(64);
  }
}

}  // namespace signal
}  // namespace tdt
