// The port's device-side language layer: the counterpart of
// triton_distributed_tpu/language/primitives.py (rank, num_ranks, wait,
// notify, consume_token, barrier_all) and language/shmem.py (remote_rank,
// putmem_signal, signal_op, signal_wait_until), for kernels whose ranks are
// blocks of one launch on one card.
//
// Signals. A signal is one 32-bit word in device memory, of one of two
// kinds. A flag is SET to a value (a per-call epoch, or a use's sequence
// number); a counter is ADDed to. A waiter spins until the word has
// reached its value, compared wrap-safe, so a flag raised to an older
// epoch reads as "not yet" and needs no reset between calls. A counter
// (and a flag raised to a use number) does need one: the kernel that
// counts on it leaves it at 0 when it is done with it (the last block to
// arrive, or the waiter that saw its last raise, clears it), so nothing an
// earlier call added can satisfy a wait of this one, and the host never
// resets it (kernels/_signal.py arrivals). The TPU's semaphores only add
// (primitives.py:80-84); on this card both kinds exist, and flow control
// needs the counter.
//
// Order. A producer block's threads store their data, meet at
// __syncthreads, and then one thread fences and releases the signal
// (putmem_signal). In a consumer block ONE thread waits (acquire), the
// block meets at __syncthreads, and only then does any thread load the
// data the signal guards, through L2 (ld.global.cg), since another SM
// wrote it and this SM's L1 is not coherent with it. Everything is GPU
// scope. The spin is bounded: after kSpinCycles of clock64 (about one
// second on an H100) the waiting thread prints the signal and traps, so a
// protocol bug makes the launch fail (the call raises at its next
// synchronisation) instead of hanging the process. That is a failure, not
// a fallback.
//
// Ranks. Team is a set of simulated ranks: rank r is block r of the
// launch. A waiter must be able to rely on the rank it waits on running:
// either the launch is cooperative (cudaLaunchCooperativeKernel promises
// co-residency, or the launch fails), or work is handed out by ticket in a
// persistent grid, every item waited on first (gemm_tile.cuh take_ticket /
// persistent_blocks).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace tdt {
namespace lang {

constexpr long long kSpinCycles = 2000000000LL;  // ~1 s at 1.98 GHz

enum SignalOp : int { SIGNAL_SET = 0, SIGNAL_ADD = 1 };

struct Team {
  int rank;
  int world;
};

// The simulated rank of this block: block r of the launch is rank r.
__device__ __forceinline__ Team simulated_team() {
  return Team{static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x)};
}

__device__ __forceinline__ int rank(const Team& t) { return t.rank; }
__device__ __forceinline__ int num_ranks(const Team& t) { return t.world; }

// (rank + offset) mod world, for any sign of offset (shmem.py:35).
__device__ __forceinline__ int remote_rank(const Team& t, int offset) {
  const int r = (t.rank + offset % t.world) % t.world;
  return r < 0 ? r + t.world : r;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Spin until *sig has reached value (wrap-safe), or trap after
// kSpinCycles. One thread of the block calls it; the block then meets at a
// barrier before it reads what the signal guards. Returns the value read.
// Between reads the thread sleeps about sleep_ns; 0 spins without a sleep
// (a waiter whose signal is on its critical path and whose SM has little
// else to run).
__device__ __forceinline__ uint32_t signal_wait_until(const uint32_t* sig,
                                                      uint32_t value,
                                                      unsigned sleep_ns = 64) {
  const long long t0 = clock64();
  uint32_t v;
  while (static_cast<int32_t>((v = ld_acquire(sig)) - value) < 0) {
    if (clock64() - t0 > kSpinCycles) {
      printf("tdt wait: timed out at block %d: signal %u, waiting for %u\n",
             blockIdx.x, v, value);
      __trap();
    }
    if (sleep_ns) __nanosleep(sleep_ns);
  }
  return v;
}

// primitives.py's wait (:51): the same spin.
__device__ __forceinline__ uint32_t wait(const uint32_t* sig, uint32_t value,
                                         unsigned sleep_ns = 64) {
  return signal_wait_until(sig, value, sleep_ns);
}

// Release a signal: SET stores value, ADD adds it. Every write this thread
// made, or saw through a barrier before the call, is visible to a waiter
// that reads the result.
__device__ __forceinline__ void signal_op(uint32_t* sig, uint32_t value,
                                          SignalOp op) {
  if (op == SIGNAL_SET) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
                 :: "l"(sig), "r"(value) : "memory");
  } else {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                 :: "l"(sig), "r"(value) : "memory");
  }
}

// primitives.py's notify (:62).
__device__ __forceinline__ void notify(uint32_t* sig, uint32_t value,
                                       SignalOp op = SIGNAL_SET) {
  signal_op(sig, value, op);
}

// Keeps the compiler from moving a load above the wait before it.
__device__ __forceinline__ void consume_token() {
  asm volatile("" ::: "memory");
}

// Copy nbytes from src to dst with every thread of the block: 16-byte
// moves, eight in flight per thread, when both pointers and nbytes allow
// it, else bytes. Loads and stores go through L2 only (data of another
// block, or data another block will read).
__device__ __forceinline__ void copy_block(void* dst, const void* src,
                                           size_t nbytes) {
  const size_t step = blockDim.x;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
        nbytes) & 15) == 0) {
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    const size_t n = nbytes / 16;
    constexpr int U = 8;
    size_t i = threadIdx.x;
    for (; i + (U - 1) * step < n; i += U * step) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = __ldcg(s + i + u * step);
#pragma unroll
      for (int u = 0; u < U; ++u) __stcg(d + i + u * step, v[u]);
    }
    for (; i < n; i += step) __stcg(d + i, __ldcg(s + i));
  } else {
    const unsigned char* s = static_cast<const unsigned char*>(src);
    unsigned char* d = static_cast<unsigned char*>(dst);
    for (size_t i = threadIdx.x; i < nbytes; i += step)
      __stcg(d + i, __ldcg(s + i));
  }
}

// Copy nbytes from src to dst with n threads (tid: this thread's index
// among them), in rounds of U 16-byte moves a thread when both pointers
// and nbytes allow it, else bytes. Every load of a round is issued before
// its first store, the last round's tail predicated, so a copy of fewer
// than U x n moves is ONE round trip (copy_block's tail loop moves one
// 16-byte value at a time, a round trip each). Loads and stores go through
// L2 only.
template <int U>
__device__ __forceinline__ void copy_rounds(void* dst, const void* src,
                                            size_t nbytes, int tid, int n) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
        nbytes) & 15) == 0) {
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    const size_t n16 = nbytes / 16;
    for (size_t i = tid; i < n16; i += (size_t)U * n) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + (size_t)u * n < n16) v[u] = __ldcg(s + i + (size_t)u * n);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + (size_t)u * n < n16) __stcg(d + i + (size_t)u * n, v[u]);
    }
  } else {
    const unsigned char* s = static_cast<const unsigned char*>(src);
    unsigned char* d = static_cast<unsigned char*>(dst);
    for (size_t i = tid; i < nbytes; i += n) __stcg(d + i, __ldcg(s + i));
  }
}

// shmem.py's putmem_signal: the block copies nbytes, meets at a barrier,
// and one thread fences and releases the signal. Every thread of the block
// calls it.
__device__ __forceinline__ void putmem_signal(void* dst, const void* src,
                                              size_t nbytes, uint32_t* sig,
                                              uint32_t value,
                                              SignalOp op = SIGNAL_SET) {
  copy_block(dst, src, nbytes);
  __syncthreads();  // every thread's stores precede the release
  if (threadIdx.x == 0) {
    __threadfence();
    signal_op(sig, value, op);
  }
}

// primitives.py's barrier_all (:113) over the blocks of one cooperative
// launch: round k (1, 2, ...) of a call adds one per block to *count and
// waits until it reads k x gridDim.x (sleeping sleep_ns between reads,
// as signal_wait_until). *count is a counter: zero when the call starts.
// Every thread of every block calls it.
__device__ __forceinline__ void barrier_all(uint32_t* count, uint32_t round,
                                            unsigned sleep_ns = 64) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    signal_op(count, 1, SIGNAL_ADD);
    signal_wait_until(count, round * gridDim.x, sleep_ns);
  }
  __syncthreads();
}

// Sleep about ns nanoseconds (%globaltimer): the kernels' private producer
// delay, a test of their waits.
__device__ __forceinline__ void sleep_ns(unsigned long long ns) {
  if (!ns) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    __nanosleep(1000);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns);
}

}  // namespace lang
}  // namespace tdt
