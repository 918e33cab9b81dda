// The notify/wait tutorial's producer -> consumer ring on one card: world
// simulated ranks in ONE cooperative launch. Rank r streams its n_chunks
// chunks into rank r + 1's 2-slot queue and consumes rank r - 1's stream
// into out[r], so out[r] = x[(r - 1) mod world]. x, out (world, n_chunks x
// chunk_bytes), queue (world, 2, chunk_bytes): bytes, any dtype.
//
// Replaces: tutorials/01-distributed-notify-wait.py:58
//   producer_consumer_kernel (pallas_call at :119).
//
// What bounds it on the H100: bytes, 2 x x's: the read of x and the write
//   of out (the queue, world x 2 chunks, stays in L2). At the tutorial's
//   shape (8 ranks x 4 chunks of (4, 128) f32, 64 KB) it is a launch and a
//   few signal round trips, nothing the memory system notices; on the long
//   run (8 x 256 chunks of 32 KB, 64 MB) 0.04 ms of bytes, while the 2-slot
//   queue lets a producer run at most two chunks ahead of its consumer: the
//   time is 256 / 2 round trips of push, arrival flag, copy-out and ack.
//
// What this design does about it (one block a rank, running each chunk
//   strictly in turn, takes ~4 us a chunk):
//   - Stripes: every rank is `stripes` blocks, each owning one 16-byte
//     aligned stripe of every chunk and running the tutorial's protocol on
//     it with signals of its own (arrival flags (rank, stripe, slot), acks
//     (rank, stripe)), so world x stripes blocks (at most the card's SMs)
//     carry the ring and each round trip moves a stripe, not a chunk.
//   - Producer and consumer at once: warps 0-3 of a block are the rank's
//     producer, warps 4-7 its consumer, each half meeting at a named
//     barrier of its own. The push of chunk c + 1 overlaps the wait for,
//     and the copy-out of, chunk c; a producer loads its next stripe of x
//     into registers right after its last push (the first before the
//     opening barrier), so the load is in flight while it waits for the
//     slot to be free, and a
//     consumer acks the slot as soon as its loads of it have landed in
//     registers, storing them to out after the ack. Signals are released
//     with st.release / red.release after the half's barrier (cumulative
//     over the half's accesses), without a separate fence before them,
//     and awaited by a thread that spins without sleeping (one a half).
//   - No host reset: every signal is 0 on entry and the kernel leaves it at
//     0. A consumer clears its arrival flags after its last chunk (their
//     producer has raised them for the last time), a producer its ack
//     counter after the drain (its consumer has added its last), and the
//     opening barrier's counter is cleared by the last block to add to it a
//     second time, on its way out (every block has then passed the
//     barrier). The signals live in a persistent buffer
//     (kernels/_signal.py arrivals), zeroed once when made.
//   The ranks are blocks of one cooperative launch
//   (cudaLaunchCooperativeKernel): the card promises that all of them run
//   at once, or the launch fails and the call raises. That is what makes a
//   spin on another block's signal safe without a ticket order. For chunk
//   c (slot c % 2) of stripe s, rank r's producer:
//   1. when c >= 2, waits until its ack counter shows that chunk c - 2 was
//      consumed (the counter reaches c - 1): the slot is free;
//   2. puts its stripe into rank r + 1's slot and SETs that stripe's
//      arrival flag of the slot to the slot's use number c / 2 + 1;
//   and rank r's consumer:
//   3. waits until its own arrival flag of the slot reaches c / 2 + 1;
//   4. copies the stripe of the slot into out (loads through L2 only);
//   5. ADDs one to rank r - 1's ack counter of the stripe (release, after a
//      barrier of the consumer's warps: the slot's reads precede it).
//   At the end the producer drains the acks of its last chunks (tutorial
//   :106-109). The arrival flag is per slot and carries the use's number:
//   with one shared signal, one slot's arrival could satisfy the other
//   slot's wait (the tutorial's documented race, :21-27 and :86-91). A
//   barrier of all ranks opens the kernel, as in the tutorial (:71).
//   delay_ns holds back every odd rank's producer before each push (a test
//   of the waits).
#include <atomic>

#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;  // the producer's, then the consumer's
constexpr int kUnroll = 4;           // 16-byte moves a thread keeps in flight
constexpr long long kRound = (long long)kUnroll * kHalf;  // moves a round
constexpr long long kMaxStripes = 16;
constexpr long long kMinStripe = 2048;  // bytes

// Named barrier of one half of the block (id 1: producer, 2: consumer).
__device__ __forceinline__ void half_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(kHalf) : "memory");
}

__global__ void __launch_bounds__(kThreads)
    notify_wait_kernel(const unsigned char* __restrict__ x,
                       unsigned char* queue, unsigned char* __restrict__ out,
                       uint32_t* arrival, uint32_t* acks, uint32_t* barrier,
                       int world, int stripes, long long stripe, int n_chunks,
                       long long chunk_bytes, unsigned long long delay_ns) {
  const int r = blockIdx.x / stripes, s = blockIdx.x % stripes;
  const lang::Team team{r, world};
  const int right = lang::remote_rank(team, 1);
  const int left = lang::remote_rank(team, -1);
  const long long lo = s * stripe;
  const long long n = min(stripe, chunk_bytes - lo);  // this stripe's bytes
  const size_t stream_bytes = (size_t)n_chunks * chunk_bytes;
  // 16-byte moves when every stripe of every chunk is 16-byte aligned
  // (stripe is a multiple of 16), else bytes; n16 moves a stripe, in
  // rounds of kRound, the last of which the loops below treat apart.
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(queue) |
                     reinterpret_cast<uintptr_t>(out) | chunk_bytes) &
                    15) == 0;
  const long long n16 = vec ? n / 16 : 0;
  const long long last = n16 > 0 ? (n16 - 1) / kRound * kRound : 0;
  // The producer's first round of its stripe of chunk c, into registers
  // (x is read-only here): chunk 0's before the opening barrier, chunk c +
  // 1's right after chunk c's push, so each load is in flight while the
  // producer waits for the barrier or for a slot.
  const int tid = threadIdx.x % kHalf;
  uint4 v[kUnroll];
  auto load_first = [&](int c) {
    const uint4* s16 = reinterpret_cast<const uint4*>(
        x + (size_t)r * stream_bytes + (size_t)c * chunk_bytes + lo);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (tid + u * kHalf < n16) v[u] = __ldg(s16 + tid + u * kHalf);
  };
  if (threadIdx.x < kHalf) load_first(0);
  lang::barrier_all(barrier, 1, 0);
  if (threadIdx.x < kHalf) {  // the producer of (r, s)
    uint32_t* my_acks = acks + (size_t)r * stripes + s;
    for (int c = 0; c < n_chunks; ++c) {
      const int slot = c & 1;
      const unsigned char* src = x + (size_t)r * stream_bytes +
                                 (size_t)c * chunk_bytes + lo;
      unsigned char* dst =
          queue + ((size_t)right * 2 + slot) * chunk_bytes + lo;
      const uint4* s16 = reinterpret_cast<const uint4*>(src);
      uint4* d16 = reinterpret_cast<uint4*>(dst);
      // 1. the slot is free once the consumer acked chunk c - 2
      if (c >= 2 && tid == 0) lang::wait(my_acks, (uint32_t)(c - 1), 0);
      if (r & 1) lang::sleep_ns(delay_ns);
      half_sync(1);
      // 2. put the stripe and raise its arrival flag of the slot
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (tid + u * kHalf < n16) __stcg(d16 + tid + u * kHalf, v[u]);
      if (vec)
        lang::copy_rounds<kUnroll>(d16 + kRound, s16 + kRound,
                                   n16 > kRound ? (n16 - kRound) * 16 : 0,
                                   tid, kHalf);
      else
        lang::copy_rounds<kUnroll>(dst, src, n, tid, kHalf);
      half_sync(1);  // every thread's stores precede the release
      if (tid == 0)
        lang::notify(arrival + (((size_t)right * stripes + s) * 2 + slot),
                     (uint32_t)(c / 2 + 1));
      if (c + 1 < n_chunks) load_first(c + 1);
    }
    // Drain: every chunk pushed has been consumed; then clear the acks.
    if (tid == 0) {
      lang::wait(my_acks, (uint32_t)n_chunks, 0);
      *my_acks = 0u;
    }
  } else {  // the consumer of (r, s)
    uint32_t* my_arrival = arrival + ((size_t)r * stripes + s) * 2;
    uint32_t* left_acks = acks + (size_t)left * stripes + s;
    for (int c = 0; c < n_chunks; ++c) {
      const int slot = c & 1;
      const unsigned char* src =
          queue + ((size_t)r * 2 + slot) * chunk_bytes + lo;
      unsigned char* dst =
          out + (size_t)r * stream_bytes + (size_t)c * chunk_bytes + lo;
      const uint4* s16 = reinterpret_cast<const uint4*>(src);
      uint4* d16 = reinterpret_cast<uint4*>(dst);
      // 3. wait for the left neighbour's chunk c in this rank's slot
      if (tid == 0) lang::wait(my_arrival + slot, (uint32_t)(c / 2 + 1), 0);
      half_sync(2);
      lang::consume_token();
      // 4. copy it out: every round but the last; the last round's loads
      // into registers, where they must have landed before the ack (a use
      // of each value waits for it) ...
      if (vec)
        lang::copy_rounds<kUnroll>(dst, src, last * 16, tid, kHalf);
      else
        lang::copy_rounds<kUnroll>(dst, src, n, tid, kHalf);
      uint32_t landed = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (last + tid + u * kHalf < n16) {
          v[u] = __ldcg(s16 + last + tid + u * kHalf);
          landed |= v[u].x;
        }
      asm volatile("" :: "r"(landed));
      // 5. ack the slot back to the producer (the release orders the
      // half's reads of the slot before it), then store the last round.
      half_sync(2);
      if (tid == 0) lang::notify(left_acks, 1, lang::SIGNAL_ADD);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (last + tid + u * kHalf < n16)
          __stcg(d16 + last + tid + u * kHalf, v[u]);
    }
    // Every raise of this rank's arrival flags has been seen: clear them.
    if (tid == 0) my_arrival[0] = my_arrival[1] = 0u;
  }
  // Out: the barrier's counter counts every block twice, the last clears it.
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicAdd(barrier, 1u) == 2u * (uint32_t)gridDim.x - 1u)
    *barrier = 0u;
}

// The card's SMs, per device (cached: the query costs the host
// microseconds).
cudaError_t device_sms(int* sms) {
  static std::atomic<int> cache[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && (*sms = cache[device].load()) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < 64) cache[device].store(*sms);
  return err;
}

}  // namespace

// x, out (world, n_chunks * chunk_bytes bytes), queue (world, 2,
// chunk_bytes); signals (uint32, 0 on entry and left at 0): 3 x world x
// min(16, ceil(chunk_bytes / 2048)) + 1 of them (arrival (world, stripes,
// 2), acks (world, stripes), the barrier counter, for the stripes chosen
// here, at most that many). A cooperative launch of world x stripes blocks,
// stripes = min(16, ceil(chunk_bytes / 2048), SMs / world), at least 1:
// fails (cudaErrorCooperativeLaunchTooLarge) if the card cannot hold them.
extern "C" int tdt_notify_wait(const void* x, void* queue, void* out,
                               void* signals, long long world,
                               long long n_chunks, long long chunk_bytes,
                               unsigned long long delay_ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 1 || world > INT32_MAX || n_chunks < 1 ||
      n_chunks > INT32_MAX / 2 || chunk_bytes < 1)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  long long stripes = (chunk_bytes + kMinStripe - 1) / kMinStripe;
  if (stripes > kMaxStripes) stripes = kMaxStripes;
  if (stripes > sms / world) stripes = sms / world;
  if (stripes < 1) stripes = 1;
  long long stripe = (chunk_bytes + stripes - 1) / stripes;
  stripe = (stripe + 15) / 16 * 16;
  stripes = (chunk_bytes + stripe - 1) / stripe;
  if (world * stripes > INT32_MAX / 4) return cudaErrorInvalidValue;
  const unsigned char* xp = static_cast<const unsigned char*>(x);
  unsigned char* qp = static_cast<unsigned char*>(queue);
  unsigned char* op = static_cast<unsigned char*>(out);
  uint32_t* arrival = static_cast<uint32_t*>(signals);
  uint32_t* acks = arrival + 2 * world * stripes;
  uint32_t* barrier = acks + world * stripes;
  int w = (int)world, st = (int)stripes, nc = (int)n_chunks;
  void* args[] = {&xp, &qp, &op, &arrival, &acks, &barrier, &w, &st,
                  &stripe, &nc, &chunk_bytes, &delay_ns};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(notify_wait_kernel),
      dim3((unsigned)(world * stripes)), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error
    return err;
  }
  return cudaGetLastError();
}
