// The notify/wait tutorial's producer -> consumer ring on one card: world
// simulated ranks, one block each, in ONE cooperative launch. Rank r
// streams its n_chunks chunks into rank r + 1's 2-slot queue and consumes
// rank r - 1's stream into out[r], so out[r] = x[(r - 1) mod world].
// x, out (world, n_chunks x chunk_bytes), queue (world, 2, chunk_bytes):
// bytes, any dtype.
//
// Replaces: tutorials/01-distributed-notify-wait.py:58
//   producer_consumer_kernel (pallas_call at :119).
//
// What bounds it on the H100: bytes, 3 x x's: the push, the read of the
//   slot and the write of out. At the tutorial's shape (8 ranks x 4 chunks
//   of (4, 128) f32, 64 KB) it is a launch and 4 x 3 signal round trips
//   per rank, nothing the memory system notices.
//
// What this design does about it: it is the language layer's first user
//   (language.cuh). The ranks are blocks of one cooperative launch
//   (cudaLaunchCooperativeKernel): the card promises that all of them run
//   at once, or the launch fails and the call raises. That is what makes a
//   spin on another block's signal safe without a ticket order. For chunk
//   c (slot c % 2), rank r:
//   1. when c >= 2, waits until its ack counter shows that chunk c - 2 was
//      consumed (the counter reaches c - 1): the slot is free;
//   2. putmem_signal's the chunk into rank r + 1's slot and SETs that
//      slot's arrival flag to the slot's use number c / 2 + 1;
//   3. waits until its own slot's arrival flag reaches c / 2 + 1;
//   4. copies the slot into out (loads through L2 only);
//   5. ADDs one to rank r - 1's ack counter (release, after a barrier: the
//      slot's reads precede it).
//   At the end it drains the acks of its last chunks (tutorial :106-109).
//   The arrival flag is per slot and carries the use's number: with one
//   shared signal, one slot's arrival could satisfy the other slot's wait
//   (the tutorial's documented race, :21-27 and :86-91). The signals are
//   counters and flags zeroed on the stream before the launch, so nothing
//   of an earlier call satisfies a wait. A barrier of all ranks opens the
//   kernel, as in the tutorial (:71). delay_ns holds back every odd rank's
//   producer before each push (a test of the waits).
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    notify_wait_kernel(const unsigned char* __restrict__ x,
                       unsigned char* queue, unsigned char* __restrict__ out,
                       uint32_t* arrival, uint32_t* acks, uint32_t* barrier,
                       int n_chunks, long long chunk_bytes,
                       unsigned long long delay_ns) {
  const lang::Team team = lang::simulated_team();
  const int r = lang::rank(team);
  const int right = lang::remote_rank(team, 1);
  const int left = lang::remote_rank(team, -1);
  const size_t stream_bytes = (size_t)n_chunks * chunk_bytes;
  lang::barrier_all(barrier, 1);
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c & 1;
    const uint32_t use = (uint32_t)(c / 2 + 1);
    // 1. the slot is free once the consumer acked chunk c - 2
    if (c >= 2 && threadIdx.x == 0) lang::wait(acks + r, (uint32_t)(c - 1));
    if (r & 1) lang::sleep_ns(delay_ns);
    __syncthreads();
    lang::consume_token();
    // 2. push into the right neighbour's slot and raise its arrival flag
    lang::putmem_signal(queue + ((size_t)right * 2 + slot) * chunk_bytes,
                        x + (size_t)r * stream_bytes + c * chunk_bytes,
                        chunk_bytes, arrival + right * 2 + slot, use);
    // 3. wait for the left neighbour's chunk c in this rank's slot
    if (threadIdx.x == 0) lang::wait(arrival + r * 2 + slot, use);
    __syncthreads();
    lang::consume_token();
    // 4. copy it out
    lang::copy_block(out + (size_t)r * stream_bytes + c * chunk_bytes,
                     queue + ((size_t)r * 2 + slot) * chunk_bytes,
                     chunk_bytes);
    // 5. ack the slot back to the producer
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      lang::notify(acks + left, 1, lang::SIGNAL_ADD);
    }
  }
  // Drain: every chunk this rank pushed has been consumed.
  if (threadIdx.x == 0) lang::wait(acks + r, (uint32_t)n_chunks);
}

}  // namespace

// x, out (world, n_chunks * chunk_bytes bytes), queue (world, 2,
// chunk_bytes); signals (3 * world + 1 uint32: arrival (world, 2), acks
// (world,), the barrier counter), zero when the launch starts (the caller
// zeroes them on the stream). A cooperative launch of world blocks: fails
// (cudaErrorCooperativeLaunchTooLarge) if the card cannot hold them.
extern "C" int tdt_notify_wait(const void* x, void* queue, void* out,
                               void* signals, long long world,
                               long long n_chunks, long long chunk_bytes,
                               unsigned long long delay_ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 1 || world > INT32_MAX || n_chunks < 1 ||
      n_chunks > INT32_MAX / 2 || chunk_bytes < 1)
    return cudaErrorInvalidValue;
  const unsigned char* xp = static_cast<const unsigned char*>(x);
  unsigned char* qp = static_cast<unsigned char*>(queue);
  unsigned char* op = static_cast<unsigned char*>(out);
  uint32_t* arrival = static_cast<uint32_t*>(signals);
  uint32_t* acks = arrival + 2 * world;
  uint32_t* barrier = acks + world;
  int nc = (int)n_chunks;
  void* args[] = {&xp, &qp, &op, &arrival, &acks, &barrier, &nc,
                  &chunk_bytes, &delay_ns};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(notify_wait_kernel),
      dim3((unsigned)world), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error
    return err;
  }
  return cudaGetLastError();
}
