// One-chip one-shot all-reduce loopback: world - 1 simulated peers push
// this card's buffer into a staging slot each, raising an arrival flag per
// chunk and slot, and a fold sums the own buffer and the slots in a fixed
// order. x (n elements, any trailing shape flattened), staging (world - 1,
// n), out (n) = cast(f32(x) + f32(staging[0]) + ... + f32(staging[world -
// 2])), which is world * x: every slot carries x. f32 or bf16.
//
// Replaces: triton_distributed_tpu/kernels/allreduce.py:158
//   _oneshot_ar_loopback_kernel (via oneshot_ar_loopback :174), whose fold
//   is common.reduce_slots_tiled (common.py:231) with me = 0: the own
//   contribution first, read straight from x, then the slots in rank
//   order, then ONE cast; it waits on one receive semaphore per source
//   (:163-166).
//
// What bounds it on the H100: bytes. The staging is written once and read
//   once, x read once and out written once: (2 (world - 1) + 2) n bytes of
//   the element size, 20.97 MB at bench.py's (128, 5,120) bf16 at world 8,
//   ~6.3 us at 3.35 TB/s. No arithmetic to speak of.
//
// What this design does about it: this is oneshot_ar.cu's design with one
//   owner whose every source is x (the items of oneshot_ar.cuh). On this
//   card a device-local copy runs on the SMs (ag_gemm_loopback.cu), so the
//   pushes are work items of the kernel itself. One persistent grid
//   (gemm_tile.cuh persistent_blocks) hands out items by an atomic ticket;
//   x is cut into chunks of whole 16 KB rounds of the block (the caller's
//   plan, kernels/allreduce.py oneshot_ar_plan).
//   - A push item (chunk c) loads x's chunk ONCE, every load of a round in
//     flight before its first store, stores it into each of the world - 1
//     slots, and after the block's barrier raises the world - 1 flags (c,
//     slot) to 1, each with a release (cumulative over the block's
//     stores).
//   - A fold item (chunk c) waits on its world - 1 flags with one lane of
//     warp 0 each, in parallel and without a sleep, meets the block at a
//     barrier, sets those flags back to 0, and folds: f32(x) read from x,
//     then the slots in order, every term's vector load in flight before
//     the first add, staged slots through L2 only; one cast.
//   - The ticket order puts chunk c's fold right behind chunk c + 1's push,
//     so a fold reads lines written moments before, from L2. A push never
//     waits and every push a fold waits on was handed out before it to a
//     running block: no deadlock, whatever the dispatch order.
//   One device operation a call: the ticket and the flags are cells of a
//   persistent per-stream buffer (kernels/_signal.py arrivals) that every
//   call leaves at 0 (every flag is raised once and lowered by its one
//   waiter; the block that takes the last ticket stores 0), so no memset
//   precedes the launch and no flag takes an epoch from the host; the
//   block count comes from the caller's cached plan
//   (tdt_oneshot_ar_loopback_blocks). delay_ns holds every push back before
//   its copy (a test of the waits: the result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"
#include "oneshot_ar.cuh"

namespace {

namespace lang = tdt::lang;
namespace os = tdt::oneshot;
using os::kThreads;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    ar_loopback_kernel(const T* __restrict__ x, T* staging,
                       T* __restrict__ out, uint32_t* flags, int* ticket,
                       long long n, long long chunk, int n_chunks, int slots,
                       unsigned long long delay_ns) {
  const int total = 2 * n_chunks;  // a push and a fold a chunk
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket, total + (int)gridDim.x - 1);
    if (t >= total) return;
    const os::Item it = os::item_of(t, 1, n_chunks);
    const long long e0 = (long long)it.c * chunk;
    const long long len = min(chunk, n - e0);
    uint32_t* chunk_flags = flags + (size_t)it.c * slots;  // one per slot
    if (it.push) {
      if (threadIdx.x == 0) lang::sleep_ns(delay_ns);
      __syncthreads();
      os::push<T, VEC>(x + e0, len, slots,
                       [&](int s) { return staging + (size_t)s * n + e0; });
      __syncthreads();  // every thread's stores precede the releases
      for (int s = threadIdx.x; s < slots; s += kThreads)
        lang::notify(chunk_flags + s, 1u);
      continue;
    }
    if (threadIdx.x < 32) {  // lane j waits on slots j, j + 32, ...
      for (int s = threadIdx.x; s < slots; s += 32)
        lang::wait(chunk_flags + s, 1u, 0);
      __syncwarp();
    }
    __syncthreads();
    lang::consume_token();
    for (int s = threadIdx.x; s < slots; s += kThreads)
      chunk_flags[s] = 0u;  // their one waiter is past them
    os::fold<T, VEC>(out + e0, len, slots + 1, 0, [&](int src) {
      return src == 0 ? x + e0 : staging + (size_t)(src - 1) * n + e0;
    });
    // take_ticket starts at a barrier: nothing here is read again.
  }
}

bool valid(long long n_chunks, long long world) {
  // The ticket counts up to 2 x chunks + blocks - 1 < 4 x chunks.
  return n_chunks >= 1 && world >= 1 && world <= 4096 &&
         n_chunks * 4 <= INT32_MAX;
}

}  // namespace

// The persistent grid of a call of n_chunks chunks, into *blocks (the
// caller's plan keeps it): the vector kernel's residency for dtype (0 f32,
// 1 bf16). A launch of the scalar kernel with as many blocks is safe too:
// a block takes a ticket only while it runs.
extern "C" int tdt_oneshot_ar_loopback_blocks(long long n_chunks,
                                              long long world, int dtype,
                                              void* blocks) {
  if (!valid(n_chunks, world)) return cudaErrorInvalidValue;
  unsigned* b = static_cast<unsigned*>(blocks);
  if (dtype == tdt::kF32)
    return tdt::gemm::persistent_blocks(ar_loopback_kernel<float, true>,
                                        kThreads, 0, 2 * n_chunks, b);
  if (dtype == tdt::kBF16)
    return tdt::gemm::persistent_blocks(
        ar_loopback_kernel<__nv_bfloat16, true>, kThreads, 0, 2 * n_chunks,
        b);
  return cudaErrorInvalidValue;
}

// x, out (n elements), staging (world - 1, n; may be null at world 1);
// flags (n_chunks x (world - 1) uint32 cells) and ticket (one int32), all
// 0 on entry and left at 0 by the kernel; n_chunks = ceil(n / chunk) and
// blocks from tdt_oneshot_ar_loopback_blocks; dtype 0 f32, 1 bf16;
// delay_ns holds every push back (0 in use).
extern "C" int tdt_oneshot_ar_loopback(const void* x, void* staging,
                                       void* out, void* flags, void* ticket,
                                       long long n, long long chunk,
                                       long long n_chunks, long long world,
                                       long long blocks, int dtype,
                                       unsigned long long delay_ns,
                                       void* stream) {
  using tdt::gemm::aligned16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || chunk <= 0 || n_chunks != (n + chunk - 1) / chunk ||
      !valid(n_chunks, world) || (world > 1 && !staging) || blocks < 1 ||
      blocks > 2 * n_chunks)
    return cudaErrorInvalidValue;
  const int slots = (int)(world - 1);
  const bool aligned = aligned16(x) && aligned16(out) &&
                       (slots == 0 || aligned16(staging));
  if (dtype == tdt::kF32) {
    auto kernel = aligned && n % 4 == 0 && chunk % 4 == 0
                      ? ar_loopback_kernel<float, true>
                      : ar_loopback_kernel<float, false>;
    kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(staging),
        static_cast<float*>(out), static_cast<uint32_t*>(flags),
        static_cast<int*>(ticket), n, chunk, (int)n_chunks, slots, delay_ns);
  } else if (dtype == tdt::kBF16) {
    auto kernel = aligned && n % 8 == 0 && chunk % 8 == 0
                      ? ar_loopback_kernel<__nv_bfloat16, true>
                      : ar_loopback_kernel<__nv_bfloat16, false>;
    kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(staging),
        static_cast<__nv_bfloat16*>(out), static_cast<uint32_t*>(flags),
        static_cast<int*>(ticket), n, chunk, (int)n_chunks, slots, delay_ns);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
