// Multi-rank one-shot all-reduce with world simulated ranks on one card:
// every rank pushes its whole buffer into a staging slot of every peer,
// and every rank folds the world contributions in one fixed order. x
// (world, n), staging (world, world - 1, n) with staging[d][peer_slot(src,
// d)] = x[src], out (world, n): out[d] = cast(x[0] + x[1] + ... + x[world -
// 1]) summed in f32 in that order, the own term read from x, so every
// rank's copy is the same bits. f32 or bf16.
//
// Replaces: triton_distributed_tpu/kernels/allreduce.py:74
//   _oneshot_ar_kernel (via oneshot_all_reduce :109 at world > 1), whose
//   fold is common.reduce_slots_tiled (common.py:231): acc = f32 of the
//   term of src 0, += the terms of src = 1 .. world - 1, then ONE cast.
//
// What bounds it on the H100: bytes. The function reads every rank's x once
//   and writes every rank's output once: 2 world n elements. The pushes
//   (a write and a read of world (world - 1) n elements) are scratch that
//   stands in for the link (NVLink is not exercised on one card).
//
// What this design does about it: the TPU kernel starts world - 1 remote
//   DMAs, waits on one receive semaphore per source and folds in VMEM row
//   tiles. Here the ranks are a field of each work item of one persistent
//   grid (gemm_tile.cuh persistent_blocks) that hands out items by an
//   atomic ticket. x is cut into chunks of whole 16 KB rounds of the block
//   (the wrapper's plan: 16 KB at the decode-sized calls, more rounds a
//   chunk once there would be over 1,024 chunks).
//   - A push item (chunk c, source src) loads x[src]'s chunk ONCE, every
//     load of a round in flight before its first store, stores it into
//     its slot at each of the world - 1 peers, and after the block's
//     barrier raises the one flag (c, src) with a release (cumulative over
//     the block's stores) to the call's epoch. x is read once, not world -
//     1 times.
//   - A fold item (chunk c, rank d) waits on the world - 1 flags (c, src !=
//     d) with one lane of warp 0 per flag, in parallel, meets the block at
//     a barrier, and each thread then loads a vector (eight bf16 or four
//     f32) of every source, eight sources in flight before the first add,
//     staged slots through L2 only; the adds run in f32 in rank order, so
//     the bits are those above.
//   - The ticket order puts chunk c's folds right behind chunk c + 1's
//     pushes (pushes of chunk 0, then for each c: pushes of c + 1, folds of
//     c; kernels/allreduce.py oneshot_ar_items is the same order in
//     Python), so a fold reads lines its producers wrote moments before,
//     from L2. Every flag a fold waits on belongs to an item handed out
//     before it to a running block, and a push never waits: no deadlock,
//     whatever the dispatch order.
//   - One device operation a call: the ticket lives in a persistent buffer
//     (kernels/_signal.py arrivals) that the last block out leaves at 0; no
//     cudaMemsetAsync before the launch.
//   The items (their order, the push and the fold) are oneshot_ar.cuh's,
//   shared with oneshot_ar_loopback.cu (one owner whose every source is x).
//   delay_ns holds every push back before its copy (a test of the waits:
//   the result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"
#include "oneshot_ar.cuh"

namespace {

namespace lang = tdt::lang;
namespace os = tdt::oneshot;
using os::kThreads;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    oneshot_ar_kernel(const T* __restrict__ x, T* staging,
                      T* __restrict__ out, uint32_t* flags, int* ticket,
                      uint32_t epoch, long long n, long long chunk,
                      int n_chunks, int world, unsigned long long delay_ns) {
  const int W = world, total = 2 * n_chunks * W;
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) {  // the last block out leaves the ticket at 0
      if (threadIdx.x == 0 && t == total + (int)gridDim.x - 1) *ticket = 0;
      return;
    }
    const os::Item it = os::item_of(t, W, n_chunks);
    const long long e0 = (long long)it.c * chunk;
    const long long len = min(chunk, n - e0);
    uint32_t* chunk_flags = flags + (size_t)it.c * W;  // one per source
    if (it.push) {
      if (threadIdx.x == 0) lang::sleep_ns(delay_ns);
      __syncthreads();
      const int src = it.r;
      os::push<T, VEC>(x + (size_t)src * n + e0, len, W - 1, [&](int k) {
        const int d = k + (k >= src);  // every peer but the source
        return staging + ((size_t)d * (W - 1) + src - (src > d)) * n + e0;
      });
      __syncthreads();  // every thread's stores precede the release
      if (threadIdx.x == 0) lang::notify(chunk_flags + it.r, epoch);
      continue;
    }
    if (threadIdx.x < 32) {  // lane j waits on sources j, j + 32, ...
      for (int src = threadIdx.x; src < W; src += 32)
        if (src != it.r) lang::wait(chunk_flags + src, epoch, 0);
      __syncwarp();
    }
    __syncthreads();
    lang::consume_token();
    const int d = it.r;
    os::fold<T, VEC>(out + (size_t)d * n + e0, len, W, d, [&](int src) {
      return src == d
                 ? x + (size_t)d * n + e0
                 : staging + ((size_t)d * (W - 1) + src - (src > d)) * n + e0;
    });
    // take_ticket starts at a barrier: nothing here is read again.
  }
}

template <typename T>
cudaError_t launch(const void* x, void* staging, void* out, void* flags,
                   void* ticket, unsigned epoch, long long n, long long chunk,
                   int world, unsigned long long delay_ns, cudaStream_t s) {
  using tdt::gemm::aligned16;
  constexpr int P = tdt::vec::Vec<T>::N;
  const long long n_chunks = (n + chunk - 1) / chunk;
  const bool vec = n % P == 0 && chunk % P == 0 && aligned16(x) &&
                   aligned16(out) && aligned16(staging);
  auto kernel = vec ? oneshot_ar_kernel<T, true>
                    : oneshot_ar_kernel<T, false>;
  unsigned blocks = 0;
  const cudaError_t err = tdt::gemm::persistent_blocks(
      kernel, kThreads, 0, 2 * n_chunks * world, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(staging), static_cast<T*>(out),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch, n,
      chunk, (int)n_chunks, world, delay_ns);
  return cudaGetLastError();
}

}  // namespace

// x, out (world, n), staging (world, world - 1, n); flags (ceil(n / chunk)
// x world, uint32, raised to epoch: one per (chunk, source)); ticket (one
// int32, 0 on entry and left at 0 by the kernel); dtype 0 f32, 1 bf16;
// delay_ns holds every push back (0 in use).
extern "C" int tdt_oneshot_ar(const void* x, void* staging, void* out,
                              void* flags, void* ticket, unsigned epoch,
                              long long world, long long n, long long chunk,
                              int dtype, unsigned long long delay_ns,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 2 || n <= 0 || chunk <= 0 || !staging || world > 4096)
    return cudaErrorInvalidValue;
  // The ticket counts up to 2 x chunks x world + blocks - 1.
  if (((n + chunk - 1) / chunk) * world * 4 > INT32_MAX)
    return cudaErrorInvalidValue;
  if (dtype == tdt::kF32)
    return launch<float>(x, staging, out, flags, ticket, epoch, n, chunk,
                         (int)world, delay_ns, s);
  if (dtype == tdt::kBF16)
    return launch<__nv_bfloat16>(x, staging, out, flags, ticket, epoch, n,
                                 chunk, (int)world, delay_ns, s);
  return cudaErrorInvalidValue;
}
