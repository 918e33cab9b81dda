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
//   atomic ticket: first the producer items, chunk-major (for chunk c, rank
//   d, then its peers src = d + 1, d + 2, ... mod world: copy x[src]'s chunk
//   into staging[d]'s slot with language.cuh's putmem_signal, which raises
//   the slot's flag for that chunk to the call's epoch), then one fold item
//   per (chunk, rank): one thread waits on the chunk's world - 1 flags, the
//   block meets at a barrier, and each thread folds 16-byte vectors (eight
//   bf16 or four f32) in f32 registers in the fixed order above, staged
//   values loaded through L2 only. A producer never waits and a block takes
//   a ticket only while it runs, so every flag a fold waits on belongs to a
//   running block: no deadlock, whatever the dispatch order. delay_ns holds
//   every producer item back before its copy (a test of the waits: the
//   result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"
#include "vec.cuh"

namespace {

namespace lang = tdt::lang;
using tdt::vec::Vec;
constexpr int kThreads = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    oneshot_ar_kernel(const T* __restrict__ x, T* staging,
                      T* __restrict__ out, uint32_t* flags, int* ticket,
                      uint32_t epoch, long long n, long long chunk,
                      int n_chunks, int world, unsigned long long delay_ns) {
  const int peers = world - 1;
  const int producers = n_chunks * world * peers;
  const int total = producers + n_chunks * world;
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    if (t < producers) {  // chunk c of rank src into rank d's slot
      const int c = t / (world * peers), d = (t / peers) % world;
      const int src = (d + 1 + t % peers) % world, slot = src - (src > d);
      const long long e0 = (long long)c * chunk;
      const long long len = min(chunk, n - e0);
      lang::sleep_ns(delay_ns);
      lang::putmem_signal(
          staging + ((size_t)d * peers + slot) * n + e0,
          x + (size_t)src * n + e0, len * sizeof(T),
          flags + ((size_t)d * peers + slot) * n_chunks + c, epoch);
      continue;
    }
    const int u = t - producers, c = u / world, d = u % world;
    if (threadIdx.x == 0)
      for (int slot = 0; slot < peers; ++slot)
        lang::wait(flags + ((size_t)d * peers + slot) * n_chunks + c, epoch);
    __syncthreads();
    lang::consume_token();
    const long long e0 = (long long)c * chunk;
    tdt::vec::fold_slots<T, VEC>(x + (size_t)d * n + e0,
                                 staging + (size_t)d * peers * n + e0, n,
                                 out + (size_t)d * n + e0, world, d,
                                 min(chunk, n - e0));
    // take_ticket starts at a barrier: nothing here is read again.
  }
}

template <typename T>
cudaError_t launch(const void* x, void* staging, void* out, void* flags,
                   void* ticket, unsigned epoch, long long n, long long chunk,
                   int world, unsigned long long delay_ns, cudaStream_t s) {
  using tdt::gemm::aligned16;
  constexpr int P = Vec<T>::N;
  const long long n_chunks = (n + chunk - 1) / chunk;
  const bool vec = n % P == 0 && chunk % P == 0 && aligned16(x) &&
                   aligned16(out) && aligned16(staging);
  auto kernel = vec ? oneshot_ar_kernel<T, true>
                    : oneshot_ar_kernel<T, false>;
  unsigned blocks = 0;
  cudaError_t err = tdt::gemm::persistent_blocks(
      kernel, kThreads, 0, n_chunks * world * world, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(staging), static_cast<T*>(out),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch, n,
      chunk, (int)n_chunks, world, delay_ns);
  return cudaGetLastError();
}

}  // namespace

// x, out (world, n), staging (world, world - 1, n); flags (world x (world -
// 1) x ceil(n / chunk), uint32, raised to epoch); ticket (one int32 of
// scratch, zeroed here on the stream); dtype 0 f32, 1 bf16; delay_ns holds
// every producer item back (0 in use).
extern "C" int tdt_oneshot_ar(const void* x, void* staging, void* out,
                              void* flags, void* ticket, unsigned epoch,
                              long long world, long long n, long long chunk,
                              int dtype, unsigned long long delay_ns,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 2 || n <= 0 || chunk <= 0 || !staging || world > 4096)
    return cudaErrorInvalidValue;
  if (((n + chunk - 1) / chunk) * world * world > INT32_MAX)
    return cudaErrorInvalidValue;
  if (dtype == tdt::kF32)
    return launch<float>(x, staging, out, flags, ticket, epoch, n, chunk,
                         (int)world, delay_ns, s);
  if (dtype == tdt::kBF16)
    return launch<__nv_bfloat16>(x, staging, out, flags, ticket, epoch, n,
                                 chunk, (int)world, delay_ns, s);
  return cudaErrorInvalidValue;
}
