// Multi-rank GEMM + reduce-scatter with world simulated ranks on one card:
// every rank's partial product a[r] @ b[r] is reduce-scattered by row
// segment. a (world, M, k), b (world, k, N), out (world, M / world, N):
// out[d] = cast(sum over src = 0 .. world - 1, in that order, in f32, of
// rank src's partial of segment d), where a remote partial is rounded to
// the output dtype before it is pushed and the owner's own partial stays
// f32. staging (world, world - 1, m, N) holds the pushed partials
// (staging[d][peer_slot(src, d)] = cast(partial_src[d])), own (world, m, N)
// f32 the owners' own partials. f32 or bf16 in and out.
//
// Replaces: triton_distributed_tpu/kernels/gemm_reduce_scatter.py:76
//   _gemm_rs_kernel (via gemm_rs_device :171 at world > 1), whose fold
//   (:124-160) starts an f32 accumulator at zero and adds, for src = 0 ..
//   world - 1, the own f32 partial or the staged partial in f32, then
//   casts once.
//
// What bounds it on the H100: at prefill the operations of every rank's
//   product (2 world M k N); at decode (M = batch) the bytes of B (each
//   rank's (k, N) shard read once): 3.35 TB/s. The pushes add a write and
//   a read of world (world - 1) m N elements of scratch that stands in for
//   the link (NVLink is not exercised on one card).
//
// What this design does about it: the TPU kernel walks destination
//   segments dst = (me + 1 + s) mod world, pushes each finished remote tile
//   from a VMEM parity buffer, and folds its own segment last. Here the
//   ranks are a field of each work item of one persistent grid (no larger
//   than the card holds at once, gemm_tile.cuh persistent_blocks) that
//   hands out items by an atomic ticket. First the product tiles: tile
//   (r, mt, nt) of rank r's full (M, N) product, rank by rank (the blocks
//   running at once then share one rank's B in L2), rank r's step j being
//   its row tile (tile of row ((r + 1) mod world) m + j) mod tiles, so
//   remote segments come first (at decode one row tile: B read once);
//   its epilogue writes each row to its owner: rows of r's own segment in
//   f32 into own, every other row rounded to the output dtype into its
//   owner's staging slot. The block meets at a barrier and one thread
//   releases the tile's flag to the call's epoch (language.cuh). Then the
//   fold items (d, row tile of segment d, column tile): one thread waits on
//   the flags of every product tile that covers these rows, for each src,
//   the block meets, and each thread folds 16-byte vectors of its elements
//   (eight bf16 or four f32 outputs at once, when N allows) in the fixed
//   order above, loads through L2 only, and casts once. A product tile never
//   waits and a block takes a ticket only while it runs, so every flag a
//   fold waits on belongs to a running block: no deadlock, whatever the
//   dispatch order. delay_ns holds every product tile back before it
//   releases its flag (a test of the waits: the result must not change).
//   The items are gemm_rs.cuh's, with one expert.
#include "gemm_rs.cuh"

namespace {

using tdt::gemm::bf16;
using tdt::gemm::TileOf;

template <typename T, bool VEC>
__global__ void __launch_bounds__(TileOf<T>::threads)
    gemm_rs_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ out, T* staging, float* own,
                   uint32_t* flags, int* ticket, uint32_t epoch,
                   tdt::rs::Geometry g, unsigned long long delay_ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  tdt::rs::run_items<T, VEC>(A, B, out, staging, own, flags, ticket, epoch,
                             g, delay_ns, smem);
}

}  // namespace

// a (world, M, k), b (world, k, N), out (world, M / world, N), staging
// (world, world - 1, M / world, N), own (world, M / world, N) f32; flags
// (world x ceil(M / tile) x ceil(N / tile), uint32, raised to epoch);
// ticket (one int32 of scratch, zeroed here on the stream); dtype 0 f32,
// 1 bf16; delay_ns holds every product tile back (0 in use).
extern "C" int tdt_gemm_rs(const void* a, const void* b, void* out,
                           void* staging, void* own, void* flags,
                           void* ticket, unsigned epoch, long long world,
                           long long M, long long k, long long N, int dtype,
                           unsigned long long delay_ns, void* stream) {
  tdt::rs::Geometry g;
  if (!staging || !own ||
      !tdt::rs::make_geometry(world, 1, M, k, N, dtype, &g))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kF32)
    return tdt::rs::launch<float>(gemm_rs_kernel<float, true>,
                                  gemm_rs_kernel<float, false>, a, b, out,
                                  staging, own, flags, ticket, epoch, g,
                                  delay_ns, s);
  if (dtype == tdt::kBF16)
    return tdt::rs::launch<bf16>(gemm_rs_kernel<bf16, true>,
                                 gemm_rs_kernel<bf16, false>, a, b, out,
                                 staging, own, flags, ticket, epoch, g,
                                 delay_ns, s);
  return cudaErrorInvalidValue;
}
