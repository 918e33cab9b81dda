// Multi-rank GroupGEMM + reduce-scatter with world simulated ranks on one
// card: every rank's per-expert down-projection partial is reduce-scattered
// over the ranks by capacity segment. act (world, E, world cap, f): rank
// r's activations of every source's rows of expert e (ag_group_gemm.cu's
// output layout); w (world, E, f, d): rank r's row shard of every expert's
// down weight; out (world, E, cap, d): out[dst][e] = cast(sum over src = 0
// .. world - 1, in that order, in f32, of rank src's partial act[src][e]
// @ w[src][e] rows [dst cap, (dst + 1) cap)), a remote partial rounded to
// the output dtype before it is pushed, the owner's own partial kept in
// f32. staging (world, world - 1, E, cap, d) holds the pushes
// (staging[dst][peer_slot(src, dst)][e]), own (world, E, cap, d) f32 the
// owners' own partials. f32 or bf16 in and out.
//
// Replaces: triton_distributed_tpu/kernels/moe_overlap.py:268
//   _group_gemm_rs_kernel (via group_gemm_rs_device :346 at world > 1): the
//   GEMM-RS of gemm_reduce_scatter.py with an expert dimension. Its fold
//   (:323-336) starts an f32 accumulator at zero and adds, for src = 0 ..
//   world - 1, its own f32 partial or the pushed tile (rounded to the
//   output dtype) in f32, then casts once.
//
// What bounds it on the H100: at prefill the operations (2 world world E
//   cap f d over every rank: 4.1e11 at Qwen3-30B-A3B's width, world 8 and
//   cap 128, ~0.42 ms at the bf16 peak); at decode (cap 8) the bytes of
//   every rank's weight shard, read once. The pushes add a write and a read
//   of world (world - 1) E cap d elements: scratch that stands in for the
//   link (NVLink is not exercised on one card).
//
// What this design does about it: the items are gemm_rs.cuh's, the dense
//   GEMM-RS's (gemm_rs.cu) with the expert a field of each item. Product
//   tiles (rank, expert, row tile, column tile) come first, expert by
//   expert within a rank so the blocks running at once share the expert's
//   weight in L2, remote segments first; their epilogue writes the rank's
//   own segment in f32 and rounds every other row into its owner's staging
//   slot, and one thread releases the tile's flag. Fold items (owner,
//   expert, row tile, column tile) come last: they wait on the flags of
//   every source's product tiles over their rows and fold in the fixed
//   order. The contraction f = 96 is three of the tile's 32-deep K steps;
//   the 16-byte loads need k and d multiples of 8, which both are.
#include "gemm_rs.cuh"

namespace {

using tdt::gemm::bf16;
using tdt::gemm::TileOf;

template <typename T, bool VEC>
__global__ void __launch_bounds__(TileOf<T>::threads)
    group_gemm_rs_kernel(const T* __restrict__ A, const T* __restrict__ B,
                         T* __restrict__ out, T* staging, float* own,
                         uint32_t* flags, int* ticket, uint32_t epoch,
                         tdt::rs::Geometry g, unsigned long long delay_ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  tdt::rs::run_items<T, VEC>(A, B, out, staging, own, flags, ticket, epoch,
                             g, delay_ns, smem);
}

}  // namespace

// act (world, E, world cap, f), w (world, E, f, d), out (world, E, cap, d),
// staging (world, world - 1, E, cap, d), own (world, E, cap, d) f32; flags
// (world x E x ceil(world cap / tile) x ceil(d / tile), uint32, raised to
// epoch); ticket (one int32 of scratch, zeroed here on the stream); dtype
// 0 f32, 1 bf16; delay_ns holds every product tile back (0 in use).
extern "C" int tdt_group_gemm_rs(const void* act, const void* w, void* out,
                                 void* staging, void* own, void* flags,
                                 void* ticket, unsigned epoch,
                                 long long world, long long E, long long cap,
                                 long long f, long long d, int dtype,
                                 unsigned long long delay_ns, void* stream) {
  tdt::rs::Geometry g;
  if (!staging || !own ||
      !tdt::rs::make_geometry(world, E, world * cap, f, d, dtype, &g))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kF32)
    return tdt::rs::launch<float>(group_gemm_rs_kernel<float, true>,
                                  group_gemm_rs_kernel<float, false>, act, w,
                                  out, staging, own, flags, ticket, epoch, g,
                                  delay_ns, s);
  if (dtype == tdt::kBF16)
    return tdt::rs::launch<bf16>(group_gemm_rs_kernel<bf16, true>,
                                 group_gemm_rs_kernel<bf16, false>, act, w,
                                 out, staging, own, flags, ticket, epoch, g,
                                 delay_ns, s);
  return cudaErrorInvalidValue;
}
