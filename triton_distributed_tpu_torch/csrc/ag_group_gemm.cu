// Multi-rank AG-GroupGEMM with world simulated ranks on one card: every
// rank's per-expert capacity grid is allgathered into every rank's
// staging, and each rank multiplies every source's rows of each expert by
// its f shard of that expert's weight, tile by tile as the rows arrive.
// grids (world, E, cap, d): source src's routed tokens, empty slots zero;
// w (world, E, d, f): rank r's column shard of every expert's up weight;
// out (world, E, world cap, f): out[r][e][src cap + i] = grids[src][e][i] @
// w[r][e]; staging (world, E, world, cap, d): staging[r][e][src] =
// grids[src][e], rank r's gathered grid of expert e in absolute source
// order. f32 or bf16 in and out, f32 accumulation.
//
// Replaces: triton_distributed_tpu/kernels/moe_overlap.py:85
//   _ag_group_gemm_kernel (via ag_group_gemm_device :144 at world > 1): the
//   AG-GEMM of allgather_gemm.py with an expert dimension. Its grid walks
//   (segment, expert, f tile, k tile) with src = (me + s) mod world and
//   waits on a source's receive semaphore when it first touches it.
//
// What bounds it on the H100: at prefill the operations (2 world world E
//   cap d f over every rank: Qwen3-30B-A3B's 128 experts at world 8, cap
//   128, d 2,048, f 96 are 4.1e11, ~0.42 ms at the bf16 peak); at decode
//   (cap 8) the bytes of every rank's weight shard, read once. The gather
//   adds a write and a read of world x world x E x cap x d elements:
//   scratch that stands in for the link (NVLink is not exercised on one
//   card).
//
// What this design does about it: the items are ag_gemm.cuh's, the dense
//   AG-GEMM's (ag_gemm.cu) with the expert a field of each item. A producer
//   item copies ec whole experts of one source's grid (cap rows each) into
//   one rank's staging and raises one flag; a consumer tile is (rank,
//   expert, row tile, column tile) over the rank's gathered (world cap, d)
//   rows of that expert, handed out expert by expert within a rank so the
//   blocks running at once share the expert's weight in L2, its rows in the
//   rank's segment order (own grid first, then src = r + 1, r + 2, ...). A
//   tile waits only on the flags of the (source, expert chunk) pairs its
//   rows touch: at cap 128 one source, at cap 8 all of them (one row tile
//   then covers every source, so each weight shard is read once). f 96 is
//   narrower than the 128-column tile: product_tile masks the columns past
//   f. Rows past a (source, expert) count are zero in the grid and are
//   multiplied like any other (the plain version does the same).
#include "ag_gemm.cuh"

namespace {

using tdt::gemm::bf16;
using tdt::gemm::TileOf;

template <typename T, bool VEC>
__global__ void __launch_bounds__(TileOf<T>::threads)
    ag_group_gemm_kernel(const T* __restrict__ A, T* S,
                         const T* __restrict__ B, T* __restrict__ C,
                         uint32_t* flags, int* ticket, uint32_t epoch,
                         tdt::ag::Geometry g, unsigned long long delay_ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  tdt::ag::run_items<T, VEC>(A, S, B, C, flags, ticket, epoch, g, delay_ns,
                             smem);
}

}  // namespace

// grids (world, E, cap, d), w (world, E, d, f), out (world, E, world cap,
// f), staging (world, E, world, cap, d); flags (world x world x ceil(E /
// ec), uint32, raised to epoch); ticket (one int32 of scratch, zeroed here
// on the stream); ec experts per producer chunk; dtype 0 f32, 1 bf16;
// delay_ns holds every producer back (0 in use).
extern "C" int tdt_ag_group_gemm(const void* grids, void* staging,
                                 const void* w, void* out, void* flags,
                                 void* ticket, unsigned epoch,
                                 long long world, long long E, long long cap,
                                 long long d, long long f, long long ec,
                                 int dtype, unsigned long long delay_ns,
                                 void* stream) {
  tdt::ag::Geometry g;
  if (!staging || !tdt::ag::make_geometry(world, E, cap, d, f, f, ec, cap,
                                          dtype, &g))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kF32)
    return tdt::ag::launch<float>(ag_group_gemm_kernel<float, true>,
                                  ag_group_gemm_kernel<float, false>, grids,
                                  staging, w, out, flags, ticket, epoch, g,
                                  delay_ns, s);
  if (dtype == tdt::kBF16)
    return tdt::ag::launch<bf16>(ag_group_gemm_kernel<bf16, true>,
                                 ag_group_gemm_kernel<bf16, false>, grids,
                                 staging, w, out, flags, ticket, epoch, g,
                                 delay_ns, s);
  return cudaErrorInvalidValue;
}
