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
// (staging[dst][peer_slot(src, dst)][e]). f32 or bf16 in and out.
//
// Replaces: triton_distributed_tpu/kernels/moe_overlap.py:268
//   _group_gemm_rs_kernel (via group_gemm_rs_device :346 at world > 1): the
//   GEMM-RS of gemm_reduce_scatter.py with an expert dimension. Its fold
//   (:323-336) starts an f32 accumulator at zero and adds, for src = 0 ..
//   world - 1, its own f32 partial (_own_segment :314-339, kept in VMEM) or
//   the pushed tile (rounded to the output dtype) in f32, then casts once.
//
// What bounds it on the H100: at prefill the bytes (the 65,536 filled rows
//   of act, every weight shard and the output: 0.31 ms at Qwen3-30B-A3B's
//   width, world 8, cap 128; the operations, 4.1e11 over whole grids, ~0.42
//   ms at the published bf16 peak, 989 TFLOP/s at 700 W); at decode (cap
//   8) the bytes of every rank's weight shard, read once. The pushes add a
//   write and a read of world (world - 1) E cap d elements (3.76 GB at the
//   prefill): scratch that stands in for the link (NVLink is not exercised
//   on one card). Staging written once and read back from L2 puts the
//   floor at ~4.9 GB, ~1.5 ms at 3.35 TB/s.
//
// What this design does about it: the items are gemm_rs.cuh's, the dense
//   GEMM-RS's (gemm_rs.cu) with the expert a field of each item, on
//   wgmma_tile.cuh's 128 x 128 tile fed by TMA (f = 96 is two 64-deep K
//   steps, the second zero-filled). The time followed the 2.15e9 partials,
//   not K (scripts/torch_gemm_rs_scaling.py, H100 80GB HBM3 at 700.00 W):
//   one 2- or 4-byte store per element behind a division, every partial
//   written to device memory and read back, products first. Now, at
//   prefill (cap 128, a multiple of the tile), tickets come in groups of
//   eight: the seven remote product tiles
//   of one output tile (owner, expert, rows, columns), then its fold item,
//   which computes the owner's own tile into registers, waits on the seven
//   flags and folds the pushes while they are still in L2 (one group's
//   pushes are 224 KB; the groups in flight on 132 SMs ~30 MB of the 50
//   MB L2); groups go expert by expert, so the blocks running together
//   share one expert's weight. No f32 scratch of own partials exists. A
//   tile leaves through shared memory as 16-byte vectors from neighbouring
//   threads, its destination found once a row. At decode (cap 8) a tile's
//   64 rows straddle every segment: products write the owner's rows in f32
//   and fold items follow per (expert, column tile). f32 keeps the SIMT
//   tile; bf16 rows that TMA cannot read take gemm_tile.cuh's mma.sync tile
//   with an element-wise epilogue, in the same one launch.
#include "gemm_rs.cuh"

namespace {

TDT_RS_KERNELS(group_gemm_rs, false)

}  // namespace

// act (world, E, world cap, f), w (world, E, f, d), out (world, E, cap, d),
// staging (world, world - 1, E, cap, d), own (world, E, cap, d) f32, or
// null for a bf16 call with tma and cap a multiple of 128 (the owner's
// product folded in place); flags (world x E x ceil(world cap / tile) x
// ceil(d / tile), uint32, raised to epoch); ticket (one int32 of scratch,
// zeroed here on the stream); dtype 0 f32, 1 bf16; tma 1 when TMA can read
// every bf16 operand (f and d multiples of 8, 16-byte aligned pointers: the
// wgmma tile), 0 for the mma.sync tile; delay_ns holds every product tile
// back (0 in use).
extern "C" int tdt_group_gemm_rs(const void* act, const void* w, void* out,
                                 void* staging, void* own, void* flags,
                                 void* ticket, unsigned epoch,
                                 long long world, long long E, long long cap,
                                 long long f, long long d, int dtype, int tma,
                                 unsigned long long delay_ns, void* stream) {
  return group_gemm_rs_launch(act, w, out, staging, own, flags, ticket, epoch,
                              world, E, world * cap, f, d, dtype, tma,
                              delay_ns, static_cast<cudaStream_t>(stream));
}
