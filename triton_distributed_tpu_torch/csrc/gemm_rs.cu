// Multi-rank GEMM + reduce-scatter with world simulated ranks on one card:
// every rank's partial product a[r] @ b[r] is reduce-scattered by row
// segment. a (world, M, k), b (world, k, N), out (world, M / world, N):
// out[d] = cast(sum over src = 0 .. world - 1, in that order, in f32, of
// rank src's partial of segment d), where a remote partial is rounded to
// the output dtype before it is pushed and the owner's own partial stays
// f32. staging (world, world - 1, m, N) holds the pushed partials
// (staging[d][peer_slot(src, d)] = cast(partial_src[d])). f32 or bf16 in
// and out.
//
// Replaces: triton_distributed_tpu/kernels/gemm_reduce_scatter.py:76
//   _gemm_rs_kernel (via gemm_rs_device :171 at world > 1), whose fold
//   (:124-160) starts an f32 accumulator at zero and adds, for src = 0 ..
//   world - 1, the own f32 partial or the staged partial in f32, then
//   casts once; its own segment (_own_segment) stays in VMEM.
//
// What bounds it on the H100: at prefill the operations of every rank's
//   product (2 world M k N: 1.07e12 at Qwen3-32B's TP = 8 shapes, M 4,096,
//   k 3,200, N 5,120, ~1.09 ms at the published bf16 peak, 989 TFLOP/s
//   at 700 W); at decode (M = batch) the bytes of B (each rank's (k, N)
//   shard read once): 3.35 TB/s. The pushes add a write and a read of
//   world (world - 1) m N elements of scratch that stands in for the link
//   (NVLink is not exercised on one card).
//
// What this design does about it: the TPU kernel walks destination
//   segments dst = (me + 1 + s) mod world, pushes each finished remote tile
//   from a VMEM parity buffer, and folds its own segment last. Here the
//   ranks are a field of each work item of one persistent grid (no larger
//   than the card holds at once, gemm_tile.cuh persistent_blocks) that
//   hands out items by an atomic ticket; the items are gemm_rs.cuh's, with
//   one expert. bf16 runs wgmma_tile.cuh's 128 x 128 wgmma tile fed by TMA,
//   the operations' tile (the mma.sync tile ran at ~3x torch.matmul on an
//   H100 80GB HBM3 at 700.00 W, PERF.md). At prefill (m 512, a multiple of
//   the tile) the owner's product tile is its fold item: it stays in
//   registers and shared memory, waits on the seven remote tiles of its
//   rows and folds them, so no f32 scratch is written or read back; the
//   products go rank by rank, as a plain GEMM's tiles do, then the folds
//   (2.35 ms against 3.43 with each fold ticketed behind its producers, as
//   GroupGEMM-RS's are: H100 80GB HBM3 at 700.00 W,
//   scripts/torch_gemm_rs_before_after.py --breakdown). At decode (m = 1)
//   one row tile covers every segment and B is read once: product tiles
//   write the owner's rows in f32 and separate fold items follow, per
//   column tile. Each tile leaves through shared memory as 16-byte
//   vectors, its rows' owners found once a row. A fold waits on the flags
//   of the tiles over its rows (its producers have smaller tickets: no
//   deadlock) and folds 16-byte vectors in the fixed order. f32 keeps the SIMT tile; bf16 rows that TMA cannot read
//   take gemm_tile.cuh's mma.sync tile with an element-wise epilogue, in
//   the same one launch. delay_ns holds every product tile back before it
//   releases its flag (a test of the waits: the result must not change).
#include "gemm_rs.cuh"

namespace {

TDT_RS_KERNELS(gemm_rs, false)

}  // namespace

// a (world, M, k), b (world, k, N), out (world, M / world, N), staging
// (world, world - 1, M / world, N), own (world, M / world, N) f32, or null
// for a bf16 call with tma and M / world a multiple of 128 (the owner's
// product folded in place); flags (world x ceil(M / tile) x ceil(N /
// tile), uint32, raised to epoch); ticket (one int32 of scratch, zeroed
// here on the stream); dtype 0 f32, 1 bf16; tma 1 when TMA can read every
// bf16 operand (k and N multiples of 8, 16-byte aligned pointers: the
// wgmma tile), 0 for the mma.sync tile; delay_ns holds every product tile
// back (0 in use).
extern "C" int tdt_gemm_rs(const void* a, const void* b, void* out,
                           void* staging, void* own, void* flags,
                           void* ticket, unsigned epoch, long long world,
                           long long M, long long k, long long N, int dtype,
                           int tma, unsigned long long delay_ns,
                           void* stream) {
  return gemm_rs_launch(a, b, out, staging, own, flags, ticket, epoch, world,
                        1, M, k, N, dtype, tma, delay_ns,
                        static_cast<cudaStream_t>(stream));
}
