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
// What bounds it on the H100: the bytes. The products (2 world world E
//   cap d f over every rank: Qwen3-30B-A3B's 128 experts at world 8, cap
//   128, d 2,048, f 96 are 4.1e11, ~0.42 ms at the bf16 peak) hide under
//   the gather, which stands in for the link (NVLink is not exercised on
//   one card): world x world x E x cap x d elements of staging, 4.3 GB at
//   that shape, written once. With the source grids (0.54 GB), the weights
//   (0.40 GB) and the output (0.20 GB) the floor with the staging kept is
//   ~5.44 GB, ~1.62 ms at 3.35 TB/s, if every staged row is read back from
//   L2. Measured on an H100, it is not: the staging's 4.3 GB are written at
//   ~2.5 TB/s and read back at about the same rate from device memory in
//   both orders tried (every producer first, or each expert chunk's
//   consumers right behind its producers), so the kernel runs at ~3.4 ms,
//   the sum of its producers alone (~1.7 ms) and its consumers alone
//   reading device memory (~1.7 ms; ~1.2 ms with their operands
//   L2-resident: the tile itself is ~2x the library's product). Why the
//   staged rows leave L2 before their consumers read them is not measured
//   yet. At decode (cap 8) the bytes of every rank's weight shard, read
//   once.
//
// What this design does about it: the items are ag_gemm.cuh's, the dense
//   AG-GEMM's (ag_gemm.cu) with the expert a field of each item. A producer
//   item reads CHUNK_BYTES of rows of one source's expert grid (whole
//   experts at decode) once, with bulk copies through shared memory (96 KB
//   in flight a block, one thread), stores them into every rank's staging
//   and raises one flag per rank. A consumer tile is (rank, expert, row
//   tile, column tile) over the rank's gathered (world cap, d) rows: at
//   f_local 96 wgmma_tile.cuh's 256 x 96 wgmma tile fed by TMA (no masked
//   column, each weight shard read by four row tiles instead of eight; 128
//   x 96 when the plane has 128 rows or fewer, as at decode), a ragged f
//   on 128-wide tiles whose edge TMA zero-fills and the store cuts, a K
//   that is no multiple of 64 zero-filled too. Every producer item is
//   handed out before the first consumer tile, expert chunk by chunk. A
//   tile waits only on the flags of the (source, chunk) pairs its rows
//   touch; at cap 8 one row tile covers every source, so each
//   weight shard is read once. Rows past a (source, expert) count are zero
//   in the grid and are multiplied like any other (the plain version does
//   the same). bf16 rows that TMA cannot read (d or f no multiple of 8, a
//   base not 16-byte aligned: the wrapper's tma) run the same items on
//   gemm_tile.cuh's mma.sync tile in the same one launch, as the JAX kernel
//   takes such shapes; f32 keeps the SIMT tile, full f32.
#include "ag_gemm.cuh"

namespace {

TDT_AG_KERNELS(ag_group_gemm)

}  // namespace

// grids (world, E, cap, d), w (world, E, d, f), out (world, E, world cap,
// f), staging (world, E, world, cap, d); flags (world x world x ceil(E /
// ec) x ceil(cap / chunk_rows), uint32, raised to epoch); ticket (one int32
// of scratch, zeroed here on the stream); a producer chunk is ec experts x
// chunk_rows rows (ec > 1 only with chunk_rows = cap); dtype 0 f32, 1 bf16;
// tma 1 when TMA can read every bf16 operand (d and f multiples of 8,
// 16-byte aligned pointers: the wgmma tile), 0 for the mma.sync tile;
// delay_ns holds every producer back (0 in use).
extern "C" int tdt_ag_group_gemm(const void* grids, void* staging,
                                 const void* w, void* out, void* flags,
                                 void* ticket, unsigned epoch,
                                 long long world, long long E, long long cap,
                                 long long d, long long f, long long ec,
                                 long long chunk_rows, int dtype, int tma,
                                 unsigned long long delay_ns, void* stream) {
  if (ec > 1 && chunk_rows < cap) return cudaErrorInvalidValue;
  return tdt::ag::launch(ag_group_gemm_kernel_wgmma<256, 96>,
                         ag_group_gemm_kernel_wgmma<128, 96>,
                         ag_group_gemm_kernel_wgmma<128, 128>,
                         ag_group_gemm_kernel_mma, ag_group_gemm_kernel_f32,
                         grids, staging, w, out, flags, ticket, epoch, world,
                         E, cap, d, f, f, ec, chunk_rows, dtype, tma,
                         delay_ns, static_cast<cudaStream_t>(stream));
}
