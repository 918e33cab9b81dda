// Multi-rank AG-GEMM with world simulated ranks on one card: every rank's A
// shard is allgathered into every rank's staging, and each rank's product
// of its gathered A against its own B shard waits, tile by tile, on the
// arrival flags of the rows it reads. a (world, m, K), b (world, K, n),
// out (world, world m, cols) with cols <= n: out[d] = gathered_d @
// b[d][:, :cols], and staging (world, world, m, K): staging[d][src] = a[src],
// rank d's gathered A in absolute rank order. f32 or bf16 in and out, f32
// accumulation.
//
// Replaces: triton_distributed_tpu/kernels/allgather_gemm.py:304
//   _ag_gemm_kernel (via ag_gemm_device :368 at world > 1). The columns
//   past cols (the JAX split, _resolve_overlap_cols :183) run in
//   matmul_tail_into.cu over each rank's staging, as the JAX wrapper does
//   (:478-480).
//
// What bounds it on the H100: at prefill the products' operations (2 world
//   (world m) K cols); at decode (m = 1) the bytes of B (each rank's (K, n)
//   shard read once): 3.35 TB/s. The gather adds a write and a read of
//   world x world x m x K elements: scratch that stands in for the link
//   (NVLink is not exercised on one card).
//
// What this design does about it: the TPU kernel pushes its shard to every
//   peer by DMA at its first grid step and walks its segments in the order
//   src = (me + s) mod world, waiting on a segment's receive semaphore when
//   it first touches it. Here the pushes are work items of the kernel
//   itself (a device-local copy runs on the SMs: ag_gemm_loopback.cu), and
//   the ranks are a field of each item, not blocks of a cooperative launch:
//   one persistent grid no larger than the card holds at once (gemm_tile.cuh
//   persistent_blocks) hands out items by an atomic ticket. The items are
//   ag_gemm.cuh's, with one expert: rank d's producers (chunk c of a[(d +
//   s) mod world] into staging[d] by bulk copies, flag (d, src, c) raised
//   to the call's epoch) are handed out ahead of rank d's consumer tiles,
//   wgmma_tile.cuh's 128 x 128 wgmma tiles fed by TMA over the rank's
//   gathered A in absolute rows (a tile may span segments, so at m = 1 one
//   row tile covers every segment and B is read once), each rank's in its
//   segment order. A consumer's thread 0 waits on the flag of every chunk
//   its rows touch (first touch) and only then issues the TMA loads of the
//   staged rows. Every flag waited on belongs to an earlier ticket: no
//   deadlock, whatever the dispatch order. delay_ns holds every producer
//   item back before its copy (a test of the waits: the result must not
//   change). bf16 rows that TMA cannot read (K or n no multiple of 8, a
//   base not 16-byte aligned: the wrapper's tma) run the same items on
//   gemm_tile.cuh's mma.sync tile in the same one launch, as the JAX kernel
//   takes such shapes; f32 keeps the SIMT tile, full f32.
#include "ag_gemm.cuh"

namespace {

TDT_AG_KERNELS(ag_gemm)

}  // namespace

// a (world, m, K), b (world, K, n), out (world, world m, cols), staging
// (world, world, m, K); flags (world x world x ceil(m / chunk_rows), uint32,
// raised to epoch); ticket (one int32 of scratch, zeroed here on the
// stream); dtype 0 f32, 1 bf16; tma 1 when TMA can read every bf16 operand
// (K and n multiples of 8, 16-byte aligned pointers: the wgmma tile), 0
// for the mma.sync tile; delay_ns holds every producer back (0 in use).
extern "C" int tdt_ag_gemm(const void* a, void* staging, const void* b,
                           void* out, void* flags, void* ticket,
                           unsigned epoch, long long world, long long m,
                           long long K, long long n, long long cols,
                           long long chunk_rows, int dtype, int tma,
                           unsigned long long delay_ns, void* stream) {
  return tdt::ag::launch(ag_gemm_kernel_wgmma<256, 96>,
                         ag_gemm_kernel_wgmma<128, 96>,
                         ag_gemm_kernel_wgmma<128, 128>, ag_gemm_kernel_mma,
                         ag_gemm_kernel_f32, a, staging, b, out, flags,
                         ticket, epoch, world, 1, m, K, n, cols, 1,
                         chunk_rows, dtype, tma, delay_ns,
                         static_cast<cudaStream_t>(stream));
}
