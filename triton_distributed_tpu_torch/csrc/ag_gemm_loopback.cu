// One-chip AG-GEMM loopback: A "allgathered" into a staging buffer chunk
// by chunk, and a consumer GEMM whose tiles wait on the arrival flags of
// the rows they read before they load them. out1 = staged A @ B[:, :cols],
// A (M, K) in `segments` row segments, B (K, n) with cols <= n, out1
// (M, cols), bf16 in and out, f32 accumulation.
//
// Replaces: triton_distributed_tpu/kernels/allgather_gemm.py:484
//   _ag_gemm_loopback_kernel (via ag_gemm_loopback :543) and, without the
//   staging (staging == null), :600 _ag_gemm_segmented_bare_kernel (via
//   ag_gemm_segmented_bare :631).
//
// What bounds it on the H100: the product's operations (2 M K cols, ~295
//   per byte moved at the Qwen3-32B TP=8 shape, (4,096 x 5,120) x (5,120 x
//   3,200)), 989 TFLOP/s dense bf16. The staging adds one read and one
//   write of A (2 x 42 MB at that shape, ~0.025 ms of HBM time).
//
// What this design does about it: on the TPU the local DMA engine copies
//   while the MXU computes. On this card every device-local copy
//   (cudaMemcpyAsync, cudaMemcpy2DAsync, cuMemcpyDtoDAsync, a peer copy to
//   itself, cudaMemcpyBatchAsync with its overlap hint) runs on the SMs:
//   measured on an H100, such a copy on a side stream never starts once
//   consumer blocks spinning on its flag hold every SM slot, so a copy
//   "engine" outside the kernel deadlocks whenever the consumer reaches the
//   card first. The copies are therefore the first work items of the
//   consumer kernel itself: ag_gemm.cuh's items at world 1 with one expert.
//   The grid is persistent (no larger than the card holds at once) and an
//   atomic ticket hands out work in order: first the producer items (chunks
//   of gcd(segment rows, 16) rows of A, so no chunk straddles a segment, in
//   segment order), then the consumer tiles (row tile by row tile, which is
//   segment order). A producer never waits, and a block takes a ticket only
//   while it runs, so every flag a consumer waits on belongs to a running
//   producer: no deadlock, whatever the dispatch order.
//
//   bf16 rows that TMA can read (K and n multiples of 8, 16-byte aligned
//   bases: the wrapper's tma) run ag_gemm.cuh's WgPath. A producer item is
//   thread 0 moving its chunk with bulk copies through the block's shared
//   memory (wgmma_tile.cuh bulk_copy, 96 KB in flight), then raising the
//   chunk's flag to the call's epoch once every byte has landed. A
//   consumer tile is wgmma_tile.cuh's 128 x 128 wgmma tile fed by TMA from
//   the staging and B (B's map covers all n columns; the store masks those
//   past cols): its thread 0 acquires the flags of the chunks its rows
//   touch (first touch) and fences the async proxy before its first TMA
//   load of staged rows. Other rows run the same items on gemm_tile.cuh's
//   mma.sync tile in the same one launch (TilePath: every thread copies).
//   The bare variant has no producer items and no waits: its tiles read A.
//
//   The ticket lives in a persistent buffer (kernels/_signal.py arrivals)
//   that the block taking the last ticket leaves at 0, and the host caches
//   the kernel's shared-memory attribute and its persistent block count:
//   a call is one device operation, the launch. delay_ns holds every
//   producer item back before its copy (a test of the waits: the result
//   must not change).
#include "ag_gemm.cuh"

namespace {

TDT_AG_KERNELS(ag_loopback)

// Launch `kernel` over the persistent grid of g's items: its shared
// memory limit raised once, its block count from the cached occupancy.
template <class Kernel, class... Args>
cudaError_t launch_items(Kernel kernel, int threads, int smem,
                         const tdt::ag::Geometry& g, cudaStream_t s,
                         Args... args) {
  using namespace tdt::gemm;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = persistent_blocks(kernel, threads, smem, g.total, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// a (M, K), b (K, n), out (M, cols). staging (M, K) with flags (M /
// chunk_rows of them, uint32, raised to epoch) for the loopback, or null
// for the segmented bare variant. ticket: one int32, 0 on entry and left
// at 0 by the kernel. tma 1 when TMA can read every operand (K and n
// multiples of 8, 16-byte aligned a, staging and b: the wgmma tile), 0 for
// the mma.sync tile. delay_ns holds every producer back (0 in use).
extern "C" int tdt_ag_gemm_loopback(const void* a, void* staging,
                                    const void* b, void* out, void* flags,
                                    void* ticket, unsigned epoch, long long M,
                                    long long cols, long long n, long long K,
                                    long long chunk_rows, int tma,
                                    unsigned long long delay_ns,
                                    void* stream) {
  namespace ag = tdt::ag;
  using tdt::gemm::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || cols <= 0 || cols > n || K <= 0 || chunk_rows <= 0 ||
      M % chunk_rows)
    return cudaErrorInvalidValue;
  const bool staged = staging != nullptr;
  const bf16* A = static_cast<const bf16*>(a);
  // The rows the consumers read: the staging, or A itself when bare.
  bf16* S = staged ? static_cast<bf16*>(staging) : const_cast<bf16*>(A);
  bf16* C = static_cast<bf16*>(out);
  uint32_t* fl = static_cast<uint32_t*>(flags);
  int* tk = static_cast<int*>(ticket);
  ag::Geometry g;
  if (tma) {
    const int bn = ag::tile_n(cols), bm = ag::tile_m(bn, M);
    CUtensorMap ta, tb;
    if (!ag::tma_ready(a, S, b, K, n) ||
        !ag::make_geometry(1, 1, M, K, n, cols, 1, chunk_rows, bm, bn, &g,
                           staged) ||
        !tdt::wg::encode_a(&ta, S, K, M, 1, bm) ||
        !tdt::wg::encode_b(&tb, b, n, K, 1))
      return cudaErrorInvalidValue;
    constexpr int T = tdt::wg::THREADS, SM = tdt::wg::SMEM_BYTES;
    if (bm == 256)
      return launch_items(ag_loopback_kernel_wgmma<256, 96>, T, SM, g, s,
                          ta, tb, A, S, C, fl, tk, epoch, g, delay_ns);
    if (bn == 96)
      return launch_items(ag_loopback_kernel_wgmma<128, 96>, T, SM, g, s,
                          ta, tb, A, S, C, fl, tk, epoch, g, delay_ns);
    return launch_items(ag_loopback_kernel_wgmma<128, 128>, T, SM, g, s, ta,
                        tb, A, S, C, fl, tk, epoch, g, delay_ns);
  }
  if (!ag::make_geometry(1, 1, M, K, n, cols, 1, chunk_rows, tdt::gemm::BM,
                         tdt::gemm::BN, &g, staged))
    return cudaErrorInvalidValue;
  return launch_items(ag_loopback_kernel_mma, tdt::gemm::THREADS,
                      tdt::gemm::SMEM_BYTES, g, s, A, S,
                      static_cast<const bf16*>(b), C, fl, tk, epoch, g,
                      delay_ns);
}
