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
//   consumer kernel itself. The grid is persistent (no larger than the
//   card holds at once) and an atomic ticket hands out work in order:
//   first the producer items (chunks of gcd(segment rows, 16) rows of A,
//   in segment order: each copied with 16-byte loads and stores, then its
//   flag raised to the call's epoch with a release store, language.cuh),
//   then the consumer tiles (128 x 128 outputs, in segment order). A
//   producer never waits, and a block takes a ticket only while it runs,
//   so every flag a consumer waits on belongs to a running producer: no
//   deadlock, whatever the dispatch order. A consumer's thread 0 waits on
//   the flags of the chunks its rows touch (first touch), the block meets
//   at a barrier, and the tile runs gemm_tile.cuh's mma.sync main loop over
//   the staged rows. The TPU kernel's VMEM double buffer of A segments is
//   the cp.async stage ring inside each block. The bare variant has no
//   staging, flags or producer items and keeps the same persistent grid,
//   ticket order and tiles. delay_ns holds every producer item back before
//   its copy (a test of the waits: the result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

using tdt::gemm::bf16;

template <bool VEC>
__global__ void __launch_bounds__(tdt::gemm::THREADS)
    ag_loopback_kernel(const bf16* __restrict__ A, bf16* S,
                       const bf16* __restrict__ B, bf16* __restrict__ C,
                       uint32_t* flags, int* ticket, uint32_t epoch, int M,
                       int cols, int ldb, int K, int chunk_rows,
                       unsigned long long delay_ns) {
  using namespace tdt::gemm;
  namespace lang = tdt::lang;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool staged = S != nullptr;
  const int producers = staged ? M / chunk_rows : 0;
  const int tiles_n = (cols + BN - 1) / BN;
  const int total = producers + ((M + BM - 1) / BM) * tiles_n;
  for (;;) {
    const int t = take_ticket(ticket);
    if (t >= total) return;
    if (t < producers) {  // stage one chunk of rows, then raise its flag
      const size_t base = (size_t)t * chunk_rows * K;
      lang::sleep_ns(delay_ns);
      lang::putmem_signal(S + base, A + base,
                          (size_t)chunk_rows * K * sizeof(bf16), flags + t,
                          epoch);
      continue;
    }
    const int tile = t - producers;  // tiles in segment order
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    if (staged) {
      if (threadIdx.x == 0) {
        const int last = min(m0 + BM, M) - 1;
        for (int c = m0 / chunk_rows; c <= last / chunk_rows; ++c)
          lang::wait(flags + c, epoch);
      }
      __syncthreads();
    }
    Acc acc;
    bf16_mainloop<VEC>(staged ? S : A, K, B, ldb, M, cols, K, m0, n0, smem,
                       acc);
    for_each_pair(acc, m0, n0, [&](int gr, int gc, float x0, float x1) {
      if (gr < M) store_pair<VEC>(C + (size_t)gr * cols, gc, cols, x0, x1);
    });
    // bf16_mainloop ends at a barrier, so shared memory is free for the
    // next ticket's tile.
  }
}

}  // namespace

// a (M, K), b (K, n), out (M, cols). staging (M, K) with flags (M /
// chunk_rows of them, uint32) for the loopback, or null for the segmented
// bare variant. ticket: one int32 of scratch, zeroed here on the stream.
extern "C" int tdt_ag_gemm_loopback(const void* a, void* staging,
                                    const void* b, void* out, void* flags,
                                    void* ticket, unsigned epoch, long long M,
                                    long long cols, long long n, long long K,
                                    long long chunk_rows,
                                    unsigned long long delay_ns,
                                    void* stream) {
  using namespace tdt::gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || cols <= 0 || cols > n || K < 0 || chunk_rows <= 0 ||
      M % chunk_rows || M > INT32_MAX || n > INT32_MAX || K > INT32_MAX)
    return cudaErrorInvalidValue;
  const long long producers = staging ? M / chunk_rows : 0;
  const long long total = producers + ((M + BM - 1) / BM) *
                                          ((cols + BN - 1) / BN);
  if (total > INT32_MAX) return cudaErrorInvalidValue;
  const bool vec = K % 8 == 0 && n % 8 == 0 && cols % 8 == 0 &&
                   aligned16(a) && aligned16(b) && aligned16(out) &&
                   (!staging || aligned16(staging));
  auto kernel = vec ? ag_loopback_kernel<true> : ag_loopback_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  unsigned blocks = 0;
  if ((err = persistent_blocks(kernel, total, &blocks)) != cudaSuccess ||
      (err = cudaMemsetAsync(ticket, 0, sizeof(int), s)) != cudaSuccess)
    return err;
  kernel<<<blocks, THREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(a), static_cast<bf16*>(staging),
      static_cast<const bf16*>(b), static_cast<bf16*>(out),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch,
      (int)M, (int)cols, (int)n, (int)K, (int)chunk_rows, delay_ns);
  return cudaGetLastError();
}
