// Multi-rank direct-push allgather with world simulated ranks on one card:
// every rank stores its shard into its segment of every rank's output. x
// (world, seg): rank r's shard of seg bytes; out (world, world seg): out[d]
// holds the shards in rank order. Any element type (the kernel moves
// bytes).
//
// Replaces: triton_distributed_tpu/kernels/allgather.py:125 _a2a_ag_kernel
//   (via a2a_all_gather :207 at world > 1): after an entry barrier every
//   rank starts world - 1 remote copies of its shard into segment `me` of
//   each peer's output, copies it into its own, and waits on one receive
//   semaphore per source (:127-152).
//
// What bounds it on the H100: bytes. The function reads every rank's shard
//   once and writes every rank's gathered copy once: (world + world^2) seg
//   bytes (NVLink is not exercised on one card).
//
// What this design does about it: a work item is one piece (16 KB) of one
//   (source, destination) pair, and the grid is sized to what the card
//   holds at once (gemm_tile.cuh persistent_blocks), each block striding
//   over the items. No item reads what another writes within the launch:
//   every item reads x and writes its own bytes of out. So the kernel has
//   no flags and no entry barrier. The TPU kernel's barrier_all (:131)
//   guards that every peer's output is live before it is written remotely;
//   on one card every buffer exists before the launch, and the stream
//   orders the launch after whatever wrote them. delay_ns holds every item
//   back before it stores (nothing waits on it: the result must not
//   change).
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    a2a_ag_kernel(const char* __restrict__ x, char* __restrict__ out,
                  long long seg, long long piece, long long n_pieces,
                  int world, unsigned long long delay_ns) {
  const long long total = (long long)world * world * n_pieces;
  const size_t row = (size_t)world * seg;  // bytes of one rank's output
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    // Destination-major, so consecutive blocks fill one output.
    const int dst = (int)(t / (world * n_pieces));
    const int src = (int)((t / n_pieces) % world);
    const long long p0 = (t % n_pieces) * piece;
    tdt::lang::sleep_ns(delay_ns);
    tdt::lang::copy_block(out + (size_t)dst * row + (size_t)src * seg + p0,
                          x + (size_t)src * seg + p0,
                          (size_t)min(piece, seg - p0));
  }
}

}  // namespace

// x (world, seg bytes), out (world, world seg bytes); delay_ns holds every
// item back (0 in use).
extern "C" int tdt_a2a_ag(const void* x, void* out, long long world,
                          long long seg, long long piece,
                          unsigned long long delay_ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 2 || seg <= 0 || piece <= 0 || world > 4096)
    return cudaErrorInvalidValue;
  const long long n_pieces = (seg + piece - 1) / piece;
  unsigned blocks = 0;
  cudaError_t err = tdt::gemm::persistent_blocks(
      a2a_ag_kernel, kThreads, 0, world * world * n_pieces, &blocks);
  if (err != cudaSuccess) return err;
  a2a_ag_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const char*>(x), static_cast<char*>(out), seg, piece,
      n_pieces, (int)world, delay_ns);
  return cudaGetLastError();
}
