// Multi-rank ring allgather with world simulated ranks on one card: world -
// 1 ring steps, each forwarding the shard that arrived at the step before,
// and each rank's own shard copied into its output. x (world, seg): rank
// r's shard of seg bytes; out (world, world seg): out[d] holds the shards
// in rank order. Any element type (the kernel moves bytes).
//
// Replaces: triton_distributed_tpu/kernels/allgather.py:87 _ring_ag_kernel
//   (via ring_all_gather :196 at world > 1). Its order: the own shard into
//   its slot, then at step s = 0 .. world - 2 rank r forwards chunk (r - s)
//   mod world to rank r + 1, into the same segment of r + 1's output, the
//   chunk it forwards at step s + 1 being the one that arrived at step s
//   (:99-114).
//
// What bounds it on the H100: bytes. The function reads every rank's shard
//   once and writes every rank's gathered copy once: (world + world^2) seg
//   bytes. The ring's reads of the forwarded segments stand in for the
//   link (NVLink is not exercised on one card).
//
// What this design does about it: this is twoshot_ar.cu's allgather leg
//   alone, and ring_rs.cu without the add. The ranks are a field of each
//   work item of one persistent grid (gemm_tile.cuh persistent_blocks), an
//   item being one piece (16 KB) of one shard, and an atomic ticket hands
//   the items out by ring step: first every rank's own copy (out[r][r] from
//   x[r]), then every rank's step 0, then step 1, and so on. Step 0 reads
//   the shard from x; an item of step s > 0 reads the piece from its own
//   output, where step s - 1 of its left neighbour stored it, after waiting
//   on that item's flag (language.cuh). Those items were handed out before
//   it and run on blocks that hold them, so no wait can deadlock, whatever
//   the dispatch order. A step item copies its piece into the right
//   neighbour's output with putmem_signal (16-byte moves through L2, the
//   block meets at a barrier, one thread releases the piece's flag to the
//   call's epoch). delay_ns holds back every item that waits on nothing
//   (the own copies and step 0) before it stores (a test of the waits: the
//   result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ring_ag_kernel(const char* __restrict__ x, char* out, uint32_t* flags,
                   int* ticket, uint32_t epoch, long long seg,
                   long long piece, int n_pieces, int world,
                   unsigned long long delay_ns) {
  const int W = world, peers = W - 1;
  const int per_step = W * n_pieces;
  const int total = W * per_step;  // the own copies, then world - 1 steps
  const size_t row = (size_t)W * seg;  // bytes of one rank's output
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    const int u = t / per_step, r = (t / n_pieces) % W, q = t % n_pieces;
    const long long p0 = (long long)q * piece;
    const size_t len = (size_t)min(piece, seg - p0);
    if (u == 0) {  // the own shard into its slot
      lang::sleep_ns(delay_ns);
      lang::copy_block(out + (size_t)r * row + (size_t)r * seg + p0,
                       x + (size_t)r * seg + p0, len);
      continue;  // take_ticket starts at a barrier
    }
    const int step = u - 1, c = ((r - step) % W + W) % W;
    const char* src;
    if (step == 0) {
      lang::sleep_ns(delay_ns);
      src = x + (size_t)r * seg + p0;
    } else {  // chunk c landed here at step - 1
      if (threadIdx.x == 0)
        lang::wait(flags + ((size_t)r * peers + step - 1) * n_pieces + q,
                   epoch);
      __syncthreads();
      lang::consume_token();
      src = out + (size_t)r * row + (size_t)c * seg + p0;
    }
    const int right = (r + 1) % W;
    lang::putmem_signal(out + (size_t)right * row + (size_t)c * seg + p0, src,
                        len,
                        flags + ((size_t)right * peers + step) * n_pieces + q,
                        epoch);
  }
}

}  // namespace

// x (world, seg bytes), out (world, world seg bytes); flags (world x (world
// - 1) x ceil(seg / piece), uint32, raised to epoch); ticket (one int32 of
// scratch, zeroed here on the stream); delay_ns holds the items that wait
// on nothing back (0 in use).
extern "C" int tdt_ring_ag(const void* x, void* out, void* flags, void* ticket,
                           unsigned epoch, long long world, long long seg,
                           long long piece, unsigned long long delay_ns,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 2 || seg <= 0 || piece <= 0 || world > 4096)
    return cudaErrorInvalidValue;
  const long long n_pieces = (seg + piece - 1) / piece;
  if (world * world * n_pieces > INT32_MAX) return cudaErrorInvalidValue;
  unsigned blocks = 0;
  cudaError_t err = tdt::gemm::persistent_blocks(
      ring_ag_kernel, kThreads, 0, world * world * n_pieces, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  ring_ag_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const char*>(x), static_cast<char*>(out),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch, seg,
      piece, (int)n_pieces, (int)world, delay_ns);
  return cudaGetLastError();
}
