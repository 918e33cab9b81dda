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
//   link (NVLink is not exercised on one card). At a decode-sized shard the
//   bytes take a few microseconds and the time is the chain: world - 1
//   dependent hops, each a wait, a copy and a release.
//
// What this design does about it: the ranks are a field of each work item
//   of one persistent grid (gemm_tile.cuh persistent_blocks), an item being
//   one piece of one shard (the caller's plan picks the piece from the
//   shard's bytes), and an atomic ticket hands the items out by ring step:
//   every rank's step 0, then step 1, and so on.
//   - A step-0 item loads x[r]'s piece once and stores it both into its own
//     slot out[r][r] and into out[r + 1][r]: the own copy is merged into
//     step 0, so x is read once.
//   - An item of step s > 0 waits on the flag of the piece that step s - 1
//     of its left neighbour stored into its output, spinning without a
//     sleep (the wait is on the chain), meets its block at a barrier, sets
//     the flag back to 0, reads the piece from its own output and stores it
//     into its right neighbour's output.
//   - Each thread's loads of a round are all issued before its first store
//     (up to 32 KB a round), so a decode-sized piece is one round trip.
//   - After the block's barrier one thread releases the piece's flag with
//     st.release (cumulative over the block's stores). The last step's
//     pieces are awaited by nobody and raise no flag.
//   Every item a step waits on belongs to the step before, handed out
//   earlier to a block that runs it, so no wait can deadlock, whatever the
//   dispatch order. A block takes its next ticket when its item is done,
//   not while it runs: at a decode-sized shard the grid holds a block for
//   every item, and a ticket taken ahead would pair two items of the chain
//   on one block while another block sits idle.
//
// One device operation a call: the ticket and the flags are cells of a
//   persistent per-stream buffer (kernels/_signal.py arrivals) that every
//   call leaves at 0 (every flag is raised once and lowered by its one
//   waiter; the block that takes the last ticket, gemm_tile.cuh
//   take_ticket(counter, last), stores 0), so no memset precedes the
//   launch and no flag takes an epoch from the host; the block count comes
//   from the caller's cached plan (tdt_ring_ag_blocks).
//   delay_ns holds back every item that waits on nothing (step 0) before
//   it stores (a test of the waits: the result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // 16-byte moves a thread: up to 32 KB a round

// src[0, nbytes) into dst and, unless null, into dst2, through L2 only:
// rounds of kUnroll 16-byte moves a thread, every load of a round issued
// before its first store, when the pointers and nbytes allow it, else
// bytes. Every thread of the block calls it.
__device__ __forceinline__ void forward(char* dst, char* dst2,
                                        const char* src, size_t nbytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(dst) |
                         reinterpret_cast<uintptr_t>(dst2) |
                         reinterpret_cast<uintptr_t>(src) | nbytes;
  if ((bits & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    uint4* d2 = reinterpret_cast<uint4*>(dst2);
    const size_t n16 = nbytes / 16;
    for (size_t i = threadIdx.x; i < n16; i += (size_t)kUnroll * kThreads) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i + (size_t)u * kThreads < n16)
          v[u] = __ldcg(s + i + (size_t)u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i + (size_t)u * kThreads < n16)
          __stcg(d + i + (size_t)u * kThreads, v[u]);
      if (d2) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (i + (size_t)u * kThreads < n16)
            __stcg(d2 + i + (size_t)u * kThreads, v[u]);
      }
    }
  } else {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
    unsigned char* d = reinterpret_cast<unsigned char*>(dst);
    unsigned char* d2 = reinterpret_cast<unsigned char*>(dst2);
    for (size_t i = threadIdx.x; i < nbytes; i += kThreads) {
      const unsigned char v = __ldcg(s + i);
      __stcg(d + i, v);
      if (d2) __stcg(d2 + i, v);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_ag_kernel(const char* __restrict__ x, char* out, uint32_t* flags,
                   int* ticket, long long seg, long long piece,
                   int n_pieces, int world, unsigned long long delay_ns) {
  const int W = world;
  const int per_step = W * n_pieces;
  const int total = (W - 1) * per_step;  // steps 0 .. world - 2
  const size_t row = (size_t)W * seg;    // bytes of one rank's output
  // Flag (d, s, q): piece q that step s stored into rank d's output; steps
  // 0 .. world - 3 raise one.
  auto flag_at = [&](int d, int s, int q) {
    return flags + ((size_t)d * (W - 2) + s) * n_pieces + q;
  };
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket, total + (int)gridDim.x - 1);
    if (t >= total) return;
    const int step = t / per_step, r = (t / n_pieces) % W, q = t % n_pieces;
    const int c = ((r - step) % W + W) % W, right = (r + 1) % W;
    const long long p0 = (long long)q * piece;
    const size_t len = (size_t)min(piece, seg - p0);
    const char* src;
    char* own = nullptr;
    if (step == 0) {  // x[r]'s piece, into its own slot too
      lang::sleep_ns(delay_ns);
      src = x + (size_t)r * seg + p0;
      own = out + (size_t)r * row + (size_t)r * seg + p0;
    } else {  // chunk c landed here at step - 1
      uint32_t* flag = flag_at(r, step - 1, q);
      if (threadIdx.x == 0) lang::wait(flag, 1u, 0);
      __syncthreads();
      lang::consume_token();
      if (threadIdx.x == 0) *flag = 0u;  // its one waiter is past it
      src = out + (size_t)r * row + (size_t)c * seg + p0;
    }
    forward(out + (size_t)right * row + (size_t)c * seg + p0, own, src, len);
    if (step < W - 2) {
      __syncthreads();  // every thread's stores precede the release
      if (threadIdx.x == 0) lang::notify(flag_at(right, step, q), 1u);
    }
  }
}

bool valid(long long world, long long n_pieces) {
  // The ticket counts up to items + blocks - 1 < 2 x items.
  return world >= 2 && world <= 4096 && n_pieces >= 1 &&
         (world - 1) * world * n_pieces * 2 <= INT32_MAX;
}

}  // namespace

// The persistent grid of a call of world ranks and n_pieces pieces a
// shard, into *blocks (the caller's plan keeps it).
extern "C" int tdt_ring_ag_blocks(long long world, long long n_pieces,
                                  void* blocks) {
  if (!valid(world, n_pieces)) return cudaErrorInvalidValue;
  return tdt::gemm::persistent_blocks(ring_ag_kernel, kThreads, 0,
                                      (world - 1) * world * n_pieces,
                                      static_cast<unsigned*>(blocks));
}

// x (world, seg bytes), out (world, world seg bytes); flags (world x (world
// - 2) x n_pieces uint32 cells, all 0 on entry and on return; none at world
// 2); ticket (one int32, 0 on entry and left at 0 by the kernel); n_pieces
// = ceil(seg / piece) and blocks from tdt_ring_ag_blocks; delay_ns holds
// the items that wait on nothing back (0 in use).
extern "C" int tdt_ring_ag(const void* x, void* out, void* flags, void* ticket,
                           long long world, long long seg, long long piece,
                           long long n_pieces, long long blocks,
                           unsigned long long delay_ns, void* stream) {
  if (!valid(world, n_pieces) || seg <= 0 || piece <= 0 ||
      n_pieces != (seg + piece - 1) / piece || blocks < 1 ||
      blocks > (world - 1) * world * n_pieces)
    return cudaErrorInvalidValue;
  ring_ag_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<char*>(out),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), seg, piece,
      (int)n_pieces, (int)world, delay_ns);
  return cudaGetLastError();
}
