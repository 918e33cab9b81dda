// Multi-rank low-latency allgather into persistent double-buffered staging,
// with world simulated ranks on one card. x (world, seg): rank r's shard of
// seg bytes; staging (world, 2, world - 1, seg): rank d's two epoch-parity
// halves of world - 1 source slots, slot peer_slot(src, d) = src - (src >
// d); out (world, world seg): every rank's gathered copy. Any element type
// (the kernel moves bytes).
//
// Replaces: triton_distributed_tpu/kernels/ll_allgather.py:55 _ll_ag_kernel
//   (via ll_all_gather_device :98 at world > 1): with p = epoch % 2, every
//   rank pushes its shard into staging[peer][p][peer_slot(me, peer)] of
//   every peer, with no entry barrier (the staging persists across calls),
//   copies its own shard into its output, and for every source waits on the
//   (p, src) receive semaphore and copies that slot into output segment src
//   (:75-95). The parity-(1 - p) half is never read or written.
//
// What bounds it on the H100: bytes. The function reads every rank's shard
//   once and writes every rank's gathered copy once: (world + world^2) seg
//   bytes. The staging (written by the pushes, read by the copies out) is
//   the protocol's scratch and stands in for the link.
//
// What this design does about it: the ranks are a field of each work item
//   of one persistent grid (gemm_tile.cuh persistent_blocks), an item being
//   one piece (16 KB) of one shard, and an atomic ticket hands out first
//   the pushes (source, destination, piece), then the own copies, then the
//   copies out of the staging. A push stores its piece into the slot and
//   sets the piece's flag to 1; a copy out waits until its flag reads 1
//   (language.cuh), copies the piece, and sets the flag back to 0 once
//   every thread of its block has read it. The pushes were handed out
//   first and run on blocks that hold them, so no wait can deadlock. The
//   flags are the TPU's per-call receive semaphores made persistent: every
//   flag a call raises is lowered by the same call, so every call starts
//   and ends with them at 0, and no flag an earlier call left can satisfy
//   a wait of a later one, however the caller numbers its epochs (a
//   restart at 0 included). The epoch is read on the device from a 0-d
//   int32 tensor when one is given, else taken as a value. delay_ns holds
//   every push back before it stores (a test of the waits: the result must
//   not change).
//
// One device operation a call, and one round trip a piece: the ticket is a
//   cell of a persistent per-stream buffer (kernels/_signal.py arrivals)
//   that the kernel leaves at 0 (every block takes exactly one ticket past
//   the work, and the block that takes the last of them stores 0), so no
//   memset precedes the launch; the block count comes from the caller's
//   cached plan (tdt_ll_allgather_blocks), so the launch makes no query.
//   Every copy is lang::copy_rounds: a 16 KB piece is four 16-byte loads a
//   thread, all in flight before the first store (copy_block's tail loop
//   would make them four dependent round trips). A push releases its flag
//   with st.release after the block's barrier (cumulative over the block's
//   stores). Each block takes its next ticket while its item runs, so no
//   item waits for a ticket's round trip after the first; a block then
//   holds a ticket it has not started, which is safe: the held ticket is
//   larger than the running one, so a block that waits holds only copies
//   out or the end, and every push it waits on is held by a block that is
//   running a push or an own copy, neither of which waits.
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // 16-byte moves a thread: up to 32 KB a round

__global__ void __launch_bounds__(kThreads)
    ll_allgather_kernel(const char* __restrict__ x, char* staging, char* out,
                        uint32_t* flags, int* ticket, const int* epoch_ptr,
                        long long epoch_val, long long seg, long long piece,
                        int n_pieces, int world,
                        unsigned long long delay_ns) {
  const int W = world, peers = W - 1;
  const long long e = epoch_ptr ? (long long)*epoch_ptr : epoch_val;
  const int p = (int)(((e % 2) + 2) % 2);
  const int pushes = W * peers * n_pieces;
  const int own = W * n_pieces;
  const int total = 2 * pushes + own;
  const size_t row = (size_t)W * seg;  // bytes of one rank's output
  // Rank d's half p: (world - 1) slots of seg bytes; flags (d, p, slot, q).
  auto slot_at = [&](int d, int slot) {
    return staging + (((size_t)d * 2 + p) * peers + slot) * seg;
  };
  auto flag_at = [&](int d, int slot, int q) {
    return flags + (((size_t)d * 2 + p) * peers + slot) * n_pieces + q;
  };
  auto copy = [&](char* dst, const char* src, long long p0) {
    lang::copy_rounds<kUnroll>(dst + p0, src + p0,
                               (size_t)min(piece, seg - p0), threadIdx.x,
                               kThreads);
  };
  __shared__ int s_ticket;
  int ahead = -1;
  for (;;) {
    if (threadIdx.x == 0)
      s_ticket = ahead >= 0 ? ahead : atomicAdd(ticket, 1);
    __syncthreads();
    const int t = s_ticket;
    __syncthreads();  // every thread has read it before it is rewritten
    if (t >= total) {  // the last block out leaves the ticket at 0
      if (threadIdx.x == 0 && t == total + (int)gridDim.x - 1) *ticket = 0;
      return;
    }
    if (threadIdx.x == 0) ahead = atomicAdd(ticket, 1);
    const int q = t % n_pieces;
    const long long p0 = (long long)q * piece;
    if (t < pushes) {  // source s's piece q into rank d's slot
      const int i = t / n_pieces;
      const int s = i / peers, d = (s + 1 + i % peers) % W;
      const int slot = s - (s > d);
      lang::sleep_ns(delay_ns);
      copy(slot_at(d, slot), x + (size_t)s * seg, p0);
      __syncthreads();  // every thread's stores precede the release
      if (threadIdx.x == 0) lang::notify(flag_at(d, slot, q), 1u);
      continue;
    }
    if (t < pushes + own) {  // the own shard straight to the output
      const int r = (t - pushes) / n_pieces;
      copy(out + (size_t)r * row + (size_t)r * seg, x + (size_t)r * seg, p0);
      continue;
    }
    // Rank d copies source s's arrived piece q into its output.
    const int i = (t - pushes - own) / n_pieces;
    const int d = i / peers, slot = i % peers, s = slot + (slot >= d);
    uint32_t* flag = flag_at(d, slot, q);
    if (threadIdx.x == 0) lang::wait(flag, 1u);
    __syncthreads();
    lang::consume_token();
    copy(out + (size_t)d * row + (size_t)s * seg, slot_at(d, slot), p0);
    __syncthreads();  // every thread has read the piece
    if (threadIdx.x == 0) *flag = 0u;
  }
}

}  // namespace

// The persistent grid of a call of world ranks and n_pieces pieces a
// shard, into *blocks (the caller's plan keeps it).
extern "C" int tdt_ll_allgather_blocks(long long world, long long n_pieces,
                                       void* blocks) {
  // The ticket counts up to work + blocks - 1 < 2 x work.
  if (world < 2 || world > 4096 || n_pieces < 1 ||
      (2 * world * (world - 1) + world) * n_pieces * 2 > INT32_MAX)
    return cudaErrorInvalidValue;
  return tdt::gemm::persistent_blocks(
      ll_allgather_kernel, kThreads, 0,
      (2 * world * (world - 1) + world) * n_pieces,
      static_cast<unsigned*>(blocks));
}

// x (world, seg bytes), staging (world, 2, world - 1, seg bytes), out
// (world, world seg bytes); flags (world x 2 x (world - 1) x n_pieces,
// uint32, all 0 on entry and on return); ticket (one int32, 0 on entry and
// left at 0 by the kernel); epoch_ptr (nullable: one int32 on the card) or
// epoch_val; n_pieces = ceil(seg / piece) and blocks from
// tdt_ll_allgather_blocks; delay_ns holds every push back (0 in use).
extern "C" int tdt_ll_allgather(const void* x, void* staging, void* out,
                                void* flags, void* ticket,
                                const void* epoch_ptr, long long epoch_val,
                                long long world, long long seg,
                                long long piece, long long n_pieces,
                                long long blocks,
                                unsigned long long delay_ns, void* stream) {
  if (world < 2 || world > 4096 || seg <= 0 || piece <= 0 || !staging ||
      n_pieces != (seg + piece - 1) / piece ||
      (2 * world * (world - 1) + world) * n_pieces * 2 > INT32_MAX ||
      blocks < 1 ||
      blocks > (2 * world * (world - 1) + world) * n_pieces)
    return cudaErrorInvalidValue;
  ll_allgather_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<char*>(staging),
      static_cast<char*>(out), static_cast<uint32_t*>(flags),
      static_cast<int*>(ticket), static_cast<const int*>(epoch_ptr),
      epoch_val, seg, piece, (int)n_pieces, (int)world, delay_ns);
  return cudaGetLastError();
}
