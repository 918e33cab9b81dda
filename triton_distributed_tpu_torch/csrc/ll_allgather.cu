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
//   copies out of the staging. A push stores its piece into the slot with
//   putmem_signal and sets the piece's flag to 1; a copy out waits until
//   its flag reads 1 (language.cuh), copies the piece, and sets the flag
//   back to 0 once every thread of its block has read it. The pushes were
//   handed out first and run on blocks that hold them, so no wait can
//   deadlock. The flags are the TPU's per-call receive semaphores made
//   persistent: every flag a call raises is lowered by the same call, so
//   every call starts and ends with them at 0, and no flag an earlier call
//   left can satisfy a wait of a later one, however the caller numbers its
//   epochs (a restart at 0 included). The epoch is read on the device from
//   a 0-d int32 tensor when one is given, else taken as a value. delay_ns
//   holds every push back before it stores (a test of the waits: the
//   result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;

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
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    if (t < pushes) {  // source s's piece q into rank d's slot
      const int q = t % n_pieces, i = t / n_pieces;
      const int s = i / peers, d = (s + 1 + i % peers) % W;
      const int slot = s - (s > d);
      const long long p0 = (long long)q * piece;
      lang::sleep_ns(delay_ns);
      lang::putmem_signal(slot_at(d, slot) + p0, x + (size_t)s * seg + p0,
                          (size_t)min(piece, seg - p0), flag_at(d, slot, q),
                          1u);
      continue;  // take_ticket starts at a barrier
    }
    if (t < pushes + own) {  // the own shard straight to the output
      const int u = t - pushes, r = u / n_pieces, q = u % n_pieces;
      const long long p0 = (long long)q * piece;
      lang::copy_block(out + (size_t)r * row + (size_t)r * seg + p0,
                       x + (size_t)r * seg + p0,
                       (size_t)min(piece, seg - p0));
      continue;
    }
    // Rank d copies source s's arrived piece q into its output.
    const int u = t - pushes - own, q = u % n_pieces, i = u / n_pieces;
    const int d = i / peers, slot = i % peers, s = slot + (slot >= d);
    const long long p0 = (long long)q * piece;
    uint32_t* flag = flag_at(d, slot, q);
    if (threadIdx.x == 0) lang::wait(flag, 1u);
    __syncthreads();
    lang::consume_token();
    lang::copy_block(out + (size_t)d * row + (size_t)s * seg + p0,
                     slot_at(d, slot) + p0, (size_t)min(piece, seg - p0));
    __syncthreads();  // every thread has read the piece
    if (threadIdx.x == 0) *flag = 0u;
  }
}

}  // namespace

// x (world, seg bytes), staging (world, 2, world - 1, seg bytes), out
// (world, world seg bytes); flags (world x 2 x (world - 1) x ceil(seg /
// piece), uint32, all 0 on entry and on return); ticket (one int32 of
// scratch, zeroed here on the stream); epoch_ptr (nullable: one int32 on
// the card) or epoch_val; delay_ns holds every push back (0 in use).
extern "C" int tdt_ll_allgather(const void* x, void* staging, void* out,
                                void* flags, void* ticket,
                                const void* epoch_ptr, long long epoch_val,
                                long long world, long long seg,
                                long long piece, unsigned long long delay_ns,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 2 || seg <= 0 || piece <= 0 || !staging || world > 4096)
    return cudaErrorInvalidValue;
  const long long n_pieces = (seg + piece - 1) / piece;
  if (world * world * n_pieces * 2 > INT32_MAX) return cudaErrorInvalidValue;
  unsigned blocks = 0;
  cudaError_t err = tdt::gemm::persistent_blocks(
      ll_allgather_kernel, kThreads, 0,
      (2 * world * (world - 1) + world) * n_pieces, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  ll_allgather_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const char*>(x), static_cast<char*>(staging),
      static_cast<char*>(out), static_cast<uint32_t*>(flags),
      static_cast<int*>(ticket), static_cast<const int*>(epoch_ptr),
      epoch_val, seg, piece, (int)n_pieces, (int)world, delay_ns);
  return cudaGetLastError();
}
