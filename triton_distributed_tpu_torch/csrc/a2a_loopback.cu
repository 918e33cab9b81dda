// One-chip EP all-to-all loopback: the dispatch protocol of the
// multi-rank exchange with every peer simulated on this card. Each payload
// is viewed as bytes, (world, capacity, row_bytes): slot i holds the rows
// bound for rank i, and, round-tripped, the rows received from it. Per
// slot, send_counts[i] rows move (at most capacity; none for a count of
// zero or below); the received counts come back unchanged. A byte mover:
// any dtype, fp8 tokens and f32 scales alike, never converted.
//
// Replaces: triton_distributed_tpu/kernels/ep_all_to_all.py:336
//   _a2a_loopback_kernel (via a2a_loopback :378).
//
// What bounds it on the H100: bytes, and only those below each count: 2 x
//   (live rows x row bytes) over the payloads, plus the count cells. At
//   bench.py's full-occupancy shape (8 x 128 fp8 tokens of 7,168 and f32
//   scales of 128) that is ~15.73 MB, ~4.7 us at 3.35 TB/s; at 10%
//   occupancy a tenth of it (the JAX design claim, ep_all_to_all.py:24-28).
//
// What this design does about it: the TPU kernel's local DMAs become work
//   items of one persistent grid (gemm_tile.cuh persistent_blocks /
//   take_ticket), handed out in the JAX kernel's order:
//   1. count items, one per slot: copy send_counts[i] into the received
//      count cell and raise its flag (language.cuh);
//   2. payload pieces, for each payload, slot and chunk of chunk_rows
//      rows: the chunk is cut into pieces of at most piece_rows rows
//      (~32 KB), so a full-occupancy chunk of 917 KB spreads over 32
//      blocks instead of one. Each piece reads send_counts[i] on the device
//      and is live only if its first row lies below min(count, capacity);
//      a chunk at or past the count is JAX's dead predicate (:355), and
//      rows past the count inside a live chunk are neither read nor
//      written. A live piece copies its rows (16-byte moves where the row
//      bytes and pointers allow, else bytes) and raises its flag (shmem's
//      putmem_signal); a dead one raises nothing;
//   3. receivers, one per slot: wait on the count flag, read the RECEIVED
//      cell (not send_counts), and from it re-derive exactly which pieces
//      of chunks c < ceil(count / chunk_rows) were sent, as the JAX
//      receiver does (:365-374); wait on each, then write recv_counts[i].
//   Flags are raised to the call's epoch (no reset between calls). The
//   waiters are the last tickets, so every flag they wait on belongs to a
//   running block that never waits: no deadlock.
//
// The receiver's waits run in parallel: a slot's live pieces of one
//   payload have consecutive flags (slot-major, then chunk, then piece),
//   so the 32 lanes of the receiver's warp each spin on every 32nd flag
//   of that range and meet at __syncwarp, one L2 round trip for up to 32
//   flags, where one thread polling 1 + 28 + 2 flags in turn at full
//   occupancy takes ~30 of them in a row. And the call makes one device
//   operation: the ticket lives in a persistent buffer (kernels/_signal.py
//   arrivals) that the last block out leaves at 0. Every block takes
//   exactly one ticket past the work; the block that takes the last of
//   them is the counter's last user in this launch, and stores 0. No
//   cudaMemsetAsync before the launch. A piece of up to 32 KB is one round
//   trip (lang::copy_rounds: every load of the round in flight before the
//   first store), where copy_block's tail loop moves a 28 KB piece as
//   seven dependent load-store pairs; and a piece releases its flag with
//   st.release after the block's barrier (cumulative over the block's
//   stores), without a separate fence before it. Each block loads the send
//   counts once, while it takes its first ticket, so a piece's liveness
//   costs no load of its own, and takes each next ticket while its item
//   runs (below), so no item waits for a ticket's round trip after the
//   first.
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // 16-byte moves a thread: 32 KB a round
constexpr int kMaxPayloads = 4;

struct Payloads {
  const unsigned char* send[kMaxPayloads];
  unsigned char* recv[kMaxPayloads];
  long long row_bytes[kMaxPayloads];
  int piece_rows[kMaxPayloads];
  int pieces[kMaxPayloads];  // per chunk: ceil(chunk_rows / piece_rows)
  int first[kMaxPayloads];   // the payload's first piece item
};

// Rows of slot i that move: min(count, capacity), none below 1.
__device__ __forceinline__ int live_rows(int count, int capacity) {
  return count <= 0 ? 0 : min(count, capacity);
}

// Every lane of one warp: wait until each of the n flags from `flags` on
// is raised to epoch, lane l taking flags l, l + 32, ...; then meet. The
// lanes spin without sleeping: the receiver is the call's last step.
__device__ __forceinline__ void wait_all(const uint32_t* flags, int n,
                                         uint32_t epoch) {
  for (int j = threadIdx.x % 32; j < n; j += 32)
    lang::wait(flags + j, epoch, 0);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
    a2a_loopback_kernel(Payloads pay, int n_payloads,
                        const int* __restrict__ send_counts, int* cells,
                        int* recv_counts, uint32_t* flags, int* ticket,
                        uint32_t epoch, int world, int capacity,
                        int chunk_rows, int n_chunks, int piece_items) {
  const int total = world + piece_items + world;
  // The send counts, loaded once a block by warps 1.. while warp 0 takes
  // its first ticket (the ticket's barriers publish them), when the block
  // can hold them.
  __shared__ int s_counts[kThreads - 32];
  const bool cached = world <= kThreads - 32;
  if (cached && threadIdx.x >= 32 && threadIdx.x - 32 < world)
    s_counts[threadIdx.x - 32] = __ldcg(send_counts + threadIdx.x - 32);
  auto count_of = [&](int i) {
    return cached ? s_counts[i] : __ldcg(send_counts + i);
  };
  // Thread 0 takes the block's next ticket as soon as an item starts, so
  // its round trip overlaps the item. The block then holds a ticket it has
  // not started, which is safe: an item held ahead is larger than the one
  // running, so a receiver holds only receivers or the end ahead, and a
  // piece or count item, which never waits, is followed by its held item.
  __shared__ int s_ticket;
  int ahead = -1;
  for (;;) {
    if (threadIdx.x == 0)
      s_ticket = ahead >= 0 ? ahead : atomicAdd(ticket, 1);
    __syncthreads();
    const int t = s_ticket;
    __syncthreads();
    if (t >= total) {  // the last block out leaves the ticket at 0
      if (threadIdx.x == 0 && t == total + (int)gridDim.x - 1) *ticket = 0;
      return;
    }
    if (threadIdx.x == 0) ahead = atomicAdd(ticket, 1);
    if (t < world) {  // 1. the count cell of slot t (the release orders it)
      if (threadIdx.x == 0) {
        __stcg(cells + t, count_of(t));
        lang::notify(flags + t, epoch);
      }
      continue;
    }
    if (t < world + piece_items) {  // 2. one piece of one chunk
      const int u = t - world;
      int p = 0;
      while (p + 1 < n_payloads && u >= pay.first[p + 1]) ++p;
      const int v = u - pay.first[p];
      const int k = v % pay.pieces[p];
      const int c = (v / pay.pieces[p]) % n_chunks;
      const int i = v / (pay.pieces[p] * n_chunks);
      const int rows = live_rows(count_of(i), capacity);
      const int r0 = c * chunk_rows + k * pay.piece_rows[p];
      const int r1 = min(min(r0 + pay.piece_rows[p], (c + 1) * chunk_rows),
                         rows);
      if (r0 >= r1) continue;  // at or past the count: nothing, no flag
      const long long rb = pay.row_bytes[p];
      const size_t off = ((size_t)i * capacity + r0) * rb;
      lang::copy_rounds<kUnroll>(pay.recv[p] + off, pay.send[p] + off,
                                 (size_t)(r1 - r0) * rb, threadIdx.x,
                                 kThreads);
      __syncthreads();  // every thread's stores precede the release
      if (threadIdx.x == 0) lang::notify(flags + t, epoch);
      continue;
    }
    // 3. the receiver of slot i: warp 0. Payload p's live pieces of slot i
    // are its full chunks' pieces and the last chunk's first ones, flags
    // base .. base + live - 1.
    if (threadIdx.x >= 32) continue;
    const int i = t - world - piece_items;
    int count = 0;
    if (threadIdx.x == 0) {
      lang::wait(flags + i, epoch, 0);
      count = __ldcg(cells + i);
    }
    count = __shfl_sync(0xffffffffu, count, 0);
    const int rows = live_rows(count, capacity);
    if (rows > 0) {
      const int chunks = (rows + chunk_rows - 1) / chunk_rows;
      const int last = rows - (chunks - 1) * chunk_rows;
      for (int p = 0; p < n_payloads; ++p) {
        const int pr = pay.piece_rows[p];
        const int live = (chunks - 1) * pay.pieces[p] + (last + pr - 1) / pr;
        const uint32_t* base =
            flags + world + pay.first[p] + i * n_chunks * pay.pieces[p];
        wait_all(base, live, epoch);
      }
    }
    if (threadIdx.x == 0) recv_counts[i] = count;
  }
}

}  // namespace

// sends, recvs: n_payloads device pointers each (a host array); row_bytes,
// piece_rows: n_payloads each (host arrays); every payload is (world,
// capacity, row_bytes) bytes. send_counts (world,) int32 on the device;
// cells (world,) int32 scratch; recv_counts (world,) int32 out; flags
// (world + pieces of every payload + world of them, uint32, raised to
// epoch); ticket (one int32, 0 on entry and left at 0 by the kernel).
extern "C" int tdt_a2a_loopback(const void* const* sends,
                                void* const* recvs,
                                const long long* row_bytes,
                                const long long* piece_rows,
                                long long n_payloads, const void* send_counts,
                                void* cells, void* recv_counts, void* flags,
                                void* ticket, unsigned epoch, long long world,
                                long long capacity, long long chunk_rows,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_payloads < 1 || n_payloads > kMaxPayloads || world < 1 ||
      capacity < 1 || chunk_rows < 1 || capacity % chunk_rows ||
      world * capacity > INT32_MAX)
    return cudaErrorInvalidValue;
  const long long n_chunks = capacity / chunk_rows;
  Payloads pay{};
  long long items = 0;
  for (int p = 0; p < n_payloads; ++p) {
    if (row_bytes[p] < 1 || piece_rows[p] < 1 || !sends[p] || !recvs[p])
      return cudaErrorInvalidValue;
    pay.send[p] = static_cast<const unsigned char*>(sends[p]);
    pay.recv[p] = static_cast<unsigned char*>(recvs[p]);
    pay.row_bytes[p] = row_bytes[p];
    pay.piece_rows[p] = (int)(piece_rows[p] < chunk_rows ? piece_rows[p]
                                                          : chunk_rows);
    pay.pieces[p] = (int)((chunk_rows + pay.piece_rows[p] - 1) /
                          pay.piece_rows[p]);
    pay.first[p] = (int)items;
    items += world * n_chunks * pay.pieces[p];
    // The ticket counts up to total + blocks - 1 < 2 x total.
    if (2 * (items + 2 * world) > INT32_MAX) return cudaErrorInvalidValue;
  }
  unsigned blocks = 0;
  const cudaError_t err = tdt::gemm::persistent_blocks(
      a2a_loopback_kernel, kThreads, 0, items + 2 * world, &blocks);
  if (err != cudaSuccess) return err;
  a2a_loopback_kernel<<<blocks, kThreads, 0, s>>>(
      pay, (int)n_payloads, static_cast<const int*>(send_counts),
      static_cast<int*>(cells), static_cast<int*>(recv_counts),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch,
      (int)world, (int)capacity, (int)chunk_rows, (int)n_chunks,
      (int)items);
  return cudaGetLastError();
}
