// Multi-rank EP all-to-all with world simulated ranks on one card: every
// rank's exchange (an MoE dispatch or combine) in one launch. Each payload
// is viewed as bytes, (world, world, capacity, row_bytes): send[r][p] holds
// the rows rank r sends to rank p, and recv[p][r] the rows rank p received
// from rank r. Per (src r, dst p) pair, send_counts[r][p] rows move (at
// most capacity; none for a count of zero or below) and recv_counts[p][r]
// = send_counts[r][p], unchanged: out[p][r] = in[r][p] below the count.
// A byte mover: any dtype (bf16 tokens and int32 expert ids, fp8 tokens and
// f32 scales), never converted. Received rows past a count are not written.
//
// Replaces: triton_distributed_tpu/kernels/ep_all_to_all.py:102
//   _a2a_kernel (via fast_all_to_all :186 at world > 1).
//
// What bounds it on the H100: bytes, and only those below each count: 2 x
//   (live rows x row bytes) over the payloads, plus the counts (each read
//   once, each received count written once). At Qwen3-30B-A3B's world-4
//   prefill dispatch (4 x 2,048 tokens, top-8: 65,536 rows of 4,096 B of
//   bf16 tokens and 4 B of expert ids) that is ~537 MB, ~0.16 ms at 3.35
//   TB/s; a decode step's 32 rows are ~0.26 MB, far below a launch.
//
// What this design does about it: the TPU kernel, on each rank, crosses a
//   barrier, then pushes per peer a count cell and the chunks of each
//   payload that hold rows (chunk c iff c * chunk_rows < count), copies its
//   own slot locally, and waits per peer on the count cell, reads the
//   RECEIVED count and from it re-derives which chunks to wait on. Here the
//   ranks are a field of each work item of one persistent grid (as in
//   ag_gemm.cu and gemm_rs.cu), no larger than the card holds at once
//   (gemm_tile.cuh persistent_blocks), handing out items by an atomic
//   ticket in this order:
//   1. count items, one per (r, p): for p != r, copy send_counts[r][p]
//      into the count cell of p's slot r and raise its flag (language.cuh);
//      the own slot's count is a local copy straight into recv_counts;
//   2. payload pieces, for each payload, pair and piece: a chunk is cut
//      into pieces of at most ~32 KB as a2a_loopback.cu cuts it, and where
//      a chunk is smaller (4 B expert ids) a piece holds whole chunks. Each
//      piece reads its pair's count on the device and is live only if its
//      first row lies below min(count, capacity); rows past the count are
//      neither read nor written, so the bytes moved follow occupancy (JAX
//      :24-28). A live piece of a remote pair copies its rows with
//      putmem_signal, raising its flag; the own slot's pieces are plain
//      local copies that no one waits on; a dead piece raises nothing;
//   3. receivers, one per remote pair (p, r): one thread waits on the count
//      flag and reads the RECEIVED cell (not send_counts), every thread
//      re-derives from it which pieces were sent (a prefix of the pair's
//      pieces) and waits on a share of them, then recv_counts[p][r] is
//      written.
//   Flags are raised to the call's epoch (kernels/_signal.py), so no reset
//   and no entry barrier is needed: calls on one stream run in order, and
//   dispatch and combine keep flag buffers of their own, as the two JAX
//   directions keep collective ids of their own. The receivers are the
//   last tickets, so every flag they wait on belongs to a block that is
//   running and never waits: no deadlock. delay_ns holds every producer
//   item back before its copy (a test of the waits).
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;
constexpr int kMaxPayloads = 4;

struct Payloads {
  const unsigned char* send[kMaxPayloads];
  unsigned char* recv[kMaxPayloads];
  long long row_bytes[kMaxPayloads];
  int piece_rows[kMaxPayloads];  // rows of one piece
  int span[kMaxPayloads];        // rows of the unit the pieces cut: a chunk,
                                 // or a piece of whole chunks
  int per_unit[kMaxPayloads];    // pieces of one unit
  int per_pair[kMaxPayloads];    // pieces of one (src, dst) pair
  int first[kMaxPayloads];       // the payload's first piece
};

// Rows of a pair that move: min(count, capacity), none below 1.
__device__ __forceinline__ int live_rows(int count, int capacity) {
  return count <= 0 ? 0 : min(count, capacity);
}

// Pieces of payload q that hold rows below `rows`: a prefix of the pair's
// pieces (unit by unit, piece by piece inside a unit).
__device__ __forceinline__ int live_pieces(const Payloads& pay, int q,
                                           int rows) {
  if (rows <= 0) return 0;
  const int units = (rows + pay.span[q] - 1) / pay.span[q];
  const int in_last = rows - (units - 1) * pay.span[q];
  return (units - 1) * pay.per_unit[q] +
         (in_last + pay.piece_rows[q] - 1) / pay.piece_rows[q];
}

__global__ void __launch_bounds__(kThreads)
    ep_a2a_kernel(Payloads pay, int n_payloads,
                  const int* __restrict__ send_counts, int* cells,
                  int* recv_counts, uint32_t* flags, int* ticket,
                  uint32_t epoch, int world, int capacity, int pieces,
                  unsigned long long delay_ns) {
  __shared__ int s_count;
  const int pairs = world * world;
  const int total = pairs + pieces + pairs;
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    if (t < pairs) {  // 1. the count of pair (r, p), r = src, p = dst
      if (threadIdx.x == 0) {
        const int r = t / world, p = t % world;
        lang::sleep_ns(delay_ns);
        const int count = __ldcg(send_counts + t);
        if (r == p) {
          recv_counts[p * world + r] = count;
        } else {
          __stcg(cells + p * world + r, count);
          __threadfence();
          lang::notify(flags + p * world + r, epoch);
        }
      }
      continue;
    }
    if (t < pairs + pieces) {  // 2. one piece of one payload of one pair
      const int u = t - pairs;
      int q = 0;
      while (q + 1 < n_payloads && u >= pay.first[q + 1]) ++q;
      const int v = u - pay.first[q];
      const int pair = v / pay.per_pair[q], j = v % pay.per_pair[q];
      const int r = pair / world, p = pair % world;
      const int rows = live_rows(__ldcg(send_counts + pair), capacity);
      const int unit = j / pay.per_unit[q], k = j % pay.per_unit[q];
      const int r0 = unit * pay.span[q] + k * pay.piece_rows[q];
      const int r1 = min(min(r0 + pay.piece_rows[q],
                             (unit + 1) * pay.span[q]), rows);
      if (r0 >= r1) continue;  // at or past the count: nothing, no flag
      lang::sleep_ns(delay_ns);
      const long long rb = pay.row_bytes[q];
      const unsigned char* src =
          pay.send[q] + ((size_t)pair * capacity + r0) * rb;
      unsigned char* dst =
          pay.recv[q] + ((size_t)(p * world + r) * capacity + r0) * rb;
      const size_t nbytes = (size_t)(r1 - r0) * rb;
      if (r == p)
        lang::copy_block(dst, src, nbytes);  // the own slot: a local copy
      else
        lang::putmem_signal(dst, src, nbytes, flags + pairs + u, epoch);
      continue;
    }
    // 3. the receiver of rank p's slot r (from rank r)
    const int i = t - pairs - pieces;
    const int p = i / world, r = i % world;
    if (r == p) continue;
    if (threadIdx.x == 0) {
      lang::wait(flags + p * world + r, epoch);
      s_count = __ldcg(cells + p * world + r);
    }
    __syncthreads();
    const int count = s_count;
    const int rows = live_rows(count, capacity);
    for (int q = 0; q < n_payloads; ++q) {
      const uint32_t* base =
          flags + pairs + pay.first[q] + (r * world + p) * pay.per_pair[q];
      const int live = live_pieces(pay, q, rows);
      for (int j = threadIdx.x; j < live; j += blockDim.x)
        lang::wait(base + j, epoch);
    }
    __syncthreads();
    if (threadIdx.x == 0) recv_counts[p * world + r] = count;
  }
}

}  // namespace

// sends, recvs: n_payloads device pointers each (a host array); row_bytes,
// piece_rows: n_payloads each (host arrays; a piece holds at most
// chunk_rows rows, or a multiple of chunk_rows); every payload is (world,
// world, capacity, row_bytes) bytes. send_counts (world, world) int32 on
// the device; cells (world, world) int32 scratch; recv_counts (world,
// world) int32 out; flags (world^2 + pieces of every payload of them,
// uint32, raised to epoch); ticket (one int32 of scratch, zeroed here on
// the stream); delay_ns holds each producer item back (0 in use).
extern "C" int tdt_ep_a2a(const void* const* sends, void* const* recvs,
                          const long long* row_bytes,
                          const long long* piece_rows, long long n_payloads,
                          const void* send_counts, void* cells,
                          void* recv_counts, void* flags, void* ticket,
                          unsigned epoch, long long world, long long capacity,
                          long long chunk_rows, unsigned long long delay_ns,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_payloads < 1 || n_payloads > kMaxPayloads || world < 1 ||
      capacity < 1 || chunk_rows < 1 || capacity % chunk_rows ||
      world * world * capacity > INT32_MAX)
    return cudaErrorInvalidValue;
  const long long pairs = world * world;
  Payloads pay{};
  long long pieces = 0;
  for (int q = 0; q < n_payloads; ++q) {
    const long long pr = piece_rows[q];
    if (row_bytes[q] < 1 || pr < 1 || !sends[q] || !recvs[q] ||
        (pr > chunk_rows && (pr % chunk_rows || pr > capacity)))
      return cudaErrorInvalidValue;
    const long long span = pr > chunk_rows ? pr : chunk_rows;
    const long long per_unit = (span + pr - 1) / pr;
    pay.send[q] = static_cast<const unsigned char*>(sends[q]);
    pay.recv[q] = static_cast<unsigned char*>(recvs[q]);
    pay.row_bytes[q] = row_bytes[q];
    pay.piece_rows[q] = (int)pr;
    pay.span[q] = (int)span;
    pay.per_unit[q] = (int)per_unit;
    pay.per_pair[q] = (int)((capacity + span - 1) / span * per_unit);
    pay.first[q] = (int)pieces;
    pieces += pairs * pay.per_pair[q];
    if (pieces + 2 * pairs > INT32_MAX) return cudaErrorInvalidValue;
  }
  unsigned blocks = 0;
  cudaError_t err = tdt::gemm::persistent_blocks(
      ep_a2a_kernel, kThreads, 0, pieces + 2 * pairs, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  ep_a2a_kernel<<<blocks, kThreads, 0, s>>>(
      pay, (int)n_payloads, static_cast<const int*>(send_counts),
      static_cast<int*>(cells), static_cast<int*>(recv_counts),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch,
      (int)world, (int)capacity, (int)pieces, delay_ns);
  return cudaGetLastError();
}
