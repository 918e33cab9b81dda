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
//   persistent_blocks) hands out items by an atomic ticket, producers
//   first. Producer item (s, d, c) copies chunk c of a[(d + s) mod world]
//   into staging[d] with language.cuh's putmem_signal, which raises flag
//   (d, src, c) to the call's epoch; items of step s come before those of
//   step s + 1. Then the consumer tiles, TileOf<T>::M x N outputs of one
//   rank over its gathered A in absolute rows (a tile may span segments, so
//   at m = 1 one row tile covers every segment and B is read once), handed
//   out rank by rank (the blocks running at once then share one rank's B
//   in L2), each rank's in its segment order: its step j is the row tile
//   (tile of row d m + j) mod tiles. A consumer's thread 0 waits on the flag
//   of every chunk its rows touch (first touch), the block meets at a
//   barrier, and the tile runs gemm_tile.cuh's product_tile over the
//   staged rows, read through L2 only. A producer never waits and a block
//   takes a ticket only while it runs, so every flag a consumer waits on
//   belongs to a running block: no deadlock, whatever the dispatch order.
//   delay_ns holds every producer item back before its copy (a test of the
//   waits: the result must not change).
#include <algorithm>

#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
using tdt::gemm::TileOf;

// Shapes of one call: per rank a (m, K), b (K, n), out (world m, cols).
struct Geometry {
  int world, m, K, n, cols;
  int chunk_rows, n_chunks;  // producer chunks of one rank's m rows
  int tiles_m, tiles_n;      // output tiles of one rank
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(TileOf<T>::threads)
    ag_gemm_kernel(const T* __restrict__ A, T* S, const T* __restrict__ B,
                   T* __restrict__ C, uint32_t* flags, int* ticket,
                   uint32_t epoch, Geometry g, unsigned long long delay_ns) {
  using Tile = TileOf<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = g.world, rows = W * g.m;
  const size_t seg = (size_t)g.m * g.K;  // elements of one rank's shard
  const int producers = W * W * g.n_chunks;
  const int per_rank = g.tiles_m * g.tiles_n;
  const int total = producers + W * per_rank;
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    if (t < producers) {  // step s: rank (d + s) mod W pushes chunk c to d
      const int s = t / (W * g.n_chunks), d = (t / g.n_chunks) % W,
                c = t % g.n_chunks, src = (d + s) % W;
      const long long r0 = (long long)c * g.chunk_rows;
      const long long nr = min((long long)g.chunk_rows, g.m - r0);
      lang::sleep_ns(delay_ns);
      lang::putmem_signal(S + ((size_t)d * W + src) * seg + r0 * g.K,
                          A + (size_t)src * seg + r0 * g.K,
                          nr * g.K * sizeof(T),
                          flags + ((size_t)d * W + src) * g.n_chunks + c,
                          epoch);
      continue;
    }
    const int u = t - producers;
    const int d = u / per_rank, j = (u / g.tiles_n) % g.tiles_m,
              nt = u % g.tiles_n;
    const int mt = ((d * g.m) / Tile::M + j) % g.tiles_m;
    const int m0 = mt * Tile::M, n0 = nt * Tile::N;
    if (threadIdx.x == 0) {  // first touch: every chunk of these rows
      const int end = min(m0 + Tile::M, rows);
      for (int r = m0; r < end;) {
        const int src = r / g.m, c = (r % g.m) / g.chunk_rows;
        lang::wait(flags + ((size_t)d * W + src) * g.n_chunks + c, epoch);
        r = src * g.m + min((c + 1) * g.chunk_rows, g.m);
      }
    }
    __syncthreads();
    lang::consume_token();
    T* Cd = C + (size_t)d * rows * g.cols;
    tdt::gemm::product_tile<T, VEC>(
        S + (size_t)d * W * seg, g.K, B + (size_t)d * g.K * g.n, g.n, rows,
        g.cols, g.K, m0, n0, smem, [&](int gr, int gc, float v) {
          if (gr < rows && gc < g.cols)
            Cd[(size_t)gr * g.cols + gc] = tdt::from_f32<T>(v);
        });
    // product_tile ends at a barrier: shared memory is free for the next
    // ticket's tile.
  }
}

template <typename T>
cudaError_t launch(const void* a, void* staging, const void* b, void* out,
                   void* flags, void* ticket, unsigned epoch, Geometry g,
                   unsigned long long delay_ns, cudaStream_t s) {
  using namespace tdt::gemm;
  using Tile = TileOf<T>;
  const bool vec = g.K % 8 == 0 && g.n % 8 == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(staging);
  auto kernel = vec ? ag_gemm_kernel<T, true> : ag_gemm_kernel<T, false>;
  cudaError_t err = cudaSuccess;
  if (Tile::smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::smem);
  const long long total = (long long)g.world * g.world * g.n_chunks +
                          (long long)g.tiles_m * g.world * g.tiles_n;
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = persistent_blocks(kernel, Tile::threads, Tile::smem, total,
                            &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, Tile::threads, Tile::smem, s>>>(
      static_cast<const T*>(a), static_cast<T*>(staging),
      static_cast<const T*>(b), static_cast<T*>(out),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch, g,
      delay_ns);
  return cudaGetLastError();
}

}  // namespace

// a (world, m, K), b (world, K, n), out (world, world m, cols), staging
// (world, world, m, K); flags (world x world x ceil(m / chunk_rows), uint32,
// raised to epoch); ticket (one int32 of scratch, zeroed here on the
// stream); dtype 0 f32, 1 bf16; delay_ns holds every producer back (0 in
// use).
extern "C" int tdt_ag_gemm(const void* a, void* staging, const void* b,
                           void* out, void* flags, void* ticket,
                           unsigned epoch, long long world, long long m,
                           long long K, long long n, long long cols,
                           long long chunk_rows, int dtype,
                           unsigned long long delay_ns, void* stream) {
  using namespace tdt::gemm;
  if (world < 2 || m <= 0 || K <= 0 || n <= 0 || cols <= 0 || cols > n ||
      chunk_rows <= 0 || world * m > INT32_MAX || K > INT32_MAX ||
      n > INT32_MAX || !staging)
    return cudaErrorInvalidValue;
  const int tm = dtype == tdt::kF32 ? TileOf<float>::M : TileOf<bf16>::M;
  const int tn = dtype == tdt::kF32 ? TileOf<float>::N : TileOf<bf16>::N;
  Geometry g;
  g.world = (int)world;
  g.m = (int)m;
  g.K = (int)K;
  g.n = (int)n;
  g.cols = (int)cols;
  g.chunk_rows = (int)std::min(chunk_rows, m);
  g.n_chunks = (int)((m + g.chunk_rows - 1) / g.chunk_rows);
  g.tiles_m = (int)((world * m + tm - 1) / tm);
  g.tiles_n = (int)((cols + tn - 1) / tn);
  if ((long long)g.world * g.world * g.n_chunks +
          (long long)g.tiles_m * g.world * g.tiles_n > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kF32)
    return launch<float>(a, staging, b, out, flags, ticket, epoch, g,
                         delay_ns, s);
  if (dtype == tdt::kBF16)
    return launch<bf16>(a, staging, b, out, flags, ticket, epoch, g,
                        delay_ns, s);
  return cudaErrorInvalidValue;
}
