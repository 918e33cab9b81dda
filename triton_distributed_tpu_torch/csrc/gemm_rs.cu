// Multi-rank GEMM + reduce-scatter with world simulated ranks on one card:
// every rank's partial product a[r] @ b[r] is reduce-scattered by row
// segment. a (world, M, k), b (world, k, N), out (world, M / world, N):
// out[d] = cast(sum over src = 0 .. world - 1, in that order, in f32, of
// rank src's partial of segment d), where a remote partial is rounded to
// the output dtype before it is pushed and the owner's own partial stays
// f32. staging (world, world - 1, m, N) holds the pushed partials
// (staging[d][peer_slot(src, d)] = cast(partial_src[d])), own (world, m, N)
// f32 the owners' own partials. f32 or bf16 in and out.
//
// Replaces: triton_distributed_tpu/kernels/gemm_reduce_scatter.py:76
//   _gemm_rs_kernel (via gemm_rs_device :171 at world > 1), whose fold
//   (:124-160) starts an f32 accumulator at zero and adds, for src = 0 ..
//   world - 1, the own f32 partial or the staged partial in f32, then
//   casts once.
//
// What bounds it on the H100: at prefill the operations of every rank's
//   product (2 world M k N); at decode (M = batch) the bytes of B (each
//   rank's (k, N) shard read once): 3.35 TB/s. The pushes add a write and
//   a read of world (world - 1) m N elements of scratch that stands in for
//   the link (NVLink is not exercised on one card).
//
// What this design does about it: the TPU kernel walks destination
//   segments dst = (me + 1 + s) mod world, pushes each finished remote tile
//   from a VMEM parity buffer, and folds its own segment last. Here the
//   ranks are a field of each work item of one persistent grid (no larger
//   than the card holds at once, gemm_tile.cuh persistent_blocks) that
//   hands out items by an atomic ticket. First the product tiles: tile
//   (r, mt, nt) of rank r's full (M, N) product, rank by rank (the blocks
//   running at once then share one rank's B in L2), rank r's step j being
//   its row tile (tile of row ((r + 1) mod world) m + j) mod tiles, so
//   remote segments come first (at decode one row tile: B read once);
//   its epilogue writes each row to its owner: rows of r's own segment in
//   f32 into own, every other row rounded to the output dtype into its
//   owner's staging slot. The block meets at a barrier and one thread
//   releases the tile's flag to the call's epoch (language.cuh). Then the
//   fold items (d, row tile of segment d, column tile): one thread waits on
//   the flags of every product tile that covers these rows, for each src,
//   the block meets, and each thread folds 16-byte vectors of its elements
//   (eight bf16 or four f32 outputs at once, when N allows) in the fixed
//   order above, loads through L2 only, and casts once. A product tile never
//   waits and a block takes a ticket only while it runs, so every flag a
//   fold waits on belongs to a running block: no deadlock, whatever the
//   dispatch order. delay_ns holds every product tile back before it
//   releases its flag (a test of the waits: the result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"
#include "vec.cuh"

namespace {

namespace lang = tdt::lang;
using tdt::gemm::TileOf;

// Shapes of one call: per rank a (M, k), b (k, N); segments of m rows.
struct Geometry {
  int world, M, m, k, N;
  int tiles_m, tiles_n;  // product tiles of one rank's (M, N)
  int fold_m;            // fold row tiles of one segment (TileOf::M rows)
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(TileOf<T>::threads)
    gemm_rs_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ out, T* staging, float* own,
                   uint32_t* flags, int* ticket, uint32_t epoch, Geometry g,
                   unsigned long long delay_ns) {
  using Tile = TileOf<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = g.world;
  const int per_rank = g.tiles_m * g.tiles_n;
  const int products = W * per_rank;
  const int total = products + W * g.fold_m * g.tiles_n;
  const size_t seg = (size_t)g.m * g.N;  // elements of one segment
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    if (t < products) {
      const int r = t / per_rank, j = (t / g.tiles_n) % g.tiles_m,
                nt = t % g.tiles_n;
      const int mt = (((r + 1) % W) * g.m / Tile::M + j) % g.tiles_m;
      const int m0 = mt * Tile::M, n0 = nt * Tile::N;
      tdt::gemm::product_tile<T, VEC>(
          A + (size_t)r * g.M * g.k, g.k, B + (size_t)r * g.k * g.N, g.N,
          g.M, g.N, g.k, m0, n0, smem, [&](int gr, int gc, float v) {
            if (gr >= g.M || gc >= g.N) return;
            const int dst = gr / g.m;
            const size_t e = (size_t)(gr % g.m) * g.N + gc;
            if (dst == r) {
              own[(size_t)r * seg + e] = v;
            } else {
              const int slot = r - (r > dst);  // common.peer_slot(r, dst)
              staging[((size_t)dst * (W - 1) + slot) * seg + e] =
                  tdt::from_f32<T>(v);
            }
          });
      lang::sleep_ns(delay_ns);
      __syncthreads();  // every thread's stores precede the release
      if (threadIdx.x == 0) {
        __threadfence();
        lang::notify(flags + ((size_t)r * g.tiles_m + mt) * g.tiles_n + nt,
                     epoch);
      }
      continue;
    }
    const int u = t - products;
    const int d = u / (g.fold_m * g.tiles_n);
    const int ft = (u / g.tiles_n) % g.fold_m, nt = u % g.tiles_n;
    const int i0 = ft * Tile::M, i1 = min(i0 + Tile::M, g.m);
    const int n0 = nt * Tile::N, n1 = min(n0 + Tile::N, g.N);
    if (threadIdx.x == 0) {
      const int mt0 = (d * g.m + i0) / Tile::M;
      const int mt1 = (d * g.m + i1 - 1) / Tile::M;
      for (int src = 0; src < W; ++src)
        for (int mt = mt0; mt <= mt1; ++mt)
          lang::wait(flags + ((size_t)src * g.tiles_m + mt) * g.tiles_n + nt,
                     epoch);
    }
    __syncthreads();
    lang::consume_token();
    // VEC: N a multiple of 8, so every tile's columns split into 16-byte
    // vectors of T (P elements); each thread folds P outputs at a time.
    constexpr int P = VEC ? 16 / sizeof(T) : 1;
    const int width = (n1 - n0) / P;
    for (int q = threadIdx.x; q < (i1 - i0) * width; q += blockDim.x) {
      const size_t e = (size_t)(i0 + q / width) * g.N + n0 + q % width * P;
      float acc[P], f[P];
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] = 0.f;
      const float* mine = own + (size_t)d * seg + e;
      for (int src = 0; src < W; ++src) {
        if (src == d) {
#pragma unroll
          for (int k = 0; k < P; k += 4) {
            if constexpr (VEC) {
              const float4 v =
                  __ldcg(reinterpret_cast<const float4*>(mine + k));
              f[k] = v.x;
              f[k + 1] = v.y;
              f[k + 2] = v.z;
              f[k + 3] = v.w;
            } else {
              f[0] = __ldcg(mine);
            }
          }
        } else {
          const T* pushed =
              staging + ((size_t)d * (W - 1) + src - (src > d)) * seg + e;
          if constexpr (VEC)
            tdt::vec::load_vec_cg(pushed, f);
          else
            f[0] = tdt::vec::load_cg(pushed);
        }
#pragma unroll
        for (int k = 0; k < P; ++k) acc[k] += f[k];
      }
      if constexpr (VEC)
        tdt::vec::store_vec(out + (size_t)d * seg + e, acc);
      else
        out[(size_t)d * seg + e] = tdt::from_f32<T>(acc[0]);
    }
    // take_ticket starts at a barrier: nothing here is read again.
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* out, void* staging,
                   void* own, void* flags, void* ticket, unsigned epoch,
                   Geometry g, unsigned long long delay_ns, cudaStream_t s) {
  using namespace tdt::gemm;
  using Tile = TileOf<T>;
  const bool vec = g.k % 8 == 0 && g.N % 8 == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(out) && aligned16(staging) &&
                   aligned16(own);
  auto kernel = vec ? gemm_rs_kernel<T, true> : gemm_rs_kernel<T, false>;
  cudaError_t err = cudaSuccess;
  if (Tile::smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::smem);
  const long long total = (long long)g.tiles_m * g.world * g.tiles_n +
                          (long long)g.world * g.fold_m * g.tiles_n;
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = persistent_blocks(kernel, Tile::threads, Tile::smem, total,
                            &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, Tile::threads, Tile::smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), static_cast<T*>(staging),
      static_cast<float*>(own), static_cast<uint32_t*>(flags),
      static_cast<int*>(ticket), epoch, g, delay_ns);
  return cudaGetLastError();
}

}  // namespace

// a (world, M, k), b (world, k, N), out (world, M / world, N), staging
// (world, world - 1, M / world, N), own (world, M / world, N) f32; flags
// (world x ceil(M / tile) x ceil(N / tile), uint32, raised to epoch);
// ticket (one int32 of scratch, zeroed here on the stream); dtype 0 f32,
// 1 bf16; delay_ns holds every product tile back (0 in use).
extern "C" int tdt_gemm_rs(const void* a, const void* b, void* out,
                           void* staging, void* own, void* flags,
                           void* ticket, unsigned epoch, long long world,
                           long long M, long long k, long long N, int dtype,
                           unsigned long long delay_ns, void* stream) {
  using namespace tdt::gemm;
  if (world < 2 || M <= 0 || M % world || k <= 0 || N <= 0 ||
      M > INT32_MAX || k > INT32_MAX || N > INT32_MAX || !staging || !own)
    return cudaErrorInvalidValue;
  const int tm = dtype == tdt::kF32 ? TileOf<float>::M : TileOf<bf16>::M;
  const int tn = dtype == tdt::kF32 ? TileOf<float>::N : TileOf<bf16>::N;
  Geometry g;
  g.world = (int)world;
  g.M = (int)M;
  g.m = (int)(M / world);
  g.k = (int)k;
  g.N = (int)N;
  g.tiles_m = (int)((M + tm - 1) / tm);
  g.tiles_n = (int)((N + tn - 1) / tn);
  g.fold_m = (g.m + tm - 1) / tm;
  if ((long long)g.tiles_m * g.world * g.tiles_n +
          (long long)g.world * g.fold_m * g.tiles_n > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::kF32)
    return launch<float>(a, b, out, staging, own, flags, ticket, epoch, g,
                         delay_ns, s);
  if (dtype == tdt::kBF16)
    return launch<bf16>(a, b, out, staging, own, flags, ticket, epoch, g,
                        delay_ns, s);
  return cudaErrorInvalidValue;
}
