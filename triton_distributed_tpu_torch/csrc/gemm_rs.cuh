// The work items of the multi-rank GEMM + reduce-scatter over world
// simulated ranks on one card, with an expert dimension: gemm_rs.cu runs
// them with one expert (the dense GEMM-RS), group_gemm_rs.cu with E (the
// MoE GroupGEMM-RS). See gemm_rs.cu for the design; the expert dimension
// is a field of each item.
//
// A (world, E, M, k) with M = world m, B (world, E, k, N): rank r's
// partial product of expert e is A[r][e] @ B[r][e], whose rows [d m, (d +
// 1) m) belong to rank d. out (world, E, m, N): out[d][e] = cast(sum over
// src = 0 .. world - 1, in that order, in f32, of rank src's partial of
// segment d), a remote partial rounded to the output dtype before it is
// pushed and the owner's own partial kept in f32. staging (world, world -
// 1, E, m, N) holds the pushes (staging[d][peer_slot(src, d)][e] =
// cast(partial_src[e] of segment d)), own (world, E, m, N) f32 the owners'
// own partials. f32 or bf16 in and out.
//
// Items, handed out by an atomic ticket in one persistent grid: first the
// product tiles (r, e, row tile, column tile), rank by rank and expert by
// expert (the blocks running at once then share one expert's B in L2),
// rank r's step j being its row tile (tile of row ((r + 1) mod world) m +
// j) mod tiles, so remote segments come first; the epilogue writes each row
// to its owner (own rows in f32 into own, every other row rounded into its
// owner's staging slot), the block meets at a barrier and one thread
// releases the tile's flag to the call's epoch (language.cuh). Then the
// fold items (d, e, row tile of segment d, column tile): one thread waits
// on the flags of every product tile that covers these rows, for each src,
// the block meets, and each thread folds 16-byte vectors of its elements
// (eight bf16 or four f32 outputs at once, when N allows) in the fixed
// order above, loads through L2 only, and casts once. A product tile never
// waits and a block takes a ticket only while it runs, so every flag a
// fold waits on belongs to a running block: no deadlock, whatever the
// dispatch order. delay_ns holds every product tile back before it
// releases its flag (a test of the waits: the result must not change).
#pragma once

#include "gemm_tile.cuh"
#include "language.cuh"
#include "vec.cuh"

namespace tdt {
namespace rs {

using gemm::TileOf;

// Shapes of one call: per (rank, expert) A (M, k), B (k, N), segments of m
// rows.
struct Geometry {
  int world, E, M, m, k, N;
  int tiles_m, tiles_n;  // product tiles of one (rank, expert)
  int fold_m;            // fold row tiles of one segment (TileOf::M rows)
};

// The geometry of a call with element type dtype (kF32 or kBF16), or false
// when the shapes do not fit the kernel's int indices.
inline bool make_geometry(long long world, long long E, long long M,
                          long long k, long long N, int dtype, Geometry* g) {
  if (world < 2 || E <= 0 || M <= 0 || M % world || k <= 0 || N <= 0 ||
      M > INT32_MAX || k > INT32_MAX || N > INT32_MAX || E > INT32_MAX)
    return false;
  const int tm =
      dtype == kF32 ? TileOf<float>::M : TileOf<__nv_bfloat16>::M;
  const int tn =
      dtype == kF32 ? TileOf<float>::N : TileOf<__nv_bfloat16>::N;
  g->world = (int)world;
  g->E = (int)E;
  g->M = (int)M;
  g->m = (int)(M / world);
  g->k = (int)k;
  g->N = (int)N;
  g->tiles_m = (int)((M + tm - 1) / tm);
  g->tiles_n = (int)((N + tn - 1) / tn);
  g->fold_m = (g->m + tm - 1) / tm;
  return world * E * ((long long)g->tiles_m + g->fold_m) * g->tiles_n <=
         INT32_MAX;
}

template <typename T, bool VEC>
__device__ __forceinline__ void run_items(const T* __restrict__ A,
                                          const T* __restrict__ B,
                                          T* __restrict__ out, T* staging,
                                          float* own, uint32_t* flags,
                                          int* ticket, uint32_t epoch,
                                          const Geometry& g,
                                          unsigned long long delay_ns,
                                          unsigned char* smem) {
  using Tile = TileOf<T>;
  const int W = g.world;
  const int per_expert = g.tiles_m * g.tiles_n;
  const int products = W * g.E * per_expert;
  const int per_fold = g.fold_m * g.tiles_n;
  const int total = products + W * g.E * per_fold;
  const size_t seg = (size_t)g.m * g.N;  // elements of one segment
  for (;;) {
    const int t = gemm::take_ticket(ticket);
    if (t >= total) return;
    if (t < products) {
      const int re = t / per_expert;  // r E + e
      const int r = re / g.E, e = re % g.E;
      const int j = (t / g.tiles_n) % g.tiles_m, nt = t % g.tiles_n;
      const int mt = (((r + 1) % W) * g.m / Tile::M + j) % g.tiles_m;
      const int m0 = mt * Tile::M, n0 = nt * Tile::N;
      gemm::product_tile<T, VEC>(
          A + (size_t)re * g.M * g.k, g.k, B + (size_t)re * g.k * g.N, g.N,
          g.M, g.N, g.k, m0, n0, smem, [&](int gr, int gc, float v) {
            if (gr >= g.M || gc >= g.N) return;
            const int dst = gr / g.m;
            const size_t el = (size_t)(gr % g.m) * g.N + gc;
            if (dst == r) {
              own[(size_t)re * seg + el] = v;
            } else {
              const int slot = r - (r > dst);  // common.peer_slot(r, dst)
              staging[(((size_t)dst * (W - 1) + slot) * g.E + e) * seg +
                      el] = from_f32<T>(v);
            }
          });
      lang::sleep_ns(delay_ns);
      __syncthreads();  // every thread's stores precede the release
      if (threadIdx.x == 0) {
        __threadfence();
        lang::notify(flags + ((size_t)re * g.tiles_m + mt) * g.tiles_n + nt,
                     epoch);
      }
      continue;
    }
    const int u = t - products;
    const int de = u / per_fold;  // d E + e
    const int d = de / g.E, e = de % g.E;
    const int ft = (u / g.tiles_n) % g.fold_m, nt = u % g.tiles_n;
    const int i0 = ft * Tile::M, i1 = min(i0 + Tile::M, g.m);
    const int n0 = nt * Tile::N, n1 = min(n0 + Tile::N, g.N);
    if (threadIdx.x == 0) {
      const int mt0 = (d * g.m + i0) / Tile::M;
      const int mt1 = (d * g.m + i1 - 1) / Tile::M;
      for (int src = 0; src < W; ++src)
        for (int mt = mt0; mt <= mt1; ++mt)
          lang::wait(flags + (((size_t)src * g.E + e) * g.tiles_m + mt) *
                                 g.tiles_n + nt,
                     epoch);
    }
    __syncthreads();
    lang::consume_token();
    // VEC: N a multiple of 8, so every tile's columns split into 16-byte
    // vectors of T (P elements); each thread folds P outputs at a time.
    constexpr int P = VEC ? 16 / sizeof(T) : 1;
    const int width = (n1 - n0) / P;
    for (int q = threadIdx.x; q < (i1 - i0) * width; q += blockDim.x) {
      const size_t el = (size_t)(i0 + q / width) * g.N + n0 + q % width * P;
      float acc[P], f[P];
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] = 0.f;
      const float* mine = own + (size_t)de * seg + el;
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
              staging +
              (((size_t)d * (W - 1) + src - (src > d)) * g.E + e) * seg + el;
          if constexpr (VEC)
            vec::load_vec_cg(pushed, f);
          else
            f[0] = vec::load_cg(pushed);
        }
#pragma unroll
        for (int k = 0; k < P; ++k) acc[k] += f[k];
      }
      if constexpr (VEC)
        vec::store_vec(out + (size_t)de * seg + el, acc);
      else
        out[(size_t)de * seg + el] = from_f32<T>(acc[0]);
    }
    // take_ticket starts at a barrier: nothing here is read again.
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, T*, T*, float*, uint32_t*, int*,
                        uint32_t, Geometry, unsigned long long);

// Launch the persistent grid of `kernel` (the 16-byte variant where k, N
// and the pointers allow it) on stream s, the ticket zeroed first.
template <typename T>
cudaError_t launch(Kernel<T> vec_kernel, Kernel<T> plain_kernel,
                   const void* a, const void* b, void* out, void* staging,
                   void* own, void* flags, void* ticket, unsigned epoch,
                   const Geometry& g, unsigned long long delay_ns,
                   cudaStream_t s) {
  using namespace gemm;
  using Tile = TileOf<T>;
  const bool vec = g.k % 8 == 0 && g.N % 8 == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(out) && aligned16(staging) &&
                   aligned16(own);
  Kernel<T> kernel = vec ? vec_kernel : plain_kernel;
  cudaError_t err = cudaSuccess;
  if (Tile::smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::smem);
  const long long total = (long long)g.world * g.E *
                          ((long long)g.tiles_m + g.fold_m) * g.tiles_n;
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

}  // namespace rs
}  // namespace tdt
