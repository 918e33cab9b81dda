// The work items of the multi-rank AG-GEMM over world simulated ranks on
// one card, with an expert dimension: ag_gemm.cu runs them with one expert
// (the dense AG-GEMM), ag_group_gemm.cu with E (the MoE AG-GroupGEMM). See
// ag_gemm.cu for the design; the expert dimension is a field of each item.
//
// A (world, E, m, K): source src's rows of expert e; S (world, E, world, m,
// K): rank d's gathered rows of expert e in absolute source order,
// S[d][e][src] = A[src][e]; B (world, E, K, n); C (world, E, world m, cols)
// with cols <= n: C[d][e] = S[d][e] (as (world m, K)) @ B[d][e][:, :cols].
// f32 or bf16 in and out, f32 accumulation.
//
// Items, handed out by an atomic ticket in one persistent grid, producers
// first. Producer (s, d, c) copies chunk c of A[(d + s) mod world] into
// S[d] (a chunk is ec experts x chunk_rows rows) and raises flag (d, src,
// c) to the call's epoch; items of step s come before those of step s + 1.
// Then the consumer tiles, TileOf<T>::M x N outputs of one (rank, expert),
// handed out rank by rank and, within a rank, expert by expert (the blocks
// running at once then share one expert's B in L2), each in its rank's
// segment order: step j is the row tile (tile of row d m + j) mod tiles. A
// consumer's thread 0 waits on the flag of every chunk its rows touch, the
// block meets at a barrier, and the tile runs gemm_tile.cuh's product_tile
// over the staged rows, read through L2 only. A producer never waits and a
// block takes a ticket only while it runs, so every flag a consumer waits
// on belongs to a running block: no deadlock, whatever the dispatch order.
// delay_ns holds every producer item back before its copy (a test of the
// waits: the result must not change).
#pragma once

#include <algorithm>

#include "gemm_tile.cuh"
#include "language.cuh"

namespace tdt {
namespace ag {

using gemm::TileOf;

// Shapes of one call: per (rank, expert) A rows (m, K), B (K, n), C (world
// m, cols); producer chunks of ec experts x chunk_rows rows.
struct Geometry {
  int world, E, m, K, n, cols;
  int ec, n_echunks;          // experts of one chunk, chunks over E
  int chunk_rows, n_rchunks;  // rows of one chunk, chunks over m
  int tiles_m, tiles_n;       // output tiles of one (rank, expert)
};

// The geometry of a call with element type dtype (kF32 or kBF16), or false
// when the shapes do not fit the kernel's int indices.
inline bool make_geometry(long long world, long long E, long long m,
                          long long K, long long n, long long cols,
                          long long ec, long long chunk_rows, int dtype,
                          Geometry* g) {
  if (world < 2 || E <= 0 || m <= 0 || K <= 0 || n <= 0 || cols <= 0 ||
      cols > n || ec <= 0 || chunk_rows <= 0 || world * m > INT32_MAX ||
      K > INT32_MAX || n > INT32_MAX || E > INT32_MAX)
    return false;
  const int tm =
      dtype == kF32 ? TileOf<float>::M : TileOf<__nv_bfloat16>::M;
  const int tn =
      dtype == kF32 ? TileOf<float>::N : TileOf<__nv_bfloat16>::N;
  g->world = (int)world;
  g->E = (int)E;
  g->m = (int)m;
  g->K = (int)K;
  g->n = (int)n;
  g->cols = (int)cols;
  g->ec = (int)std::min(ec, E);
  g->n_echunks = (int)((E + g->ec - 1) / g->ec);
  g->chunk_rows = (int)std::min(chunk_rows, m);
  g->n_rchunks = (int)((m + g->chunk_rows - 1) / g->chunk_rows);
  g->tiles_m = (int)((world * m + tm - 1) / tm);
  g->tiles_n = (int)((cols + tn - 1) / tn);
  return world * world * g->n_echunks * g->n_rchunks +
             world * E * g->tiles_m * g->tiles_n <= INT32_MAX;
}

template <typename T, bool VEC>
__device__ __forceinline__ void run_items(const T* __restrict__ A, T* S,
                                          const T* __restrict__ B,
                                          T* __restrict__ C, uint32_t* flags,
                                          int* ticket, uint32_t epoch,
                                          const Geometry& g,
                                          unsigned long long delay_ns,
                                          unsigned char* smem) {
  using Tile = TileOf<T>;
  const int W = g.world, rows = W * g.m;
  const size_t seg = (size_t)g.m * g.K;  // elements of one (source, expert)
  const int n_chunks = g.n_echunks * g.n_rchunks;
  const int producers = W * W * n_chunks;
  const int per_expert = g.tiles_m * g.tiles_n;
  const int per_rank = g.E * per_expert;
  const int total = producers + W * per_rank;
  for (;;) {
    const int t = gemm::take_ticket(ticket);
    if (t >= total) return;
    if (t < producers) {  // step s: rank (d + s) mod W pushes chunk c to d
      const int s = t / (W * n_chunks), d = (t / n_chunks) % W,
                c = t % n_chunks, src = (d + s) % W;
      const int ce = c / g.n_rchunks, cr = c % g.n_rchunks;
      const long long r0 = (long long)cr * g.chunk_rows;
      const long long nr = min((long long)g.chunk_rows, g.m - r0);
      lang::sleep_ns(delay_ns);
      for (int e = ce * g.ec; e < min(g.E, (ce + 1) * g.ec); ++e)
        lang::copy_block(
            S + (((size_t)d * g.E + e) * W + src) * seg + r0 * g.K,
            A + ((size_t)src * g.E + e) * seg + r0 * g.K,
            nr * g.K * sizeof(T));
      __syncthreads();  // every thread's stores precede the release
      if (threadIdx.x == 0) {
        __threadfence();
        lang::notify(flags + ((size_t)d * W + src) * n_chunks + c, epoch);
      }
      continue;
    }
    const int u = t - producers;
    const int d = u / per_rank, e = (u / per_expert) % g.E,
              j = (u / g.tiles_n) % g.tiles_m, nt = u % g.tiles_n;
    const int mt = ((d * g.m) / Tile::M + j) % g.tiles_m;
    const int m0 = mt * Tile::M, n0 = nt * Tile::N;
    if (threadIdx.x == 0) {  // first touch: every chunk of these rows
      const int end = min(m0 + Tile::M, rows);
      const uint32_t* ef =
          flags + (size_t)(e / g.ec) * g.n_rchunks;  // expert e's chunks
      for (int r = m0; r < end;) {
        const int src = r / g.m, cr = (r % g.m) / g.chunk_rows;
        lang::wait(ef + ((size_t)d * W + src) * n_chunks + cr, epoch);
        r = src * g.m + min((cr + 1) * g.chunk_rows, g.m);
      }
    }
    __syncthreads();
    lang::consume_token();
    const size_t de = (size_t)d * g.E + e;
    T* Cde = C + de * rows * g.cols;
    gemm::product_tile<T, VEC>(
        S + de * W * seg, g.K, B + de * g.K * g.n, g.n, rows, g.cols, g.K,
        m0, n0, smem, [&](int gr, int gc, float v) {
          if (gr < rows && gc < g.cols)
            Cde[(size_t)gr * g.cols + gc] = from_f32<T>(v);
        });
    // product_tile ends at a barrier: shared memory is free for the next
    // ticket's tile.
  }
}

template <typename T>
using Kernel = void (*)(const T*, T*, const T*, T*, uint32_t*, int*,
                        uint32_t, Geometry, unsigned long long);

// Launch the persistent grid of `kernel` (the 16-byte variant where K, n
// and the pointers allow it) on stream s, the ticket zeroed first.
template <typename T>
cudaError_t launch(Kernel<T> vec_kernel, Kernel<T> plain_kernel,
                   const void* a, void* staging, const void* b, void* out,
                   void* flags, void* ticket, unsigned epoch,
                   const Geometry& g, unsigned long long delay_ns,
                   cudaStream_t s) {
  using namespace gemm;
  using Tile = TileOf<T>;
  const bool vec = g.K % 8 == 0 && g.n % 8 == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(staging);
  Kernel<T> kernel = vec ? vec_kernel : plain_kernel;
  cudaError_t err = cudaSuccess;
  if (Tile::smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::smem);
  const long long total =
      (long long)g.world * g.world * g.n_echunks * g.n_rchunks +
      (long long)g.world * g.E * g.tiles_m * g.tiles_n;
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

}  // namespace ag
}  // namespace tdt
