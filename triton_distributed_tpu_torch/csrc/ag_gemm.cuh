// The work items of the multi-rank AG-GEMM over world simulated ranks on
// one card, with an expert dimension: ag_gemm.cu runs them with one expert
// (the dense AG-GEMM), ag_group_gemm.cu with E (the MoE AG-GroupGEMM), and
// ag_gemm_loopback.cu at world 1 with one expert (the one-chip loopback,
// whose chunks never straddle a segment; its bare twin has no producer
// items, and its consumers read A itself and wait on nothing).
//
// A (world, E, m, K): source src's rows of expert e; S (world, E, world, m,
// K): rank d's gathered rows of expert e in absolute source order,
// S[d][e][src] = A[src][e]; B (world, E, K, n); C (world, E, world m, cols)
// with cols <= n: C[d][e] = S[d][e] (as (world m, K)) @ B[d][e][:, :cols].
// f32 or bf16 in and out, f32 accumulation.
//
// Items, handed out by an atomic ticket in one persistent grid. A unit is
// one expert chunk ce (ec experts): its producer items (src, cr) copy rows
// [cr chunk_rows, ...) of the chunk's experts of A[src] into every rank's
// staging, reading them once, and raise flag (d, src, chunk) to the call's
// epoch for every rank d; its consumer items are the output tiles of each
// rank d over the chunk's experts, rank by rank and expert by expert, each
// rank's in its segment order (step j is the row tile (tile of row d m +
// j) mod tiles). A consumer's thread 0 waits on the flag of every chunk its
// rows touch and then reads those rows from S, never from A. Every producer
// item is handed out before the first consumer, unit by unit. Every flag a
// consumer waits on belongs to a producer with a smaller ticket; a producer
// never waits, and a block takes a ticket only while it runs: no deadlock,
// whatever the dispatch order.
// delay_ns holds every producer item back before its copy (a test of the
// waits: the result must not change).
//
// At Qwen3-30B-A3B's prefill the staging (world x world x E x m x K) is
// written to and read back from device memory: measured, producers alone
// and consumers alone each take about half the kernel's time, and an order
// that hands each unit's consumers out right behind its producers (~24 MB
// of staging ahead) was no faster than this one (ag_group_gemm.cu).
// Reading each source chunk once for all world ranks keeps the producers'
// reads at 1 x the grids.
//
// bf16 that TMA can read (WgPath): a producer item is thread 0 moving the
// rows with bulk copies through the block's shared memory (wgmma_tile.cuh
// bulk_copy, 96 KB in flight), and a consumer item is wgmma_tile.cuh's 256
// x 96 or 128 x 128 tile (128 x 96 for a plane of at most 128 rows), fed by
// TMA from S and B. TMA needs K and n in whole 16-byte rows and 16-byte
// aligned bases: the wrapper decides from the shapes and pointers and
// passes the answer (tma). Every other call runs TilePath: every thread
// copies (lang::copy_block) and the tile is gemm_tile.cuh's, the mma.sync
// tile for bf16 (element loads, any row length) and the SIMT tile for f32,
// full f32. Either way one launch of one kernel, chosen before it.
#pragma once

#include <algorithm>

#include "gemm_tile.cuh"
#include "language.cuh"
#include "wgmma_tile.cuh"

namespace tdt {
namespace ag {

// Shapes of one call: per (rank, expert) A rows (m, K), B (K, n), C (world
// m, cols); producer chunks of ec experts x chunk_rows rows; bm x bn tiles.
struct Geometry {
  int world, E, m, K, n, cols;
  int ec, n_echunks;          // experts of one chunk, chunks over E
  int chunk_rows, n_rchunks;  // rows of one chunk, chunks over m
  int bm, bn;                 // the consumer tile
  int tiles_m, tiles_n;       // output tiles of one (rank, expert)
  int units, p_items, c_items;
  int total;
};

// The geometry of a call with bm x bn tiles, or false when the shapes do
// not fit the kernel's int indices. Without producers (produce false) the
// consumer items read their rows in place and wait on no flag.
inline bool make_geometry(long long world, long long E, long long m,
                          long long K, long long n, long long cols,
                          long long ec, long long chunk_rows, int bm, int bn,
                          Geometry* g, bool produce = true) {
  if (world < 1 || E <= 0 || m <= 0 || K <= 0 || n <= 0 || cols <= 0 ||
      cols > n || ec <= 0 || chunk_rows <= 0 || world * m > INT32_MAX ||
      K > INT32_MAX || n > INT32_MAX || E > INT32_MAX)
    return false;
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
  g->bm = bm;
  g->bn = bn;
  g->tiles_m = (int)((world * m + bm - 1) / bm);
  g->tiles_n = (int)((cols + bn - 1) / bn);
  const long long units = g->n_echunks;
  const long long p = produce ? world * g->n_rchunks : 0;
  const long long c = world * g->ec * g->tiles_m * g->tiles_n;
  if (units * (p + c) > INT32_MAX) return false;
  g->units = (int)units;
  g->p_items = (int)p;
  g->c_items = (int)c;
  g->total = (int)(units * (p + c));
  return true;
}

struct Item {
  bool producer;
  int unit, r;  // r: the item's index within its unit's producers/consumers
};

// Ticket t's item in the order P(0) .. P(units - 1), C(0) .. C(units - 1).
__device__ __forceinline__ Item item_of(int t, const Geometry& g) {
  const int P = g.p_items, C = g.c_items;
  if (t < g.units * P) return Item{true, t / P, t % P};
  t -= g.units * P;
  return Item{false, t / C, t % C};
}

// The items of one call, over a Path that moves the rows and runs the
// tiles (WgPath, TilePath). Every thread of the block calls it. Each block
// takes one ticket past the work; the block that takes the last of them
// leaves the ticket at 0 for the next call.
template <class Path>
__device__ __forceinline__ void run_items(Path& path, uint32_t* flags,
                                          int* ticket, uint32_t epoch,
                                          const Geometry& g,
                                          unsigned long long delay_ns) {
  const int W = g.world, rows = W * g.m;
  const size_t seg = (size_t)g.m * g.K;  // elements of one (source, expert)
  const int n_chunks = g.n_echunks * g.n_rchunks;
  const int per_rank = g.ec * g.tiles_m * g.tiles_n;
  for (;;) {
    const int t = gemm::take_ticket(ticket);
    if (t >= g.total) {
      if (threadIdx.x == 0 && t == g.total + (int)gridDim.x - 1) *ticket = 0;
      return;
    }
    const Item it = item_of(t, g);
    const int ce = it.unit;
    if (it.producer) {  // source src pushes chunk c to every rank
      const int src = it.r / g.n_rchunks, cr = it.r % g.n_rchunks;
      const int c = ce * g.n_rchunks + cr;
      const long long r0 = (long long)cr * g.chunk_rows;
      const long long nr = min((long long)g.chunk_rows, g.m - r0);
      if (threadIdx.x == 0) lang::sleep_ns(delay_ns);
      for (int e = ce * g.ec; e < min(g.E, (ce + 1) * g.ec); ++e)
        path.push(path.S + ((size_t)e * W + src) * seg + r0 * g.K,
                  (size_t)g.E * W * seg, W,
                  path.A + ((size_t)src * g.E + e) * seg + r0 * g.K,
                  nr * g.K);
      path.pushed();  // every copy has landed and is visible
      if (threadIdx.x == 0) {
        __threadfence();
        for (int d = 0; d < W; ++d)
          lang::notify(flags + ((size_t)d * W + src) * n_chunks + c, epoch);
      }
      continue;
    }
    const int d = it.r / per_rank, rr = it.r % per_rank;
    const int e = ce * g.ec + rr / (g.tiles_m * g.tiles_n);
    if (e >= g.E) continue;  // the padding of a short last chunk
    const int j = (rr / g.tiles_n) % g.tiles_m, nt = rr % g.tiles_n;
    const int mt = ((d * g.m) / g.bm + j) % g.tiles_m;
    const int m0 = mt * g.bm, n0 = nt * g.bn;
    if (threadIdx.x == 0 && g.p_items) {  // first touch: every chunk
      const int end = min(m0 + g.bm, rows);
      const uint32_t* ef =
          flags + (size_t)(e / g.ec) * g.n_rchunks;  // expert e's chunks
      for (int r = m0; r < end;) {
        const int src = r / g.m, cr = (r % g.m) / g.chunk_rows;
        path.wait(ef + ((size_t)d * W + src) * n_chunks + cr, epoch);
        r = src * g.m + min((cr + 1) * g.chunk_rows, g.m);
      }
    }
    path.consume(d * g.E + e, m0, n0);
  }
}

// bf16 on Hopper's units: bulk-copy producers, the BM x BN wgmma tile.
template <int BM, int BN>
struct WgPath {
  using T = gemm::bf16;
  const T* A;
  T* S;
  T* C;
  const CUtensorMap* ta;  // S as (K, world m, world E)
  const CUtensorMap* tb;  // B as (n, K, world E)
  const Geometry& g;
  wg::Smem sm;
  uint32_t it = 0, cit = 0;  // stage loads and copy pieces so far

  // n elements of src to the n_dst destinations dst + i dst_stride.
  __device__ __forceinline__ void push(T* dst, size_t dst_stride, int n_dst,
                                       const T* src, size_t n) {
    if (threadIdx.x == 0)
      wg::bulk_copy(dst, dst_stride * sizeof(T), n_dst, src, n * sizeof(T),
                    sm, cit);
  }
  __device__ __forceinline__ void pushed() {
    if (threadIdx.x == 0) wg::fence_proxy_async();
  }
  __device__ __forceinline__ void wait(const uint32_t* flag, uint32_t e) {
    wg::wait_flag(flag, e);
  }
  // Every thread; thread 0 has acquired the rows' flags.
  __device__ __forceinline__ void consume(int plane, int m0, int n0) {
    const int rows = g.world * g.m;
    if (threadIdx.x == 0) wg::fence_proxy_async();  // then TMA reads S
    wg::Acc<BM, BN> acc;
    wg::mainloop<BM, BN>(ta, tb, plane, plane, m0, n0, g.K, rows, sm, it,
                         acc);
    T* Cp = C + (size_t)plane * rows * g.cols;
    const bool pairs = g.cols % 2 == 0;
    wg::for_each_pair<BM, BN>(acc, m0, n0, [&](int r, int c, float x0,
                                               float x1) {
      if (r >= rows || c >= g.cols) return;
      T* p = Cp + (size_t)r * g.cols + c;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        p[0] = __float2bfloat16(x0);
        if (c + 1 < g.cols) p[1] = __float2bfloat16(x1);
      }
    });
  }
};

// Every thread copies (16-byte moves where the shapes allow), and the tile
// is gemm_tile.cuh's product_tile: mma.sync for bf16 (its element loads take
// any row length and alignment; smem holds gemm::SMEM_BYTES), SIMT for f32.
template <typename T>
struct TilePath {
  const T* A;
  T* S;
  T* C;
  const T* B;
  const Geometry& g;
  unsigned char* smem;

  __device__ __forceinline__ void push(T* dst, size_t dst_stride, int n_dst,
                                       const T* src, size_t n) {
    for (int i = 0; i < n_dst; ++i)
      lang::copy_block(dst + i * dst_stride, src, n * sizeof(T));
  }
  __device__ __forceinline__ void pushed() {
    __syncthreads();  // every thread's stores precede the release
  }
  __device__ __forceinline__ void wait(const uint32_t* flag, uint32_t e) {
    lang::wait(flag, e);
  }
  __device__ __forceinline__ void consume(int plane, int m0, int n0) {
    __syncthreads();
    lang::consume_token();
    const int rows = g.world * g.m;
    T* Cp = C + (size_t)plane * rows * g.cols;
    gemm::product_tile<T, false>(
        S + (size_t)plane * rows * g.K, g.K, B + (size_t)plane * g.K * g.n,
        g.n, rows, g.cols, g.K, m0, n0, smem,
        [&](int gr, int gc, float v) {
          if (gr < rows && gc < g.cols)
            Cp[(size_t)gr * g.cols + gc] = from_f32<T>(v);
        });
    // product_tile ends at a barrier: its shared memory is free again.
  }
};

// The bf16 tile for a plane of `rows` x cols outputs: 96 columns where
// that covers them with fewer masked columns than 128 (Qwen3-30B-A3B's
// f_local), else 128; 256 rows for a 96-wide tile over more than 128 rows
// (each weight shard is then read half as often), else 128.
inline int tile_n(long long cols) {
  return cols % 96 == 0 && cols % 128 != 0 ? 96 : 128;
}
inline int tile_m(int bn, long long rows) {
  return bn == 96 && rows > 128 ? 256 : 128;
}

// Whether a bf16 call meets TMA's rules: 16-byte aligned bases and rows in
// whole 16-byte units (the wrapper's tma, checked again before a launch
// that relies on it).
inline bool tma_ready(const void* a, const void* staging, const void* b,
                      long long K, long long n) {
  return K % 8 == 0 && n % 8 == 0 && gemm::aligned16(a) &&
         gemm::aligned16(staging) && gemm::aligned16(b);
}

// Launch the persistent grid of a kernel of `threads` threads and `smem`
// bytes of dynamic shared memory, the ticket zeroed first on stream s.
template <class Kernel, class... Args>
cudaError_t launch_grid(Kernel kernel, int threads, int smem,
                        const Geometry& g, void* ticket, cudaStream_t s,
                        Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = gemm::persistent_blocks(kernel, threads, smem, g.total, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// Launch a call: bf16 that TMA can read (tma) on the wgmma kernel of the
// tile_m x tile_n shape, other bf16 on the mma.sync kernel, f32 on the
// SIMT kernel. a (world, E, m, K), staging (world, E, world, m, K), b
// (world, E, K, n), out (world, E, world m, cols).
template <class Wg256x96, class Wg128x96, class Wg128x128, class Mma,
          class F32>
cudaError_t launch(Wg256x96 wg256x96, Wg128x96 wg128x96,
                   Wg128x128 wg128x128, Mma mma, F32 f32, const void* a,
                   void* staging, const void* b, void* out, void* flags,
                   void* ticket, unsigned epoch, long long world, long long E,
                   long long m, long long K, long long n, long long cols,
                   long long ec, long long chunk_rows, int dtype, int tma,
                   unsigned long long delay_ns, cudaStream_t s) {
  Geometry g;
  uint32_t* fl = static_cast<uint32_t*>(flags);
  int* tk = static_cast<int*>(ticket);
  if (!staging) return cudaErrorInvalidValue;
  if (dtype == kBF16 && tma) {
    using gemm::bf16;
    const int bn = tile_n(cols), bm = tile_m(bn, world * m);
    if (!tma_ready(a, staging, b, K, n) ||
        !make_geometry(world, E, m, K, n, cols, ec, chunk_rows, bm, bn, &g))
      return cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    if (!wg::encode_a(&ta, staging, K, world * m, world * E, bm) ||
        !wg::encode_b(&tb, b, n, K, world * E))
      return cudaErrorInvalidValue;
    const bf16* A = static_cast<const bf16*>(a);
    bf16* S = static_cast<bf16*>(staging);
    bf16* C = static_cast<bf16*>(out);
    if (bm == 256)
      return launch_grid(wg256x96, wg::THREADS, wg::SMEM_BYTES, g, ticket, s,
                         ta, tb, A, S, C, fl, tk, epoch, g, delay_ns);
    if (bn == 96)
      return launch_grid(wg128x96, wg::THREADS, wg::SMEM_BYTES, g, ticket, s,
                         ta, tb, A, S, C, fl, tk, epoch, g, delay_ns);
    return launch_grid(wg128x128, wg::THREADS, wg::SMEM_BYTES, g, ticket, s,
                       ta, tb, A, S, C, fl, tk, epoch, g, delay_ns);
  }
  if (dtype == kBF16) {
    using gemm::bf16;
    if (!make_geometry(world, E, m, K, n, cols, ec, chunk_rows, gemm::BM,
                       gemm::BN, &g))
      return cudaErrorInvalidValue;
    return launch_grid(mma, gemm::THREADS, gemm::SMEM_BYTES, g, ticket, s,
                       static_cast<const bf16*>(a),
                       static_cast<bf16*>(staging),
                       static_cast<const bf16*>(b), static_cast<bf16*>(out),
                       fl, tk, epoch, g, delay_ns);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  using Tile = gemm::TileOf<float>;
  if (!make_geometry(world, E, m, K, n, cols, ec, chunk_rows, Tile::M, Tile::N,
                     &g))
    return cudaErrorInvalidValue;
  return launch_grid(f32, Tile::threads, 0, g, ticket, s,
                     static_cast<const float*>(a),
                     static_cast<float*>(staging),
                     static_cast<const float*>(b), static_cast<float*>(out),
                     fl, tk, epoch, g, delay_ns);
}

}  // namespace ag
}  // namespace tdt

// The kernels of a .cu file that runs these items, named after it (the
// profiler finds a kernel by its name): NAME_kernel_wgmma<BM, BN>,
// NAME_kernel_mma (bf16 rows TMA cannot read) and NAME_kernel_f32.
#define TDT_AG_KERNELS(NAME)                                                 \
  template <int BM, int BN>                                                  \
  __global__ void __launch_bounds__(tdt::wg::THREADS, 2)                     \
      NAME##_kernel_wgmma(const __grid_constant__ CUtensorMap ta,            \
                          const __grid_constant__ CUtensorMap tb,            \
                          const tdt::gemm::bf16* A, tdt::gemm::bf16* S,      \
                          tdt::gemm::bf16* C, uint32_t* flags, int* ticket,  \
                          uint32_t epoch, tdt::ag::Geometry g,               \
                          unsigned long long delay_ns) {                     \
    extern __shared__ __align__(16) unsigned char smem[];                    \
    tdt::ag::WgPath<BM, BN> path{A, S, C, &ta, &tb, g, tdt::wg::Smem(smem)}; \
    path.sm.init();                                                          \
    tdt::ag::run_items(path, flags, ticket, epoch, g, delay_ns);             \
  }                                                                          \
  __global__ void __launch_bounds__(tdt::gemm::THREADS)                      \
      NAME##_kernel_mma(const tdt::gemm::bf16* A, tdt::gemm::bf16* S,        \
                        const tdt::gemm::bf16* B, tdt::gemm::bf16* C,        \
                        uint32_t* flags, int* ticket, uint32_t epoch,        \
                        tdt::ag::Geometry g, unsigned long long delay_ns) {  \
    extern __shared__ __align__(16) unsigned char smem[];                    \
    tdt::ag::TilePath<tdt::gemm::bf16> path{A, S, C, B, g, smem};            \
    tdt::ag::run_items(path, flags, ticket, epoch, g, delay_ns);             \
  }                                                                          \
  __global__ void __launch_bounds__(tdt::gemm::F_THREADS)                    \
      NAME##_kernel_f32(const float* A, float* S, const float* B, float* C,  \
                        uint32_t* flags, int* ticket, uint32_t epoch,        \
                        tdt::ag::Geometry g, unsigned long long delay_ns) {  \
    tdt::ag::TilePath<float> path{A, S, C, B, g, nullptr};                   \
    tdt::ag::run_items(path, flags, ticket, epoch, g, delay_ns);             \
  }
