// The work items of the multi-rank GEMM + reduce-scatter over world
// simulated ranks on one card, with an expert dimension: gemm_rs.cu runs
// them with one expert (the dense GEMM-RS), group_gemm_rs.cu with E (the
// MoE GroupGEMM-RS). See gemm_rs.cu for the design; the expert dimension
// is a field of each item.
//
// A (world, E, M, k) with M = world m, B (world, E, k, N): rank r's
// partial product of expert e is A[r][e] @ B[r][e], whose rows [d m, (d +
// 1) m) belong to rank d. out (world, E, m, N): out[d][e] = cast(sum over
// src = 0 .. world - 1, in that order, in f32, starting from zero, of rank
// src's partial of segment d), a remote partial rounded to the output
// dtype before it is pushed and the owner's own partial kept in f32.
// staging (world, world - 1, E, m, N) holds the pushes
// (staging[d][peer_slot(src, d)][e] = cast(partial_src[e] of segment d)).
// f32 or bf16 in and out.
//
// Two item sets, one launch of one kernel, chosen before it:
//
// bf16 that TMA can read (K and N multiples of 8, 16-byte aligned
// pointers: the wrapper's tma), run_wg_items. A product item is
// wgmma_tile.cuh's 128 x 128 tile fed by TMA (A K-major, B MN-major, K
// zero-filled to whole 64-deep steps); its f32 accumulators are staged in
// the block's shared memory (the ring, free once the K loop ends), each
// row's destination is found once (one thread a row), and the tile leaves
// as 16-byte vectors from neighbouring threads: rounded to bf16 into its
// owner's staging slot, or, for the owner's own rows, in f32. Then the
// block meets and one thread releases the tile's flag to the call's epoch
// (language.cuh). A fold item waits on the flags of every product tile
// over its rows (one thread, then a barrier) and folds 16-byte vectors of
// eight outputs in the fixed order, every source's vector loaded (through
// L2 only) before the first add, one cast. The kernel has a 64 KB ring
// (two stages) and runs three blocks an SM.
//   fused (m a multiple of 128, every tile inside one segment): the
//     owner's product and its fold are one item, as JAX's _own_segment
//     keeps the own partial in VMEM. The fold item computes rank d's tile
//     into registers, stages it in shared memory, waits on the world - 1
//     remote tiles of the same (e, rows, columns) and folds them with it:
//     no f32 scratch, own is null. Tickets come in groups: the world - 1
//     remote product tiles of one output tile, then its fold, so the fold
//     reads the pushes while they are in L2; groups run expert by expert,
//     column tile by column tile, so the blocks running together share one
//     expert's B. Where one expert's operands over every rank pass
//     GROUPED_BYTES (the dense GEMM-RS: 472 MB at Qwen3-32B's prefill),
//     their re-reads would cost more than the pushes' round trip, and the
//     tickets go rank by rank as in a plain GEMM: every remote product tile
//     (rank, expert, row tile, column tile), remote segments first, then
//     the folds (owner, expert, row tile, column tile).
//   split (m not a multiple of 128: a tile's rows straddle segments, as at
//     decode, where one row tile covers every segment and B is read once):
//     product tiles over the whole (M, N) plane write the owner's rows in
//     f32 into own, and separate fold items read them back. Tickets per
//     (expert, column tile): every rank's product tiles, then the folds.
//
// Every other call (f32, and bf16 rows TMA cannot read), run_items: the
// product tile is gemm_tile.cuh's (mma.sync for bf16, SIMT for f32) with an
// element-wise epilogue into own and staging; first every product tile
// (r, e, row tile, column tile), rank by rank and expert by expert, remote
// segments first, then the fold items (d, e, row tile, column tile).
//
// The loopback (gemm_rs_loopback.cu, one card's GEMM-RS arm) is one owner
// of a world-S call: the S sources are A's S row segments of m rows, each
// read as a plane of (m, k), one B serves every source, and only owner 0
// folds (out = source 0's f32 product + the bf16 pushes of 1 .. S - 1, in
// that order). It runs the same items (fused where m is a multiple of
// BM, else split; the gemm_tile.cuh items where TMA cannot read), with
// staging (S - 1, m, N) and, split, own (m, N) f32; fused, its tickets go
// rank by rank (in groups measured ~5% more device time at bench.py's
// shape on an H100 80GB HBM3 at 700.00 W).
//
// A product tile never waits, a fold waits only on smaller tickets, and a
// block takes a ticket only while it runs, so every flag a fold waits on
// belongs to a running block: no deadlock, whatever the dispatch order.
// Each block takes one ticket past the work; in the loopback's kernels the
// block that takes the last of them leaves the ticket at 0 (gemm_tile.cuh
// take_ticket), so a ticket kept between calls (kernels/_signal.py
// arrivals) needs no memset. Whether a kernel is the loopback's is one
// template argument (LOOPBACK), stated once in TDT_RS_KERNELS: the
// multi-rank kernels fold its branches away.
// delay_ns holds every product tile back before it releases its flag (a
// test of the waits: the result must not change).
#pragma once

#include "gemm_tile.cuh"
#include "language.cuh"
#include "vec.cuh"
#include "wgmma_tile.cuh"

namespace tdt {
namespace rs {

using gemm::bf16;
using gemm::TileOf;

// The wgmma tile, and the kernel's ring: 64 KB, two stages of a 64-deep K
// step (Qwen3-30B-A3B's f_local 96 takes both), the whole ring holding the
// staged f32 accumulators after the K loop; three blocks an SM. The items are
// short and wait mostly on latency, so more of them in flight is what
// shortens a call (a 96 KB ring at two blocks an SM measured 26% slower at
// GroupGEMM-RS's prefill and ~1.5% faster at GEMM-RS's on an H100 80GB
// HBM3 at 700.00 W, scripts/torch_gemm_rs_before_after.py --breakdown: one
// kernel serves both).
constexpr int BM = 128, BN = 128;
constexpr int RING = 64 * 1024, BLOCKS = 3;
constexpr int SMEM_BYTES = 1024 + RING + 8 * (wg::MAX_STAGES + wg::COPY_SLOTS);
static_assert(BM == TileOf<bf16>::M && BN == TileOf<bf16>::N,
              "one flag layout for both bf16 tiles");
static_assert(BM == wg::THREADS, "one thread per row of a staged tile");
static_assert(BM * BN * 4 <= RING, "the staged tile fits the ring");
// Bytes of one expert's operands over every rank up to which the fused
// items go in groups (each fold right behind its producers); past it, rank
// by rank. Qwen3-30B-A3B's GroupGEMM-RS: 4.7 MB an expert.
constexpr double GROUPED_BYTES = 16.0 * (1 << 20);

// Shapes of one call: per (rank, expert) A (M, k), B (k, N), segments of m
// rows.
struct Geometry {
  int world, E, M, m, k, N;
  int tiles_m, tiles_n;  // product tiles of one (rank, expert)
  int fold_m;            // fold row tiles of one segment
  int fused;             // wgmma, m a multiple of BM: own product in place
  int grouped;           // fused, tickets by output tile
  int total;             // items of the call
};

// The geometry of a call with element type dtype (kF32 or kBF16), on the
// wgmma items or not, or false when the shapes do not fit the kernel's int
// indices.
inline bool make_geometry(long long world, long long E, long long M,
                          long long k, long long N, int dtype, bool wgmma,
                          Geometry* g) {
  if (world < 2 || E <= 0 || M <= 0 || M % world || k <= 0 || N <= 0 ||
      M > INT32_MAX || k > INT32_MAX || N > INT32_MAX || E > INT32_MAX)
    return false;
  const int tm = dtype == kF32 ? TileOf<float>::M : BM;
  const int tn = dtype == kF32 ? TileOf<float>::N : BN;
  g->world = (int)world;
  g->E = (int)E;
  g->M = (int)M;
  g->m = (int)(M / world);
  g->k = (int)k;
  g->N = (int)N;
  g->tiles_m = (int)((M + tm - 1) / tm);
  g->tiles_n = (int)((N + tn - 1) / tn);
  g->fold_m = (g->m + tm - 1) / tm;
  g->fused = wgmma && g->m % BM == 0;
  g->grouped = g->fused && (double)world * ((double)M * k + (double)k * N) *
                                   2 <= GROUPED_BYTES;
  const long long rows = g->fused ? g->tiles_m : g->tiles_m + g->fold_m;
  const long long total = world * E * rows * g->tiles_n;
  g->total = (int)total;
  return total <= INT32_MAX;
}

// The geometry of a loopback call: S sources of m rows (A (S m, k)), B (k,
// N), out (m, N); false where it does not fit the int indices (or K is 0
// on the wgmma items, which TMA cannot read).
inline bool make_loopback_geometry(long long S, long long m, long long k,
                                   long long N, int dtype, bool wgmma,
                                   Geometry* g) {
  if (S < 1 || m <= 0 || k < 0 || (wgmma && k == 0) || N <= 0 ||
      S * m > INT32_MAX || k > INT32_MAX || N > INT32_MAX)
    return false;
  const int tm = dtype == kF32 ? TileOf<float>::M : BM;
  const int tn = dtype == kF32 ? TileOf<float>::N : BN;
  g->world = (int)S;
  g->E = 1;
  g->M = g->m = (int)m;
  g->k = (int)k;
  g->N = (int)N;
  g->tiles_m = g->fold_m = (int)((m + tm - 1) / tm);
  g->tiles_n = (int)((N + tn - 1) / tn);
  g->fused = wgmma && m % BM == 0;
  g->grouped = 0;
  // fused: S - 1 sources' products and the folds; split: every source's
  // products (source 0's into own), then the folds.
  const long long total =
      (g->fused ? S * g->tiles_m : S * g->tiles_m + g->fold_m) *
      (long long)g->tiles_n;
  g->total = (int)total;
  return total <= INT32_MAX;
}

// The block's next ticket. The loopback's ticket persists: with g.total
// items and gridDim.x blocks, each taking tickets until one is past the
// work, the block that takes the last one leaves it at 0. The multi-rank
// calls' ticket the host zeroes.
template <bool LOOPBACK>
__device__ __forceinline__ int next_ticket(int* ticket, const Geometry& g) {
  if constexpr (LOOPBACK)
    return gemm::take_ticket(ticket, g.total + (int)gridDim.x - 1);
  else
    return gemm::take_ticket(ticket);
}

// --- the wgmma items (bf16 that TMA reads) ---------------------------------

// One item: a product tile (rank r = src, row tile `row` of its (M, N)
// plane) or a fold (owner r = d, row tile `row` of segment d).
struct Item {
  bool fold;
  int r, e, row, nt;
};

// Ticket t's item in the order the header describes.
template <bool LOOPBACK>
__device__ __forceinline__ Item item_of(int t, const Geometry& g) {
  const int W = g.world, TM = g.tiles_m, TN = g.tiles_n, FM = g.fold_m;
  if (g.grouped) {  // output tile (e, nt, mt): W - 1 products, its fold
    const int grp = t / W, s = t % W;
    const int e = grp / (TM * TN), nt = (grp / TM) % TN, mt = grp % TM;
    const int d = mt / FM;
    if (s == W - 1) return Item{true, d, e, mt % FM, nt};
    return Item{false, s + (s >= d), e, mt, nt};
  }
  if (LOOPBACK && g.fused) {  // sources 1 .. S - 1, then the folds
    const int P = (W - 1) * g.E * TM * TN;
    if (t < P) {
      const int re = t / (TM * TN);
      return Item{false, 1 + re / g.E, re % g.E, (t / TN) % TM, t % TN};
    }
    t -= P;
    return Item{true, 0, t / (FM * TN), (t / TN) % FM, t % TN};
  }
  if (g.fused) {  // rank by rank: every remote product tile, then the folds
    const int RT = TM - FM;  // remote row tiles of one (rank, expert)
    const int P = W * g.E * RT * TN;
    if (t < P) {
      const int re = t / (RT * TN);
      const int r = re / g.E, j = (t / TN) % RT;
      return Item{false, r, re % g.E, ((r + 1) % W * FM + j) % TM, t % TN};
    }
    t -= P;
    const int de = t / (FM * TN);
    return Item{true, de / g.E, de % g.E, (t / TN) % FM, t % TN};
  }
  // split: per (e, nt), every rank's product tiles, then the folds (the
  // loopback's owner's alone)
  const int per = LOOPBACK ? W * TM + FM : W * (TM + FM);
  const int grp = t / per, s = t % per;
  const int e = grp / TN, nt = grp % TN;
  if (s < W * TM) return Item{false, s / TM, e, s % TM, nt};
  return Item{true, (s - W * TM) / FM, e, (s - W * TM) % FM, nt};
}

// Element (r, c) of the staged f32 tile: rows of BN floats, the 8-float
// chunk index XORed with r mod 8, so that a half-warp's 8-byte stores of
// one accumulator column (four rows) fall on distinct banks.
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * BN + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

// This thread's accumulators into the staged f32 tile.
__device__ __forceinline__ void stage(wg::Acc<BM, BN>& acc, float* tile) {
  wg::for_each_pair<BM, BN>(acc, 0, 0, [&](int r, int c, float x0,
                                           float x1) {
    *reinterpret_cast<float2*>(tile + tile_at(r, c)) = make_float2(x0, x1);
  });
}

// Eight f32 of a staged tile, or (cg) of memory another block wrote.
__device__ __forceinline__ void load8(const float* p, float* f, bool cg) {
  const float4 lo = cg ? __ldcg(reinterpret_cast<const float4*>(p))
                       : *reinterpret_cast<const float4*>(p);
  const float4 hi = cg ? __ldcg(reinterpret_cast<const float4*>(p + 4))
                       : *reinterpret_cast<const float4*>(p + 4);
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = lo.z;
  f[3] = lo.w;
  f[4] = hi.x;
  f[5] = hi.y;
  f[6] = hi.z;
  f[7] = hi.w;
}

// Sources whose 16-byte vectors a fold thread loads at once, before the
// first add: the loads' round trips overlap (a fold item is mostly their
// latency).
constexpr int FOLD_SRCS = 8;

// The items of a wgmma call: A from map ta ((k, M, world E)), B from map
// tb ((N, k, world E); the loopback's (N, k, 1)). Every thread of the
// block (wg::THREADS) calls it, with SMEM_BYTES of dynamic shared memory
// at raw.
template <bool LOOPBACK>
__device__ __forceinline__ void run_wg_items(
    const CUtensorMap* ta, const CUtensorMap* tb, bf16* __restrict__ out,
    bf16* staging, float* own, uint32_t* flags, int* ticket, uint32_t epoch,
    const Geometry& g, unsigned long long delay_ns, unsigned char* raw) {
  const wg::Smem sm(raw, RING);
  sm.init();
  uint32_t it = 0;  // stage loads so far (the ring's mbarrier phases)
  float* tile = reinterpret_cast<float*>(sm.ring);
  // A product tile's row table: each row's destination, and whether it is
  // an own row (f32).
  __shared__ void* rowp[BM];
  __shared__ bool row_own[BM];
  const int W = g.world, tid = threadIdx.x;
  const size_t seg = (size_t)g.m * g.N;  // elements of one segment
  constexpr int V = BN / 8;              // 16-byte vectors of a tile row
  // The tile at (m0, n0) of A's plane `plane` (and B's, or the one B of
  // the loopback) into `tile`, every thread.
  auto product = [&](int plane, int m0, int n0) {
    // The ring's last generic accesses precede the TMA writes into it.
    if (tid == 0) wg::fence_proxy_async();
    wg::Acc<BM, BN> acc;
    wg::mainloop<BM, BN, RING>(ta, tb, plane, LOOPBACK ? 0 : plane, m0, n0,
                               g.k, g.M, sm, it, acc);
    stage(acc, tile);
  };
  for (;;) {
    const int t = next_ticket<LOOPBACK>(ticket, g);
    if (t >= g.total) return;
    const Item item = item_of<LOOPBACK>(t, g);
    const int e = item.e, nt = item.nt, n0 = nt * BN;
    if (!item.fold) {
      const int src = item.r, plane = src * g.E + e, m0 = item.row * BM;
      product(plane, m0, n0);
      const int gr = m0 + tid;  // this thread's row: its destination
      void* p = nullptr;
      bool mine = false;
      if (gr < g.M) {
        const int dst = gr / g.m, i = gr % g.m;
        mine = dst == src;
        if (mine)
          p = own + ((size_t)dst * g.E + e) * seg + (size_t)i * g.N;
        else
          p = staging +
              (((size_t)dst * (W - 1) + src - (src > dst)) * g.E + e) * seg +
              (size_t)i * g.N;
      }
      rowp[tid] = p;
      row_own[tid] = mine;
      __syncthreads();
      for (int q = tid; q < BM * V; q += wg::THREADS) {
        const int r = q / V, c = q % V * 8;
        void* dst = rowp[r];
        if (!dst || n0 + c >= g.N) continue;
        float f[8];
        load8(tile + tile_at(r, c), f, false);
        if (row_own[r]) {
          float4* o = reinterpret_cast<float4*>(static_cast<float*>(dst) +
                                                n0 + c);
          o[0] = make_float4(f[0], f[1], f[2], f[3]);
          o[1] = make_float4(f[4], f[5], f[6], f[7]);
        } else {
          vec::store_vec(static_cast<bf16*>(dst) + n0 + c, f);
        }
      }
      lang::sleep_ns(delay_ns);
      __syncthreads();  // every thread's stores precede the release
      if (tid == 0) {
        __threadfence();
        lang::notify(flags + ((size_t)plane * g.tiles_m + item.row) *
                                 g.tiles_n + nt,
                     epoch);
      }
      continue;
    }
    const int d = item.r, plane = d * g.E + e;
    const int i0 = item.row * BM, i1 = min(i0 + BM, g.m);
    const int n1 = min(n0 + BN, g.N);
    if (g.fused) product(plane, d * g.m + i0, n0);  // own partial: tile
    if (tid == 0) {
      const int mt0 = (d * g.m + i0) / BM, mt1 = (d * g.m + i1 - 1) / BM;
      for (int src = 0; src < W; ++src) {
        if (g.fused && src == d) continue;
        for (int mt = mt0; mt <= mt1; ++mt)
          wg::wait_flag(flags + (((size_t)src * g.E + e) * g.tiles_m + mt) *
                                    g.tiles_n + nt,
                        epoch);
      }
    }
    __syncthreads();  // the flags are acquired and the own tile staged
    lang::consume_token();
    const int width = (n1 - n0) / 8, n = (i1 - i0) * width;
    const bf16* pushes = staging + ((size_t)d * (W - 1) * g.E + e) * seg;
    const size_t slot = (size_t)g.E * seg;  // one peer slot
    for (int q = tid; q < n; q += wg::THREADS) {
      const int r = q / width, c = q % width * 8;
      const size_t el = (size_t)(i0 + r) * g.N + n0 + c;
      float acc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.f;
      for (int s0 = 0; s0 < W; s0 += FOLD_SRCS) {
        uint4 v[FOLD_SRCS];
#pragma unroll
        for (int u = 0; u < FOLD_SRCS; ++u) {
          const int src = s0 + u;
          if (src >= W || src == d) continue;
          v[u] = __ldcg(reinterpret_cast<const uint4*>(
              pushes + (src - (src > d)) * slot + el));
        }
#pragma unroll
        for (int u = 0; u < FOLD_SRCS; ++u) {
          const int src = s0 + u;
          if (src >= W) continue;
          float f[8];
          if (src != d)
            vec::Vec<bf16>::load(v[u], f);
          else if (g.fused)
            load8(tile + tile_at(r, c), f, false);
          else
            load8(own + (size_t)plane * seg + el, f, true);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] += f[k];
        }
      }
      vec::store_vec(out + (size_t)plane * seg + el, acc);
    }
    // take_ticket starts at a barrier: the tile is not read again.
  }
}

// --- the gemm_tile.cuh items (f32, and bf16 rows TMA cannot read) ----------

template <typename T, bool VEC, bool LOOPBACK>
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
  const size_t seg = (size_t)g.m * g.N;  // elements of one segment
  for (;;) {
    const int t = next_ticket<LOOPBACK>(ticket, g);
    if (t >= g.total) return;
    if (t < products) {
      const int re = t / per_expert;  // r E + e
      const int r = re / g.E, e = re % g.E;
      const int j = (t / g.tiles_n) % g.tiles_m, nt = t % g.tiles_n;
      const int mt = (((r + 1) % W) * g.m / Tile::M + j) % g.tiles_m;
      const int m0 = mt * Tile::M, n0 = nt * Tile::N;
      gemm::product_tile<T, VEC>(
          A + (size_t)re * g.M * g.k, g.k,
          B + (size_t)(LOOPBACK ? e : re) * g.k * g.N, g.N,
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

// The persistent grid of `kernel` (threads, smem bytes of dynamic shared
// memory, the limit raised once) over g.total items on stream s, the
// ticket zeroed first unless it is a persistent one that the kernel left
// at 0 (the loopback's).
template <bool LOOPBACK, class K, class... Args>
cudaError_t launch_grid(K kernel, int threads, int smem, const Geometry& g,
                        void* ticket, cudaStream_t s, Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem > 0)
    err = gemm::allow_smem(reinterpret_cast<const void*>(kernel), smem);
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = gemm::persistent_blocks(kernel, threads, smem, g.total, &blocks);
  if (err == cudaSuccess && !LOOPBACK)
    err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// Launch one call: bf16 with tma on the wgmma kernel (own may be null when
// m is a multiple of BM), every other call on the gemm_tile.cuh kernels
// (the 16-byte variant where k, N and the pointers allow it; own needed).
// a (world, E, M, k), b (world, E, k, N), out (world, E, m, N), staging
// (world, world - 1, E, m, N), own (world, E, m, N) f32. The loopback's
// (E 1): a (world m, k) in world segments of M = m rows, b (k, N), out (m,
// N), staging (world - 1, m, N), own (m, N) f32.
template <bool LOOPBACK, class WgKernel>
cudaError_t launch(WgKernel wg_kernel, Kernel<bf16> bf16_vec,
                   Kernel<bf16> bf16_plain, Kernel<float> f32_vec,
                   Kernel<float> f32_plain, const void* a, const void* b,
                   void* out, void* staging, void* own, void* flags,
                   void* ticket, unsigned epoch, long long world,
                   long long E, long long M, long long k, long long N,
                   int dtype, int tma, unsigned long long delay_ns,
                   cudaStream_t s) {
  using gemm::aligned16;
  Geometry g;
  const bool wgmma = dtype == kBF16 && tma;
  if ((dtype != kF32 && dtype != kBF16) || !staging ||
      !(LOOPBACK ? E == 1 && make_loopback_geometry(world, M, k, N, dtype,
                                                    wgmma, &g)
                 : make_geometry(world, E, M, k, N, dtype, wgmma, &g)) ||
      (!g.fused && !own))
    return cudaErrorInvalidValue;
  uint32_t* fl = static_cast<uint32_t*>(flags);
  int* tk = static_cast<int*>(ticket);
  if (wgmma) {
    CUtensorMap ta, tb;
    if (k % 8 || N % 8 || !aligned16(a) || !aligned16(b) ||
        !aligned16(out) || !aligned16(staging) || (own && !aligned16(own)) ||
        !wg::encode_a(&ta, a, k, M, world * E, BM) ||
        !wg::encode_b(&tb, b, N, k, LOOPBACK ? E : world * E))
      return cudaErrorInvalidValue;
    return launch_grid<LOOPBACK>(
        wg_kernel, wg::THREADS, SMEM_BYTES, g, ticket, s, ta, tb,
        static_cast<bf16*>(out), static_cast<bf16*>(staging),
        static_cast<float*>(own), fl, tk, epoch, g, delay_ns);
  }
  const bool vec = k % 8 == 0 && N % 8 == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(out) && aligned16(staging) &&
                   aligned16(own);
  if (dtype == kF32) {
    using Tile = TileOf<float>;
    return launch_grid<LOOPBACK>(
        vec ? f32_vec : f32_plain, Tile::threads, Tile::smem, g, ticket, s,
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), static_cast<float*>(staging),
        static_cast<float*>(own), fl, tk, epoch, g, delay_ns);
  }
  using Tile = TileOf<bf16>;
  return launch_grid<LOOPBACK>(
      vec ? bf16_vec : bf16_plain, Tile::threads, Tile::smem, g, ticket, s,
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), static_cast<bf16*>(staging),
      static_cast<float*>(own), fl, tk, epoch, g, delay_ns);
}

}  // namespace rs
}  // namespace tdt

// The kernels of a .cu file that runs these items, named after it (the
// profiler finds a kernel by its name): NAME_kernel_wgmma and
// NAME_kernel<T, VEC>, and NAME_launch; LOOPBACK true for the loopback's.
#define TDT_RS_KERNELS(NAME, LOOPBACK)                                        \
  __global__ void __launch_bounds__(tdt::wg::THREADS, tdt::rs::BLOCKS)        \
      NAME##_kernel_wgmma(const __grid_constant__ CUtensorMap ta,             \
                          const __grid_constant__ CUtensorMap tb,             \
                          tdt::gemm::bf16* out, tdt::gemm::bf16* staging,     \
                          float* own, uint32_t* flags, int* ticket,           \
                          uint32_t epoch, tdt::rs::Geometry g,                \
                          unsigned long long delay_ns) {                      \
    extern __shared__ __align__(16) unsigned char smem[];                     \
    tdt::rs::run_wg_items<LOOPBACK>(&ta, &tb, out, staging, own, flags,       \
                                    ticket, epoch, g, delay_ns, smem);        \
  }                                                                           \
  template <typename T, bool VEC>                                             \
  __global__ void __launch_bounds__(tdt::gemm::TileOf<T>::threads)            \
      NAME##_kernel(const T* __restrict__ A, const T* __restrict__ B,         \
                    T* __restrict__ out, T* staging, float* own,              \
                    uint32_t* flags, int* ticket, uint32_t epoch,             \
                    tdt::rs::Geometry g, unsigned long long delay_ns) {       \
    extern __shared__ __align__(16) unsigned char smem[];                     \
    tdt::rs::run_items<T, VEC, LOOPBACK>(A, B, out, staging, own, flags,      \
                                         ticket, epoch, g, delay_ns, smem);   \
  }                                                                           \
  inline cudaError_t NAME##_launch(                                           \
      const void* a, const void* b, void* out, void* staging, void* own,      \
      void* flags, void* ticket, unsigned epoch, long long world,             \
      long long E, long long M, long long k, long long N, int dtype, int tma, \
      unsigned long long delay_ns, cudaStream_t s) {                          \
    using tdt::gemm::bf16;                                                    \
    return tdt::rs::launch<LOOPBACK>(                                         \
        NAME##_kernel_wgmma, NAME##_kernel<bf16, true>,                       \
        NAME##_kernel<bf16, false>, NAME##_kernel<float, true>,               \
        NAME##_kernel<float, false>, a, b, out, staging, own, flags, ticket,  \
        epoch, world, E, M, k, N, dtype, tma, delay_ns, s);                   \
  }
