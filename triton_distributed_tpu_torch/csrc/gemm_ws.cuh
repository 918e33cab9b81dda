// A warp-specialised persistent bf16 GEMM on Hopper's units: C = A @ B with
// A (M, K) and B (K, N) row-major, f32 accumulation, C bf16.
//
// The block: three warpgroups, 384 threads, one block an SM.
//   Warpgroup 0 is the producer. It gives up registers (setmaxnreg.dec to
//     PRODUCER_REGS) and one of its threads keeps TMA loads in flight
//     through a ring of STAGES stages of BK = 64 (wgmma_tile.cuh's operand
//     layouts: A K-major with the 128-byte swizzle, one box of 128 rows a
//     stage; B as it is stored, MN-major with wgmma's transpose bit, BN /
//     32 boxes of 64 k rows x 32 columns with the 64-byte swizzle).
//   Warpgroups 1 and 2 are the consumers (setmaxnreg.inc to CONSUMER_REGS):
//     each takes 64 rows of the BM x BN tile (BM = 128) and runs
//     m64nBNk16 wgmma on the stages as they land, BN / 2 f32 accumulators
//     a thread. A consumer whose 64 rows lie wholly past M issues no
//     products (it still passes each stage on).
//   Each stage has a full barrier (the producer's arrival with the stage's
//     transaction bytes) and an empty barrier (one arrival per consumer
//     warpgroup). A consumer releases stage s as soon as wgmma.wait_group
//     shows that s's products are done (one k-tile behind the products it
//     has in flight). No __syncthreads in the K loop. The empty barriers'
//     first phase passes without a wait: the producer waits on the parity
//     before the current one.
// Persistence: the grid is at most one block an SM; block b walks the
//   output tiles b, b + gridDim.x, ... of a tile order (Grouped: bands of
//   GROUP_M row tiles swept along N, so that the blocks running together
//   share A's rows and B's columns in L2). The producer's ring runs across
//   tiles, so it loads the next tile's first stages while the consumers
//   store this one. No tile waits on another: no ticket, no scratch.
// Epilogue: each consumer casts its 64 x BN accumulators to bf16 box by
//   box (64 rows x 64 columns) into BOXES shared-memory boxes of its
//   own, laid out as TMA's 128-byte swizzle (which keeps a warp's stores
//   on distinct banks), fences the async proxy, meets its warpgroup at a
//   named barrier, and one thread stores the box by TMA (which writes no
//   row past M and no column past N); before a box is refilled that
//   thread waits until the store that used it has read it. Two boxes a
//   consumer (32 KB) leave room for four stages of the 128 x 256 tile.
// TMA zero-fills loads past the tensor, so ragged M, N and K need no mask.
//
// The main loop (produce, consume) and the tile order (Grouped, a template
// argument of run) are apart, so that another kernel can walk its own
// tiles over the same loop.
//
// Hazard: ptxas serialises every wgmma of a kernel (info line C7520) when
// a call or a spin it cannot see through sits where a product is in
// flight; no printf here, and the waits are wgmma_tile.cuh's bounded
// mbar_wait (a trap, not a print).
#pragma once

#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace tdt {
namespace ws {

constexpr int BM = 128, BK = wg::BK, THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
              "the register split fits the SM's file");
// Row tiles of one band of the grouped order.
constexpr int GROUP_M = 8;
// One epilogue box: 64 rows x 64 bf16 columns (128 bytes, the swizzle's
// span); a consumer's boxes in shared memory.
constexpr int EPI_BOX = 64 * 128, BOXES = 2;
// Dynamic shared memory a block may use (232,448 bytes), less the 1 KB of
// slack that aligns the ring to the swizzle's 1,024-byte atom and the
// barriers' room: the ring's and the epilogue boxes' budget.
constexpr int BUDGET = 232448 - 1024 - 256;

template <int BN>
struct Shape {
  static_assert(BN == 128 || BN == 256, "128 x 128 or 128 x 256 tiles");
  static constexpr int A_STAGE = BM * BK * 2;
  static constexpr int B_STAGE = BN * BK * 2;  // BN / 32 blocks of 4 KB
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int EPI = 2 * BOXES * EPI_BOX;
  static constexpr int STAGES = (BUDGET - EPI) / STAGE;
  // The slack, the ring, the epilogue boxes, then the full and empty
  // barriers.
  static constexpr int SMEM = 1024 + STAGES * STAGE + EPI + 16 * STAGES;
  static_assert(STAGES >= 2 && SMEM <= 232448, "the ring fits");
};

// --- PTX wrappers -----------------------------------------------------------

// One arrival on an mbarrier.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   wg::smem_u32(bar))
               : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The threads of one warpgroup meet (named barrier id, 128 threads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The 3-D box at (c0, c1, c2) of `map` from shared memory at src, in this
// thread's open bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(wg::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// --- the tile order ---------------------------------------------------------

// Output tiles in bands of GROUP_M row tiles, each band swept column tile
// by column tile, its row tiles in a row (a short last band of fewer).
struct Grouped {
  int tiles_m, tiles_n, total;

  __device__ __forceinline__ void tile(int t, int& mt, int& nt) const {
    const int per_band = GROUP_M * tiles_n;
    const int first = t / per_band * GROUP_M;
    const int rows = min(GROUP_M, tiles_m - first);
    const int r = t % per_band;
    mt = first + r % rows;
    nt = r / rows;
  }
};

// --- the ring ---------------------------------------------------------------

template <int BN>
struct Ring {
  using S = Shape<BN>;
  unsigned char* stages;  // STAGES x (A box, then B's blocks)
  unsigned char* epi;     // 2 x BOXES boxes
  uint64_t* full;         // STAGES
  uint64_t* empty;        // STAGES

  __device__ __forceinline__ explicit Ring(unsigned char* raw) {
    const uint32_t a = wg::smem_u32(raw);
    stages = raw + ((1024 - (a & 1023)) & 1023);
    epi = stages + S::STAGES * S::STAGE;
    full = reinterpret_cast<uint64_t*>(epi + S::EPI);
    empty = full + S::STAGES;
  }
  // Thread 0, once, before the block's first __syncthreads.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < S::STAGES; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    wg::fence_barrier_init();
  }
};

// The producer thread: the ktiles k-tiles of the tile at rows m0 and
// columns n0 into the ring; `it` counts the stage loads so far and is
// advanced.
template <int BN>
__device__ __forceinline__ void produce(const Ring<BN>& ring,
                                        const CUtensorMap* ta,
                                        const CUtensorMap* tb, int m0, int n0,
                                        int ktiles, uint32_t& it) {
  using S = Shape<BN>;
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % S::STAGES;
    // The use before this one has been released (a fresh barrier's
    // "previous" phase counts as done).
    wg::mbar_wait(ring.empty + s, ((it / S::STAGES) & 1) ^ 1);
    uint64_t* bar = ring.full + s;
    unsigned char* st = ring.stages + s * S::STAGE;
    wg::mbar_expect_tx(bar, S::STAGE);
    wg::tma_load_3d(st, ta, bar, kt * BK, m0, 0);
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
      wg::tma_load_3d(st + S::A_STAGE + j * wg::B_BLOCK, tb, bar,
                      n0 + 32 * j, kt * BK, 0);
  }
}

// A consumer warpgroup's K loop over the next ktiles stages: its 64 rows
// (h: 0 or 1 of the tile) into acc, or, when live is false, no products
// (each stage passed on). `it` counts the stages used so far.
template <int BN>
__device__ __forceinline__ void consume(const Ring<BN>& ring, int h,
                                        bool live, int ktiles, uint32_t& it,
                                        float (&acc)[BN / 2]) {
  using S = Shape<BN>;
  const bool leader = threadIdx.x % 128 == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (live) {
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint32_t u = it + kt;
      const int s = u % S::STAGES;
      wg::mbar_wait(ring.full + s, (u / S::STAGES) & 1);
      const unsigned char* st = ring.stages + s * S::STAGE;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wg::Mma<BN>::run(
            acc, wg::make_desc(st + h * 64 * 128 + kk * 32, 16, 1024, 1),
            wg::make_desc(st + S::A_STAGE + kk * 16 * 64, wg::B_BLOCK, 512,
                          2));
      wg::wgmma_commit();
      // k-tile kt - 1's products are done (kt's may still run): its
      // stage goes back to the producer.
      wg::wgmma_wait<1>();
      if (leader && kt > 0) mbar_arrive(ring.empty + (u - 1) % S::STAGES);
    }
    wg::wgmma_wait<0>();
    if (leader && ktiles > 0)
      mbar_arrive(ring.empty + (it + ktiles - 1) % S::STAGES);
  } else {
    for (int kt = 0; kt < ktiles; ++kt) {
      const uint32_t u = it + kt;
      wg::mbar_wait(ring.full + u % S::STAGES, (u / S::STAGES) & 1);
      if (leader) mbar_arrive(ring.empty + u % S::STAGES);
    }
  }
  it += ktiles;
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A consumer warpgroup's rows [m0, m0 + 64) x columns [n0, n0 + BN) of C
// ((N, M, 1) map tc), bf16. `stored` counts the boxes this warpgroup has
// stored so far (which box is free) and is advanced.
template <int BN>
__device__ __forceinline__ void store(const Ring<BN>& ring, int h,
                                      const CUtensorMap* tc, int N, int m0,
                                      int n0, float (&acc)[BN / 2],
                                      uint32_t& stored) {
  const bool leader = threadIdx.x % 128 == 0;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 4;  // and r + 8, the same r mod 8
#pragma unroll
  for (int j = 0; j < BN / 64; ++j) {
    if (n0 + 64 * j >= N) break;  // uniform: a column box past N
    unsigned char* box = ring.epi + (h * BOXES + stored % BOXES) * EPI_BOX;
    // The store that last used this box has read it.
    if (leader) wg::bulk_wait_read_upto<BOXES - 1>();
    warpgroup_sync(1 + h);
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // columns 8 q + 2 (lane % 4) of the box
      const int byte = (8 * q + 2 * (lane % 4)) * 2;
      const int at = (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
      const float* x = acc + 4 * (8 * j + q);
      *reinterpret_cast<uint32_t*>(box + r * 128 + at) = pack_bf16(x[0], x[1]);
      *reinterpret_cast<uint32_t*>(box + (r + 8) * 128 + at) =
          pack_bf16(x[2], x[3]);
    }
    wg::fence_proxy_async();
    warpgroup_sync(1 + h);
    if (leader) {
      tma_store_3d(tc, box, n0 + 64 * j, m0, 0);
      wg::bulk_commit();
    }
    ++stored;
  }
}

// The persistent block: every thread of it (THREADS) calls run, with
// Shape<BN>::SMEM bytes of dynamic shared memory at raw. A from map ta ((K,
// M, 1), boxes of BM rows), B from map tb ((N, K, 1)), C through map tc
// ((N, M, 1), boxes of 64 x 64, the 128-byte swizzle).
template <int BN, class Order>
__device__ __forceinline__ void run(const CUtensorMap* ta,
                                    const CUtensorMap* tb,
                                    const CUtensorMap* tc, int M, int N, int K,
                                    const Order& order, unsigned char* raw) {
  const Ring<BN> ring(raw);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int ktiles = (K + BK - 1) / BK;
  const int w = threadIdx.x / 128;
  uint32_t it = 0;
  if (w == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      for (int t = blockIdx.x; t < order.total; t += gridDim.x) {
        int mt, nt;
        order.tile(t, mt, nt);
        produce<BN>(ring, ta, tb, mt * BM, nt * BN, ktiles, it);
      }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int h = w - 1;
  uint32_t stored = 0;  // epilogue boxes this warpgroup has stored
  for (int t = blockIdx.x; t < order.total; t += gridDim.x) {
    int mt, nt;
    order.tile(t, mt, nt);
    const int m0 = mt * BM + 64 * h, n0 = nt * BN;
    float acc[BN / 2];
    consume<BN>(ring, h, m0 < M, ktiles, it, acc);
    if (m0 < M) store<BN>(ring, h, tc, N, m0, n0, acc, stored);
  }
  if (threadIdx.x % 128 == 0) wg::bulk_wait();
}

// --- host -------------------------------------------------------------------

// The SM count of the current device, cached per device.
inline cudaError_t sm_count(int* n) {
  static int cache[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cache[dev]) {
    *n = cache[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cache[dev] = *n;
  return err;
}

// The tile's width for an (M, N) output: 256 columns where 128 x 256
// tiles give every SM one at least, else 128.
inline int tile_n(long long M, long long N, int sms) {
  const long long wide = (M + BM - 1) / BM * ((N + 255) / 256);
  return wide >= sms ? 256 : 128;
}

inline Grouped grouped(long long M, long long N, int bn) {
  const int tm = (int)((M + BM - 1) / BM), tn = (int)((N + bn - 1) / bn);
  return Grouped{tm, tn, tm * tn};
}

// The maps of one call: A (M, K), B (K, N), C (M, N), row-major bf16.
inline bool encode(CUtensorMap* ta, CUtensorMap* tb, CUtensorMap* tc,
                   const void* a, const void* b, void* c, long long M,
                   long long N, long long K) {
  return wg::encode_a(ta, a, K, M, 1, BM) && wg::encode_b(tb, b, N, K, 1) &&
         wg::encode_3d(tc, c, N, M, 1, N * 2, M * N * 2, 64, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace ws
}  // namespace tdt
