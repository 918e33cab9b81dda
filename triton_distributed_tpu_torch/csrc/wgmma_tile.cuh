// Hopper's own units for a bf16 product tile: TMA loads into a ring of
// shared-memory stages, mbarriers that count the bytes landed, and wgmma,
// the warpgroup MMA that reads both operands from shared memory; and bulk
// copies (cp.async.bulk) through shared memory, so that one thread keeps a
// device-memory-rate copy in flight. ag_gemm.cuh builds its consumer tiles
// and producer copies from these (ag_gemm.cu, ag_group_gemm.cu).
//
// The tile: BM rows (BM / 64 m64 halves, one warpgroup of 128 threads) x
// BN columns of C = A @ B (256 x 96 or 128 x 128, template arguments), f32
// accumulators in registers, K in steps of BK = 64 through the stages of a
// 96 KB ring that thread 0 keeps filled by TMA.
//   A (rows, K), K contiguous (K-major): one TMA box {64, BM} per stage
//     with the 128-byte swizzle, each row one 128-byte line; a k16 step
//     moves the descriptor's start 32 bytes inside the swizzle atom.
//   B (K, N), N contiguous (MN-major, wgmma's transpose bit set): BN / 32
//     TMA boxes {32, 64} per stage with the 64-byte swizzle, each a
//     64-row x 64-byte block; the descriptor's leading byte offset steps
//     from one 32-column block to the next (4 KB), its stride byte offset
//     from one group of 8 k rows to the next (512 B).
// TMA zero-fills whatever lies past the tensor: rows past a plane's row
// count, K past the row, columns past N. Both tensors are 3-D (inner,
// rows, plane), a plane being one (rank, expert) matrix, so a box never
// reads into the next plane and ragged edges need no mask until the store.
//
// Host side: encode_3d (encode_4d) builds a CUtensorMap with
// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint),
// so the library needs no libcuda at link time. Kernels take the maps as
// __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "language.cuh"

namespace tdt {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int BK = 64, THREADS = 128;
constexpr int B_BLOCK = BK * 32 * 2;  // 4 KB: 64 k rows x 32 columns
constexpr int RING_BYTES = 96 * 1024;

constexpr int MAX_STAGES = 3;
// A tile shape: BM rows (BM / 64 m64 halves) x BN columns, its stage (an A
// box of BM rows of 128 bytes, then room for BN = 128 of B) and the stages
// of a RING-byte ring (96 KB unless a kernel asks for less). The 256 x 96
// tile (Qwen3-30B-A3B's f_local) reads each weight shard half as often as
// a 128-row one, in two stages; the 128 x 128 tile keeps three (two in a
// 64 KB ring).
template <int BM, int BN, int RING = RING_BYTES>
struct Shape {
  static_assert((BM == 128 || BM == 256) && (BN == 96 || BN == 128),
                "tile shapes: 128 or 256 rows, 96 or 128 columns");
  static constexpr int HALVES = BM / 64;
  static constexpr int A_STAGE = BM * BK * 2;
  static constexpr int STAGE = A_STAGE + 4 * B_BLOCK;
  static constexpr int STAGES = RING / STAGE;
  static_assert(STAGES >= 2 && STAGES <= MAX_STAGES &&
                    HALVES * BN / 2 <= 192,
                "two or three stages, at most 192 accumulators a thread");
};
// The producer copies reuse the ring as COPY_SLOTS pieces of PIECE bytes.
constexpr int PIECE = 16384;
constexpr int COPY_SLOTS = RING_BYTES / PIECE;
// Dynamic shared memory of a block: 1 KB of slack to align the ring to the
// 128-byte swizzle's 1,024-byte atom, the ring, then the mbarriers (one per
// stage, one per copy slot). Two blocks fit on an SM.
constexpr int SMEM_BYTES = 1024 + RING_BYTES + 8 * (MAX_STAGES + COPY_SLOTS);

// --- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Thread's one arrival, announcing `bytes` of transactions to land.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of `parity` has completed; trap after about one
// second (lang::kSpinCycles), so a lost transaction fails the launch
// instead of hanging the card. (No printf: a call in a kernel that issues
// wgmma makes ptxas serialise every wgmma.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = clock64();
    if (clock64() - t0 > lang::kSpinCycles) __trap();
  }
}

// lang::wait for a kernel that issues wgmma: the same acquire spin and
// bound, a trap without the printf.
__device__ __forceinline__ void wait_flag(const uint32_t* sig,
                                          uint32_t value) {
  const long long t0 = clock64();
  while (static_cast<int32_t>(lang::ld_acquire(sig) - value) < 0) {
    if (clock64() - t0 > lang::kSpinCycles) __trap();
    __nanosleep(64);
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's generic-proxy accesses with its async-proxy ones
// (TMA, bulk copies) in both directions.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The 3-D box at (c0, c1, c2) of `map` into shared memory at dst; its bytes
// complete a transaction of `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The 4-D box at (c0, c1, c2, c3) of `map`, as tma_load_3d.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global src
// into shared dst, completing a transaction of `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bytes from shared src to global dst, in this thread's open bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Every committed bulk store has read its shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// All but the N most recent committed bulk groups have read their
// shared-memory sources.
template <int N>
__device__ __forceinline__ void bulk_wait_read_upto() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Every committed bulk store has been written to global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// At most N of this warpgroup's committed wgmma groups still run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), and the swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)swz << 62);
}

// D (64 x N, f32, this thread's N / 2 registers) += A (64 x 16, K-major,
// descriptor da) @ B (16 x N, MN-major, descriptor db): bf16 in, f32
// accumulate, B transposed. N = 256 is gemm_ws.cuh's tile.
template <int N>
struct Mma;

template <>
struct Mma<96> {
  __device__ __forceinline__ static void run(float (&d)[48], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<256> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// --- the block's shared memory ---------------------------------------------

// The ring (aligned to 1 KB, ring_bytes long) and the mbarriers of one
// block's dynamic shared memory (1 KB + ring_bytes + the barriers' 8 bytes
// each). init() (every thread calls it once, at the start of the kernel)
// sets each barrier to one arrival per phase.
struct Smem {
  unsigned char* ring;
  uint64_t* stage_bar;  // MAX_STAGES
  uint64_t* copy_bar;   // COPY_SLOTS

  __device__ __forceinline__ explicit Smem(unsigned char* raw,
                                           int ring_bytes = RING_BYTES) {
    const uint32_t a = smem_u32(raw);
    ring = raw + ((1024 - (a & 1023)) & 1023);
    stage_bar = reinterpret_cast<uint64_t*>(ring + ring_bytes);
    copy_bar = stage_bar + MAX_STAGES;
  }
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < MAX_STAGES + COPY_SLOTS; ++i)
        mbar_init(stage_bar + i, 1);
      fence_barrier_init();
    }
    __syncthreads();
  }
};

// --- the tile ---------------------------------------------------------------

// One thread's accumulators of the BM x BN tile: [m64 half][BN / 2].
template <int BM, int BN>
using Acc = float[BM / 64][BN / 2];

// The K loop of the tile at rows [m0, m0 + BM) and columns [n0, n0 + BN):
// A from plane `plane` of map ta ((K, rows, planes), boxes of BM rows), B
// from plane `b_plane` of map tb ((N, K, planes); the same plane but where
// several A planes share one B, as the GEMM-RS loopback's sources do).
// Every thread of the block (one warpgroup) calls it, the ring RING bytes
// long (sm's). `it` counts the stage loads this block has made so far
// (each stage's mbarrier phase follows from it) and is advanced; rows is
// the plane's row count (an m64 half wholly past it multiplies nothing).
// Thread 0 must not issue the first loads before whatever the tile waits
// on is visible to the async proxy (the caller fences). The ring is free
// again on return.
template <int BM, int BN, int RING = RING_BYTES>
__device__ __forceinline__ void mainloop(const CUtensorMap* ta,
                                         const CUtensorMap* tb, int plane,
                                         int b_plane, int m0, int n0, int K,
                                         int rows, const Smem& sm,
                                         uint32_t& it, Acc<BM, BN>& acc) {
  using S = Shape<BM, BN, RING>;
  constexpr uint32_t kBytes = S::A_STAGE + (BN / 32) * B_BLOCK;
#pragma unroll
  for (int h = 0; h < S::HALVES; ++h)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
  const int ktiles = (K + BK - 1) / BK;
  auto a_stage = [&](int s) { return sm.ring + s * S::STAGE; };
  auto b_stage = [&](int s) { return sm.ring + s * S::STAGE + S::A_STAGE; };
  auto issue = [&](int kt) {  // thread 0: k tile kt into its stage
    const int s = (it + kt) % S::STAGES;
    uint64_t* bar = sm.stage_bar + s;
    mbar_expect_tx(bar, kBytes);
    tma_load_3d(a_stage(s), ta, bar, kt * BK, m0, plane);
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
      tma_load_3d(b_stage(s) + j * B_BLOCK, tb, bar, n0 + 32 * j, kt * BK,
                  b_plane);
  };
  if (threadIdx.x == 0)
    for (int kt = 0; kt < S::STAGES && kt < ktiles; ++kt) issue(kt);
  for (int kt = 0; kt < ktiles; ++kt) {
    const uint32_t u = it + kt;
    const int s = u % S::STAGES;
    mbar_wait(sm.stage_bar + s, (u / S::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db =
          make_desc(b_stage(s) + kk * 16 * 64, B_BLOCK, 512, 2);
#pragma unroll
      for (int h = 0; h < S::HALVES; ++h)
        if (h == 0 || m0 + 64 * h < rows)
          Mma<BN>::run(acc[h],
                       make_desc(a_stage(s) + h * 64 * 128 + kk * 32, 16,
                                 1024, 1),
                       db);
    }
    wgmma_commit();
    // k tile kt - 1's products are done (kt's may still run): its stage
    // takes k tile kt - 1 + STAGES once every warp is past this point.
    wgmma_wait<1>();
    __syncthreads();
    if (threadIdx.x == 0 && kt >= 1 && kt - 1 + S::STAGES < ktiles)
      issue(kt - 1 + S::STAGES);
  }
  wgmma_wait<0>();
  __syncthreads();  // the ring is free
  it += ktiles;
}

// Visit this thread's outputs of the tile as column pairs: f(row, col,
// x[col], x[col + 1]), col even; the caller masks rows and columns.
template <int BM, int BN, class F>
__device__ __forceinline__ void for_each_pair(Acc<BM, BN>& acc, int m0,
                                              int n0, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = m0 + warp * 16 + lane / 4, c = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < BM / 64; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      f(r + 64 * h, c + 8 * j, acc[h][4 * j], acc[h][4 * j + 1]);
      f(r + 64 * h + 8, c + 8 * j, acc[h][4 * j + 2], acc[h][4 * j + 3]);
    }
}

// --- the producer copy ------------------------------------------------------

// Copy `bytes` (a multiple of 16; every address 16-byte aligned) from
// global src to the n_dst global destinations dst + i dst_stride through
// the ring: each piece is bulk-loaded once, COPY_SLOTS pieces ahead, and
// bulk-stored to every destination as it lands, so the source is read
// once however many ranks receive it. Thread 0 alone calls it; `cit`
// counts the pieces this block has loaded so far and is advanced. Returns
// once every store has been written: the caller then fences and releases
// its flags.
__device__ __forceinline__ void bulk_copy(void* dst, size_t dst_stride,
                                          int n_dst, const void* src,
                                          size_t bytes, const Smem& sm,
                                          uint32_t& cit) {
  const size_t n = (bytes + PIECE - 1) / PIECE;
  auto piece = [&](size_t i) {
    const size_t rest = bytes - i * PIECE;
    return (uint32_t)(rest < (size_t)PIECE ? rest : PIECE);
  };
  auto load = [&](size_t i) {
    const int s = (cit + i) % COPY_SLOTS;
    mbar_expect_tx(sm.copy_bar + s, piece(i));
    bulk_load(sm.ring + s * PIECE,
              static_cast<const unsigned char*>(src) + i * PIECE, piece(i),
              sm.copy_bar + s);
  };
  for (size_t i = 0; i < n && i < COPY_SLOTS; ++i) load(i);
  for (size_t i = 0; i < n; ++i) {
    const uint32_t u = cit + (uint32_t)i;
    const int s = u % COPY_SLOTS;
    mbar_wait(sm.copy_bar + s, (u / COPY_SLOTS) & 1);
    for (int d = 0; d < n_dst; ++d)
      bulk_store(static_cast<unsigned char*>(dst) + d * dst_stride +
                     i * PIECE,
                 sm.ring + s * PIECE, piece(i));
    bulk_commit();
    if (i + COPY_SLOTS < n) {
      bulk_wait_read();  // piece i has left slot s
      load(i + COPY_SLOTS);
    }
  }
  bulk_wait();
  cit += (uint32_t)n;
}

// --- host: tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `planes` planes of (rows, inner) elements, rows
// row_bytes apart and planes plane_bytes apart, read in boxes of
// (box_inner, box_rows, 1) with the given swizzle; out-of-bounds elements
// read as zero. False when the encoding is refused (alignment, strides).
inline bool encode_3d(CUtensorMap* map, const void* base, uint64_t inner,
                      uint64_t rows, uint64_t planes, uint64_t row_bytes,
                      uint64_t plane_bytes, uint32_t box_inner,
                      uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {inner, rows, planes};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t box[3] = {box_inner, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor of four dimensions, dims[0] contiguous, dims[i] elements
// strides[i - 1] bytes apart (each a multiple of 16), read in boxes of
// box[0 .. 3] elements with the given swizzle; out-of-bounds elements read
// as zero. False when the encoding is refused.
inline bool encode_4d(CUtensorMap* map, const void* base,
                      const uint64_t (&dims)[4], const uint64_t (&strides)[3],
                      const uint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            d, st, bx, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of the tile's operands: A planes of (rows, K), B planes of (K,
// N), both row-major bf16.
inline bool encode_a(CUtensorMap* map, const void* a, long long K,
                     long long rows, long long planes, int bm) {
  return encode_3d(map, a, K, rows, planes, K * 2, rows * K * 2, BK, bm,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}
inline bool encode_b(CUtensorMap* map, const void* b, long long N,
                     long long K, long long planes) {
  return encode_3d(map, b, N, K, planes, N * 2, K * N * 2, 32, BK,
                   CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace wg
}  // namespace tdt
