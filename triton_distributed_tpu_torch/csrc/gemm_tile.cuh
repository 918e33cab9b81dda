// One output tile of a row-major product C = A @ B (A (M, K), B (K, N),
// C (M, N)), f32 accumulation, C in the inputs' dtype: the block-level body
// shared by matmul.cu, grouped_gemm.cu, the one-chip overlap kernels
// (ag_gemm_loopback.cu, matmul_tail_into.cu, gemm_rs_loopback.cu,
// fused_step.cu) and, through product_tile (either dtype, an epilogue per
// output), the multi-rank kernels (ag_gemm.cuh and gemm_rs.cuh: ag_gemm.cu,
// gemm_rs.cu, ag_group_gemm.cu, group_gemm_rs.cu).
//
// bf16: a BM x BN tile on the tensor cores with mma.sync m16n8k16 (f32
//   accumulate), fragments loaded by ldmatrix (A) and ldmatrix.trans (B)
//   from BM x BK / BK x BN shared-memory tiles that cp.async fills STAGES
//   deep, so three K tiles are in flight while one multiplies. Each warp's
//   64x64 f32 accumulators stay in registers for the whole K loop
//   (bf16_mainloop); bf16_tile stores them straight from there, and the
//   other kernels run their own epilogue over the same fragments
//   (for_each_pair). A and B take row strides (lda, ldb) of their own, so a
//   caller can multiply a column window of B or a row segment of A in
//   place; a B-fragment operator (BOp) may rewrite B's fragments after
//   ldmatrix (the fused step adds its scalar there).
// f32: a plain SIMT tile (64x64 outputs, 4x4 per thread, full f32 FMAs, no
//   TF32).
//
// Rows are masked twice: A rows at or past m_load are never read (they load
// as zeros: cp.async with a source size of 0), and C rows at or past
// m_store are not written. matmul passes M for both; the grouped GEMM
// passes an expert's row count for m_load and its capacity for m_store, so
// the rows between them come out as exact zeros without being read.
// Columns and K past the matrix are masked the same way.
#pragma once

#include <mutex>
#include <vector>

#include "common.cuh"

namespace tdt {
namespace gemm {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int STAGES = 4;
constexpr int LDA = BK + 8;  // bf16 per A smem row: ldmatrix conflict-free
constexpr int LDB = BN + 8;  // bf16 per B smem row
constexpr int THREADS = 128;  // 4 warps: 2 (M) x 2 (N), 64x64 per warp
constexpr int MI = 4, NJ = 8;  // m16 x n8 accumulator fragments per warp
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;

// Fill one stage: the BM x BK tile of A at (m0, k0) and the BK x BN tile of
// B at (k0, n0); B's columns at or past N are masked, its rows are ldb
// apart. VEC: 16-byte cp.async (needs K, lda, ldb and N multiples of 8 and
// 16-byte aligned bases); otherwise element loads with bounds checks.
template <bool VEC>
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* A,
                                           int lda, const bf16* B, int ldb,
                                           int m_load, int N, int K, int m0,
                                           int n0, int k0, int tid) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      int gr = m0 + r, gc = k0 + c;
      bool ok = gr < m_load && gc < K;
      const bf16* src = ok ? A + (size_t)gr * lda + gc : A;
      cp_async16(sA + r * LDA + c, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      int gr = k0 + r, gc = n0 + c;
      bool ok = gr < K && gc < N;
      const bf16* src = ok ? B + (size_t)gr * ldb + gc : B;
      cp_async16(sB + r * LDB + c, src, ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < BM * BK; i += THREADS) {
      int r = i / BK, c = i % BK;
      int gr = m0 + r, gc = k0 + c;
      // Through L2 only, as cp.async.cg above: A may be staged by another
      // block of the same launch (the multi-rank kernels).
      sA[r * LDA + c] = (gr < m_load && gc < K)
                            ? __ushort_as_bfloat16(__ldcg(
                                  reinterpret_cast<const unsigned short*>(
                                      A + (size_t)gr * lda + gc)))
                            : zero;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      int r = i / BN, c = i % BN;
      int gr = k0 + r, gc = n0 + c;
      sB[r * LDB + c] = (gr < K && gc < N) ? B[(size_t)gr * ldb + gc] : zero;
    }
  }
}

// The identity B-fragment operator (see bf16_mainloop).
struct NoBOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t b) const {
    return b;
  }
};

// One warp's 64 x 64 share of the tile: MI (m16) x NJ (n8) accumulator
// fragments.
using Acc = float[MI][NJ][4];

// The K loop of the bf16 tile at (m0, n0): every thread of the block
// (THREADS) calls it, with SMEM_BYTES of dynamic shared memory at smem, and
// gets its fragments of A[m0:, :] @ B[:, n0:] in acc. Each B fragment
// register (two bf16) passes through bop after ldmatrix. The block's
// shared memory is free again when it returns.
template <bool VEC, class BOp = NoBOp>
__device__ __forceinline__ void bf16_mainloop(const bf16* __restrict__ A,
                                              int lda,
                                              const bf16* __restrict__ B,
                                              int ldb, int m_load, int N,
                                              int K, int m0, int n0,
                                              unsigned char* smem, Acc& acc,
                                              BOp bop = BOp()) {
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix addressing
  // A warp whose 64 rows all lie past m_load multiplies only zeros: it
  // skips the products (its accumulators stay 0) but still loads its share.
  const bool warp_live = m0 + wm * 64 < m_load;

  // Warp tile 64 x 64. The wide warp tile halves the shared-memory
  // fragment reads per mma against a 64 x 32 one, which is what bounds
  // this tile.
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles)
      load_stage<VEC>(sA + st * A_STAGE, sB + st * B_STAGE, A, lda, B, ldb,
                      m_load, N, K, m0, n0, st * BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread; tile kt-1's stage is free
    const int next = kt + STAGES - 1;
    if (next < ktiles)
      load_stage<VEC>(sA + (next % STAGES) * A_STAGE,
                      sB + (next % STAGES) * B_STAGE, A, lda, B, ldb, m_load,
                      N, K, m0, n0, next * BK, tid);
    cp_async_commit();
    if (!warp_live) continue;

    const bf16* a_s = sA + (kt % STAGES) * A_STAGE;
    const bf16* b_s = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4], bfr[NJ / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], a_s + (wm * 64 + i * 16 + (mat & 1) * 8 + mrow) *
                                     LDA +
                               kk * 16 + (mat >> 1) * 8);
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        ldmatrix_x4_trans(bfr[jj], b_s + (kk * 16 + (mat & 1) * 8 + mrow) *
                                             LDB +
                                       wn * 64 + (jj * 2 + (mat >> 1)) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) bfr[jj][e] = bop(bfr[jj][e]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc[i][j], af[i], &bfr[j / 2][(j % 2) * 2]);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the stages
}

// Visit this thread's outputs of the tile at (m0, n0) as column pairs:
// f(row, col, x[col], x[col + 1]) with col even, rows (gid, gid + 8) of
// each 16 x 8 fragment; the two values are the accumulators themselves,
// so f may update them. The caller masks rows and columns.
template <class F>
__device__ __forceinline__ void for_each_pair(Acc& acc, int m0, int n0,
                                              F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        f(m0 + wm * 64 + i * 16 + gid + half * 8,
          n0 + wn * 64 + j * 8 + 2 * tig, acc[i][j][2 * half],
          acc[i][j][2 * half + 1]);
}

// Store a pair of bf16 outputs into row crow at column gc, masked at N.
// VEC: N % 8 == 0 and the row 4-byte aligned, so the pair is inside C or
// wholly past it.
template <bool VEC>
__device__ __forceinline__ void store_pair(bf16* crow, int gc, int N,
                                           float x0, float x1) {
  if (VEC) {
    if (gc < N)
      *reinterpret_cast<__nv_bfloat162*>(crow + gc) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (gc < N) crow[gc] = __float2bfloat16(x0);
    if (gc + 1 < N) crow[gc + 1] = __float2bfloat16(x1);
  }
}

// The bf16 tile at (m0, n0) of C = A @ B with A (., K), B and C (., N):
// bf16_mainloop, then the accumulators stored straight from registers.
template <bool VEC>
__device__ __forceinline__ void bf16_tile(const bf16* __restrict__ A,
                                          const bf16* __restrict__ B,
                                          bf16* __restrict__ C, int m_load,
                                          int m_store, int N, int K, int m0,
                                          int n0, unsigned char* smem) {
  Acc acc;
  bf16_mainloop<VEC>(A, K, B, N, m_load, N, K, m0, n0, smem, acc);
  for_each_pair(acc, m0, n0, [&](int gr, int gc, float x0, float x1) {
    if (gr < m_store) store_pair<VEC>(C + (size_t)gr * N, gc, N, x0, x1);
  });
}

// float32: SIMT tiles, FT x FT outputs per block of F_THREADS, 4x4 per
// thread.
constexpr int FT = 64, FK = 16, F_THREADS = 256;

// The f32 tile's K loop at (m0, n0) over A (rows lda apart) and B (rows
// ldb apart), every thread of the block (F_THREADS) calling it; f(row, col,
// value) then receives this thread's 4 x 4 outputs (the caller masks rows
// and columns).
template <class F>
__device__ __forceinline__ void f32_mainloop(const float* __restrict__ A,
                                             int lda,
                                             const float* __restrict__ B,
                                             int ldb, int m_load, int N,
                                             int K, int m0, int n0, F f) {
  __shared__ float sA[FK][FT + 4];  // transposed A tile: sA[k][m]
  __shared__ float sB[FK][FT + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = tid; i < FT * FK; i += F_THREADS) {
      int r = i / FK, c = i % FK;
      sA[c][r] = (m0 + r < m_load && k0 + c < K)
                     ? __ldcg(A + (size_t)(m0 + r) * lda + k0 + c)  // L2
                     : 0.f;
      int rb = i / FT, cb = i % FT;
      sB[rb][cb] = (k0 + rb < K && n0 + cb < N)
                       ? B[(size_t)(k0 + rb) * ldb + n0 + cb]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f(m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

__device__ __forceinline__ void f32_tile(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         float* __restrict__ C, int m_load,
                                         int m_store, int N, int K, int m0,
                                         int n0) {
  f32_mainloop(A, K, B, N, m_load, N, K, m0, n0,
               [&](int gr, int gc, float v) {
                 if (gr < m_store && gc < N) C[(size_t)gr * N + gc] = v;
               });
}

// --- one tile of either dtype, for kernels templated on it (ag_gemm.cuh,
// gemm_rs.cuh) ---

template <typename T>
struct TileOf;
template <>
struct TileOf<bf16> {  // mma.sync, dynamic shared memory
  static constexpr int M = BM, N = BN, threads = THREADS, smem = SMEM_BYTES;
};
template <>
struct TileOf<float> {  // SIMT, static shared memory
  static constexpr int M = FT, N = FT, threads = F_THREADS, smem = 0;
};

// The tile at (m0, n0) of A @ B, A's rows lda apart and B's ldb apart (B
// has N columns, A and B K columns and rows), f32 accumulation; f(row, col,
// value) receives each of this thread's outputs, unmasked. VEC applies to
// bf16 (load_stage); smem is TileOf<T>::smem bytes of dynamic shared
// memory. Every thread of the block calls it.
template <typename T, bool VEC, class F>
__device__ __forceinline__ void product_tile(const T* __restrict__ A,
                                             int lda,
                                             const T* __restrict__ B, int ldb,
                                             int m_load, int N, int K, int m0,
                                             int n0, unsigned char* smem,
                                             F f) {
  if constexpr (sizeof(T) == 2) {
    Acc acc;
    bf16_mainloop<VEC>(A, lda, B, ldb, m_load, N, K, m0, n0, smem, acc);
    for_each_pair(acc, m0, n0, [&](int gr, int gc, float x0, float x1) {
      f(gr, gc, x0);
      f(gr, gc + 1, x1);
    });
  } else {
    f32_mainloop(A, lda, B, ldb, m_load, N, K, m0, n0, f);
  }
}

// --- persistent grids with ticketed work (the loopbacks and the
// multi-rank kernels) ---

// The block's next work item: thread 0 takes a ticket from the counter and
// every thread of the block gets it. Ends at a barrier, so thread 0 may
// take the next ticket as soon as the block calls again.
__device__ __forceinline__ int take_ticket(int* counter) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(counter, 1);
  __syncthreads();
  const int t = s_ticket;
  __syncthreads();
  return t;
}

// The same, and the block that takes ticket `last` leaves the counter at 0
// for the next launch: every block takes tickets until one is past the
// work, so with W items and B blocks the last ticket taken is W + B - 1.
// (The reset sits in the taking thread's branch: the same store after the
// item loop made ptxas spill and serialise the GEMM-RS loopback's wgmma.)
__device__ __forceinline__ int take_ticket(int* counter, int last) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) {
    const int t = atomicAdd(counter, 1);
    if (t == last) *counter = 0;
    s_ticket = t;
  }
  __syncthreads();
  const int t = s_ticket;
  __syncthreads();
  return t;
}

// Blocks the current device holds at once of a kernel of `threads` threads
// and `smem` bytes of dynamic shared memory (SMs x blocks an SM). The
// answer is cached per (kernel, threads, shared memory, device): the
// device and occupancy queries cost the host microseconds, and a short
// call would otherwise pay them every time. A kernel whose shared memory
// limit is raised (cudaFuncSetAttribute) raises it before each query, to
// the same value for the same kernel. Errors are not cached.
inline cudaError_t resident_blocks(const void* kernel, int threads,
                                   size_t smem, long long* cap) {
  struct Entry {
    const void* kernel;
    int threads, device;
    size_t smem;
    long long cap;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Entry& e : cache)
      if (e.kernel == kernel && e.threads == threads && e.smem == smem &&
          e.device == device) {
        *cap = e.cap;
        return cudaSuccess;
      }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = (long long)per_sm * sms;
  std::lock_guard<std::mutex> lock(mu);
  cache.push_back(Entry{kernel, threads, device, smem, *cap});
  return cudaSuccess;
}

// Raise a kernel's dynamic shared memory limit to `smem` bytes, once per
// (kernel, device): the attribute stays set, and a short call would
// otherwise pay the runtime call every time. Errors are not cached.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  struct Entry {
    const void* kernel;
    int device;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Entry> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : done)
    if (e.kernel == kernel && e.device == device && e.smem == smem)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) done.push_back(Entry{kernel, device, smem});
  return err;
}

// Blocks of a persistent grid for a kernel of `threads` threads and `smem`
// bytes of dynamic shared memory: as many as the card holds at once, and no
// more than `work` items. A block that waits on another's item can then
// rely on that item being held by a running block, if items are handed out
// by take_ticket in an order where every item waited on comes first.
template <class Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                                     long long work, unsigned* blocks) {
  long long cap = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(kernel), threads, smem, &cap);
  if (err != cudaSuccess) return err;
  *blocks = (unsigned)(work < cap ? work : cap);
  return cudaSuccess;
}

// The same for the GEMM tile's THREADS and SMEM_BYTES.
template <class Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, long long work,
                                     unsigned* blocks) {
  return persistent_blocks(kernel, THREADS, SMEM_BYTES, work, blocks);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace gemm
}  // namespace tdt
