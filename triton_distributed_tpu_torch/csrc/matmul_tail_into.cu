// The AG-GEMM split's assembly: the full (m, n) product in one pass, where
// columns [0, col_start) are copied from c (the overlap kernel's output)
// and columns [col_start, n) are computed as a @ b[:, col_start:]. a (m, k),
// b (k, n), c (m, col_start), out (m, n), all bf16 row-major, f32
// accumulation.
//
// Replaces: triton_distributed_tpu/kernels/allgather_gemm.py:206
//   _matmul_tail_into_kernel (via matmul_tail_into :232).
//
// What bounds it on the H100: the tail product's operations (2 m k
//   (n - col_start)), 989 TFLOP/s dense bf16; the pass-through columns are
//   a copy of m x col_start elements (bytes, 3.35 TB/s).
//
// What this design does about it: one grid over (column tiles, row tiles)
//   covers every output tile. A block on a pass-through column tile copies
//   its c tile with 16-byte loads and stores and touches neither a nor b
//   (the TPU kernel's clamped index maps did the same for its DMAs). A
//   block on a tail column tile runs gemm_tile.cuh's mma.sync main loop
//   over a column window of b, b + col_start with row stride n, so no slice
//   is materialised, and stores its tile at column col_start + its offset.
//   Ragged edges (col_start, n or k not multiples of the tile) are masked
//   in the loads and stores; the TPU version's XLA fallback for infeasible
//   blocks (:265-272) has no counterpart.
#include "gemm_tile.cuh"

namespace {

using tdt::gemm::bf16;

template <bool VEC>
__global__ void __launch_bounds__(tdt::gemm::THREADS)
    tail_into_kernel(const bf16* __restrict__ Cin, const bf16* __restrict__ A,
                     const bf16* __restrict__ B, bf16* __restrict__ O, int M,
                     int n, int K, int col_start, int pass_tiles) {
  using namespace tdt::gemm;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * BM;
  if ((int)blockIdx.x < pass_tiles) {
    const int c0 = blockIdx.x * BN;
    if constexpr (VEC) {  // col_start % 8 == 0: 8 bf16 per 16-byte move
      for (int i = threadIdx.x; i < BM * (BN / 8); i += THREADS) {
        const int r = m0 + i / (BN / 8), c = c0 + (i % (BN / 8)) * 8;
        if (r < M && c < col_start)
          *reinterpret_cast<uint4*>(O + (size_t)r * n + c) =
              *reinterpret_cast<const uint4*>(Cin + (size_t)r * col_start +
                                              c);
      }
    } else {
      for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
        const int r = m0 + i / BN, c = c0 + i % BN;
        if (r < M && c < col_start)
          O[(size_t)r * n + c] = Cin[(size_t)r * col_start + c];
      }
    }
    return;
  }
  const int j0 = (blockIdx.x - pass_tiles) * BN;
  const int ncols = n - col_start;
  Acc acc;
  bf16_mainloop<VEC>(A, K, B + col_start, n, M, ncols, K, m0, j0, smem, acc);
  for_each_pair(acc, m0, j0, [&](int gr, int gc, float x0, float x1) {
    if (gr < M)
      store_pair<VEC>(O + (size_t)gr * n + col_start, gc, ncols, x0, x1);
  });
}

}  // namespace

extern "C" int tdt_matmul_tail_into(const void* c, const void* a,
                                    const void* b, void* out, long long M,
                                    long long n, long long K,
                                    long long col_start, void* stream) {
  using namespace tdt::gemm;
  if (M <= 0 || n <= 0 || K < 0 || col_start < 0 || col_start > n ||
      M > INT32_MAX || n > INT32_MAX || K > INT32_MAX ||
      (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  const long long pass_tiles = (col_start + BN - 1) / BN;
  const long long tail_tiles = (n - col_start + BN - 1) / BN;
  const bool vec = K % 8 == 0 && n % 8 == 0 && col_start % 8 == 0 &&
                   aligned16(c) && aligned16(a) && aligned16(b) &&
                   aligned16(out);
  auto kernel = vec ? tail_into_kernel<true> : tail_into_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(pass_tiles + tail_tiles), (unsigned)((M + BM - 1) / BM));
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(c), static_cast<const bf16*>(a),
      static_cast<const bf16*>(b), static_cast<bf16*>(out), (int)M, (int)n,
      (int)K, (int)col_start, (int)pass_tiles);
  return cudaGetLastError();
}
