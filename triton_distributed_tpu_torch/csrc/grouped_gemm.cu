// Count-aware grouped GEMM: out[e] = X[e] @ W[e] for every expert e,
// X (E, cap, d), W (E, d, f), out (E, cap, f), all row-major, f32
// accumulation, out in the inputs' dtype. counts (E,) int32 on the card:
// expert e holds rows [0, counts[e]) of X[e]; the rows past its count are
// zero by the caller's contract (the MoE capacity grid), so their product
// rows are zero.
//
// Replaces: triton_distributed_tpu/kernels/moe_utils.py:237
//   _grouped_gemm_skip_kernel (via grouped_gemm_skip :254), the expert
//   GEMMs of the MoE FFN (layers/moe_mlp.py _expert_ffn).
//
// What bounds it on the H100: at decode (cap 16, a few rows per expert)
//   the bytes of the non-empty experts' weights (d x f bf16 each; 0.5 +
//   0.25 MB per expert at Qwen3-30B-A3B); at a prefill (cap 1,024) the
//   operations of the live rows. Empty experts' weights are the bytes to
//   avoid: at 8 decode tokens x top-8 over 128 experts most are empty.
//
// What this design does about it: a grid over (f tiles, cap tiles, expert).
//   A block whose expert is empty, or whose row tile starts at or past the
//   expert's count, writes zeros to its tile and loads nothing, neither
//   weights nor rows. A live block runs gemm_tile.cuh's tile (mma.sync over
//   cp.async stages for bf16, SIMT for f32) with A rows at or past the
//   count never read, so NaN there cannot reach an output, and warps whose
//   rows are all past the count skip their products. The TPU kernel's
//   "repeat the last non-empty expert's block index" trick that makes
//   Mosaic skip the copy is not needed: a block simply does not load.
//   The layer of stacked (L, E, d, f) weights is a pointer offset chosen
//   by the wrapper. Later work: an M tile sized for cap 16 (the 128-row
//   tile multiplies mostly zeros at decode), wgmma and TMA.
#include "gemm_tile.cuh"

namespace {

using tdt::gemm::bf16;

// Zeros over the (bm, bn) tile at (m0, n0), rows below m_store. VEC: N is a
// multiple of 16 bytes' worth of T and C 16-byte aligned, so each thread
// stores 16 bytes (a dead tile's only work is this store).
template <bool VEC, typename T>
__device__ __forceinline__ void zero_tile(T* C, int m_store, int N, int m0,
                                          int n0, int bm, int bn) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    for (int i = threadIdx.x; i < bm * (bn / V); i += blockDim.x) {
      const int gr = m0 + i / (bn / V), gc = n0 + (i % (bn / V)) * V;
      if (gr < m_store && gc < N)
        *reinterpret_cast<uint4*>(C + (size_t)gr * N + gc) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const T zero = tdt::from_f32<T>(0.f);
    for (int i = threadIdx.x; i < bm * bn; i += blockDim.x) {
      const int gr = m0 + i / bn, gc = n0 + i % bn;
      if (gr < m_store && gc < N) C[(size_t)gr * N + gc] = zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(tdt::gemm::THREADS)
    grouped_bf16_kernel(const bf16* __restrict__ X,
                        const bf16* __restrict__ W, bf16* __restrict__ C,
                        const int* __restrict__ counts, int cap, int N,
                        int K) {
  using namespace tdt::gemm;
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(max(counts[e], 0), cap);
  bf16* Ce = C + (size_t)e * cap * N;
  if (m0 >= rows) {
    zero_tile<VEC>(Ce, cap, N, m0, n0, BM, BN);
    return;
  }
  bf16_tile<VEC>(X + (size_t)e * cap * K, W + (size_t)e * K * N, Ce, rows,
                 cap, N, K, m0, n0, smem);
}

__global__ void __launch_bounds__(tdt::gemm::F_THREADS)
    grouped_f32_kernel(const float* __restrict__ X,
                       const float* __restrict__ W, float* __restrict__ C,
                       const int* __restrict__ counts, int cap, int N,
                       int K) {
  using namespace tdt::gemm;
  const int e = blockIdx.z, m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  const int rows = min(max(counts[e], 0), cap);
  float* Ce = C + (size_t)e * cap * N;
  if (m0 >= rows) {
    zero_tile<false>(Ce, cap, N, m0, n0, FT, FT);
    return;
  }
  f32_tile(X + (size_t)e * cap * K, W + (size_t)e * K * N, Ce, rows, cap, N,
           K, m0, n0);
}

}  // namespace

extern "C" int tdt_grouped_gemm(const void* x, const void* w, void* c,
                                const void* counts, long long E,
                                long long cap, long long K, long long N,
                                int dtype, void* stream) {
  using namespace tdt::gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || cap <= 0 || N <= 0 || K < 0 || E > 65535 ||
      cap * N > INT32_MAX || cap * K > INT32_MAX || K * N > INT32_MAX)
    return cudaErrorInvalidValue;
  const int* cnt = static_cast<const int*>(counts);
  if (dtype == tdt::kBF16) {
    dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((cap + BM - 1) / BM),
              (unsigned)E);
    const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
                     aligned16(w) && aligned16(c);
    auto kernel = vec ? grouped_bf16_kernel<true> : grouped_bf16_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(c), cnt, (int)cap, (int)N, (int)K);
  } else if (dtype == tdt::kF32) {
    dim3 grid((unsigned)((N + FT - 1) / FT), (unsigned)((cap + FT - 1) / FT),
              (unsigned)E);
    grouped_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(c), cnt, (int)cap, (int)N, (int)K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
