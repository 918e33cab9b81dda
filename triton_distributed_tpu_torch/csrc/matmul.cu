// Dense matmul C = A @ B, A (M, K), B (K, N), C (M, N), all row-major,
// f32 accumulation, C in the inputs' dtype.
//
// Replaces: triton_distributed_tpu/kernels/allgather_gemm.py:733
//   _matmul_kernel (via ag_gemm_single_chip :793, the world-1 path of
//   ag_gemm_device :399 and gemm_rs_device, gemm_reduce_scatter.py:190).
//
// What bounds it on the H100: at the prefill projections (M = 8192 tokens,
//   K and N in the thousands) the product does ~300-3000 operations per
//   byte it must move, far above the card's ~295 for bf16, so the tensor
//   cores' rate bounds it (989 TFLOP/s dense bf16).
//
// What this design does about it: bf16 tiles go through the tensor cores
//   with mma.sync m16n8k16 (f32 accumulate), fragments loaded by ldmatrix
//   (A) and ldmatrix.trans (B) from 128x128x32 shared-memory tiles that
//   cp.async fills four stages deep, so three K tiles are in flight while
//   one multiplies (the tile is gemm_tile.cuh's, shared with the grouped
//   GEMM). The TPU grid's sequential K axis becomes the loop inside the
//   block; each warp's 64x64 f32 accumulators stay in registers for the
//   whole K loop and are stored straight from them. Ragged M/N/K
//   edges are masked: rows and columns past the matrix load as zeros
//   (cp.async with a source size of 0) and the epilogue stores only what
//   lies inside C. It stops short of the peak: wgmma, TMA and warp
//   specialisation are later work.
//   float32 inputs take a plain SIMT kernel (64x64 tiles, 4x4 outputs per
//   thread, full f32 FMAs, no TF32), which the bf16 model path never runs.
#include "gemm_tile.cuh"

namespace {

using tdt::gemm::bf16;

template <bool VEC>
__global__ void __launch_bounds__(tdt::gemm::THREADS)
    matmul_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                       bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  tdt::gemm::bf16_tile<VEC>(A, B, C, M, M, N, K, blockIdx.y * tdt::gemm::BM,
                            blockIdx.x * tdt::gemm::BN, smem);
}

__global__ void __launch_bounds__(tdt::gemm::F_THREADS)
    matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K) {
  tdt::gemm::f32_tile(A, B, C, M, M, N, K, blockIdx.y * tdt::gemm::FT,
                      blockIdx.x * tdt::gemm::FT);
}

}  // namespace

extern "C" int tdt_matmul(const void* a, const void* b, void* c, long long M,
                          long long N, long long K, int dtype, void* stream) {
  using namespace tdt::gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0 || M > INT32_MAX || N > INT32_MAX ||
      K > INT32_MAX)
    return cudaErrorInvalidValue;
  if (dtype == tdt::kBF16) {
    dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
    const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(a) &&
                     aligned16(b) && aligned16(c);
    auto kernel = vec ? matmul_bf16_kernel<true> : matmul_bf16_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<bf16*>(c), (int)M, (int)N, (int)K);
  } else if (dtype == tdt::kF32) {
    dim3 grid((unsigned)((N + FT - 1) / FT), (unsigned)((M + FT - 1) / FT));
    matmul_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), (int)M, (int)N, (int)K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
