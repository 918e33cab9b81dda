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
// What this design does about it: bf16 whose operands TMA can read (K and
//   N multiples of 8, 16-byte aligned bases: the wrapper's tma) runs
//   gemm_ws.cuh's warp-specialised persistent wgmma GEMM: one block an SM
//   walking output tiles in bands of row tiles, a producer warpgroup
//   keeping TMA loads up to a ring of stages ahead, two consumer
//   warpgroups on m64n256k16 (or m64n128k16) wgmma, each stage released
//   as soon as its products are done, and the epilogue's TMA stores
//   overlapping the next tile's loads. The 128 x 256 tile runs wherever
//   it gives every SM a tile; smaller outputs (a serving step of a few
//   hundred rows) run the same kernel with a 128 x 128 tile. One device
//   operation a call: the
//   shared-memory attribute is raised once per process and the grid size
//   (the SM count) cached.
//   Other bf16 (rows TMA cannot read) keeps gemm_tile.cuh's mma.sync tile:
//   m16n8k16 fragments loaded by ldmatrix from 128x128x32 shared-memory
//   tiles that cp.async fills four stages deep, a block an output tile,
//   ragged M/N/K edges masked (cp.async with a source size of 0, an
//   epilogue that stores only what lies inside C).
//   float32 inputs take a plain SIMT kernel (64x64 tiles, 4x4 outputs per
//   thread, full f32 FMAs, no TF32), which the bf16 model path never runs.
#include "gemm_tile.cuh"
#include "gemm_ws.cuh"

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

template <int BN>
__global__ void __launch_bounds__(tdt::ws::THREADS, 1)
    matmul_ws_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, int M, int N,
                     int K, tdt::ws::Grouped order) {
  extern __shared__ __align__(16) unsigned char smem[];
  tdt::ws::run<BN>(&ta, &tb, &tc, M, N, K, order, smem);
}

// The persistent grid of the wgmma GEMM over an (M, N) output.
template <int BN>
cudaError_t launch_ws(const void* a, const void* b, void* c, long long M,
                      long long N, long long K, cudaStream_t s) {
  using tdt::ws::Shape;
  CUtensorMap ta, tb, tc;
  if (!tdt::ws::encode(&ta, &tb, &tc, a, b, c, M, N, K))
    return cudaErrorInvalidValue;
  const tdt::ws::Grouped order = tdt::ws::grouped(M, N, BN);
  auto kernel = matmul_ws_kernel<BN>;
  cudaError_t err = tdt::gemm::allow_smem(
      reinterpret_cast<const void*>(kernel), Shape<BN>::SMEM);
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = tdt::gemm::persistent_blocks(kernel, tdt::ws::THREADS,
                                       Shape<BN>::SMEM, order.total, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, tdt::ws::THREADS, Shape<BN>::SMEM, s>>>(
      ta, tb, tc, (int)M, (int)N, (int)K, order);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(tdt::gemm::F_THREADS)
    matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K) {
  tdt::gemm::f32_tile(A, B, C, M, M, N, K, blockIdx.y * tdt::gemm::FT,
                      blockIdx.x * tdt::gemm::FT);
}

}  // namespace

// tma 1: bf16 whose operands TMA can read (K > 0 and N multiples of 8,
// 16-byte aligned a, b and c), the wgmma GEMM; 0: the mma.sync tile (bf16)
// or the SIMT tile (f32).
extern "C" int tdt_matmul(const void* a, const void* b, void* c, long long M,
                          long long N, long long K, int dtype, int tma,
                          void* stream) {
  using namespace tdt::gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0 || M > INT32_MAX || N > INT32_MAX ||
      K > INT32_MAX)
    return cudaErrorInvalidValue;
  if (dtype == tdt::kBF16 && tma) {
    if (K == 0 || K % 8 || N % 8 || !aligned16(a) || !aligned16(b) ||
        !aligned16(c))
      return cudaErrorInvalidValue;
    int sms = 0;
    cudaError_t err = tdt::ws::sm_count(&sms);
    if (err != cudaSuccess) return err;
    return tdt::ws::tile_n(M, N, sms) == 256
               ? launch_ws<256>(a, b, c, M, N, K, s)
               : launch_ws<128>(a, b, c, M, N, K, s);
  }
  if (dtype == tdt::kBF16) {
    dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
    const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(a) &&
                     aligned16(b) && aligned16(c);
    auto kernel = vec ? matmul_bf16_kernel<true> : matmul_bf16_kernel<false>;
    cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(kernel), SMEM_BYTES);
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
