// One fused accumulate step: out = c + a @ (b + s) in f32, a (M, K) and
// b (K, N) bf16, c and out (M, N) f32 (out may be c itself: each element
// is read and written by the same thread), s a scalar cast to bf16 before
// the add, so b + s rounds in bf16 as the TPU kernel's
// `b_ref[...] + s_ref[0].astype(b_ref.dtype)` does.
//
// Replaces: triton_distributed_tpu/kernels/allgather_gemm.py:875
//   _fused_step_kernel (via fused_matmul_step :892).
//
// What bounds it on the H100: the product's operations (2 M K N), 989
//   TFLOP/s dense bf16; c is read and out written once in f32 (2 x 52 MB
//   at (4,096 x 3,200), ~0.03 ms of HBM time).
//
// What this design does about it: the elementwise b + s rides on the B
//   fragments after ldmatrix (one __hadd2 per register, a bf16 add with
//   round-to-nearest-even), inside gemm_tile.cuh's mma.sync main loop, and
//   the epilogue adds c from registers, so neither b + s nor the product
//   makes a round trip through device memory. B's rows past K load as
//   zeros and become s, but they meet A's zeroed columns there. s comes
//   from a device scalar when the caller has one (no host read), else by
//   value.
#include "gemm_tile.cuh"

namespace {

using tdt::gemm::bf16;

struct AddScalar {
  __nv_bfloat162 s2;
  __device__ __forceinline__ uint32_t operator()(uint32_t b) const {
    __nv_bfloat162 r =
        __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&b), s2);
    return *reinterpret_cast<uint32_t*>(&r);
  }
};

template <bool VEC>
__global__ void __launch_bounds__(tdt::gemm::THREADS)
    fused_step_kernel(const float* C, const bf16* __restrict__ A,
                      const bf16* __restrict__ B, float* O,
                      const float* s_dev, float s_val, int M, int N, int K) {
  using namespace tdt::gemm;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16 sb = __float2bfloat16(s_dev ? *s_dev : s_val);
  Acc acc;
  bf16_mainloop<VEC>(A, K, B, N, M, N, K, m0, n0, smem, acc,
                     AddScalar{__halves2bfloat162(sb, sb)});
  for_each_pair(acc, m0, n0, [&](int gr, int gc, float x0, float x1) {
    if (gr >= M) return;
    const size_t i = (size_t)gr * N + gc;
    if (VEC) {  // N % 8 == 0: the pair is inside the row or past it
      if (gc < N) {
        const float2 cv = *reinterpret_cast<const float2*>(C + i);
        *reinterpret_cast<float2*>(O + i) = make_float2(cv.x + x0,
                                                        cv.y + x1);
      }
    } else {
      if (gc < N) O[i] = C[i] + x0;
      if (gc + 1 < N) O[i + 1] = C[i + 1] + x1;
    }
  });
}

}  // namespace

// c, out (M, N) f32 (out == c updates c in place); a (M, K), b (K, N)
// bf16; s: a device f32 scalar, or null to use s_val.
extern "C" int tdt_fused_step(const void* c, const void* a, const void* b,
                              void* out, const void* s, float s_val,
                              long long M, long long N, long long K,
                              void* stream) {
  using namespace tdt::gemm;
  if (M <= 0 || N <= 0 || K < 0 || M > INT32_MAX || N > INT32_MAX ||
      K > INT32_MAX || (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(c) &&
                   aligned16(a) && aligned16(b) && aligned16(out);
  auto kernel = vec ? fused_step_kernel<true> : fused_step_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const bf16*>(a),
      static_cast<const bf16*>(b), static_cast<float*>(out),
      static_cast<const float*>(s), s_val, (int)M, (int)N, (int)K);
  return cudaGetLastError();
}
