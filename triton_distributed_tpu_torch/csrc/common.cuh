// Helpers shared by the port's CUDA kernels: element conversion between the
// storage types the kernels take (float, __nv_bfloat16, and the 1-byte KV
// wire types int8 and fp8 e4m3) and f32, and vector loads of 8 elements
// into f32 registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

// dtype codes of the C interface (kernels/_build.py DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;
constexpr int kFP8 = 3;  // float8_e4m3fn

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load 8 consecutive elements (16-byte aligned for bf16, 32-byte for f32).
__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Load 8 consecutive 1-byte wire values (8-byte aligned).
template <typename W>
__device__ __forceinline__ void load8_bytes(const W* p, float* out) {
  static_assert(sizeof(W) == 1, "1-byte wire types only");
  uint2 u = *reinterpret_cast<const uint2*>(p);
  const W* w = reinterpret_cast<const W*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f32(w[i]);
}
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  load8_bytes(p, out);
}
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* out) {
  load8_bytes(p, out);
}

// 16-byte asynchronous global -> shared copy; src_bytes 0 fills the 16
// bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 4-byte asynchronous global -> shared copy (through L1); src_bytes 0
// fills the 4 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- tensor-core fragments (mma.sync m16n8k16, bf16 in, f32 accumulate) ---

__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major fragment) * b (16x8, col-major fragment).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed: with rows = k and columns = n of a
// row-major (k, n) tile, it yields mma_bf16's B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Four 1-byte KV wire values (one 32-bit word, element 0 in its low byte)
// as two bf16x2 words (elements 0, 1 in lo; 2, 3 in hi), exactly: every
// int8 and every finite e4m3 value is a bf16 value, so nothing rounds. Only
// byte permutes, logic, f32 adds and bf16x2 multiplies, which issue at the
// full or half FMA rate; cvt runs at a sixteenth of it on this card, and a
// tensor-core tile converts every K and V element it reads.
//   int8: with its sign bit flipped the byte is x + 128, the low byte of
//   the f32 2^23 + x + 128; subtracting 2^23 + 128 leaves x, whose upper
//   16 bits are its bf16 (|x| <= 128 has at most 8 significant bits).
//   e4m3: the byte's exponent and mantissa bits moved 4 places down inside
//   a bf16, the sign kept, are the value times 2^-120, subnormals included
//   (both formats' subnormals carry the same mantissa bits); one bf16x2
//   multiply by 2^120 restores the value, which is normal in bf16. The fn
//   format's NaN bytes (0x7f, 0xff) come out as +-480 (a pool holds
//   quantizer output: a NaN row carries a NaN scale, which the caller
//   multiplies in).
__device__ __forceinline__ void wire4_to_bf16x2(int8_t, uint32_t w,
                                                uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}
__device__ __forceinline__ void wire4_to_bf16x2(__nv_fp8_e4m3, uint32_t w,
                                                uint32_t& lo, uint32_t& hi) {
  // Each element's byte in the high byte of a 16-bit lane.
  const uint32_t a = __byte_perm(w, 0u, 0x1404);  // elements 0, 1
  const uint32_t b = __byte_perm(w, 0u, 0x3424);  // elements 2, 3
  const uint32_t ra = (a & 0x80008000u) | ((a & 0x7F007F00u) >> 4);
  const uint32_t rb = (b & 0x80008000u) | ((b & 0x7F007F00u) >> 4);
  const __nv_bfloat162 bias =
      __halves2bfloat162(__ushort_as_bfloat16((unsigned short)0x7B80),
                         __ushort_as_bfloat16((unsigned short)0x7B80));
  __nv_bfloat162 x = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&ra),
                             bias);
  __nv_bfloat162 y = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&rb),
                             bias);
  lo = *reinterpret_cast<uint32_t*>(&x);
  hi = *reinterpret_cast<uint32_t*>(&y);
}

}  // namespace tdt
