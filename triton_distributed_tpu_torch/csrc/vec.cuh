// 16-byte vectors of f32 or bf16 elements, converted to and from f32
// registers, and element loads through L2 only: the elementwise passes of
// the multi-rank all-reduces (oneshot_ar.cu, twoshot_ar.cu). Data another
// block of the same launch wrote is loaded through L2 only (ld.global.cg),
// since the loading SM's L1 is not coherent with the writer's.
#pragma once

#include "common.cuh"

namespace tdt {
namespace vec {

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(uint4 u, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&u);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static uint4 store(const float* f) {
    const float4 v = make_float4(f[0], f[1], f[2], f[3]);
    return *reinterpret_cast<const uint4*>(&v);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(uint4 u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

// One element as f32, through L2 only.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// 16 bytes at p (16-byte aligned) as f32, through L2 only.
template <typename T>
__device__ __forceinline__ void load_vec_cg(const T* p, float* f) {
  Vec<T>::load(__ldcg(reinterpret_cast<const uint4*>(p)), f);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = Vec<T>::store(f);
}

}  // namespace vec
}  // namespace tdt
