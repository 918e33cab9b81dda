// 16-byte vectors of f32 or bf16 elements, converted to and from f32
// registers, and element loads through L2 only; and the two elementwise
// passes built on them: the fixed-order fold of staged slots (oneshot_ar.cu,
// oneshot_rs.cu) and the add-and-round of a ring hop (twoshot_ar.cu,
// ring_rs.cu). Data another
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

// out[0, len) = cast(the f32 sum over src = 0 .. world - 1, in that order,
// of own[0, len) for src == d and slots[(src - (src > d)) * slot_stride +
// 0, len) for every other src): common.reduce_slots_tiled's order. own is
// read directly (an input of the call), the slots through L2 only. Every
// thread of the block calls it; VEC needs len, slot_stride and the
// pointers in whole 16-byte vectors.
template <typename T, bool VEC>
__device__ __forceinline__ void fold_slots(const T* __restrict__ own,
                                           const T* slots, size_t slot_stride,
                                           T* __restrict__ out, int world,
                                           int d, long long len) {
  if constexpr (VEC) {
    constexpr int P = Vec<T>::N;
    for (long long i = threadIdx.x; i < len / P; i += blockDim.x) {
      const long long e = i * P;
      float acc[P], f[P];
      for (int src = 0; src < world; ++src) {
        if (src == d)
          Vec<T>::load(*reinterpret_cast<const uint4*>(own + e), f);
        else
          load_vec_cg(slots + (src - (src > d)) * slot_stride + e, f);
#pragma unroll
        for (int k = 0; k < P; ++k) acc[k] = src == 0 ? f[k] : acc[k] + f[k];
      }
      store_vec(out + e, acc);
    }
  } else {
    for (long long e = threadIdx.x; e < len; e += blockDim.x) {
      float acc = 0.f;
      for (int src = 0; src < world; ++src) {
        const float f =
            src == d ? to_f32(own[e])
                     : load_cg(slots + (src - (src > d)) * slot_stride + e);
        acc = src == 0 ? f : acc + f;
      }
      out[e] = from_f32<T>(acc);
    }
  }
}

// dst[0, len) = round(a + b) (b may be null: a copied), a read directly
// (an input of the call) or through L2 only (a_cg: a piece another block
// wrote), b through L2 only: common.reduce_rows_tiled's hop. Every thread
// of the block calls it.
template <typename T, bool VEC>
__device__ __forceinline__ void add_rows(T* dst, const T* a, bool a_cg,
                                         const T* b, long long len) {
  if constexpr (VEC) {
    constexpr int P = Vec<T>::N;
    for (long long i = threadIdx.x; i < len / P; i += blockDim.x) {
      float acc[P], f[P];
      if (a_cg)
        load_vec_cg(a + i * P, acc);
      else
        Vec<T>::load(*reinterpret_cast<const uint4*>(a + i * P), acc);
      if (b) {
        load_vec_cg(b + i * P, f);
#pragma unroll
        for (int k = 0; k < P; ++k) acc[k] += f[k];
      }
      store_vec(dst + i * P, acc);
    }
  } else {
    for (long long i = threadIdx.x; i < len; i += blockDim.x) {
      float acc = a_cg ? load_cg(a + i) : to_f32(a[i]);
      if (b) acc += load_cg(b + i);
      dst[i] = from_f32<T>(acc);
    }
  }
}

}  // namespace vec
}  // namespace tdt
