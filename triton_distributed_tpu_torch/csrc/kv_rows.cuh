// Where the attention kernels find the K/V row of one key position.
//
// The flash prefill and flash decode kernels (flash_prefill.cuh,
// flash_decode.cuh) are written once against this small interface and
// instantiated for two layouts:
//
//   DenseRows  the contiguous cache (B, S, Hkv, dh) or (B, Hkv, S, dh),
//              given as batch/seq/head strides: row s at base + s * ss;
//   PagedRows  the block-paged pool (n_blocks, block_size, Hkv, dh) of the
//              serving path: key position s lives at line s % block_size
//              of block table[s / block_size], the table entry clamped to
//              [0, n_blocks). With QUANT the pool holds int8/fp8 wire values
//              and every (row, kv head) has an f32 scale in a
//              (n_blocks, block_size, Hkv) arena: the value is
//              float(wire) * scale, the expression of dequantize_kv_rows.
//
// A kernel calls bind(b, h) once for its (batch row or slot, kv head), then
// krow(s)/vrow(s) for a pointer to the head_dim values of key position s
// and kscale(s)/vscale(s) for its dequantization scale (1 when unquantized).
#pragma once

#include "common.cuh"

namespace tdt {

template <typename T>
struct DenseRows {
  using Elem = T;
  static constexpr bool kQuant = false;
  const T* k;
  const T* v;
  long long sb, ss, sh;
  const T* kb;  // set by bind
  const T* vb;

  __device__ __forceinline__ void bind(int b, int h) {
    kb = k + (size_t)b * sb + (size_t)h * sh;
    vb = v + (size_t)b * sb + (size_t)h * sh;
  }
  __device__ __forceinline__ const T* krow(int s) const {
    return kb + (size_t)s * ss;
  }
  __device__ __forceinline__ const T* vrow(int s) const {
    return vb + (size_t)s * ss;
  }
  __device__ __forceinline__ float kscale(int) const { return 1.f; }
  __device__ __forceinline__ float vscale(int) const { return 1.f; }
};

template <typename T, bool QUANT>
struct PagedRows {
  using Elem = T;
  static constexpr bool kQuant = QUANT;
  const T* k;
  const T* v;
  const float* ks;  // (n_blocks, bs, Hkv) f32 when QUANT, else unused
  const float* vs;
  const int* tables;  // (B, max_blocks) int32
  int max_blocks, n_blocks, bs, Hkv, dh;
  const int* tbl;  // set by bind
  int h;

  __device__ __forceinline__ void bind(int b, int hh) {
    tbl = tables + (size_t)b * max_blocks;
    h = hh;
  }
  // (block * bs + line) * Hkv + h: the (row, kv head) index of position s.
  __device__ __forceinline__ size_t line(int s) const {
    const int blk = min(max(tbl[s / bs], 0), n_blocks - 1);
    return ((size_t)blk * bs + s % bs) * Hkv + h;
  }
  __device__ __forceinline__ const T* krow(int s) const {
    return k + line(s) * dh;
  }
  __device__ __forceinline__ const T* vrow(int s) const {
    return v + line(s) * dh;
  }
  __device__ __forceinline__ float kscale(int s) const {
    if constexpr (QUANT) return ks[line(s)];
    return 1.f;
  }
  __device__ __forceinline__ float vscale(int s) const {
    if constexpr (QUANT) return vs[line(s)];
    return 1.f;
  }
};

}  // namespace tdt
