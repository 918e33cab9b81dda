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
// PagedRows::line loads the table entry of every row it is asked for (L1
// keeps it); the prefill's query tiles use it.
//
// The split-KV decode (flash_decode.cuh) reads a range of keys [s0, s1)
// page by page instead: bind_split(s0, s1, sm), called by every thread of
// the block (a barrier follows), copies the table entries of the range's
// pages into shared memory, one load per page, clamped; split_line(s) is
// then the row of key s in [s0, s1) with no table load, and
// krow_at/vrow_at/kscale_at/vscale_at read that row. DenseRows keeps no
// table: its line is the position itself.
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

  __device__ __forceinline__ void bind_split(int, int, int*) {}
  __device__ __forceinline__ size_t split_line(int s) const { return s; }
  __device__ __forceinline__ const T* krow_at(size_t s) const {
    return kb + s * ss;
  }
  __device__ __forceinline__ const T* vrow_at(size_t s) const {
    return vb + s * ss;
  }
  __device__ __forceinline__ float kscale_at(size_t) const { return 1.f; }
  __device__ __forceinline__ float vscale_at(size_t) const { return 1.f; }
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
  const int* pages;  // set by bind_split: clamped entries, shared memory
  int page0;

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

  // The pages of keys [s0, s1), s0 < s1 <= the slot's kv_len: table
  // entries s0 / bs .. (s1 - 1) / bs, at most (s1 - s0 - 1) / bs + 2.
  __device__ __forceinline__ void bind_split(int s0, int s1, int* sm) {
    page0 = s0 / bs;
    const int n = (s1 - 1) / bs - page0 + 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      sm[i] = min(max(tbl[page0 + i], 0), n_blocks - 1);
    pages = sm;
  }
  __device__ __forceinline__ size_t split_line(int s) const {
    return ((size_t)pages[s / bs - page0] * bs + s % bs) * Hkv + h;
  }
  __device__ __forceinline__ const T* krow_at(size_t ln) const {
    return k + ln * dh;
  }
  __device__ __forceinline__ const T* vrow_at(size_t ln) const {
    return v + ln * dh;
  }
  __device__ __forceinline__ float kscale_at(size_t ln) const {
    if constexpr (QUANT) return ks[ln];
    return 1.f;
  }
  __device__ __forceinline__ float vscale_at(size_t ln) const {
    if constexpr (QUANT) return vs[ln];
    return 1.f;
  }
};

}  // namespace tdt
