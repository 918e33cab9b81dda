// GQA attention of an L-token query block per slot, read straight from a
// block-paged KV pool: the serving path's decode (L == 1), chunked-prefill
// and ragged mixed steps.
//
// Replaces: triton_distributed_tpu/kernels/paged_attention.py:248
//   _paged_attn_kernel (via paged_attention :402 and
//   paged_decode_attention :613), in its unquantized and its int8/fp8
//   builds.
//
// Contract: q (B, L, Hq, dh) row-major, f32 or bf16; the pools
//   (n_blocks, block_size, Hkv, dh) in q's dtype, or int8 / fp8 e4m3 with
//   f32 scales (n_blocks, block_size, Hkv); tables (B, max_blocks) int32,
//   dead slots already routed to block 0 by the caller; rows (3, B) int32
//   = (kv_len - q_len, kv_len, q_len) per slot, kv_len 0 where q_len is 0.
//   Query row j of slot b sits at position kv_len - q_len + j and attends
//   keys 0..that position; key position p lives at line p % block_size of
//   block table[b, p / block_size], clamped to [0, n_blocks). Rows
//   j >= q_len are padding and come back as exact zeros. Output
//   (B, L, Hq, dh) in q's dtype.
//
// What bounds it on the H100: device memory. A decode step reads every
//   valid key and value row once (2 * kv_len * Hkv * dh wire elements per
//   slot, plus the scales when quantized) for ~4 * g operations per
//   element, far below the ~295 operations per byte where the tensor cores
//   would become the limit. A mixed step with a long chunk (L = 256 at
//   g = 2) does ~4 * g * L operations per K/V element, near that line.
//
// What this design does about it: the block table is the only new piece.
//   It is walked inside the kernel, so the pool bytes are read once per
//   causal query tile and no contiguous copy of the cache is ever made. The
//   two halves are the existing kernels, instantiated over the paged rows
//   (kv_rows.cuh PagedRows):
//   - L == 1 takes flash_decode.cuh, split-KV: a grid of (ceil(S / 256),
//     Hkv, B) blocks with S = max_blocks x block_size, a static shape (no
//     read of kv_lens on the host), each streaming 256 keys of one (slot,
//     kv head) with 16-byte loads, its pages' table entries loaded once
//     into shared memory; the last block of each (slot, kv head) merges the
//     splits' f32 partials in split order. At Qwen3-1.7B's 8 slots x 8 kv
//     heads over 4,096 positions that is 1,024 blocks where one block per
//     (slot, kv head) gave 64, and the longest slot no longer sets the time
//     alone.
//   - L > 1 takes flash_prefill.cuh (one block per (slot, kv head, 64-row
//     query tile)). bf16 q at head_dim 64/128 runs on mma.sync over every
//     pool: a bf16 pool's rows go to shared memory as they are; an int8 /
//     fp8 pool's wire bytes (half the bytes) and f32 scales are staged by
//     cp.async, one table load per key, converted to bf16 exactly once a
//     block, and the scales applied outside the products (to S's key
//     columns and to P's before its bf16 rounding). fp32 q and other
//     head_dims take the CUDA-core kernel in f32, int8/fp8 rows
//     dequantized as float(wire) * scale right after the load.
//   Both load only rows below each tile's causal frontier min(kv_len,
//   kv_len - q_len + last live row + 1): table entries past it (allocator
//   padding that may name a live sequence's block) are never followed,
//   rows not loaded are zeros (with zero scales) or masked by a select,
//   and a fully masked row adds nothing to its denominator. The prefill
//   half has no wgmma or TMA yet.
#include "flash_decode.cuh"
#include "flash_prefill.cuh"

namespace {

// Decode scratch: the split partials and arrival counters (null at one
// split).
struct Scratch {
  float* part;
  int* arrivals;
};

template <typename TQ, typename KV>
cudaError_t run(const void* q, KV kv, void* out, const int* rows, int B,
                int L, int Hq, int Hkv, int S, int dh, float scale,
                Scratch sc, cudaStream_t s) {
  if (L == 1) {
    // One query row per slot: kv_len is the middle row of `rows`.
    if (!decode::dispatch<TQ, TQ>(Hq / Hkv, q, kv, static_cast<TQ*>(out),
                                  nullptr, rows + B, 0, B, Hq, Hkv, S, dh,
                                  scale, sc.part, sc.arrivals, s))
      return cudaErrorInvalidValue;
    return cudaGetLastError();
  }
  if (prefill::R % (Hq / Hkv)) return cudaErrorInvalidValue;
  return prefill::dispatch<TQ>(q, kv, out, rows, 0, 0, 0, B, L, Hq, Hkv, S,
                               dh, scale, s);
}

template <typename TQ>
cudaError_t by_pool(int kv_dtype, const void* q, const void* k,
                    const void* v, const float* ks, const float* vs,
                    const int* tables, const int* rows, void* out, int B,
                    int L, int Hq, int Hkv, int n_blocks, int bs,
                    int max_blocks, int dh, float scale, Scratch sc,
                    cudaStream_t s) {
  const int S = max_blocks * bs;
  const bool quant = kv_dtype == tdt::kI8 || kv_dtype == tdt::kFP8;
  if (quant != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  if (kv_dtype == tdt::kI8) {
    tdt::PagedRows<int8_t, true> kv{
        static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ks, vs,
        tables, max_blocks, n_blocks, bs, Hkv, dh};
    return run<TQ>(q, kv, out, rows, B, L, Hq, Hkv, S, dh, scale, sc, s);
  }
  if (kv_dtype == tdt::kFP8) {
    using F8 = __nv_fp8_e4m3;
    tdt::PagedRows<F8, true> kv{static_cast<const F8*>(k),
                                static_cast<const F8*>(v), ks, vs, tables,
                                max_blocks, n_blocks, bs, Hkv, dh};
    return run<TQ>(q, kv, out, rows, B, L, Hq, Hkv, S, dh, scale, sc, s);
  }
  // Unquantized: the pool holds q's dtype.
  const int q_code = std::is_same<TQ, float>::value ? tdt::kF32 : tdt::kBF16;
  if (kv_dtype != q_code) return cudaErrorInvalidValue;
  tdt::PagedRows<TQ, false> kv{static_cast<const TQ*>(k),
                               static_cast<const TQ*>(v), nullptr, nullptr,
                               tables, max_blocks, n_blocks, bs, Hkv, dh};
  return run<TQ>(q, kv, out, rows, B, L, Hq, Hkv, S, dh, scale, sc, s);
}

}  // namespace

// partials ((B, Hq, splits, dh + 2) f32) and arrivals ((B, Hkv) int32,
// zero, left zero) serve the decode (L == 1) when splits, which must be
// ceil(max_blocks * block_size / 256), is more than 1; null otherwise.
extern "C" int tdt_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* rows, void* out,
    long long B, long long L, long long Hq, long long Hkv, long long n_blocks,
    long long bs, long long max_blocks, long long dh, float scale,
    int q_dtype, int kv_dtype, void* partials, void* arrivals,
    long long splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv || dh <= 0 || dh > 128 ||
      dh % 8 || B > 65535 || Hkv > 65535 || L > INT32_MAX ||
      n_blocks <= 0 || bs <= 0 || max_blocks <= 0 ||
      n_blocks * bs > INT32_MAX || max_blocks * bs > INT32_MAX)
    return cudaErrorInvalidValue;
  if (L == 1 && splits != decode::splits_of(max_blocks * bs))
    return cudaErrorInvalidValue;
  const Scratch sc{static_cast<float*>(partials),
                   static_cast<int*>(arrivals)};
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* t = static_cast<const int*>(tables);
  const int* r = static_cast<const int*>(rows);
  if (q_dtype == tdt::kBF16)
    return by_pool<__nv_bfloat16>(kv_dtype, q, k, v, ks, vs, t, r, out,
                                  (int)B, (int)L, (int)Hq, (int)Hkv,
                                  (int)n_blocks, (int)bs, (int)max_blocks,
                                  (int)dh, scale, sc, s);
  if (q_dtype == tdt::kF32)
    return by_pool<float>(kv_dtype, q, k, v, ks, vs, t, r, out, (int)B,
                          (int)L, (int)Hq, (int)Hkv, (int)n_blocks, (int)bs,
                          (int)max_blocks, (int)dh, scale, sc, s);
  return cudaErrorInvalidValue;
}
