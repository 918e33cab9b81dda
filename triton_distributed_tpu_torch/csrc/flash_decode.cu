// Split-KV GQA decode: one query token per row against a contiguous KV
// cache, returning the f32 partial pair (out (B, Hq, dh), lse (B, Hq)).
//
// Replaces: triton_distributed_tpu/kernels/sp_attention.py:511
//   _flash_decode_kernel and :567 _flash_decode_bd_kernel (both via
//   flash_decode_local :654). The block-diagonal variant exists to feed the
//   TPU's matrix unit in the bshd layout; on Hopper one kernel serves both
//   contracts, the cache layout (bshd or bhsd) arriving as strides.
//
// What bounds it on the H100: device memory. Every valid key and value row
//   is read once (2 * kv_len * Hkv * dh elements per batch row) for only
//   ~4 * g operations per element, far below the ~295 operations per byte
//   where the tensor cores would become the limit.
//
// What this design does about it: see flash_decode.cuh, which holds the
//   kernel (written once for any K/V row layout); this file instantiates
//   it over the contiguous cache (kv_rows.cuh DenseRows). The grid is
//   (ceil(S / 256), Hkv, B): at Qwen3-1.7B's 4 rows x 8 kv heads over a
//   4,096-position cache, 512 blocks of 256 keys (32 without the split), a
//   split past a row's kv_len loading nothing; the last block of each
//   (row, kv head) merges the f32 partials in split order into out and the
//   lse that the SP decode's log-sum-exp merge reads. The paged decode
//   (paged_attention.cu) runs the same kernel over the same split, so the
//   two give the same bits on the same keys.
#include "flash_decode.cuh"

// partials ((B, Hq, splits, dh + 2) f32) and arrivals ((B, Hkv) int32,
// zero, left zero) when splits, which must be ceil(S / 256), is more than
// 1; null otherwise. The strides are in elements, multiples of 8.
extern "C" int tdt_flash_decode(const void* q, const void* k, const void* v,
                                void* out, void* lse, const void* kv_lens,
                                int kv_len0, long long B, long long Hq,
                                long long Hkv, long long S, long long dh,
                                long long sb, long long ss, long long sh,
                                float scale, int dtype, void* partials,
                                void* arrivals, long long splits,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dh <= 128 with dh % 8 == 0; strides in whole 16-byte vectors of bf16
  // (8 elements) so every lane's load stays aligned; Hq a multiple of Hkv.
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || dh <= 0 || dh > 128 || dh % 8 ||
      B > 65535 || Hkv > 65535 || S < 0 || S > INT32_MAX || sb % 8 ||
      ss % 8 || sh % 8 || splits != decode::splits_of(S))
    return cudaErrorInvalidValue;
  const int g = (int)(Hq / Hkv);
  const int* lens = static_cast<const int*>(kv_lens);
  float* o = static_cast<float*>(out);
  float* ls = static_cast<float*>(lse);
  float* part = static_cast<float*>(partials);
  int* arr = static_cast<int*>(arrivals);
  bool ok;
  if (dtype == tdt::kBF16) {
    using T = __nv_bfloat16;
    tdt::DenseRows<T> kv{static_cast<const T*>(k), static_cast<const T*>(v),
                         sb, ss, sh};
    ok = decode::dispatch<T, float>(g, q, kv, o, ls, lens, kv_len0, (int)B,
                                    (int)Hq, (int)Hkv, (int)S, (int)dh, scale,
                                    part, arr, s);
  } else if (dtype == tdt::kF32) {
    tdt::DenseRows<float> kv{static_cast<const float*>(k),
                             static_cast<const float*>(v), sb, ss, sh};
    ok = decode::dispatch<float, float>(g, q, kv, o, ls, lens, kv_len0,
                                        (int)B, (int)Hq, (int)Hkv, (int)S,
                                        (int)dh, scale, part, arr, s);
  } else {
    ok = false;
  }
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
