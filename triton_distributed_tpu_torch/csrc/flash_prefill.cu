// Causal GQA flash prefill against a contiguous KV cache, with per-row
// offsets and lengths (varlen).
//
// Replaces: triton_distributed_tpu/kernels/sp_attention.py:308
//   _flash_prefill_kernel (via flash_prefill :412).
//
// Contract: q (B, L, Hq, dh) row-major; the cache (B, S, Hkv, dh) or
//   (B, Hkv, S, dh), given as batch/seq/head strides with head_dim
//   contiguous. Query j of row b sits at position offset[b] + j and attends
//   keys at positions <= its own and < kv_len[b]; query rows j >= q_len[b]
//   are padding and come back as exact zeros. q head h reads kv head h / g.
//
// What bounds it on the H100: at the slice's prefill (B 4, L 2048, Hq 16,
//   dh 128) the causal half of QK^T and PV is ~69 GFLOP per layer against
//   ~100 MB of q, k, v and out, ~680 operations per byte: the tensor cores'
//   rate bounds it.
//
// What this design does about it: see flash_prefill.cuh, which holds the
//   kernels (written once for any K/V row layout); this file instantiates
//   them over the contiguous cache (kv_rows.cuh DenseRows).
#include "flash_prefill.cuh"

extern "C" int tdt_flash_prefill(const void* q, const void* k, const void* v,
                                 void* o, const void* rows, int offset0,
                                 int kv_len0, int q_len0, long long B,
                                 long long L, long long Hq, long long Hkv,
                                 long long S, long long dh, long long sb,
                                 long long ss, long long sh, float scale,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // g must divide the 64-row tile; dh a multiple of 8 up to 128.
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv ||
      prefill::R % (Hq / Hkv) || dh <= 0 || dh > 128 || dh % 8 ||
      B > 65535 || Hkv > 65535 || L > INT32_MAX || S > INT32_MAX)
    return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(rows);
  if (dtype == tdt::kBF16) {
    using T = __nv_bfloat16;
    tdt::DenseRows<T> kv{static_cast<const T*>(k), static_cast<const T*>(v),
                         sb, ss, sh};
    return prefill::dispatch<T>(q, kv, o, r, offset0, kv_len0, q_len0, (int)B,
                                (int)L, (int)Hq, (int)Hkv, (int)S, (int)dh,
                                scale, s);
  }
  if (dtype == tdt::kF32) {
    tdt::DenseRows<float> kv{static_cast<const float*>(k),
                             static_cast<const float*>(v), sb, ss, sh};
    return prefill::dispatch<float>(q, kv, o, r, offset0, kv_len0, q_len0,
                                    (int)B, (int)L, (int)Hq, (int)Hkv, (int)S,
                                    (int)dh, scale, s);
  }
  return cudaErrorInvalidValue;
}
