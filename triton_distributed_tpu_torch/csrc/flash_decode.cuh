// GQA decode: one query token per row against its first kv_len[b] keys,
// for any K/V row layout of kv_rows.cuh. flash_decode.cu instantiates it
// over the contiguous cache (f32 out and lse, the partial pair a
// multi-rank combine merges), paged_attention.cu over the block-paged pool
// (out in q's dtype, no lse).
//
// Design: one block per (batch row, kv head), so the g query heads of a
//   GQA group share every K/V row they read, and nothing is read past the
//   row's kv_len (those loads are skipped, never multiplied by 0, so
//   garbage there cannot leak). Eight warps each stream their own runs of 8
//   consecutive keys, keeping 16 row loads per warp in flight; the lanes
//   split head_dim and reduce the q.k dot products with shuffles. int8/fp8
//   K/V rows are dequantized in registers right after the load. Each warp
//   keeps a streaming-softmax state (max, sum, acc) in f32 registers and
//   the warps merge theirs through shared memory at the end.
#pragma once

#include <math.h>

#include "common.cuh"
#include "kv_rows.cuh"

namespace {
namespace decode {

constexpr int WARPS = 8;
constexpr int U = 8;  // consecutive keys per warp per step

// EPL: head_dim elements per lane (lane l holds [l*EPL, l*EPL + EPL));
// G: query heads per kv head; TO: the output type. lse may be null.
template <typename TQ, typename TO, int EPL, int G, typename KV>
__global__ void __launch_bounds__(WARPS * 32)
    flash_decode_kernel(const TQ* __restrict__ q, KV kv, TO* __restrict__ out,
                        float* __restrict__ lse,
                        const int* __restrict__ kv_lens, int kv_len0, int Hq,
                        int S, int dh, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * EPL;
  const bool active = d0 < dh;
  int kv_len = kv_lens ? kv_lens[b] : kv_len0;
  kv_len = min(max(kv_len, 0), S);
  kv.bind(b, h);

  float qv[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (active) {
      tdt::load_n<EPL>(q + ((size_t)b * Hq + (size_t)h * G + gi) * dh + d0,
                       qv[gi]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[gi][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[gi][e] = 0.f;
    }
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }

  for (int base = warp * U; base < kv_len; base += WARPS * U) {
    float kf[U][EPL], vf[U][EPL];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int s = base + j;
      if (active && s < kv_len) {
        tdt::load_n<EPL>(kv.krow(s) + d0, kf[j]);
        tdt::load_n<EPL>(kv.vrow(s) + d0, vf[j]);
        if constexpr (KV::kQuant) {
          const float ka = kv.kscale(s), va = kv.vscale(s);
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            kf[j][e] *= ka;
            vf[j][e] *= va;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[j][e] = vf[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float sc[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qv[gi][e], kf[j][e], part);
        sc[j] = tdt::warp_sum(part);
      }
      float mx = sc[0];  // key `base` is valid: base < kv_len
#pragma unroll
      for (int j = 1; j < U; ++j)
        if (base + j < kv_len) mx = fmaxf(mx, sc[j]);
      const float mn = fmaxf(m[gi], mx);
      const float corr = expf(m[gi] - mn);  // 0 while m is still -inf
      float ps = 0.f, p[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        p[j] = base + j < kv_len ? expf(sc[j] - mn) : 0.f;
        ps += p[j];
      }
      l[gi] = l[gi] * corr + ps;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[gi][e] * corr;
#pragma unroll
        for (int j = 0; j < U; ++j) a = fmaf(p[j], vf[j][e], a);
        acc[gi][e] = a;
      }
      m[gi] = mn;
    }
  }

  // Merge the warps' states, one query head at a time.
  __shared__ float sm_m[WARPS][G], sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][32 * EPL];
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
  }
  const int t = threadIdx.x;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][d0 + e] = acc[gi][e];
    }
    __syncthreads();
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][gi]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = sm_m[w][gi];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - M);
      L = fmaf(sm_l[w][gi], wt, L);
      if (t < dh) o = fmaf(sm_acc[w][t], wt, o);
    }
    const float den = fmaxf(L, 1e-30f);
    const size_t row = (size_t)b * Hq + (size_t)h * G + gi;
    if (t < dh) out[row * dh + t] = tdt::from_f32<TO>(o / den);
    if (lse && t == 0) lse[row] = M + logf(den);
    __syncthreads();
  }
}

template <typename TQ, typename TO, int EPL, int G, typename KV>
void launch(const void* q, KV kv, TO* out, float* lse, const int* kv_lens,
            int kv_len0, int B, int Hq, int Hkv, int S, int dh, float scale,
            cudaStream_t s) {
  dim3 grid(Hkv, B);
  flash_decode_kernel<TQ, TO, EPL, G, KV><<<grid, WARPS * 32, 0, s>>>(
      static_cast<const TQ*>(q), kv, out, lse, kv_lens, kv_len0, Hq, S, dh,
      scale);
}

template <typename TQ, typename TO, int EPL, typename KV>
bool dispatch_g(int g, const void* q, KV kv, TO* out, float* lse,
                const int* kv_lens, int kv_len0, int B, int Hq, int Hkv,
                int S, int dh, float scale, cudaStream_t s) {
#define TDT_G(GV)                                                          \
  case GV:                                                                 \
    launch<TQ, TO, EPL, GV>(q, kv, out, lse, kv_lens, kv_len0, B, Hq, Hkv, \
                            S, dh, scale, s);                              \
    return true;
  switch (g) {
    TDT_G(1) TDT_G(2) TDT_G(4) TDT_G(8) TDT_G(16)
    default:
      return false;
  }
#undef TDT_G
}

// Launches the kernel for head_dim dh (a multiple of 8 up to 128) and g
// query heads per kv head; false when g is not one of 1, 2, 4, 8, 16.
template <typename TQ, typename TO, typename KV>
bool dispatch(int g, const void* q, KV kv, TO* out, float* lse,
              const int* kv_lens, int kv_len0, int B, int Hq, int Hkv, int S,
              int dh, float scale, cudaStream_t s) {
  if (dh <= 32)
    return dispatch_g<TQ, TO, 1>(g, q, kv, out, lse, kv_lens, kv_len0, B, Hq,
                                 Hkv, S, dh, scale, s);
  if (dh <= 64)
    return dispatch_g<TQ, TO, 2>(g, q, kv, out, lse, kv_lens, kv_len0, B, Hq,
                                 Hkv, S, dh, scale, s);
  return dispatch_g<TQ, TO, 4>(g, q, kv, out, lse, kv_lens, kv_len0, B, Hq,
                               Hkv, S, dh, scale, s);
}

}  // namespace decode
}  // namespace
