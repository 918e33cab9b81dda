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
// What this design does about it: one block per (batch row, kv head), so
//   the g query heads of a GQA group share every K/V row they read, and
//   nothing is read past the row's kv_len (those loads are skipped, never
//   multiplied by 0, so garbage there cannot leak). Eight warps each stream
//   their own runs of 8 consecutive keys, keeping 16 row loads per warp in
//   flight; the lanes split head_dim and reduce the q.k dot products with
//   shuffles. Each warp keeps a streaming-softmax state (max, sum, acc) in
//   f32 registers and the warps merge theirs through shared memory at the
//   end. At B * Hkv = 32 blocks the grid fills only a quarter of the 132
//   SMs: splitting the KV range across blocks (a second merge pass) is the
//   next step.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int U = 8;  // consecutive keys per warp per step

// EPL: head_dim elements per lane (lane l holds [l*EPL, l*EPL + EPL));
// G: query heads per kv head.
template <typename T, int EPL, int G>
__global__ void __launch_bounds__(WARPS * 32)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse,
                        const int* __restrict__ kv_lens, int kv_len0, int Hq,
                        int S, int dh, long long sb, long long ss,
                        long long sh, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * EPL;
  const bool active = d0 < dh;
  int kv_len = kv_lens ? kv_lens[b] : kv_len0;
  kv_len = min(max(kv_len, 0), S);

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

  const T* kb = k + (size_t)b * sb + (size_t)h * sh + d0;
  const T* vb = v + (size_t)b * sb + (size_t)h * sh + d0;
  for (int base = warp * U; base < kv_len; base += WARPS * U) {
    float kf[U][EPL], vf[U][EPL];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (active && base + j < kv_len) {
        tdt::load_n<EPL>(kb + (size_t)(base + j) * ss, kf[j]);
        tdt::load_n<EPL>(vb + (size_t)(base + j) * ss, vf[j]);
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
    if (t < dh) out[row * dh + t] = o / den;
    if (t == 0) lse[row] = M + logf(den);
    __syncthreads();
  }
}

template <typename T, int EPL, int G>
void launch(const void* q, const void* k, const void* v, float* out,
            float* lse, const int* kv_lens, int kv_len0, int B, int Hq,
            int Hkv, int S, int dh, long long sb, long long ss, long long sh,
            float scale, cudaStream_t s) {
  dim3 grid(Hkv, B);
  flash_decode_kernel<T, EPL, G><<<grid, WARPS * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, lse, kv_lens, kv_len0, Hq, S, dh, sb, ss,
      sh, scale);
}

template <typename T, int EPL>
bool dispatch_g(int g, const void* q, const void* k, const void* v,
                float* out, float* lse, const int* kv_lens, int kv_len0,
                int B, int Hq, int Hkv, int S, int dh, long long sb,
                long long ss, long long sh, float scale, cudaStream_t s) {
#define TDT_G(GV)                                                           \
  case GV:                                                                  \
    launch<T, EPL, GV>(q, k, v, out, lse, kv_lens, kv_len0, B, Hq, Hkv, S,  \
                       dh, sb, ss, sh, scale, s);                           \
    return true;
  switch (g) {
    TDT_G(1) TDT_G(2) TDT_G(4) TDT_G(8) TDT_G(16)
    default:
      return false;
  }
#undef TDT_G
}

template <typename T>
bool dispatch(int g, const void* q, const void* k, const void* v, float* out,
              float* lse, const int* kv_lens, int kv_len0, int B, int Hq,
              int Hkv, int S, int dh, long long sb, long long ss,
              long long sh, float scale, cudaStream_t s) {
  if (dh <= 32)
    return dispatch_g<T, 1>(g, q, k, v, out, lse, kv_lens, kv_len0, B, Hq, Hkv,
                            S, dh, sb, ss, sh, scale, s);
  if (dh <= 64)
    return dispatch_g<T, 2>(g, q, k, v, out, lse, kv_lens, kv_len0, B, Hq, Hkv,
                            S, dh, sb, ss, sh, scale, s);
  return dispatch_g<T, 4>(g, q, k, v, out, lse, kv_lens, kv_len0, B, Hq, Hkv,
                          S, dh, sb, ss, sh, scale, s);
}

}  // namespace

extern "C" int tdt_flash_decode(const void* q, const void* k, const void* v,
                                void* out, void* lse, const void* kv_lens,
                                int kv_len0, long long B, long long Hq,
                                long long Hkv, long long S, long long dh,
                                long long sb, long long ss, long long sh,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dh <= 128 with dh % 8 == 0 (and dh % 4 == 0 keeps every lane's vector
  // load inside the row); Hq a multiple of Hkv.
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || dh <= 0 || dh > 128 || dh % 8 ||
      B > 65535 || S > INT32_MAX)
    return cudaErrorInvalidValue;
  const int g = (int)(Hq / Hkv);
  const int* lens = static_cast<const int*>(kv_lens);
  float* o = static_cast<float*>(out);
  float* ls = static_cast<float*>(lse);
  bool ok;
  if (dtype == tdt::kBF16)
    ok = dispatch<__nv_bfloat16>(g, q, k, v, o, ls, lens, kv_len0, (int)B,
                                 (int)Hq, (int)Hkv, (int)S, (int)dh, sb, ss,
                                 sh, scale, s);
  else if (dtype == tdt::kF32)
    ok = dispatch<float>(g, q, k, v, o, ls, lens, kv_len0, (int)B, (int)Hq,
                         (int)Hkv, (int)S, (int)dh, sb, ss, sh, scale, s);
  else
    ok = false;
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
