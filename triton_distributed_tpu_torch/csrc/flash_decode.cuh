// Split-KV GQA decode: one query token per row against its first kv_len[b]
// keys, for any K/V row layout of kv_rows.cuh. flash_decode.cu
// instantiates it over the contiguous cache (f32 out and lse, the partial
// pair a multi-rank combine merges), paged_attention.cu over the
// block-paged pool (out in q's dtype, no lse).
//
// What bounds it on the H100: device memory. Every valid key and value row
//   is read once (2 * kv_len * Hkv * dh elements per row, plus the scales
//   of an int8/fp8 pool) for ~4 * g operations per element, far below the
//   ~295 operations per byte where the tensor cores would become the limit.
//   To stream at that rate the card needs ~40 KB in flight on every SM, and
//   no block may walk a long row alone. That holds at small g; at g = 8
//   (the SP decode's 64 / 8 heads) the CUDA cores' dot products, lane
//   shuffles and exponentials of every (head, key) set the time, ~4x
//   SDPA's on an H100: a tensor-core tile for large g is the next step.
//
// Design: the grid is (splits, Hkv, B). A split is SPLIT consecutive keys
//   (256, kernels/_build.py DECODE_SPLIT: 16 pages of 16), and the number
//   of splits, ceil(S / SPLIT), comes from the cache's static length S
//   (max_blocks x block_size for the pool), never from kv_lens, which live
//   on the device: a launch reads nothing back and a serving step stays
//   capturable. A block owns one (split, kv head, row) and streams its keys
//   below kv_len; a split that starts at or past kv_len loads nothing and
//   records m = -inf, l = 0. Within a block the g query heads of a GQA
//   group share every K/V row read. A row is read by a group of lanes, each
//   lane one 16-byte vector of EPL elements (fewer at large G, so that q
//   and the accumulators stay in registers); the group is as wide as dh 128
//   needs, fixed at compile time (a shorter row leaves lanes idle), so the
//   dot products' lane shuffles of every (head, row) unroll and interleave.
//   The block steps through the split 32 rows of K and of V at a time at dh
//   128, the next step's rows loaded into a second register buffer while
//   this step's are multiplied (4 KB in flight per
//   warp at bf16). The paged layout loads the split's block-table entries
//   once per page into shared memory first (kv_rows.cuh bind_split);
//   entries past ceil(kv_len / block_size) are never followed, and a row
//   past kv_len is never loaded. int8/fp8 rows are dequantized right after
//   the load. Each lane group keeps a streaming-softmax state (m, l, acc)
//   in f32 registers; groups merge by shuffles, warps through shared
//   memory, in a fixed order. With one split the block writes the result.
//   Otherwise it writes its partial (unnormalised acc, m, l) to f32
//   scratch (B, Hq, splits, dh + 2), and the block that arrives last at its
//   (row, kv head) counter (reset by that block for the next call) merges
//   every split's partial in split order, the weights of up to 256 splits
//   at a time in shared memory: the same bits run to run, and the same for
//   a contiguous and a paged cache of the same keys. Out = acc / max(l,
//   1e-30) and lse = m + log(max(l, 1e-30)), so a row with kv_len 0 gives
//   out 0 and lse -inf, never NaN.
#pragma once

#include <math.h>

#include "common.cuh"
#include "kv_rows.cuh"

namespace {
namespace decode {

// Keys of one split: kernels/_build.py DECODE_SPLIT, passed to nvcc.
#ifndef TDT_DECODE_SPLIT
#error "TDT_DECODE_SPLIT must be defined (kernels/_build.py NVCC_FLAGS)"
#endif
constexpr int SPLIT = TDT_DECODE_SPLIT;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_DH = 128;

// Splits of a cache of S positions (at least one): static shapes only.
inline long long splits_of(long long S) {
  return S <= SPLIT ? 1 : (S + SPLIT - 1) / SPLIT;
}

// Elements a lane loads per row: a 16-byte vector, at most max(4, 64 / G)
// so that q and the accumulators (2 G EPL floats) stay in registers.
template <typename T, int G>
constexpr int epl_for() {
  constexpr int e = 16 / (int)sizeof(T), cap = 64 / G < 4 ? 4 : 64 / G;
  return e < cap ? e : cap;
}

template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> {
  using T = uint4;
};
template <>
struct RawOf<8> {
  using T = uint2;
};
template <>
struct RawOf<4> {
  using T = uint32_t;
};

template <typename T, int EPL, typename Raw>
__device__ __forceinline__ void to_floats(const Raw& r, float* f) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < EPL; ++i) f[i] = tdt::to_f32(e[i]);
}

// Fold another (m, l) state into (m, l), returning the weights of the old
// and the other state's sums; a state at -inf weighs 0.
__device__ __forceinline__ void fold(float& m, float& l, float mo, float lo,
                                     float& wa, float& wb) {
  const float M = fmaxf(m, mo);
  wa = m == -INFINITY ? 0.f : expf(m - M);
  wb = mo == -INFINITY ? 0.f : expf(mo - M);
  l = l * wa + lo * wb;
  m = M;
}

// EPL: elements per lane per row; G: query heads per kv head; TO: the
// output type; lse may be null. part/arrivals: the split partials and the
// (row, kv head) arrival counters, null when there is one split.
template <typename TQ, typename TO, int EPL, int G, typename KV>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const TQ* __restrict__ q, KV kv, TO* __restrict__ out,
                        float* __restrict__ lse,
                        const int* __restrict__ kv_lens, int kv_len0, int Hq,
                        int S, int dh, float scale, float* part,
                        int* arrivals) {
  using T = typename KV::Elem;
  using Raw = typename RawOf<EPL * sizeof(T)>::T;
  // Rows a lane group loads per step: 16 / EPL, so a warp holds 4 rows of
  // K and of V at dh 128 in each of its two register buffers.
  constexpr int U = 16 / EPL;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Lanes per row: enough for MAX_DH (a shorter row leaves the lanes past
  // dh idle), a compile-time power of two so that the shuffle trees of
  // every (head, row) unroll and interleave.
  constexpr int LPR = MAX_DH / EPL < 32 ? MAX_DH / EPL : 32;
  constexpr int R = 32 / LPR;  // rows a warp reads at once
  static_assert(LPR * EPL >= MAX_DH && (LPR & (LPR - 1)) == 0, "lanes");
  const int d0 = (lane % LPR) * EPL;
  const bool active = d0 < dh;
  int kv_len = kv_lens ? kv_lens[b] : kv_len0;
  kv_len = min(max(kv_len, 0), S);
  const int k0 = split * SPLIT, k1 = min(k0 + SPLIT, kv_len);
  const size_t row0 = (size_t)b * Hq + (size_t)h * G;

  __shared__ int sm_pages[SPLIT + 1];
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][MAX_DH];
  __shared__ float sm_w[THREADS], sm_lw[THREADS];
  __shared__ int s_last;

  // The block's state for each query head of the group: thread t < dh
  // holds element t of the unnormalised sum.
  float bm[G], bl[G], bo[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    bm[gi] = -INFINITY;
    bl[gi] = 0.f;
    bo[gi] = 0.f;
  }
  const int t = threadIdx.x;

  if (k0 < k1) {  // block-uniform
    kv.bind(b, h);
    kv.bind_split(k0, k1, sm_pages);
    __syncthreads();

    float qv[G][EPL];
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        qv[gi][e] = active ? tdt::to_f32(q[(row0 + gi) * dh + d0 + e]) * scale
                           : 0.f;

    float m[G], l[G], acc[G][EPL];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      m[gi] = -INFINITY;
      l[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
    }

    // The block steps through the split NG * U keys at a time (lane group
    // gid of the block takes keys step + gid + u NG), the next step's rows
    // loaded into registers while this step's are multiplied. The step is
    // block-uniform, so every lane runs the shuffles; a lane group past k1
    // loads nothing and skips the update.
    const int NG = WARPS * R, gid = warp * R + lane / LPR;
    Raw kr[2][U], vr[2][U];
    float ka[2][U], va[2][U];
    auto load = [&](int step, int buf) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = step + gid + u * NG;
        if (active && s < k1) {
          const size_t ln = kv.split_line(s);
          kr[buf][u] = *reinterpret_cast<const Raw*>(kv.krow_at(ln) + d0);
          vr[buf][u] = *reinterpret_cast<const Raw*>(kv.vrow_at(ln) + d0);
          ka[buf][u] = kv.kscale_at(ln);
          va[buf][u] = kv.vscale_at(ln);
        } else {
          kr[buf][u] = vr[buf][u] = Raw{};
          ka[buf][u] = va[buf][u] = 0.f;
        }
      }
    };
    auto run = [&](int step, int buf) {
      const int base = step + gid;
      float kf[U][EPL], vf[U][EPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        to_floats<T, EPL>(kr[buf][u], kf[u]);
        to_floats<T, EPL>(vr[buf][u], vf[u]);
        if constexpr (KV::kQuant) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            kf[u][e] *= ka[buf][u];
            vf[u][e] *= va[buf][u];
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float sc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float p = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) p = fmaf(qv[gi][e], kf[u][e], p);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            p += __shfl_xor_sync(0xffffffffu, p, o);
          sc[u] = p;
        }
        if (base >= k1) continue;
        float mx = sc[0];  // row `base` is below k1
#pragma unroll
        for (int u = 1; u < U; ++u)
          if (base + u * NG < k1) mx = fmaxf(mx, sc[u]);
        const float mn = fmaxf(m[gi], mx);
        const float corr = expf(m[gi] - mn);  // 0 while m is still -inf
        float ps = 0.f, p[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = base + u * NG < k1 ? expf(sc[u] - mn) : 0.f;
          ps += p[u];
        }
        l[gi] = l[gi] * corr + ps;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = acc[gi][e] * corr;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
          acc[gi][e] = a;
        }
        m[gi] = mn;
      }
    };
    load(k0, 0);
    for (int step = k0; step < k1; step += 2 * NG * U) {
      load(step + NG * U, 1);
      run(step, 0);
      if (step + NG * U >= k1) break;
      load(step + 2 * NG * U, 0);
      run(step + NG * U, 1);
    }

    // The lane groups of a warp, then the warps, in a fixed order.
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[gi], o);
        float wa, wb;
        fold(m[gi], l[gi], mo, lo, wa, wb);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
          acc[gi][e] = acc[gi][e] * wa + ao * wb;
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (lane < LPR && active)
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[warp][d0 + e] = acc[gi][e];
      if (lane == 0) {
        sm_m[warp] = m[gi];
        sm_l[warp] = l[gi];
      }
      __syncthreads();
      for (int w = 0; w < WARPS; ++w) {
        float wa, wb;
        fold(bm[gi], bl[gi], sm_m[w], sm_l[w], wa, wb);
        bo[gi] = t < dh ? bo[gi] * wa + sm_acc[w][t] * wb : 0.f;
      }
      __syncthreads();
    }
  }

  auto finish = [&](int gi, float M, float L, float o) {
    const float den = fmaxf(L, 1e-30f);
    if (t < dh) out[(row0 + gi) * dh + t] = tdt::from_f32<TO>(o / den);
    if (lse && t == 0) lse[row0 + gi] = M + logf(den);
  };
  if (n_splits == 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) finish(gi, bm[gi], bl[gi], bo[gi]);
    return;
  }

  // Partial of this split: acc[0, dh), m, l.
  const int stride = dh + 2;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float* p = part + ((row0 + gi) * n_splits + split) * stride;
    if (k0 < k1 && t < dh) p[t] = bo[gi];
    if (t == 0) {
      p[dh] = bm[gi];
      p[dh + 1] = bl[gi];
    }
  }
  __syncthreads();  // every thread's stores precede the arrival
  if (t == 0) {
    int* cnt = arrivals + (size_t)b * gridDim.y + h;
    __threadfence();
    s_last = atomicAdd(cnt, 1) == n_splits - 1;
    if (s_last) *cnt = 0;  // the counter's consumer resets it
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // The last block merges: M, the largest split max (any order gives the
  // same max), then the weights exp(m_s - M) of up to THREADS splits at a
  // time in shared memory (0 for a split that saw no key: its acc is never
  // used), and l and acc summed over them in split order.
  for (int gi = 0; gi < G; ++gi) {
    const float* p = part + (row0 + gi) * n_splits * stride;
    float M = -INFINITY;
    for (int s = t; s < n_splits; s += THREADS)
      M = fmaxf(M, __ldcg(p + (size_t)s * stride + dh));
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    __syncthreads();  // the previous head's readers are done with sm_*
    if (lane == 0) sm_m[warp] = M;
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w]);
    float L = 0.f, o = 0.f;
    for (int c0 = 0; c0 < n_splits; c0 += THREADS) {
      const int s = c0 + t, n = min(THREADS, n_splits - c0);
      if (s < n_splits) {
        const float ms = __ldcg(p + (size_t)s * stride + dh);
        const float ws = ms == -INFINITY ? 0.f : expf(ms - M);
        sm_w[t] = ws;
        sm_lw[t] = __ldcg(p + (size_t)s * stride + dh + 1) * ws;
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) L += sm_lw[i];
      if (t < dh) {
        const float* pa = p + (size_t)c0 * stride + t;
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          const float a = __ldcg(pa + (size_t)i * stride), ws = sm_w[i];
          o += ws != 0.f ? a * ws : 0.f;
        }
      }
      __syncthreads();  // sm_w is refilled next
    }
    finish(gi, M, L, o);
  }
}

template <typename TQ, typename TO, int EPL, int G, typename KV>
void launch(const void* q, KV kv, TO* out, float* lse, const int* kv_lens,
            int kv_len0, int B, int Hq, int Hkv, int S, int dh, float scale,
            float* part, int* arrivals, cudaStream_t s) {
  dim3 grid((unsigned)splits_of(S), Hkv, B);
  flash_decode_kernel<TQ, TO, EPL, G, KV><<<grid, THREADS, 0, s>>>(
      static_cast<const TQ*>(q), kv, out, lse, kv_lens, kv_len0, Hq, S, dh,
      scale, part, arrivals);
}

template <typename TQ, typename TO, int G, typename KV>
void launch_g(const void* q, KV kv, TO* out, float* lse, const int* kv_lens,
              int kv_len0, int B, int Hq, int Hkv, int S, int dh,
              float scale, float* part, int* arrivals, cudaStream_t s) {
  constexpr int E = epl_for<typename KV::Elem, G>();
  if constexpr (E == 16) {  // 1-byte rows: 16-byte vectors need dh % 16
    if (dh % 16) {
      launch<TQ, TO, 8, G>(q, kv, out, lse, kv_lens, kv_len0, B, Hq, Hkv, S,
                           dh, scale, part, arrivals, s);
      return;
    }
  }
  launch<TQ, TO, E, G>(q, kv, out, lse, kv_lens, kv_len0, B, Hq, Hkv, S, dh,
                       scale, part, arrivals, s);
}

// Launches the kernel for head_dim dh (a multiple of 8 up to 128) and g
// query heads per kv head over ceil(S / SPLIT) splits; part ((B, Hq,
// splits, dh + 2) f32) and arrivals ((B, Hkv) int32, zero) are needed when
// there is more than one split. False when g is not one of 1, 2, 4, 8, 16
// or the scratch is missing.
template <typename TQ, typename TO, typename KV>
bool dispatch(int g, const void* q, KV kv, TO* out, float* lse,
              const int* kv_lens, int kv_len0, int B, int Hq, int Hkv, int S,
              int dh, float scale, float* part, int* arrivals,
              cudaStream_t s) {
  if (dh <= 0 || dh > MAX_DH || dh % 8) return false;
  if (splits_of(S) > 1 && (!part || !arrivals)) return false;
#define TDT_G(GV)                                                       \
  case GV:                                                              \
    launch_g<TQ, TO, GV>(q, kv, out, lse, kv_lens, kv_len0, B, Hq, Hkv, \
                         S, dh, scale, part, arrivals, s);              \
    return true;
  switch (g) {
    TDT_G(1) TDT_G(2) TDT_G(4) TDT_G(8) TDT_G(16)
    default:
      return false;
  }
#undef TDT_G
}

}  // namespace decode
}  // namespace
