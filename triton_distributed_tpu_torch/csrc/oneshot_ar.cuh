// The one-shot all-reduce's two kinds of work item, shared by
// oneshot_ar.cu (world simulated ranks, every rank an owner) and
// oneshot_ar_loopback.cu (one owner whose every source is x): the ticket
// order of the items, the push of a chunk into every slot it goes to, and
// the fixed-order fold of a chunk's terms.
//   - A push loads its chunk ONCE, every load of a round in flight before
//     its first store, and stores it into each of its slots.
//   - A fold loads a vector (eight bf16 or four f32) of every term, eight
//     terms' loads in flight before the first add, the staged terms
//     through L2 only, and adds them in f32 in term order, then casts once:
//     common.reduce_slots_tiled's order.
//   - The ticket order puts chunk c's folds right behind chunk c + 1's
//     pushes (pushes of chunk 0, then for each c: pushes of c + 1, folds of
//     c), so a fold reads lines its pushes wrote moments before, from L2.
//     Every push a fold waits on was handed out before it to a running
//     block, and a push never waits: no deadlock, whatever the dispatch
//     order.
#pragma once

#include "language.cuh"
#include "vec.cuh"

namespace tdt {
namespace oneshot {

constexpr int kThreads = 256;
constexpr int kRound = 4;  // 16-byte vectors a thread a round: 16 KB
constexpr int kGroup = 8;  // terms whose loads are in flight at once
constexpr int kLag = 1;    // chunks of pushes handed out ahead of a fold

struct Item {
  bool push;
  int c, r;  // chunk; the source of a push, the owner of a fold
};

// The item of ticket t with W pushes and W folds a chunk and nc chunks
// (kernels/allreduce.py oneshot_ar_items): the pushes of chunks 0 .. lag -
// 1, then for each chunk c the pushes of c + lag (while there is one) and
// the folds of c.
__device__ __forceinline__ Item item_of(int t, int W, int nc) {
  const int lag = min(kLag, nc);
  if (t < lag * W) return {true, t / W, t % W};
  const int u = t - lag * W, full = (nc - lag) * 2 * W;
  if (u < full) {
    const int g = u / (2 * W), v = u % (2 * W);
    return v < W ? Item{true, g + lag, v} : Item{false, g, v - W};
  }
  return {false, nc - lag + (u - full) / W, (u - full) % W};
}

__device__ __forceinline__ void st_cg(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void st_cg(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// from[0, len) into to(k)[0, len) for k = 0 .. n_to - 1, stores through L2
// only. from is an input of the call, read directly. VEC needs len and the
// pointers in whole 16-byte vectors. Every thread of the block calls it.
template <typename T, bool VEC, class To>
__device__ __forceinline__ void push(const T* __restrict__ from,
                                     long long len, int n_to, To to) {
  if constexpr (VEC) {
    constexpr int P = vec::Vec<T>::N;
    const uint4* s = reinterpret_cast<const uint4*>(from);
    const long long n16 = len / P;
    for (long long i = threadIdx.x; i < n16; i += kRound * kThreads) {
      uint4 v[kRound];
#pragma unroll
      for (int u = 0; u < kRound; ++u)
        if (i + u * kThreads < n16) v[u] = s[i + u * kThreads];
      for (int k = 0; k < n_to; ++k) {
        uint4* d = reinterpret_cast<uint4*>(to(k));
#pragma unroll
        for (int u = 0; u < kRound; ++u)
          if (i + u * kThreads < n16) __stcg(d + i + u * kThreads, v[u]);
      }
    }
  } else {
    for (long long e = threadIdx.x; e < len; e += kThreads) {
      const T v = from[e];
      for (int k = 0; k < n_to; ++k) st_cg(to(k) + e, v);
    }
  }
}

// to[0, len) = cast(the f32 sum over src = 0 .. W - 1, in that order, of
// term(src)[0, len)): term(own) is an input of the call, read directly,
// every other term a staged slot, read through L2 only. VEC needs len and
// the pointers in whole 16-byte vectors. Every thread of the block calls
// it.
template <typename T, bool VEC, class Term>
__device__ __forceinline__ void fold(T* __restrict__ to, long long len,
                                     int W, int own, Term term) {
  if constexpr (VEC) {
    constexpr int P = vec::Vec<T>::N;
    for (long long i = threadIdx.x; i < len / P; i += kThreads) {
      float acc[P];
      for (int g0 = 0; g0 < W; g0 += kGroup) {
        uint4 v[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int src = g0 + k;
          if (src < W) {
            const uint4* p = reinterpret_cast<const uint4*>(term(src)) + i;
            v[k] = src == own ? *p : __ldcg(p);
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (g0 + k < W) {
            float f[P];
            vec::Vec<T>::load(v[k], f);
#pragma unroll
            for (int e = 0; e < P; ++e)
              acc[e] = g0 + k == 0 ? f[e] : acc[e] + f[e];
          }
        }
      }
      vec::store_vec(to + i * P, acc);
    }
  } else {
    for (long long e = threadIdx.x; e < len; e += kThreads) {
      float acc = 0.f;
      for (int src = 0; src < W; ++src) {
        const float f = src == own ? to_f32(term(src)[e])
                                   : vec::load_cg(term(src) + e);
        acc = src == 0 ? f : acc + f;
      }
      to[e] = from_f32<T>(acc);
    }
  }
}

}  // namespace oneshot
}  // namespace tdt
