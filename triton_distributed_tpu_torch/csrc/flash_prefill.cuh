// Causal GQA flash prefill with per-row offsets and lengths (varlen), for
// any K/V row layout of kv_rows.cuh. flash_prefill.cu instantiates it over
// the contiguous cache, paged_attention.cu over the block-paged pool.
//
// Contract: q (B, L, Hq, dh) row-major. Query j of row b sits at position
//   offset[b] + j and attends keys at positions <= its own and < kv_len[b];
//   query rows j >= q_len[b] are padding and come back as exact zeros.
//   q head h reads kv head h / g.
//
// Design: one block per (q tile, kv head, batch row); a tile is 64 query
//   rows, the (position, GQA head) pairs of 64/g consecutive positions, so
//   all g heads of the group share every K/V chunk the block loads. The
//   block walks key chunks only up to its causal frontier and the row's
//   kv_len; K/V rows past that are never loaded (zeros in shared memory,
//   never a multiply by 0 of garbage), so NaN in the cache tail cannot
//   leak. Streaming softmax in f32 with the max(l, 1e-30) denominator.
//   bf16 q with head_dim 64 or 128 (the Qwen3/Llama presets) runs both
//   products on the tensor cores (mma.sync m16n8k16, FlashAttention-2
//   register layout, K/V chunks double-buffered by cp.async), over
//   unquantized bf16 K/V or an int8 / fp8 e4m3 pool with f32 row scales;
//   wgmma, TMA and warp specialisation are later steps. Every other case
//   (fp32 q, other head_dims) takes a plain kernel on the CUDA cores in f32
//   (4x2 scores and 4x8 outputs per thread from shared-memory tiles, int8 /
//   fp8 K/V dequantized right after the load).
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "kv_rows.cuh"

namespace {
namespace prefill {

constexpr int R = 64;   // query rows (position x GQA head) per block
constexpr int CK = 32;  // keys per chunk
constexpr int THREADS = 256;

template <int DH>
constexpr int smem_floats() {
  return R * (DH + 1)      // sQ  [R][DH+1]
         + CK * (DH + 1)   // sK  [CK][DH+1]
         + CK * DH         // sV  [CK][DH]
         + R * (CK + 1)    // sS  [R][CK+1]
         + 3 * R;          // row max, row sum, correction
}

// One key chunk of the CUDA-core tile, K and V already in shared memory
// (sK [CK][DH+1], sV [CK][DH]): the R x CK scores against the scaled sQ
// [R][DH+1], each kept where keep(row, key in chunk) holds and -inf
// elsewhere; the streaming-softmax update of the row max sM and sum sL
// (sC the correction); and acc = acc * corr + P V, rows ty + 16 i, head_dim
// columns tx + 16 j. Every thread of the THREADS-thread block calls it; it
// ends at a barrier, so the caller may refill sK and sV.
template <int DH, typename Keep>
__device__ __forceinline__ void simt_chunk(const float* sQ, const float* sK,
                                           const float* sV, float* sS,
                                           float* sM, float* sL, float* sC,
                                           float (&acc)[4][DH / 16], int dh,
                                           Keep keep) {
  constexpr int NC = DH / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // Scores: rows ty + 16 i, keys tx + 16 j.
  float sc[4][CK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CK / 16; ++j) sc[i][j] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float a[4], kk[CK / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < CK / 16; ++j) kk[j] = sK[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CK / 16; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < CK / 16; ++j) {
      const int c = tx + 16 * j;
      sS[r * (CK + 1) + c] = keep(r, c) ? sc[i][j] : -INFINITY;
    }
  }
  __syncthreads();

  // Streaming softmax: 4 threads per row, CK/4 keys each.
  {
    const int r = tid >> 2, part = tid & 3;
    float* srow = sS + r * (CK + 1) + part * (CK / 4);
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < CK / 4; ++c) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_old = sM[r];
    const float mn = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CK / 4; ++c) {
      const float sv = srow[c];
      const float pv = sv == -INFINITY ? 0.f : expf(sv - mn);
      srow[c] = pv;
      sum += pv;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      const float corr = m_old == -INFINITY ? 0.f : expf(m_old - mn);
      sC[r] = corr;
      sL[r] = sL[r] * corr + sum;
      sM[r] = mn;
    }
  }
  __syncthreads();

  // acc = acc * corr + P V: rows ty + 16 i, head_dim columns tx + 16 j.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float corr = sC[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
  }
  for (int c = 0; c < CK; ++c) {
    float p[4], vv[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * (CK + 1) + c];
#pragma unroll
    for (int j = 0; j < NC; ++j) vv[j] = sV[c * DH + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
  }
  __syncthreads();
}

template <typename TQ, int DH, typename KV>
__global__ void __launch_bounds__(THREADS)
    flash_prefill_kernel(const TQ* __restrict__ q, KV kv, TQ* __restrict__ o,
                         const int* __restrict__ rows, int offset0,
                         int kv_len0, int q_len0, int L, int Hq, int Hkv,
                         int S, int dh, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + R * (DH + 1);
  float* sV = sK + CK * (DH + 1);
  float* sS = sV + CK * DH;
  float* sM = sS + R * (CK + 1);
  float* sL = sM + R;
  float* sC = sL + R;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int g = Hq / Hkv, lb = R / g;
  const int offset = rows ? rows[b] : offset0;
  const int kv_len = min(rows ? rows[B + b] : kv_len0, S);
  const int q_len = min(rows ? rows[2 * B + b] : q_len0, L);
  const int p0 = qb * lb;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int vecs = dh / 8;
  kv.bind(b, h);

  for (int i = tid; i < R * vecs; i += THREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    const int p = p0 + r / g;
    float buf[8];
    if (p < L) {
      tdt::load8(q + (((size_t)b * L + p) * Hq + (size_t)h * g + r % g) * dh +
                     c,
                 buf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) buf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sQ[r * (DH + 1) + c + e] = buf[e] * scale;
  }
  if (tid < R) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  // Keys this tile can see: below the causal frontier of its last valid
  // query and below kv_len. A tile of padding rows sees none.
  const int q_hi = min(p0 + lb, q_len);
  const int kv_hi = q_hi > p0 ? min(kv_len, offset + q_hi) : 0;

  constexpr int NC = DH / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  __syncthreads();
  for (int c0 = 0; c0 < kv_hi; c0 += CK) {
    for (int i = tid; i < CK * vecs; i += THREADS) {
      const int c = i / vecs, d = (i % vecs) * 8;
      const int s = c0 + c;
      float kf[8], vf[8];
      if (s < kv_hi) {
        tdt::load8(kv.krow(s) + d, kf);
        tdt::load8(kv.vrow(s) + d, vf);
        if constexpr (KV::kQuant) {
          const float ka = kv.kscale(s), va = kv.vscale(s);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kf[e] *= ka;
            vf[e] *= va;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sK[c * (DH + 1) + d + e] = kf[e];
        sV[c * DH + d + e] = vf[e];
      }
    }
    __syncthreads();

    simt_chunk<DH>(sQ, sK, sV, sS, sM, sL, sC, acc, dh,
                   [&](int r, int c) {
                     const int p = p0 + r / g, key = c0 + c;
                     return p < q_hi && key <= offset + p && key < kv_len;
                   });
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int p = p0 + r / g;
    if (p >= L) continue;
    const float den = fmaxf(sL[r], 1e-30f);
    TQ* orow = o + (((size_t)b * L + p) * Hq + (size_t)h * g + r % g) * dh;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < dh) orow[col] = tdt::from_f32<TQ>(acc[i][j] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (head_dim 64 or 128, unquantized bf16 K/V):
// mma.sync m16n8k16 in the FlashAttention-2 arrangement. Four warps own 16
// of the tile's 64 rows each; a warp keeps its Q fragments and its O
// accumulator in registers, turns its score accumulators into the P operand
// without a trip through shared memory, and reads V through ldmatrix.trans.
// K/V chunks of 64 keys are double-buffered with cp.async; rows past the
// visible keys arrive as zeros (cp.async with a source size of 0), never
// read from the cache.
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_CK = 64;  // keys per chunk

template <int DH>
constexpr int mma_smem_bytes() {
  return (R + 4 * MMA_CK) * (DH + 8) * 2;  // Q + 2 stages of K and V
}

// The streaming-softmax state of one thread's two rows of the 64-row tile,
// r0 = warp * 16 + gid and r1 = r0 + 8 (gid = lane / 4), in the mma.sync
// register layout: the running max and (per-thread partial) sum of each
// row in the log2 domain, the O accumulator fragments and the warp's Q
// fragments. Shared by the flash prefill and the SP prefill
// (sp_ag_attn.cu), whose tiles differ only in their masks.
template <int DH>
struct MmaRows {
  using bf16 = __nv_bfloat16;
  static constexpr int LD = DH + 8;   // shared row stride (bf16)
  static constexpr int KT = DH / 16;  // k-steps of Q K^T
  static constexpr int NT = DH / 8;   // n-tiles of P V
  float m_a, m_b, l_a, l_b;
  float o[NT][4];
  uint32_t qf[KT][4];

  __device__ __forceinline__ void init() {
    m_a = m_b = -INFINITY;
    l_a = l_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // The warp's Q fragments from sQ [R][LD].
  __device__ __forceinline__ void load_q(const bf16* sQ) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane / 4, tig = lane % 4;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const bf16* base = sQ + (warp * 16 + gid) * LD + kk * 16 + 2 * tig;
      qf[kk][0] = tdt::ld_b32(base);
      qf[kk][1] = tdt::ld_b32(base + 8 * LD);
      qf[kk][2] = tdt::ld_b32(base + 8);
      qf[kk][3] = tdt::ld_b32(base + 8 * LD + 8);
    }
  }

  // One chunk of MMA_CK keys, K and V in shared memory (cK, cV [MMA_CK]
  // [LD]): S = Q K^T scaled into the log2 domain, masked to -inf where
  // keep(key in chunk, row r1?) is false, the running max and sum updated,
  // O = O * corr + P V with P rounded to bf16. SCALED: cK and cV hold a
  // quantized pool's wire values and ks / vs (shared memory, [MMA_CK]) the
  // chunk's per-key factors, K's with scale_log2 folded in: key k's score
  // column is scaled by ks[k] in place of scale_log2, and P's column k by
  // vs[k] before it is rounded to bf16 (the row sum stays on the unscaled
  // P), which is the plain version's float(wire) * scale on both operands.
  template <bool SCALED = false, typename Keep>
  __device__ __forceinline__ void chunk(const bf16* cK, const bf16* cV,
                                        float scale_log2, Keep keep,
                                        const float* ks = nullptr,
                                        const float* vs = nullptr) {
    const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
    // S for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float sacc[MMA_CK / 8][4];
#pragma unroll
    for (int j = 0; j < MMA_CK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int j = 0; j < MMA_CK / 8; ++j) {
        const bf16* kp = cK + (j * 8 + gid) * LD + kk * 16 + 2 * tig;
        const uint32_t bfrag[2] = {tdt::ld_b32(kp), tdt::ld_b32(kp + 8)};
        tdt::mma_bf16(sacc[j], qf[kk], bfrag);
      }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < MMA_CK / 8; ++j) {
      float2 f = make_float2(scale_log2, scale_log2);
      if constexpr (SCALED)
        f = *reinterpret_cast<const float2*>(ks + j * 8 + 2 * tig);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * 8 + 2 * tig + e;
        const float fk = e ? f.y : f.x;
        const float sa = keep(key, false) ? sacc[j][e] * fk : -INFINITY;
        const float sbv = keep(key, true) ? sacc[j][2 + e] * fk : -INFINITY;
        sacc[j][e] = sa;
        sacc[j][2 + e] = sbv;
        mx_a = fmaxf(mx_a, sa);
        mx_b = fmaxf(mx_b, sbv);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = m_a == -INFINITY ? 0.f : exp2f(m_a - mn_a);
    const float corr_b = m_b == -INFINITY ? 0.f : exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < MMA_CK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xa = sacc[j][e], xb = sacc[j][2 + e];
        const float pva = xa == -INFINITY ? 0.f : exp2f(xa - mn_a);
        const float pvb = xb == -INFINITY ? 0.f : exp2f(xb - mn_b);
        sacc[j][e] = pva;
        sacc[j][2 + e] = pvb;
        sum_a += pva;
        sum_b += pvb;
      }
    }
    // Partial row sums stay per thread (the quad shares corr); they are
    // summed across the quad once, in finish.
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    if constexpr (SCALED) {
#pragma unroll
      for (int j = 0; j < MMA_CK / 8; ++j) {
        const float2 f =
            *reinterpret_cast<const float2*>(vs + j * 8 + 2 * tig);
        sacc[j][0] *= f.x;
        sacc[j][1] *= f.y;
        sacc[j][2] *= f.x;
        sacc[j][3] *= f.y;
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr_a;
      o[n][1] *= corr_a;
      o[n][2] *= corr_b;
      o[n][3] *= corr_b;
    }

    // O += P V: the score accumulators of key tiles 2ks, 2ks+1 are the
    // A fragment of k-step ks.
    const int mat = lane / 8, mrow = lane % 8;
#pragma unroll
    for (int ks = 0; ks < MMA_CK / 16; ++ks) {
      const uint32_t pfrag[4] = {
          tdt::pack_bf16x2(sacc[2 * ks][0], sacc[2 * ks][1]),
          tdt::pack_bf16x2(sacc[2 * ks][2], sacc[2 * ks][3]),
          tdt::pack_bf16x2(sacc[2 * ks + 1][0], sacc[2 * ks + 1][1]),
          tdt::pack_bf16x2(sacc[2 * ks + 1][2], sacc[2 * ks + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vfrag[4];
        tdt::ldmatrix_x4_trans(
            vfrag, cV + (ks * 16 + (mat & 1) * 8 + mrow) * LD +
                       (n + (mat >> 1)) * 8);
        tdt::mma_bf16(o[n], pfrag, vfrag);
        tdt::mma_bf16(o[n + 1], pfrag, vfrag + 2);
      }
    }
  }

  // Sum each row's partial sums over its quad (once, after the last
  // chunk); the rows' sums, at least 1e-30.
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
    }
    l_a = fmaxf(l_a, 1e-30f);
    l_b = fmaxf(l_b, 1e-30f);
  }
};

// The tile's geometry, shared by the two tensor-core kernels: block
// (blockIdx.x, h, b) holds 64 query rows, the (position, GQA head) pairs of
// R / g positions from p0, latest tile first so the grid's tail is short;
// kv_hi bounds the keys it can see (its last live row's causal frontier
// and kv_len; 0 for a tile of padding rows).
struct MmaTile {
  int h, b, g, p0, offset, kv_len, q_hi, kv_hi;

  __device__ __forceinline__ MmaTile(const int* rows, int offset0,
                                     int kv_len0, int q_len0, int L, int Hq,
                                     int Hkv, int S) {
    const int qb = gridDim.x - 1 - blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
    const int B = gridDim.z;
    g = Hq / Hkv;
    const int lb = R / g;
    offset = rows ? rows[b] : offset0;
    kv_len = min(rows ? rows[B + b] : kv_len0, S);
    const int q_len = min(rows ? rows[2 * B + b] : q_len0, L);
    p0 = qb * lb;
    q_hi = min(p0 + lb, q_len);
    kv_hi = q_hi > p0 ? min(kv_len, offset + q_hi) : 0;
  }

  // Start the cp.async of the tile's Q rows into sQ [R][DH + 8] (zeros past
  // L); the caller commits.
  template <int DH>
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q,
                                         __nv_bfloat16* sQ, int L,
                                         int Hq) const {
    constexpr int LD = DH + 8, VEC = DH / 8;
    for (int i = threadIdx.x; i < R * VEC; i += MMA_WARPS * 32) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const int p = p0 + r / g;
      const bool ok = p < L;
      const __nv_bfloat16* src =
          ok ? q + (((size_t)b * L + p) * Hq + (size_t)h * g + r % g) * DH + c
             : q;
      tdt::cp_async16(sQ + r * LD + c, src, ok ? 16 : 0);
    }
  }

  // The mask of this thread's two rows (mma.sync layout: r0 = warp * 16 +
  // lane / 4, r1 = r0 + 8) for the chunk of keys from c0: causal, kv_len,
  // padding rows.
  __device__ __forceinline__ auto keep(int c0) const {
    const int lane = threadIdx.x % 32;
    const int r0 = (threadIdx.x / 32) * 16 + lane / 4, r1 = r0 + 8;
    const int pa = p0 + r0 / g, pb = p0 + r1 / g;
    const int qpos_a = offset + pa, qpos_b = offset + pb;
    const bool live_a = pa < q_hi, live_b = pb < q_hi;
    const int kl = kv_len;
    return [=](int key, bool row_b) {
      const int k = c0 + key;
      return k < kl && (row_b ? live_b && k <= qpos_b : live_a && k <= qpos_a);
    };
  }

  // The finished rows of st into o (B, L, Hq, DH) bf16, rows past L left.
  template <int DH>
  __device__ __forceinline__ void store(MmaRows<DH>& st, __nv_bfloat16* o,
                                        int L, int Hq) const {
    const int lane = threadIdx.x % 32, tig = lane % 4;
    const int r0 = (threadIdx.x / 32) * 16 + lane / 4, r1 = r0 + 8;
    const int pa = p0 + r0 / g, pb = p0 + r1 / g;
    st.finish();
    const float inv_a = 1.f / st.l_a, inv_b = 1.f / st.l_b;
    if (pa < L) {
      __nv_bfloat16* orow =
          o + (((size_t)b * L + pa) * Hq + (size_t)h * g + r0 % g) * DH;
#pragma unroll
      for (int n = 0; n < MmaRows<DH>::NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tig) =
            __floats2bfloat162_rn(st.o[n][0] * inv_a, st.o[n][1] * inv_a);
    }
    if (pb < L) {
      __nv_bfloat16* orow =
          o + (((size_t)b * L + pb) * Hq + (size_t)h * g + r1 % g) * DH;
#pragma unroll
      for (int n = 0; n < MmaRows<DH>::NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tig) =
            __floats2bfloat162_rn(st.o[n][2] * inv_b, st.o[n][3] * inv_b);
    }
  }
};

template <int DH, typename KV>
__global__ void __launch_bounds__(MMA_WARPS * 32)
    flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, KV kv,
                             __nv_bfloat16* __restrict__ o,
                             const int* __restrict__ rows, int offset0,
                             int kv_len0, int q_len0, int L, int Hq, int Hkv,
                             int S, float scale_log2) {
  using bf16 = __nv_bfloat16;
  static_assert(std::is_same<typename KV::Elem, bf16>::value && !KV::kQuant,
                "the bf16 tensor-core kernel reads unquantized bf16 K/V");
  constexpr int LD = MmaRows<DH>::LD;
  constexpr int VEC = DH / 8;  // 16-byte vectors per row
  constexpr int THREADS_M = MMA_WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + R * LD;             // [2][MMA_CK][LD]
  bf16* sV = sK + 2 * MMA_CK * LD;    // [2][MMA_CK][LD]

  const MmaTile tile(rows, offset0, kv_len0, q_len0, L, Hq, Hkv, S);
  const int tid = threadIdx.x, kv_hi = tile.kv_hi;
  kv.bind(tile.b, tile.h);
  tile.load_q<DH>(q, sQ, L, Hq);
  tdt::cp_async_commit();

  auto load_kv = [&](int stage, int c0) {
    bf16* dk = sK + stage * MMA_CK * LD;
    bf16* dv = sV + stage * MMA_CK * LD;
    for (int i = tid; i < MMA_CK * VEC; i += THREADS_M) {
      const int c = i / VEC, d = (i % VEC) * 8;
      const int s = c0 + c;
      const bool ok = s < kv_hi;
      tdt::cp_async16(dk + c * LD + d, ok ? kv.krow(s) + d : kv.k,
                      ok ? 16 : 0);
      tdt::cp_async16(dv + c * LD + d, ok ? kv.vrow(s) + d : kv.v,
                      ok ? 16 : 0);
    }
  };

  MmaRows<DH> st;
  st.init();
  const int nchunks = (kv_hi + MMA_CK - 1) / MMA_CK;
  if (nchunks > 0) load_kv(0, 0);
  tdt::cp_async_commit();
  for (int it = 0; it < nchunks; ++it) {
    const int stg = it & 1;
    if (it + 1 < nchunks) load_kv(stg ^ 1, (it + 1) * MMA_CK);
    tdt::cp_async_commit();
    tdt::cp_async_wait1();  // Q and this chunk have landed
    __syncthreads();
    if (it == 0) st.load_q(sQ);
    st.chunk(sK + stg * MMA_CK * LD, sV + stg * MMA_CK * LD, scale_log2,
             tile.keep(it * MMA_CK));
    __syncthreads();  // the stage is free for the load two chunks on
  }
  tdt::cp_async_wait_all();  // a tile that saw no keys still loaded Q
  tile.store<DH>(st, o, L, Hq);
}

// ---------------------------------------------------------------------------
// bf16 q over an int8 / fp8 e4m3 pool on the tensor cores (head_dim 64 or
// 128): the bf16 kernel's tile and MmaRows' register layout, fed from the
// pool's wire bytes. Per chunk of 64 keys, cp.async stages the raw K and V
// rows (64 x DH bytes each, half the bf16 bytes) and their 64 + 64 f32
// scales, double-buffered; two threads share one key, so each key's table
// entry is loaded once a chunk. The block then converts the landed chunk
// once into bf16 tiles in shared memory (wire4_to_bf16x2: exact, and once a
// block rather than once a warp) and copies its scales beside them, K's
// times scale_log2. The products run on the unscaled wire values and the
// scales are applied outside them (MmaRows::chunk<true>: S's key columns,
// and P's before P is rounded to bf16), so the result is the plain
// version's float(wire) * scale up to the bf16 rounding of P, which the
// bf16 pool's path has too. A key the tile does not load arrives as zero
// bytes with a zero scale (cp.async of 0 source bytes): nothing is read
// from the pool for it, so a NaN scale of an unreached block never meets a
// product, and its masked probability is 0 * 0.
// ---------------------------------------------------------------------------

template <int DH>
constexpr int mma_q8_smem_bytes() {
  return (R + 2 * MMA_CK) * (DH + 8) * 2  // Q, the converted chunk's K, V
         + 2 * 2 * MMA_CK * DH            // 2 stages of wire K and V rows
         + 2 * 2 * MMA_CK * 4             // 2 stages of their scales
         + 2 * MMA_CK * 4;                // the converted chunk's factors
}

template <int DH, typename KV>
__global__ void __launch_bounds__(MMA_WARPS * 32)
    flash_prefill_mma_q8_kernel(const __nv_bfloat16* __restrict__ q, KV kv,
                                __nv_bfloat16* __restrict__ o,
                                const int* __restrict__ rows, int L, int Hq,
                                int Hkv, int S, float scale_log2) {
  using bf16 = __nv_bfloat16;
  using W = typename KV::Elem;
  static_assert(KV::kQuant && sizeof(W) == 1,
                "the quantized tensor-core kernel reads 1-byte wire K/V");
  constexpr int LD = MmaRows<DH>::LD;
  constexpr int THREADS_M = MMA_WARPS * 32;
  static_assert(THREADS_M == 2 * MMA_CK, "two threads load each key");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + R * LD;  // [MMA_CK][LD]: the chunk, converted
  bf16* sV = sK + MMA_CK * LD;
  unsigned char* wK = reinterpret_cast<unsigned char*>(sV + MMA_CK * LD);
  unsigned char* wV = wK + 2 * MMA_CK * DH;  // [2][MMA_CK][DH] wire bytes
  float* wS = reinterpret_cast<float*>(wV + 2 * MMA_CK * DH);  // [2][K|V][]
  float* cS = wS + 4 * MMA_CK;  // [K x scale_log2 | V][MMA_CK]

  const MmaTile tile(rows, 0, 0, 0, L, Hq, Hkv, S);
  const int tid = threadIdx.x, kv_hi = tile.kv_hi;
  kv.bind(tile.b, tile.h);
  tile.load_q<DH>(q, sQ, L, Hq);
  tdt::cp_async_commit();

  // Thread tid loads half (tid % 2) of key tid / 2's K and V rows, and its
  // K (even) or V (odd) scale.
  const int key = tid >> 1, half = tid & 1;
  auto load_wire = [&](int stage, int c0) {
    const int s = c0 + key;
    const bool ok = s < kv_hi;
    const size_t ln = ok ? kv.line(s) : 0;
    const size_t at = ln * DH + half * (DH / 2);
    const unsigned char* gk = reinterpret_cast<const unsigned char*>(kv.k);
    const unsigned char* gv = reinterpret_cast<const unsigned char*>(kv.v);
    const int to = (stage * MMA_CK + key) * DH + half * (DH / 2);
#pragma unroll
    for (int u = 0; u < DH / 32; ++u) {
      tdt::cp_async16(wK + to + 16 * u, gk + at + 16 * u, ok ? 16 : 0);
      tdt::cp_async16(wV + to + 16 * u, gv + at + 16 * u, ok ? 16 : 0);
    }
    tdt::cp_async4(wS + (stage * 2 + half) * MMA_CK + key,
                   (half ? kv.vs : kv.ks) + ln, ok ? 4 : 0);
  };
  // The landed stage into sK, sV (8 wire bytes -> 8 bf16 a step) and cS.
  auto convert = [&](int stage) {
    const unsigned char* rk = wK + stage * MMA_CK * DH;
    const unsigned char* rv = wV + stage * MMA_CK * DH;
#pragma unroll
    for (int n = 0; n < MMA_CK * DH / 8 / THREADS_M; ++n) {
      const int i = tid + n * THREADS_M;
      const int c = i / (DH / 8), d = (i % (DH / 8)) * 8;
      const uint2 a = *reinterpret_cast<const uint2*>(rk + c * DH + d);
      const uint2 v = *reinterpret_cast<const uint2*>(rv + c * DH + d);
      uint4 ka, va;
      tdt::wire4_to_bf16x2(W{}, a.x, ka.x, ka.y);
      tdt::wire4_to_bf16x2(W{}, a.y, ka.z, ka.w);
      tdt::wire4_to_bf16x2(W{}, v.x, va.x, va.y);
      tdt::wire4_to_bf16x2(W{}, v.y, va.z, va.w);
      *reinterpret_cast<uint4*>(sK + c * LD + d) = ka;
      *reinterpret_cast<uint4*>(sV + c * LD + d) = va;
    }
    // threads 0..63 the K factors, 64..127 the V scales
    const float f = wS[stage * 2 * MMA_CK + tid];
    cS[tid] = tid < MMA_CK ? f * scale_log2 : f;
  };

  MmaRows<DH> st;
  st.init();
  const int nchunks = (kv_hi + MMA_CK - 1) / MMA_CK;
  if (nchunks > 0) load_wire(0, 0);
  tdt::cp_async_commit();
  for (int it = 0; it < nchunks; ++it) {
    const int stg = it & 1;
    if (it + 1 < nchunks) load_wire(stg ^ 1, (it + 1) * MMA_CK);
    tdt::cp_async_commit();
    tdt::cp_async_wait1();  // Q and this chunk's wire bytes have landed
    __syncthreads();        // ... for every thread; the last chunk is done
    if (it == 0) st.load_q(sQ);
    convert(stg);
    __syncthreads();  // the converted chunk is ready; its stage is free
    st.template chunk<true>(sK, sV, scale_log2, tile.keep(it * MMA_CK), cS,
                            cS + MMA_CK);
  }
  tdt::cp_async_wait_all();  // a tile that saw no keys still loaded Q
  tile.store<DH>(st, o, L, Hq);
}

template <int DH, typename KV>
cudaError_t launch_mma(const void* q, KV kv, void* o, const int* rows,
                       int offset0, int kv_len0, int q_len0, int B, int L,
                       int Hq, int Hkv, int S, float scale, cudaStream_t s) {
  const int lb = R / (Hq / Hkv);
  const dim3 grid((L + lb - 1) / lb, Hkv, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  if constexpr (KV::kQuant) {
    // The serving path's pools: per-slot rows always.
    if (!rows) return cudaErrorInvalidValue;
    constexpr int bytes = mma_q8_smem_bytes<DH>();
    auto kernel = flash_prefill_mma_q8_kernel<DH, KV>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, MMA_WARPS * 32, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), kv,
        static_cast<__nv_bfloat16*>(o), rows, L, Hq, Hkv, S, scale_log2);
  } else {
    constexpr int bytes = mma_smem_bytes<DH>();
    auto kernel = flash_prefill_mma_kernel<DH, KV>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, MMA_WARPS * 32, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), kv,
        static_cast<__nv_bfloat16*>(o), rows, offset0, kv_len0, q_len0, L,
        Hq, Hkv, S, scale_log2);
  }
  return cudaGetLastError();
}

template <typename TQ, int DH, typename KV>
cudaError_t launch_simt(const void* q, KV kv, void* o, const int* rows,
                        int offset0, int kv_len0, int q_len0, int B, int L,
                        int Hq, int Hkv, int S, int dh, float scale,
                        cudaStream_t s) {
  constexpr int bytes = smem_floats<DH>() * 4;
  auto kernel = flash_prefill_kernel<TQ, DH, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int lb = R / (Hq / Hkv);
  dim3 grid((L + lb - 1) / lb, Hkv, B);
  kernel<<<grid, THREADS, bytes, s>>>(
      static_cast<const TQ*>(q), kv, static_cast<TQ*>(o), rows, offset0,
      kv_len0, q_len0, L, Hq, Hkv, S, dh, scale);
  return cudaGetLastError();
}

// The tensor-core kernels for bf16 q at head_dim 64/128 over unquantized
// bf16 K/V or a 1-byte (int8 / fp8) pool with scales; the CUDA-core kernel
// for everything else (fp32 q, other head_dims), chosen from the types at
// compile time and the head_dim at the call. The caller has checked the
// shapes (g divides R, dh a multiple of 8 up to 128).
template <typename TQ, typename KV>
cudaError_t dispatch(const void* q, KV kv, void* o, const int* rows,
                     int offset0, int kv_len0, int q_len0, int B, int L,
                     int Hq, int Hkv, int S, int dh, float scale,
                     cudaStream_t s) {
  using Elem = typename KV::Elem;
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value &&
                (KV::kQuant ? sizeof(Elem) == 1
                            : std::is_same<Elem, __nv_bfloat16>::value)) {
    if (dh == 128)
      return launch_mma<128>(q, kv, o, rows, offset0, kv_len0, q_len0, B, L,
                             Hq, Hkv, S, scale, s);
    if (dh == 64)
      return launch_mma<64>(q, kv, o, rows, offset0, kv_len0, q_len0, B, L,
                            Hq, Hkv, S, scale, s);
  }
  if (dh <= 64)
    return launch_simt<TQ, 64>(q, kv, o, rows, offset0, kv_len0, q_len0, B,
                               L, Hq, Hkv, S, dh, scale, s);
  return launch_simt<TQ, 128>(q, kv, o, rows, offset0, kv_len0, q_len0, B, L,
                              Hq, Hkv, S, dh, scale, s);
}

}  // namespace prefill
}  // namespace
