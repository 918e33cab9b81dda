// Sequence-parallel prefill attention with the KV allgather overlapped,
// world simulated ranks on one card. q (world, H, m, dh): rank r's m query
// rows, at global positions row0[r] + i; k, v (world, H, m_kv, dh): rank
// r's key shard, global columns col0[r] + src m_kv + j once gathered (src
// the shard's rank); k_full, v_full (world, world, H, m_kv, dh): every
// rank's gathered K and V, [dst][src]; out (world, H, m, dh); lse (world,
// H, m) f32 (optional): m + log(l) per row, -1e30 + log(1e-30) for a row
// that saw no key. f32 or bf16.
//
// Replaces: triton_distributed_tpu/kernels/sp_attention.py:47
//   _sp_attn_kernel (via sp_ag_attention_device :147 at world > 1). Its
//   order: every rank pushes its K and V shard into slot `me` of every
//   rank's k_full / v_full; the grid walks (head, segment), segments in
//   arrival order, own shard first (src = (me + s) mod world, :66), waiting
//   on each segment's receive semaphores, skipping a segment whose first
//   column lies right of the rank's last row when causal (:98), and
//   carrying the running max, denominator and accumulator across segments
//   in f32 (:104-128), a fully masked row adding nothing (the `* valid`
//   guard, :119-124); out = acc / max(l, 1e-30), lse = m + log(max(l,
//   1e-30)) (:130-138).
//
// What bounds it on the H100: operations. At Qwen3-32B's attention width
//   over 8 ranks x 4,096 tokens (64 heads, dh 128, causal) the mask keeps
//   S (S + 1) / 2 = 5.4e8 (row, column) pairs a head, 4 H dh of them
//   1.76e13 operations on the tensor cores (17.8 ms at 989 TFLOP/s), against
//   ~1.1 GB of q, k, v and out (0.3 ms at 3.35 TB/s).
//
// What this design does about it: one persistent grid (gemm_tile.cuh
//   persistent_blocks), work items handed out by an atomic ticket that
//   lives in a persistent buffer (kernels/_signal.py arrivals) and that the
//   last block out leaves at 0, so the call makes no memset.
//
//   bf16 at head_dim 128 (the path's shape) runs on attn_wgmma.cuh's tile
//   (given a positive scale, at most 64 ranks and 16-byte aligned
//   operands, which its softmax, its segment table and TMA take): a block
//   is two warpgroups of 64 query rows, Q and 128-key chunks of K and V
//   loaded by TMA through a three-stage ring, S = Q K^T and O += P V on
//   wgmma, the softmax on S in registers while the previous chunk's P V
//   runs, the two warpgroups taking turns on the tensor cores.
//   Its items (sp_ag_attn_items in kernels/sp_attention.py is the same
//   order in Python):
//   - a push item (src, head) bulk-copies rank src's K and V of one head
//     through shared memory into every rank dst's k_full / v_full[src]
//     (wgmma_tile.cuh bulk_copy: each byte read once, stored world times)
//     and raises the world flags (dst, src, head) to the call's epoch;
//   - an attend item (rank r, head h, 128-row q tile) walks rank r's
//     segments in JAX's order, skipping one whose first global column lies
//     right of the tile's last row, and streams each one's chunks up to
//     the tile's causal frontier, after one thread has acquired the flags
//     of the segments it reads; each row's mask is one bound on a chunk's
//     keys (the segment's end, or the row's own column when causal).
//   The tickets go head by head: the pushes of heads 0 and 1, then for
//   each head h the pushes of head h + 2 (while there is one) and the
//   attend items of head h, ranks and tiles latest first (the heaviest
//   under the causal mask) and one (rank, head)'s tiles consecutive, so
//   its K and V come from device memory about once and from L2 for the
//   rest; a head's pushes run on a few blocks two heads ahead of its
//   attend items, hidden behind the items between.
//
//   Other dtypes and head dims, and bf16 at 128 outside those conditions,
//   keep the earlier items on the present tiles, in the same launch path:
//   push items per (distance, dst, head), copying with every thread
//   (language.cuh putmem_signal), latest first, and attend items per
//   (rank, 64-row tile, head) on flash_prefill.cuh's tiles: for bf16 at
//   head_dim 64 or 128 the mma.sync FlashAttention-2 tile
//   (MmaRows: Q fragments and the f32 state in registers, 64-key chunks
//   double-buffered by cp.async.cg, P in bf16), else the CUDA-core tile
//   (simt_chunk, f32).
//
//   Either way the state carries across segments; the mask compares global
//   rows and columns, so row and column offsets need no alignment. A push
//   never waits and every item an attend item waits on was handed out
//   before it to a running block, so no wait can deadlock. delay_ns holds
//   every push item back before its copy (a test of the waits: the result
//   must not change).
#include "attn_wgmma.cuh"
#include "flash_prefill.cuh"
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
namespace wg = tdt::wg;
using prefill::CK;
using prefill::MMA_CK;
using prefill::R;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // JAX's _NEG_INF (sp_attention.py:44)

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  void* k_full;
  void* v_full;
  void* out;
  float* lse;
  const int* offs;  // (2, world): row0, col0
  uint32_t* flags;  // (dst, src, head)
  int* ticket;
  uint32_t epoch;
  int world, H, m, m_kv, dh, n_tiles;
  bool causal;
  float scale;
  unsigned long long delay_ns;
};

// Eight consecutive elements as f32, through L2 only (another block
// staged them).
__device__ __forceinline__ void load8_cg(const float* p, float* out) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8_cg(const bf16* p, float* out) {
  uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  tdt::load8(reinterpret_cast<const bf16*>(&u), out);
}

// A block whose ticket t is past the work: the last one out (every block
// takes exactly one such ticket) leaves the ticket at 0 for the next call.
__device__ __forceinline__ void leave_ticket(const Problem& P, int t,
                                             int total) {
  if (threadIdx.x == 0 && t == total + (int)gridDim.x - 1) *P.ticket = 0;
}

// Producer item t: rank src's K and V of head h into rank dst's slot src.
template <typename T>
__device__ void produce(const Problem& P, int t) {
  const int W = P.world, H = P.H;
  const int dist = t / (W * H), dst = (t / H) % W, h = t % H;
  const int src = (dst + dist) % W;
  const size_t seg = (size_t)P.m_kv * P.dh;  // elements of one head's keys
  const size_t from = ((size_t)src * H + h) * seg;
  const size_t to = (((size_t)dst * W + src) * H + h) * seg;
  lang::sleep_ns(P.delay_ns);
  lang::copy_block(static_cast<T*>(P.k_full) + to,
                   static_cast<const T*>(P.k) + from, seg * sizeof(T));
  lang::putmem_signal(static_cast<T*>(P.v_full) + to,
                      static_cast<const T*>(P.v) + from, seg * sizeof(T),
                      P.flags + ((size_t)dst * W + src) * H + h, P.epoch);
}

// The consumer's walk over rank r's segments, own first: for each one the
// tile needs, wait on its flag and call seg(kseg, vseg, cb, kv_hi) with
// its keys' base pointers, its first global column and the keys it needs.
template <typename T, typename Seg>
__device__ __forceinline__ void walk_segments(const Problem& P, int r, int h,
                                              int row_hi, Seg seg) {
  const int W = P.world;
  const int col0 = P.offs[W + r];
  for (int s = 0; s < W; ++s) {
    const int src = (r + s) % W;
    const int cb = col0 + src * P.m_kv;
    const int kv_hi = P.causal ? min(P.m_kv, row_hi - cb + 1) : P.m_kv;
    if (kv_hi <= 0) continue;  // right of the tile's last row
    if (threadIdx.x == 0)
      lang::wait(P.flags + ((size_t)r * W + src) * P.H + h, P.epoch);
    __syncthreads();
    lang::consume_token();
    const size_t at = (((size_t)r * W + src) * P.H + h) * P.m_kv * P.dh;
    seg(static_cast<const T*>(P.k_full) + at,
        static_cast<const T*>(P.v_full) + at, cb, kv_hi);
  }
}

// Consumer item (r, h, q tile qt) on the tensor cores: bf16, head_dim DH.
template <int DH>
__device__ void consume_mma(const Problem& P, int r, int h, int qt,
                            unsigned char* smem_raw) {
  using Rows = prefill::MmaRows<DH>;
  constexpr int LD = Rows::LD, VEC = DH / 8;
  constexpr int THREADS = prefill::MMA_WARPS * 32;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + R * LD;           // [2][MMA_CK][LD]
  bf16* sV = sK + 2 * MMA_CK * LD;  // [2][MMA_CK][LD]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m = P.m, i0 = qt * R;
  const bf16* q =
      static_cast<const bf16*>(P.q) + ((size_t)r * P.H + h) * m * DH;
  for (int i = tid; i < R * VEC; i += THREADS) {
    const int rr = i / VEC, c = (i % VEC) * 8;
    const bool ok = i0 + rr < m;
    tdt::cp_async16(sQ + rr * LD + c, ok ? q + (size_t)(i0 + rr) * DH + c : q,
                    ok ? 16 : 0);
  }
  tdt::cp_async_commit();

  const int row0 = P.offs[r];
  const int ra = warp * 16 + gid, rb = ra + 8;
  const bool live_a = i0 + ra < m, live_b = i0 + rb < m;
  const int grow_a = row0 + i0 + ra, grow_b = row0 + i0 + rb;
  const int row_hi = row0 + min(i0 + R, m) - 1;
  const float scale_log2 = P.scale * 1.4426950408889634f;
  Rows st;
  st.init();
  bool q_ready = false;
  walk_segments<bf16>(P, r, h, row_hi, [&](const bf16* kseg,
                                            const bf16* vseg, int cb,
                                            int kv_hi) {
    auto load_kv = [&](int stage, int c0) {
      bf16* dk = sK + stage * MMA_CK * LD;
      bf16* dv = sV + stage * MMA_CK * LD;
      for (int i = tid; i < MMA_CK * VEC; i += THREADS) {
        const int c = i / VEC, d = (i % VEC) * 8, j = c0 + c;
        const bool ok = j < kv_hi;
        tdt::cp_async16(dk + c * LD + d, ok ? kseg + (size_t)j * DH + d : kseg,
                        ok ? 16 : 0);
        tdt::cp_async16(dv + c * LD + d, ok ? vseg + (size_t)j * DH + d : vseg,
                        ok ? 16 : 0);
      }
    };
    const int nchunks = (kv_hi + MMA_CK - 1) / MMA_CK;
    load_kv(0, 0);
    tdt::cp_async_commit();
    for (int it = 0; it < nchunks; ++it) {
      const int stg = it & 1;
      if (it + 1 < nchunks) load_kv(stg ^ 1, (it + 1) * MMA_CK);
      tdt::cp_async_commit();
      tdt::cp_async_wait1();  // Q and this chunk have landed
      __syncthreads();
      if (!q_ready) {
        st.load_q(sQ);
        q_ready = true;
      }
      const int c0 = it * MMA_CK;
      st.chunk(sK + stg * MMA_CK * LD, sV + stg * MMA_CK * LD, scale_log2,
               [&](int key, bool row_b) {
                 const int j = c0 + key;
                 if (j >= kv_hi || !(row_b ? live_b : live_a)) return false;
                 return !P.causal || cb + j <= (row_b ? grow_b : grow_a);
               });
      __syncthreads();  // the stage is free for the load two chunks on
    }
  });
  tdt::cp_async_wait_all();  // a tile that saw no keys still loaded Q

  st.finish();
  bf16* o = static_cast<bf16*>(P.out) + ((size_t)r * P.H + h) * m * DH;
  float* lse = P.lse ? P.lse + ((size_t)r * P.H + h) * m : nullptr;
  const float ln2 = 0.6931471805599453f;
  if (live_a) {
    bf16* orow = o + (size_t)(i0 + ra) * DH;
    const float inv = 1.f / st.l_a;
#pragma unroll
    for (int n = 0; n < Rows::NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tig) =
          __floats2bfloat162_rn(st.o[n][0] * inv, st.o[n][1] * inv);
    if (lse && tig == 0)
      lse[i0 + ra] =
          (st.m_a == -INFINITY ? kNegInf : st.m_a * ln2) + logf(st.l_a);
  }
  if (live_b) {
    bf16* orow = o + (size_t)(i0 + rb) * DH;
    const float inv = 1.f / st.l_b;
#pragma unroll
    for (int n = 0; n < Rows::NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tig) =
          __floats2bfloat162_rn(st.o[n][2] * inv, st.o[n][3] * inv);
    if (lse && tig == 0)
      lse[i0 + rb] =
          (st.m_b == -INFINITY ? kNegInf : st.m_b * ln2) + logf(st.l_b);
  }
}

// Consumer item (r, h, q tile qt) on the CUDA cores, f32 math, head_dim up
// to DH.
template <typename T, int DH>
__device__ void consume_simt(const Problem& P, int r, int h, int qt,
                             unsigned char* smem_raw) {
  constexpr int THREADS = prefill::THREADS;
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + R * (DH + 1);
  float* sV = sK + CK * (DH + 1);
  float* sS = sV + CK * DH;
  float* sM = sS + R * (CK + 1);
  float* sL = sM + R;
  float* sC = sL + R;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m = P.m, dh = P.dh, vecs = dh / 8, i0 = qt * R;
  const T* q = static_cast<const T*>(P.q) + ((size_t)r * P.H + h) * m * dh;
  for (int i = tid; i < R * vecs; i += THREADS) {
    const int rr = i / vecs, c = (i % vecs) * 8;
    float buf[8];
    if (i0 + rr < m) {
      tdt::load8(q + (size_t)(i0 + rr) * dh + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) buf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sQ[rr * (DH + 1) + c + e] = buf[e] * P.scale;
  }
  if (tid < R) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  constexpr int NC = DH / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const int row0 = P.offs[r];
  const int row_hi = row0 + min(i0 + R, m) - 1;
  walk_segments<T>(P, r, h, row_hi, [&](const T* kseg, const T* vseg, int cb,
                                        int kv_hi) {
    for (int c0 = 0; c0 < kv_hi; c0 += CK) {
      for (int i = tid; i < CK * vecs; i += THREADS) {
        const int c = i / vecs, d = (i % vecs) * 8, j = c0 + c;
        float kf[8], vf[8];
        if (j < kv_hi) {
          load8_cg(kseg + (size_t)j * dh + d, kf);
          load8_cg(vseg + (size_t)j * dh + d, vf);
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
      prefill::simt_chunk<DH>(
          sQ, sK, sV, sS, sM, sL, sC, acc, dh, [&](int rr, int c) {
            const int j = c0 + c;
            if (j >= kv_hi || i0 + rr >= m) return false;
            return !P.causal || cb + j <= row0 + i0 + rr;
          });
    }
  });

  T* o = static_cast<T*>(P.out) + ((size_t)r * P.H + h) * m * dh;
  float* lse = P.lse ? P.lse + ((size_t)r * P.H + h) * m : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i;
    if (i0 + rr >= m) continue;
    const float den = fmaxf(sL[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + 16 * j;
      if (col < dh)
        o[(size_t)(i0 + rr) * dh + col] = tdt::from_f32<T>(acc[i][j] / den);
    }
    if (lse && tx == 0)
      lse[i0 + rr] = (sM[rr] == -INFINITY ? kNegInf : sM[rr]) + logf(den);
  }
}

// MMA: the tensor-core consumer for bf16 at head_dim DH, else the CUDA-core
// one with head_dim up to DH.
template <typename T, int DH, bool MMA>
__global__ void __launch_bounds__(MMA ? prefill::MMA_WARPS * 32
                                      : prefill::THREADS)
    sp_ag_attn_kernel(Problem P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = P.world, H = P.H;
  const int producers = W * W * H;
  const int total = producers + W * H * P.n_tiles;
  for (;;) {
    const int t = tdt::gemm::take_ticket(P.ticket);
    if (t >= total) {
      leave_ticket(P, t, total);
      return;
    }
    if (t < producers) {
      produce<T>(P, t);
      continue;  // take_ticket starts at a barrier
    }
    // Latest ranks and tiles first.
    const int u = t - producers;
    const int r = W - 1 - u / (H * P.n_tiles);
    const int qt = P.n_tiles - 1 - (u / H) % P.n_tiles, h = u % H;
    if constexpr (MMA)
      consume_mma<DH>(P, r, h, qt, smem_raw);
    else
      consume_simt<T, DH>(P, r, h, qt, smem_raw);
  }
}

template <typename T, int DH, bool MMA>
cudaError_t launch(const Problem& P, cudaStream_t s) {
  constexpr int threads = MMA ? prefill::MMA_WARPS * 32 : prefill::THREADS;
  constexpr int bytes = MMA ? prefill::mma_smem_bytes<DH>()
                            : prefill::smem_floats<DH>() * 4;
  auto kernel = sp_ag_attn_kernel<T, DH, MMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  unsigned blocks = 0;
  const long long work =
      (long long)P.world * P.world * P.H + (long long)P.world * P.H * P.n_tiles;
  if (err == cudaSuccess)
    err = tdt::gemm::persistent_blocks(kernel, threads, bytes, work, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, bytes, s>>>(P);
  return cudaGetLastError();
}

// --- bf16 at head_dim 128: attn_wgmma.cuh's tile ---------------------------

constexpr int kLookahead = 2;  // heads whose pushes go out ahead

struct WgItem {
  bool push;
  int r, h, qt;  // r: the source of a push, the rank of an attend item
};

// The item of ticket t (sp_ag_attn_items in kernels/sp_attention.py): the
// pushes of heads 0 .. la - 1, then for each head h the pushes of head h +
// la (while there is one) and the attend items of head h, ranks and tiles
// latest first.
__device__ __forceinline__ WgItem wg_item_of(int t, int W, int H, int nt) {
  const int la = min(kLookahead, H);
  if (t < la * W) return {true, t % W, t / W, 0};
  const int u = t - la * W, group = W + W * nt, full = (H - la) * group;
  int g, v;
  if (u < full) {
    g = u / group;
    v = u % group;
    if (v < W) return {true, v, g + la, 0};
    v -= W;
  } else {
    g = H - la + (u - full) / (W * nt);
    v = (u - full) % (W * nt);
  }
  return {false, W - 1 - v / nt, g, nt - 1 - v % nt};
}

// Push item (src, h), thread 0: rank src's K and V of head h into every
// rank's k_full / v_full[src], then the world flags (dst, src, h).
__device__ void push_bulk(const Problem& P, int src, int h,
                          const tdt::attn::Smem& sm, uint32_t& cit) {
  const int W = P.world, H = P.H;
  const size_t seg = (size_t)P.m_kv * P.dh;  // elements of one head's keys
  const size_t at = ((size_t)src * H + h) * seg;  // dst 0's slot src
  const size_t stride = (size_t)W * H * seg * sizeof(bf16);
  lang::sleep_ns(P.delay_ns);
  wg::bulk_copy(static_cast<bf16*>(P.k_full) + at, stride, W,
                static_cast<const bf16*>(P.k) + at, seg * sizeof(bf16),
                sm.base, cit);
  wg::bulk_copy(static_cast<bf16*>(P.v_full) + at, stride, W,
                static_cast<const bf16*>(P.v) + at, seg * sizeof(bf16),
                sm.base, cit);
  wg::fence_proxy_async();
  __threadfence();
  for (int d = 0; d < W; ++d)
    lang::notify(P.flags + ((size_t)d * W + src) * H + h, P.epoch);
}

// The chunks of attend item (r, h, qt) in order, for attn_wgmma.cuh's
// Rows::run: rank r's segments own first, each skipped when right of the
// tile's last row, else cut into 128-key chunks up to the tile's causal
// frontier. Chunk j takes ring use u + j.
struct Chunks {
  const Problem& P;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const tdt::attn::Smem& sm;
  int r, h, row_hi;
  uint32_t u;
  int n;               // chunks in all
  int grow_a, grow_b;  // this thread's two rows, global
  int col0;            // the global column of rank r's gathered keys
  // This thread's cursor: chunk k of segment s, keys [c0, c0 + 128).
  int k = -1, s = -1, cb = 0, kv_hi = 0, c0 = 0;

  // Segment seg: its source, first global column and the keys the tile
  // needs (none when right of the tile's last row).
  __device__ __forceinline__ int segment(int seg, int& src, int& col) const {
    src = r + seg < P.world ? r + seg : r + seg - P.world;
    col = col0 + src * P.m_kv;
    return P.causal ? min(P.m_kv, row_hi - col + 1) : P.m_kv;
  }
  // The keys of chunk j (j never decreases) that rows a and b see: below
  // the segment's end, and at or left of the row when causal.
  __device__ __forceinline__ void limits(int j, int (&lim)[2]) {
    while (k < j) {
      if (k >= 0 && c0 + tdt::attn::BKV < kv_hi) {
        c0 += tdt::attn::BKV;
      } else {
        int src;
        do {
          kv_hi = segment(++s, src, cb);
        } while (kv_hi <= 0);
        c0 = 0;
      }
      ++k;
    }
    lim[0] = (P.causal ? min(kv_hi, grow_a - cb + 1) : kv_hi) - c0;
    lim[1] = (P.causal ? min(kv_hi, grow_b - cb + 1) : kv_hi) - c0;
  }

  // One thread, before the tile's first load: the table of the segments
  // the tile reads in shared memory (each one's plane and first chunk, and
  // the chunk count after the last), each one's flag acquired, then the
  // async proxy fenced (TMA then reads rows another block staged). The
  // table is published with the Q barrier's arrival that follows.
  __device__ __forceinline__ void prepare() const {
    int segs = 0, total = 0;
    for (int seg = 0; seg < P.world; ++seg) {
      int src, col;
      const int hi = segment(seg, src, col);
      if (hi <= 0) continue;
      const int plane = (r * P.world + src) * P.H + h;
      wg::wait_flag(P.flags + plane, P.epoch);
      sm.seg_plane[segs] = plane;
      sm.seg_first[segs++] = total;
      total += (hi + tdt::attn::BKV - 1) / tdt::attn::BKV;
    }
    sm.seg_first[segs] = total;
    wg::fence_proxy_async();
  }
  __device__ __forceinline__ int count() const {
    int total = 0;
    for (int seg = 0; seg < P.world; ++seg) {
      int src, col;
      const int hi = segment(seg, src, col);
      if (hi > 0) total += (hi + tdt::attn::BKV - 1) / tdt::attn::BKV;
    }
    return total;
  }
  // Load chunk j into its stage (one thread), its segment from the table.
  __device__ __forceinline__ void load(int j) const {
    int seg = 0;
    while (j >= sm.seg_first[seg + 1]) ++seg;
    tdt::attn::load_kv(sm, tk, tv, (u + j) % tdt::attn::STAGES,
                       sm.seg_plane[seg],
                       (j - sm.seg_first[seg]) * tdt::attn::BKV);
  }
  // The thread that released chunk j's stage last refills it.
  __device__ __forceinline__ void refill(int j) const {
    if (j + tdt::attn::STAGES < n) load(j + tdt::attn::STAGES);
  }
  // A chunk's keys past its segment lie past the plane's rows, which TMA
  // reads as zeros: nothing to clear.
  __device__ __forceinline__ void v_landed(int) const {}
};

// Attend item (r, h, qt): every thread. u counts the ring uses of this
// block's chunks so far, tiles its attend items; both advance the same in
// every thread. Thread 0 acquires the tile's segment flags and loads Q and
// the first STAGES chunks; later chunks are loaded by the thread that
// frees their stage (Rows::run).
__device__ void attend(const Problem& P, const CUtensorMap* tq,
                       const CUtensorMap* tk, const CUtensorMap* tv,
                       const tdt::attn::Smem& sm, int r, int h, int qt,
                       uint32_t& u, uint32_t& tiles) {
  namespace at = tdt::attn;
  const int m = P.m, i0 = qt * at::BQ, row0 = P.offs[r];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp / 4;  // the consumer warpgroup
  const int la = i0 + 64 * w + 16 * (warp % 4) + lane / 4, lb = la + 8;
  Chunks ch{P, tk, tv, sm, r, h, row0 + min(i0 + at::BQ, m) - 1, u, 0,
            row0 + la, row0 + lb, P.offs[P.world + r]};
  ch.n = ch.count();
  if (threadIdx.x == 0) {
    ch.prepare();
    at::load_q(sm, tq, r * P.H + h, i0);
    for (int j = 0; j < at::STAGES && j < ch.n; ++j) ch.load(j);
  }
  at::Rows st;
  st.init();
  wg::mbar_wait(sm.q_bar(), tiles & 1);
  st.run(sm, w, u, ch.n, P.scale * 1.4426950408889634f, ch);
  st.finish();
  bf16* o = static_cast<bf16*>(P.out) + ((size_t)r * P.H + h) * m * at::DH;
  float* lse = P.lse ? P.lse + ((size_t)r * P.H + h) * m : nullptr;
  const float ln2 = 0.6931471805599453f;
  const int tig = lane % 4;
  if (la < m) {
    bf16* orow = o + (size_t)la * at::DH + 2 * tig;
    const float inv = 1.f / st.l_a;
#pragma unroll
    for (int j = 0; j < at::DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(st.o[4 * j] * inv, st.o[4 * j + 1] * inv);
    if (lse && tig == 0)
      lse[la] =
          (st.m_a == -INFINITY ? kNegInf : st.m_a * ln2) + logf(st.l_a);
  }
  if (lb < m) {
    bf16* orow = o + (size_t)lb * at::DH + 2 * tig;
    const float inv = 1.f / st.l_b;
#pragma unroll
    for (int j = 0; j < at::DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(st.o[4 * j + 2] * inv, st.o[4 * j + 3] * inv);
    if (lse && tig == 0)
      lse[lb] =
          (st.m_b == -INFINITY ? kNegInf : st.m_b * ln2) + logf(st.l_b);
  }
  u += ch.n;
  ++tiles;
}

__global__ void __launch_bounds__(tdt::attn::THREADS, 1)
    sp_ag_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            Problem P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tdt::attn::Smem sm(smem_raw);
  sm.init();
  const int W = P.world, H = P.H, nt = P.n_tiles;
  const int total = W * H + W * H * nt;
  uint32_t u = 0, tiles = 0, cit = 0;  // chunks, tiles, copy pieces
  for (;;) {
    const int t = tdt::gemm::take_ticket(P.ticket);
    if (t >= total) {
      leave_ticket(P, t, total);
      return;
    }
    const WgItem it = wg_item_of(t, W, H, nt);
    if (it.push) {
      if (threadIdx.x == 0) push_bulk(P, it.r, it.h, sm, cit);
      continue;  // take_ticket starts at a barrier
    }
    attend(P, &tq, &tk, &tv, sm, it.r, it.h, it.qt, u, tiles);
  }
}

cudaError_t launch_wgmma(Problem P, cudaStream_t s) {
  namespace at = tdt::attn;
  CUtensorMap tq, tk, tv;
  const long long planes = (long long)P.world * P.world * P.H;
  if (!at::encode(&tq, P.q, P.m, (long long)P.world * P.H) ||
      !at::encode(&tk, P.k_full, P.m_kv, planes) ||
      !at::encode(&tv, P.v_full, P.m_kv, planes))
    return cudaErrorInvalidValue;
  P.n_tiles = (P.m + at::BQ - 1) / at::BQ;
  auto kernel = sp_ag_attn_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, at::SMEM_BYTES);
  unsigned blocks = 0;
  const long long work = (long long)P.world * P.H * (1 + P.n_tiles);
  if (err == cudaSuccess)
    err = tdt::gemm::persistent_blocks(kernel, at::THREADS, at::SMEM_BYTES,
                                       work, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, at::THREADS, at::SMEM_BYTES, s>>>(tq, tk, tv, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Problem& P, cudaStream_t s) {
  using tdt::gemm::aligned16;
  if constexpr (std::is_same<T, bf16>::value) {
    if (P.dh == 128 && P.scale > 0.f &&
        P.world <= tdt::attn::MAX_SEGMENTS && aligned16(P.q) &&
        aligned16(P.k_full) &&
        aligned16(P.v_full) && aligned16(P.k) && aligned16(P.v))
      return launch_wgmma(P, s);
    if (P.dh == 128) return launch<T, 128, true>(P, s);
    if (P.dh == 64) return launch<T, 64, true>(P, s);
  }
  if (P.dh <= 64) return launch<T, 64, false>(P, s);
  return launch<T, 128, false>(P, s);
}

}  // namespace

// q (world, H, m, dh), k and v (world, H, m_kv, dh), k_full and v_full
// (world, world, H, m_kv, dh), out (world, H, m, dh), lse (world, H, m) f32
// or null; offs (2, world) int32: each rank's first global row, and the
// global column of its gathered keys' first; flags (world x world x H,
// uint32, raised to epoch); ticket (one int32, 0 on entry and left at 0 by
// the kernel); causal 0/1; dtype 0 f32, 1 bf16; delay_ns holds every
// producer item back (0 in use).
extern "C" int tdt_sp_ag_attn(const void* q, const void* k, const void* v,
                              void* k_full, void* v_full, void* out,
                              void* lse, const void* offs, void* flags,
                              void* ticket, unsigned epoch, long long world,
                              long long H, long long m, long long m_kv,
                              long long dh, int causal, float scale,
                              int dtype, unsigned long long delay_ns,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 1 || world > 4096 || H <= 0 || m <= 0 || m_kv <= 0 ||
      dh <= 0 || dh > 128 || dh % 8 || m > INT32_MAX / 2 ||
      world * m_kv > INT32_MAX / 2)
    return cudaErrorInvalidValue;
  const long long n_tiles = (m + R - 1) / R;
  if (world * H * (world + n_tiles) > INT32_MAX) return cudaErrorInvalidValue;
  Problem P{q, k, v, k_full, v_full, out, static_cast<float*>(lse),
            static_cast<const int*>(offs), static_cast<uint32_t*>(flags),
            static_cast<int*>(ticket), epoch, (int)world, (int)H, (int)m,
            (int)m_kv, (int)dh, (int)n_tiles, causal != 0, scale, delay_ns};
  if (dtype == tdt::kBF16) return dispatch<bf16>(P, s);
  if (dtype == tdt::kF32) return dispatch<float>(P, s);
  return cudaErrorInvalidValue;
}
