// A FlashAttention-3-style attention tile on Hopper's units, bf16 at head
// dim 128: 128 query rows a block, as two consumer warpgroups of 64 rows
// each, K and V streamed by TMA through a ring of mbarrier-guarded stages.
//
//   Q (32 KB) is loaded once a tile by TMA: two boxes of 64 head columns x
//     128 rows with the 128-byte swizzle (rows of 128 bytes, one half of
//     the head each), as wgmma_tile.cuh's A operand.
//   K and V come in chunks of 128 keys (32 KB each) through a ring of
//     STAGES stages. A stage's K and its V are each two such
//     128-byte-swizzled boxes of 128 keys (one key's half head a 128-byte
//     row), K read K-major and V MN-major. Each stage has a full barrier
//     for K and one for V (the loader's expected bytes).
//   S = Q K^T is wgmma m64n128k16 with both operands in shared memory and K
//     K-major (B not transposed), eight k-steps over the head. The
//     streaming softmax runs in f32 on S in registers (the running max and
//     per-thread partial sums in the log2 domain, as flash_prefill.cuh's
//     MmaRows); masks are applied only where a chunk needs one. P is
//     rounded to bf16 in registers, where the accumulator layout of S is
//     already the register-A fragment layout of the next product.
//   O += P V is the register-A (RS) form of wgmma m64n128k16 with V
//     MN-major (the transpose bit set), eight k-steps over the chunk's
//     keys.
//   Inside a warpgroup the products overlap the softmax: chunk k's S is
//     issued, then chunk k - 1's P V, and the exponentials of chunk k run
//     while that P V is on the tensor cores; only the rescale of O and the
//     packing of P wait for it. The two warpgroups run their chunks
//     independently, so one's softmax also overlaps the other's products.
//
// No warp is set aside to load. A 288-thread block (a producer warp beside
// the two warpgroups) gets at most 168 registers a thread from ptxas,
// which spilled the plain loop and leaves no room for the overlap above
// (S, O and P take 160); setmaxnreg would need warpgroup roles that never
// meet again, which a persistent loop of ticketed items does not give.
// Instead each consumer warp releases a stage when it is done with it (one
// count in shared memory), and the last of the eight to release it
// refills it with the chunk STAGES further on: nobody waits for a stage to
// empty. Whatever guards the tile's keys (the caller's flags) is acquired
// once, by the thread that loads Q and the first chunks, which then fences
// the async proxy; every other load of the tile is ordered after that
// through the Q barrier that all threads wait on, so a refill neither
// polls a flag nor fences (either one, on the refilling warp, stalls its
// warpgroup at the next product). A block
// keeps one chunk count and one tile count across its tiles (each
// barrier's phase follows from them), so the ring needs no reset between
// tiles. Kernels that issue wgmma must not call printf (ptxas then
// serialises every wgmma): the waits here trap without printing
// (wgmma_tile.cuh mbar_wait, wait_flag).
#pragma once

#include "wgmma_tile.cuh"

namespace tdt {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int DH = 128;
constexpr int BQ = 128;   // query rows of a tile
constexpr int BKV = 128;  // keys of a chunk
constexpr int STAGES = 3;
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int HALF_BYTES = 128 * 128;    // 128 rows of 128 bytes
constexpr int Q_BYTES = 2 * HALF_BYTES;  // 32 KB
constexpr int KV_BYTES = BKV * DH * 2;   // 32 KB
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int TILE_BYTES = Q_BYTES + STAGES * STAGE_BYTES;
constexpr int BARS = 1 + 2 * STAGES;  // Q, then full K, full V
// The caller's table of a tile's segments holds at most MAX_SEGMENTS,
// each one's plane and first chunk.
constexpr int MAX_SEGMENTS = 64;
// Dynamic shared memory: 1 KB to align to the swizzle atom, Q and the
// ring, wgmma_tile.cuh's barriers (its bulk copies reuse the ring), ours,
// a release count a stage and the segment table.
constexpr int SMEM_BYTES = 1024 + TILE_BYTES +
                           8 * (wg::MAX_STAGES + wg::COPY_SLOTS + BARS) +
                           4 * STAGES + 8 * (MAX_SEGMENTS + 1);
static_assert(TILE_BYTES >= wg::COPY_SLOTS * wg::PIECE,
              "the bulk copies' slots live in the tile's memory");

// The block's shared memory: wgmma_tile.cuh's (its ring is Q and the
// stages; its copy barriers serve wg::bulk_copy), the tile's barriers and
// release counts, and the segment table.
struct Smem {
  wg::Smem base;
  uint64_t* bars;
  int* released;  // STAGES: warp releases of each stage so far
  int* seg_plane;  // MAX_SEGMENTS: the caller's segment table
  int* seg_first;  // MAX_SEGMENTS + 1

  __device__ __forceinline__ explicit Smem(unsigned char* raw)
      : base(raw, TILE_BYTES),
        bars(base.copy_bar + wg::COPY_SLOTS),
        released(reinterpret_cast<int*>(bars + BARS)),
        seg_plane(released + STAGES),
        seg_first(seg_plane + MAX_SEGMENTS) {}
  __device__ __forceinline__ unsigned char* q() const { return base.ring; }
  __device__ __forceinline__ unsigned char* k(int s) const {
    return base.ring + Q_BYTES + s * STAGE_BYTES;
  }
  __device__ __forceinline__ unsigned char* v(int s) const {
    return k(s) + KV_BYTES;
  }
  __device__ __forceinline__ uint64_t* q_bar() const { return bars; }
  __device__ __forceinline__ uint64_t* full_k(int s) const {
    return bars + 1 + s;
  }
  __device__ __forceinline__ uint64_t* full_v(int s) const {
    return bars + 1 + STAGES + s;
  }
  // Every thread, once, at the start of the kernel.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < wg::MAX_STAGES + wg::COPY_SLOTS; ++i)
        wg::mbar_init(base.stage_bar + i, 1);
      for (int i = 0; i < BARS; ++i) wg::mbar_init(bars + i, 1);
      for (int s = 0; s < STAGES; ++s) released[s] = 0;
      wg::fence_barrier_init();
    }
    __syncthreads();
  }
};

#define TDT_ATTN_D64(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TDT_ATTN_R64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = (acc ? d : 0) + A (64 x 16, shared, K-major) @ B (16
// x 128, shared, K-major: the keys' rows of K).
__device__ __forceinline__ void mma_ss_kmajor(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TDT_ATTN_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TDT_ATTN_D64(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128, f32) += A (64 x 16, this thread's four registers of bf16
// pairs) @ B (16 x 128, shared, MN-major: the keys' rows of V).
__device__ __forceinline__ void mma_rs_mnmajor(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TDT_ATTN_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TDT_ATTN_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TDT_ATTN_D64
#undef TDT_ATTN_R64

// Descriptors. Q for warpgroup w and k-step kk (head columns 16 kk ..):
// half kk / 4, 32 bytes a step inside the 128-byte swizzle atom; K the
// same for all 128 keys; V (MN-major) for k-step kk (keys 16 kk ..): 16
// key rows of 128 bytes a step, 1 KB from one group of 8 keys to the next
// and 16 KB from one half of the head to the other.
__device__ __forceinline__ uint64_t q_desc(const Smem& sm, int w, int kk) {
  return wg::make_desc(
      sm.q() + (kk / 4) * HALF_BYTES + w * 64 * 128 + (kk % 4) * 32, 16, 1024,
      1);
}
__device__ __forceinline__ uint64_t k_desc(const Smem& sm, int s, int kk) {
  return wg::make_desc(sm.k(s) + (kk / 4) * HALF_BYTES + (kk % 4) * 32, 16,
                       1024, 1);
}
__device__ __forceinline__ uint64_t v_desc(const Smem& sm, int s, int kk) {
  return wg::make_desc(sm.v(s) + kk * 16 * 128, HALF_BYTES, 1024, 1);
}

// The loads, each issued by one thread. Q rows [i0, i0 + 128) of plane
// q_plane; the chunk of keys [c0, c0 + 128) of plane kv_plane into stage
// s. TMA zero-fills rows past a plane, and counts the whole box.
__device__ __forceinline__ void load_q(const Smem& sm, const CUtensorMap* tq,
                                       int q_plane, int i0) {
  wg::mbar_expect_tx(sm.q_bar(), Q_BYTES);
  wg::tma_load_3d(sm.q(), tq, sm.q_bar(), 0, i0, q_plane);
  wg::tma_load_3d(sm.q() + HALF_BYTES, tq, sm.q_bar(), 64, i0, q_plane);
}
__device__ __forceinline__ void load_kv(const Smem& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int s,
                                        int kv_plane, int c0) {
  wg::mbar_expect_tx(sm.full_k(s), KV_BYTES);
  wg::tma_load_3d(sm.k(s), tk, sm.full_k(s), 0, c0, kv_plane);
  wg::tma_load_3d(sm.k(s) + HALF_BYTES, tk, sm.full_k(s), 64, c0, kv_plane);
  wg::mbar_expect_tx(sm.full_v(s), KV_BYTES);
  wg::tma_load_3d(sm.v(s), tv, sm.full_v(s), 0, c0, kv_plane);
  wg::tma_load_3d(sm.v(s) + HALF_BYTES, tv, sm.full_v(s), 64, c0, kv_plane);
}

// A warp's release of the stage of chunk use u, after its products on it
// are done. Returns true to the one thread whose release is the stage's
// last of the eight for this use: it may refill the stage.
__device__ __forceinline__ bool release(const Smem& sm, uint32_t u) {
  __syncwarp();
  if (threadIdx.x % 32) return false;
  return atomicAdd(sm.released + u % STAGES, 1) % 8 == 7;
}

// The two warpgroups take turns to issue their products (named barriers 1
// and 2, the 256 consumer threads): warpgroup w waits for its turn, issues,
// and hands the turn to the other, so that one's softmax runs while the
// other's products hold the tensor cores. Warpgroup 1 hands warpgroup 0
// the first turn of a tile, and warpgroup 0 takes back the extra hand-over
// after its last (each warpgroup takes the same number of turns).
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
}

// 2^x on the special-function unit (flushing denormals to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One consumer thread's rows of the tile: rows a = 16 warp + lane / 4 and
// b = a + 8 of its warpgroup's 64, in the wgmma accumulator layout (o[4j
// + e]: row a, column 8 j + 2 (lane % 4) + e; o[4j + 2 + e]: row b).
struct Rows {
  float m_a, m_b, l_a, l_b;
  float o[64];

  __device__ __forceinline__ void init() {
    m_a = m_b = -INFINITY;
    l_a = l_b = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
  }

  // Wait until the K (V) of the chunk in ring use u has landed.
  __device__ __forceinline__ static void wait_k(const Smem& sm, uint32_t u) {
    wg::mbar_wait(sm.full_k(u % STAGES), (u / STAGES) & 1);
  }
  __device__ __forceinline__ static void wait_v(const Smem& sm, uint32_t u) {
    wg::mbar_wait(sm.full_v(u % STAGES), (u / STAGES) & 1);
  }

  // Issue S = Q K^T of the chunk in ring use u (its K landed).
  __device__ __forceinline__ static void issue_s(const Smem& sm, int w,
                                                 uint32_t u, float (&sc)[64]) {
    const int s = u % STAGES;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      mma_ss_kmajor(sc, q_desc(sm, w, kk), k_desc(sm, s, kk), kk > 0);
    wg::wgmma_commit();
  }

  // Issue O += P V of the chunk in ring use u (its V landed).
  __device__ __forceinline__ void issue_pv(const Smem& sm, uint32_t u,
                                           const uint32_t (&p)[BKV / 16][4]) {
    const int s = u % STAGES;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      mma_rs_mnmajor(o, p[kk], v_desc(sm, s, kk));
    wg::wgmma_commit();
  }

  // The softmax of S, in place: keys at or past lim[0] (row a) / lim[1]
  // (row b) of the chunk set to -inf when MASKED, the running max (of the
  // raw scores, then scaled into the log2 domain: scale_log2 must be
  // positive) and sum updated, and S replaced by P = 2^(S scale_log2 -
  // max) in f32, one fma an element. Returns the rows' corrections of O in
  // corr. Touches neither O nor P, and has no branch: it runs while a
  // product is in flight, and ptxas serialises every wgmma of a kernel
  // whose in-flight window holds a divergent path (the caller picks
  // MASKED by a warp-uniform vote). Maxima and sums run as four
  // independent chains a row; a row whose max is still -inf subtracts 0
  // instead, so a fully masked row gives P = 0 and no NaN.
  template <bool MASKED>
  __device__ __forceinline__ void softmax(float (&sc)[64], float scale_log2,
                                          const int (&lim)[2],
                                          float (&corr)[2]) {
    const int tig = threadIdx.x % 4;
    if constexpr (MASKED) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * tig + e;
          if (key >= lim[0]) sc[4 * j + e] = -INFINITY;
          if (key >= lim[1]) sc[4 * j + 2 + e] = -INFINITY;
        }
    }
    float ma[4], mb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ma[c] = fmaxf(sc[4 * c], sc[4 * c + 1]);
      mb[c] = fmaxf(sc[4 * c + 2], sc[4 * c + 3]);
    }
#pragma unroll
    for (int j = 4; j < BKV / 8; ++j) {
      ma[j % 4] = fmaxf(ma[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mb[j % 4] = fmaxf(mb[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float mx_a = fmaxf(fmaxf(ma[0], ma[1]), fmaxf(ma[2], ma[3]));
    float mx_b = fmaxf(fmaxf(mb[0], mb[1]), fmaxf(mb[2], mb[3]));
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    // The max of the raw scores, scaled (scale_log2 > 0: the caller's).
    const float mn_a = fmaxf(m_a, mx_a * scale_log2);
    const float mn_b = fmaxf(m_b, mx_b * scale_log2);
    const float sa = mn_a == -INFINITY ? 0.f : mn_a;
    const float sb = mn_b == -INFINITY ? 0.f : mn_b;
    corr[0] = ex2(m_a - sa);  // 0 while the row has seen no key
    corr[1] = ex2(m_b - sb);
    m_a = mn_a;
    m_b = mn_b;
    float ua[4] = {0.f, 0.f, 0.f, 0.f}, ub[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -sa));
        sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -sb));
        ua[j % 4] += sc[4 * j + e];
        ub[j % 4] += sc[4 * j + 2 + e];
      }
    }
    // Partial row sums stay per thread (the quad shares corr); finish()
    // sums them across the quad once.
    l_a = l_a * corr[0] + ((ua[0] + ua[1]) + (ua[2] + ua[3]));
    l_b = l_b * corr[1] + ((ub[0] + ub[1]) + (ub[2] + ub[3]));
  }

  // O *= corr, and P (f32 in sc) rounded to bf16 into the A fragments:
  // key tiles 2 kk and 2 kk + 1 make k-step kk's.
  __device__ __forceinline__ void rescale_pack(const float (&sc)[64],
                                               const float (&corr)[2],
                                               uint32_t (&p)[BKV / 16][4]) {
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      p[j / 2][2 * (j % 2)] = tdt::pack_bf16x2(sc[4 * j], sc[4 * j + 1]);
      p[j / 2][2 * (j % 2) + 1] =
          tdt::pack_bf16x2(sc[4 * j + 2], sc[4 * j + 3]);
    }
  }

  // Warpgroup w's n chunks, uses u .. u + n - 1 of the ring: chunk k's S
  // issued, then chunk k - 1's P V, chunk k's softmax while that P V runs,
  // then O's rescale and P's packing. tile.limits(k, lim) gives the keys of
  // chunk k this thread's rows see (BKV or more: all), tile.v_landed(k) is
  // called by every thread of both warpgroups once chunk k's V has landed
  // and before any product reads it, and tile.refill(k) by the thread that
  // releases chunk k's stage last. Every wait and every branch comes while
  // no product is in flight.
  template <typename Tile>
  __device__ __forceinline__ void run(const Smem& sm, int w, uint32_t u,
                                      int n, float scale_log2, Tile& tile) {
    if (n <= 0) return;
    float sc[64], corr[2];
    uint32_t p[BKV / 16][4];
    int lim[2];
    // Whether a row of this warp sees fewer than all keys of chunk k.
    auto masked = [&](int k) {
      tile.limits(k, lim);
      return __any_sync(0xffffffffu, min(lim[0], lim[1]) < BKV);
    };
    if (w == 1) turn_pass(w);
    bool mk = masked(0);
    wait_k(sm, u);
    turn_wait(w);
    wg::wgmma_fence();
    issue_s(sm, w, u, sc);
    turn_pass(w);
    wg::wgmma_wait<0>();
    if (mk)
      softmax<true>(sc, scale_log2, lim, corr);
    else
      softmax<false>(sc, scale_log2, lim, corr);
    rescale_pack(sc, corr, p);
    for (int k = 1; k < n; ++k) {
      mk = masked(k);
      wait_k(sm, u + k);
      wait_v(sm, u + k - 1);
      tile.v_landed(k - 1);
      turn_wait(w);
      wg::wgmma_fence();  // sc, o and p were written since the last wgmma
      issue_s(sm, w, u + k, sc);
      issue_pv(sm, u + k - 1, p);
      turn_pass(w);
      wg::wgmma_wait<1>();  // S of chunk k is done, P V of k - 1 may run
      if (mk)
        softmax<true>(sc, scale_log2, lim, corr);
      else
        softmax<false>(sc, scale_log2, lim, corr);
      wg::wgmma_wait<0>();
      if (release(sm, u + k - 1)) tile.refill(k - 1);
      rescale_pack(sc, corr, p);
    }
    wait_v(sm, u + n - 1);
    tile.v_landed(n - 1);
    turn_wait(w);
    wg::wgmma_fence();
    issue_pv(sm, u + n - 1, p);
    turn_pass(w);
    wg::wgmma_wait<0>();
    if (release(sm, u + n - 1)) tile.refill(n - 1);
    if (w == 0) turn_wait(w);
  }

  // Sum each row's partial sums over its quad (once, after the last
  // chunk); the rows' sums, at least 1e-30.
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
    }
    l_a = fmaxf(l_a, 1e-30f);
    l_b = fmaxf(l_b, 1e-30f);
  }
};

// Host: the map of a tile operand (Q, K or V), bf16 planes of (rows, 128)
// with rows of 256 bytes, in boxes of 64 columns x 128 rows with the
// 128-byte swizzle.
inline bool encode(CUtensorMap* map, const void* base, long long rows,
                   long long planes) {
  return wg::encode_3d(map, base, DH, rows, planes, DH * 2, rows * DH * 2,
                       64, 128, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace attn
}  // namespace tdt
