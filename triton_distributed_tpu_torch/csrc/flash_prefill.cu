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
//   K/V rows at or past kv_len[b] are never used: they may hold NaN.
//
// What bounds it on the H100: at the slice's prefill (B 4, L 2048, Hq 16,
//   dh 128) the causal half of QK^T and PV is ~69 GFLOP per layer against
//   ~100 MB of q, k, v and out, ~680 operations per byte: the tensor cores'
//   rate bounds it.
//
// What this design does about it: bf16 q and K/V at head_dim 128 that TMA
//   can read (16-byte aligned bases, every stride a whole number of 16-byte
//   units: the wrapper's tma), given a positive scale, run on
//   attn_wgmma.cuh's tile: 128 query rows a block as two warpgroups, Q and
//   128-key chunks of K and V loaded by TMA through a three-stage ring, S =
//   Q K^T and O += P V on wgmma, the softmax on S in registers while the
//   previous chunk's P V runs.
//   - A tile's 128 rows are the (position, GQA head) pairs of 128 / g
//     consecutive positions of one (batch row, kv head), position-major, so
//     the g heads share every K/V chunk. Q's map is 4-D (dh, Hq, L, B) with
//     a box of {64, g, 128 / g, 1}: its rows land in that order, as the
//     swizzled 128-row A operand expects; rows past L read as zeros. K's and
//     V's maps are 4-D over the cache's own strides, (dh, then seq, head
//     and batch in the order of their strides), one 128-key box a half.
//   - A thread's row at position p sees keys below min(offset + p + 1,
//     kv_len) (none for a padding row): the chunk's mask is that one bound,
//     applied as a select of -inf, never an add, so a NaN score of a masked
//     key is dropped. The tile walks chunks up to its last live row's
//     frontier.
//   - The NaN tail: a TMA box loads whole 128-key chunks, so the chunk that
//     straddles kv_len brings the cache's rows past it into shared memory,
//     and a masked key's P of 0 times a NaN in V is NaN. Once that chunk's
//     V has landed (attn_wgmma.cuh's v_landed), the block zeroes those V
//     rows in shared memory and fences the async proxy before either
//     warpgroup's P V reads them; K's rows there are masked by the select.
//   - One persistent grid (gemm_tile.cuh persistent_blocks) takes tiles by
//     an atomic ticket in a persistent buffer (kernels/_signal.py arrivals)
//     that the block taking the last ticket leaves at 0; the host caches
//     the kernel's shared-memory attribute and block count, so a call with
//     integer offsets is one device operation. Tiles go (batch row, kv
//     head) by (batch row, kv head), each one's latest (heaviest under the
//     causal mask) first, so its K and V come from device memory about once
//     and from L2 for the rest (sp_ag_attn.cu's order;
//     flash_prefill_wgmma_items in kernels/sp_attention.py mirrors it).
//   Everything else keeps flash_prefill.cuh's kernels, chosen by the same
//   static dispatch as before: bf16 at head_dim 64, and at 128 where TMA
//   cannot read an operand, on the mma.sync tile (K/V rows past kv_len never
//   loaded: cp.async of 0 bytes); fp32 and other head dims on the CUDA
//   cores.
#include <utility>

#include "attn_wgmma.cuh"
#include "flash_prefill.cuh"
#include "gemm_tile.cuh"

namespace {

namespace at = tdt::attn;
namespace wg = tdt::wg;
using bf16 = __nv_bfloat16;

// One call on the wgmma tile.
struct WgProblem {
  bf16* o;
  const int* rows;  // (3, B) int32: offset, kv_len, q_len; or null
  int* ticket;
  int offset0, kv_len0, q_len0;
  int B, L, Hq, Hkv, S, g, n_tiles, total;
  int kv_dim[3];  // the K/V maps' dimension of the key, the head, the batch
  float scale_log2;
};

// The K/V map coordinate of dimension d (1 .. 3) for (key, head, batch).
__device__ __forceinline__ int kv_coord(const WgProblem& P, int d, int key,
                                        int h, int b) {
  return P.kv_dim[0] == d ? key : (P.kv_dim[1] == d ? h : b);
}

// One tile's chunks for attn_wgmma.cuh's Rows::run: chunk j holds keys
// [128 j, 128 j + 128) of (row b, kv head h) and takes ring use u + j.
struct PrefillTile {
  const WgProblem& P;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const at::Smem& sm;
  int b, h, n, kv_len;
  uint32_t u;
  int key_a, key_b;  // keys this thread's two rows see: [0, key)

  __device__ __forceinline__ void limits(int j, int (&lim)[2]) const {
    lim[0] = key_a - j * at::BKV;
    lim[1] = key_b - j * at::BKV;
  }
  // Chunk j into its stage (one thread).
  __device__ __forceinline__ void load(int j) const {
    const int s = (u + j) % at::STAGES, key = j * at::BKV;
    const int c1 = kv_coord(P, 1, key, h, b), c2 = kv_coord(P, 2, key, h, b),
              c3 = kv_coord(P, 3, key, h, b);
    wg::mbar_expect_tx(sm.full_k(s), at::KV_BYTES);
    wg::tma_load_4d(sm.k(s), tk, sm.full_k(s), 0, c1, c2, c3);
    wg::tma_load_4d(sm.k(s) + at::HALF_BYTES, tk, sm.full_k(s), 64, c1, c2,
                    c3);
    wg::mbar_expect_tx(sm.full_v(s), at::KV_BYTES);
    wg::tma_load_4d(sm.v(s), tv, sm.full_v(s), 0, c1, c2, c3);
    wg::tma_load_4d(sm.v(s) + at::HALF_BYTES, tv, sm.full_v(s), 64, c1, c2,
                    c3);
  }
  // The thread that released chunk j's stage last refills it.
  __device__ __forceinline__ void refill(int j) const {
    if (j + at::STAGES < n) load(j + at::STAGES);
  }
  // Every thread, once chunk j's V has landed: in the chunk that straddles
  // kv_len, the V rows at or past it (the cache's, possibly NaN) become
  // zeros before any product reads them. Each half holds a key's 64 head
  // columns in one 128-byte row, so a whole row is zeroed whatever its
  // swizzle. The block meets at named barrier 3 (both warpgroups' 256
  // threads; 1 and 2 are attn_wgmma.cuh's turns).
  __device__ __forceinline__ void v_landed(int j) const {
    const int z = kv_len - j * at::BKV;  // > 0: chunk j < n
    if (z >= at::BKV) return;
    unsigned char* v = sm.v((u + j) % at::STAGES);
    const int rows = at::BKV - z, vecs = rows * 8;  // 16-byte units a half
    for (int i = threadIdx.x; i < 2 * vecs; i += at::THREADS)
      *reinterpret_cast<uint4*>(v + (i / vecs) * at::HALF_BYTES +
                                (z + (i % vecs) / 8) * 128 +
                                (i % 8) * 16) = make_uint4(0, 0, 0, 0);
    wg::fence_proxy_async();
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
  }
};

// Tile qt of (row b, kv head h): every thread. u counts the ring uses of
// this block's chunks so far, tiles its Q loads; both advance the same in
// every thread. Thread 0 loads Q and the first STAGES chunks; later chunks
// are loaded by the thread that frees their stage (Rows::run). A tile that
// sees no key loads nothing and stores zeros.
__device__ void attend(const WgProblem& P, const CUtensorMap* tq,
                       const CUtensorMap* tk, const CUtensorMap* tv,
                       const at::Smem& sm, int b, int h, int qt, uint32_t& u,
                       uint32_t& tiles) {
  const int g = P.g, ppt = at::BQ / g, p0 = qt * ppt;
  const int offset = P.rows ? P.rows[b] : P.offset0;
  const int kv_len = min(P.rows ? P.rows[P.B + b] : P.kv_len0, P.S);
  const int q_len = min(P.rows ? P.rows[2 * P.B + b] : P.q_len0, P.L);
  const int q_hi = min(p0 + ppt, q_len);
  const int kv_hi = q_hi > p0 ? min(kv_len, offset + q_hi) : 0;
  const int n = kv_hi > 0 ? (kv_hi + at::BKV - 1) / at::BKV : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp / 4;  // the consumer warpgroup
  const int ra = 64 * w + 16 * (warp % 4) + lane / 4, rb = ra + 8;
  const int pa = p0 + ra / g, pb = p0 + rb / g;
  auto keys = [&](int p) {
    return p < q_hi ? max(0, min(offset + p + 1, kv_len)) : 0;
  };
  const PrefillTile tile{P, tk, tv, sm, b, h, n, kv_len, u, keys(pa),
                         keys(pb)};
  at::Rows st;
  st.init();
  if (n > 0) {
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(sm.q_bar(), at::Q_BYTES);
      wg::tma_load_4d(sm.q(), tq, sm.q_bar(), 0, h * g, p0, b);
      wg::tma_load_4d(sm.q() + at::HALF_BYTES, tq, sm.q_bar(), 64, h * g, p0,
                      b);
      for (int j = 0; j < at::STAGES && j < n; ++j) tile.load(j);
    }
    wg::mbar_wait(sm.q_bar(), tiles & 1);
    st.run(sm, w, u, n, P.scale_log2, tile);
    ++tiles;
  }
  st.finish();  // a row that saw no key: O 0, l 1e-30, so it stores zeros
  const int tig = lane % 4;
  auto store = [&](int r, int p, bool row_b, float l) {
    if (p >= P.L) return;
    bf16* orow = P.o + (((size_t)b * P.L + p) * P.Hq + (size_t)h * g + r % g) *
                           at::DH +
                 2 * tig;
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < at::DH / 8; ++j) {  // row b: o[4 j + 2 + e]
      const float x0 = row_b ? st.o[4 * j + 2] : st.o[4 * j];
      const float x1 = row_b ? st.o[4 * j + 3] : st.o[4 * j + 1];
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(x0 * inv, x1 * inv);
    }
  };
  store(ra, pa, false, st.l_a);
  store(rb, pb, true, st.l_b);
  u += n;
}

__global__ void __launch_bounds__(at::THREADS, 1)
    flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               WgProblem P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const at::Smem sm(smem_raw);
  sm.init();
  uint32_t u = 0, tiles = 0;  // ring uses, Q loads
  for (;;) {
    const int t = tdt::gemm::take_ticket(P.ticket);
    if (t >= P.total) {
      // Every block takes one ticket past the work: the last leaves it 0.
      if (threadIdx.x == 0 && t == P.total + (int)gridDim.x - 1)
        *P.ticket = 0;
      return;
    }
    const int grp = t / P.n_tiles, qt = P.n_tiles - 1 - t % P.n_tiles;
    attend(P, &tq, &tk, &tv, sm, grp / P.Hkv, grp % P.Hkv, qt, u, tiles);
  }
}

// The wgmma kernel over bf16 q (B, L, Hq, 128) and a cache of (batch, seq,
// head) strides sb, ss, sh (elements): cudaErrorInvalidValue when a base is
// misaligned or TMA refuses a map (the wrapper's tma said it would not).
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, const int* rows, int offset0, int kv_len0,
                         int q_len0, int B, int L, int Hq, int Hkv, int S,
                         long long sb, long long ss, long long sh,
                         float scale, void* ticket, cudaStream_t s) {
  using tdt::gemm::aligned16;
  const int g = Hq / Hkv;
  if (at::BQ % g || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !ticket)
    return cudaErrorInvalidValue;
  WgProblem P{static_cast<bf16*>(o), rows, static_cast<int*>(ticket),
              offset0, kv_len0, q_len0, B, L, Hq, Hkv, S, g, 0, 0, {0, 0, 0},
              scale * 1.4426950408889634f};
  const long long n_tiles = (L + at::BQ / g - 1) / (at::BQ / g);
  if ((long long)B * Hkv * n_tiles > INT32_MAX) return cudaErrorInvalidValue;
  P.n_tiles = (int)n_tiles;
  P.total = (int)(B * Hkv * n_tiles);
  // K and V: head_dim, then (seq, head, batch) in the order of their
  // strides, one 128-key box.
  const long long size[3] = {S, Hkv, B}, stride[3] = {ss, sh, sb};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j)
      std::swap(order[j], order[j - 1]);
  uint64_t kv_dims[4] = {at::DH, 0, 0, 0}, kv_strides[3];
  uint32_t kv_box[4] = {64, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    kv_dims[i + 1] = (uint64_t)size[order[i]];
    kv_strides[i] = (uint64_t)stride[order[i]] * 2;
    P.kv_dim[order[i]] = i + 1;
    if (order[i] == 0) kv_box[i + 1] = at::BKV;
  }
  const uint64_t q_dims[4] = {at::DH, (uint64_t)Hq, (uint64_t)L,
                              (uint64_t)B};
  const uint64_t q_strides[3] = {(uint64_t)at::DH * 2,
                                 (uint64_t)Hq * at::DH * 2,
                                 (uint64_t)L * Hq * at::DH * 2};
  const uint32_t q_box[4] = {64, (uint32_t)g, (uint32_t)(at::BQ / g), 1};
  CUtensorMap tq, tk, tv;
  if (!wg::encode_4d(&tq, q, q_dims, q_strides, q_box,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg::encode_4d(&tk, k, kv_dims, kv_strides, kv_box,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg::encode_4d(&tv, v, kv_dims, kv_strides, kv_box,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kernel = flash_prefill_wgmma_kernel;
  cudaError_t err = tdt::gemm::allow_smem(
      reinterpret_cast<const void*>(kernel), at::SMEM_BYTES);
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = tdt::gemm::persistent_blocks(kernel, at::THREADS, at::SMEM_BYTES,
                                       P.total, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, at::THREADS, at::SMEM_BYTES, s>>>(tq, tk, tv, P);
  return cudaGetLastError();
}

}  // namespace

// rows: (3, B) int32 (offset, kv_len, q_len) or null for the ints; tma 1
// when TMA can read q, k and v (bf16, 16-byte aligned bases, every stride a
// multiple of 8 elements: the wgmma tile at head_dim 128), else 0; ticket:
// one int32, 0 on entry and left at 0 by the wgmma kernel (unused by the
// others).
extern "C" int tdt_flash_prefill(const void* q, const void* k, const void* v,
                                 void* o, const void* rows, int offset0,
                                 int kv_len0, int q_len0, long long B,
                                 long long L, long long Hq, long long Hkv,
                                 long long S, long long dh, long long sb,
                                 long long ss, long long sh, float scale,
                                 int dtype, int tma, void* ticket,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // g must divide the 64-row tile; dh a multiple of 8 up to 128.
  if (B <= 0 || L <= 0 || Hkv <= 0 || Hq % Hkv ||
      prefill::R % (Hq / Hkv) || dh <= 0 || dh > 128 || dh % 8 ||
      B > 65535 || Hkv > 65535 || L > INT32_MAX || S > INT32_MAX)
    return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(rows);
  if (dtype == tdt::kBF16) {
    using T = __nv_bfloat16;
    if (tma && dh == at::DH && scale > 0.f)
      return launch_wgmma(q, k, v, o, r, offset0, kv_len0, q_len0, (int)B,
                          (int)L, (int)Hq, (int)Hkv, (int)S, sb, ss, sh,
                          scale, ticket, s);
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
