// One-chip GEMM-RS loopback: every row segment's partial product A[dst] @ B
// is computed; the remote segments 1..S-1 push each finished tile, cast to
// the output dtype, into staging[dst - 1] and raise that tile's flag; the
// own segment 0 folds them per tile in a fixed order. A (S m, K), B (K, N),
// out (m, N) = A[0] @ B + sum over dst of bf16(A[dst] @ B), bf16 in and out.
//
// Replaces: triton_distributed_tpu/kernels/gemm_reduce_scatter.py:270
//   _gemm_rs_loopback_kernel (via gemm_rs_loopback :330).
//
// What bounds it on the H100: the operations of all S partial products
//   (2 S m K N, the full matmul's), 989 TFLOP/s dense bf16. The staging
//   adds a write and a read of (S - 1) m N bf16 elements (2 x 29 MB at the
//   Qwen3-32B TP=8 down-projection shape, ~0.018 ms of HBM time).
//
// What this design does about it: the TPU kernel's push-as-computed tiles
//   and fixed-order fold stay; its parity send tiles and their reclaim
//   waits answer VMEM scarcity and are gone (a tile is stored straight
//   from its accumulators). The owner's tiles wait on tiles that other
//   blocks of this same kernel produce, and block dispatch order is not
//   promised, so the grid is persistent and no larger than the card holds
//   at once, and work is handed out by an atomic ticket: producer tiles
//   (tickets 0 .. (S-1) T - 1) first, owner tiles last. A block takes a
//   ticket only while it runs, so every producer tile an owner waits on
//   is held by a running block that never waits: no deadlock, whatever
//   the dispatch order. Each tile runs gemm_tile.cuh's mma.sync main loop;
//   a producer stores its bf16 tile, meets its block at a barrier, and
//   thread 0 raises the flag with a release store (language.cuh); an owner
//   keeps its own partial in f32 registers and, for src = 0 .. S-2 in
//   order, waits on staging[src]'s tile flag, meets the block, and adds
//   the staged bf16 partial (loaded through L2 only), then casts once.
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

using tdt::gemm::bf16;

template <bool VEC>
__global__ void __launch_bounds__(tdt::gemm::THREADS)
    gemm_rs_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                   bf16* __restrict__ out, bf16* staging, uint32_t* flags,
                   int* ticket, uint32_t epoch, int segments, int m, int N,
                   int K, int tiles_m, int tiles_n) {
  using namespace tdt::gemm;
  namespace lang = tdt::lang;
  extern __shared__ __align__(16) unsigned char smem[];
  const int per_seg = tiles_m * tiles_n;
  const int remote = (segments - 1) * per_seg;
  const int total = segments * per_seg;
  for (;;) {
    const int t = take_ticket(ticket);
    if (t >= total) return;
    const bool own = t >= remote;
    const int dst = own ? 0 : 1 + t / per_seg;
    const int r = own ? t - remote : t % per_seg;  // tile within a segment
    const int m0 = (r / tiles_n) * BM, n0 = (r % tiles_n) * BN;
    Acc acc;
    bf16_mainloop<VEC>(A + (size_t)dst * m * K, K, B, N, m, N, K, m0, n0,
                       smem, acc);
    if (!own) {
      bf16* S = staging + (size_t)(dst - 1) * m * N;
      for_each_pair(acc, m0, n0, [&](int gr, int gc, float x0, float x1) {
        if (gr < m) store_pair<VEC>(S + (size_t)gr * N, gc, N, x0, x1);
      });
      __syncthreads();  // every thread's stores precede the release
      if (threadIdx.x == 0) {
        __threadfence();
        lang::notify(flags + (size_t)(dst - 1) * per_seg + r, epoch);
      }
      continue;
    }
    for (int src = 0; src < segments - 1; ++src) {
      if (threadIdx.x == 0)
        lang::wait(flags + (size_t)src * per_seg + r, epoch);
      __syncthreads();
      const bf16* S = staging + (size_t)src * m * N;
      for_each_pair(acc, m0, n0, [&](int gr, int gc, float& x0, float& x1) {
        if (gr >= m) return;
        const bf16* p = S + (size_t)gr * N + gc;
        if (VEC) {  // N % 8 == 0: the pair is inside the row or past it
          if (gc < N) {
            const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&u));
            x0 += f.x;
            x1 += f.y;
          }
        } else {
          if (gc < N) x0 += __bfloat162float(__ldcg(p));
          if (gc + 1 < N) x1 += __bfloat162float(__ldcg(p + 1));
        }
      });
    }
    for_each_pair(acc, m0, n0, [&](int gr, int gc, float x0, float x1) {
      if (gr < m) store_pair<VEC>(out + (size_t)gr * N, gc, N, x0, x1);
    });
  }
}

}  // namespace

// a (segments m, K), b (K, N), out (m, N), staging (segments - 1, m, N),
// flags ((segments - 1) * tiles, uint32, raised to epoch), ticket (one
// int32 of scratch, zeroed here on the stream).
extern "C" int tdt_gemm_rs_loopback(const void* a, const void* b, void* out,
                                    void* staging, void* flags, void* ticket,
                                    unsigned epoch, long long segments,
                                    long long m, long long N, long long K,
                                    void* stream) {
  using namespace tdt::gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (segments < 1 || m <= 0 || N <= 0 || K < 0 || segments * m > INT32_MAX ||
      N > INT32_MAX || K > INT32_MAX)
    return cudaErrorInvalidValue;
  const long long tiles_m = (m + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  if (segments * tiles_m * tiles_n > INT32_MAX) return cudaErrorInvalidValue;
  const bool vec = K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(b) &&
                   aligned16(out) && aligned16(staging);
  auto kernel = vec ? gemm_rs_kernel<true> : gemm_rs_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  unsigned blocks = 0;
  if ((err = persistent_blocks(kernel, segments * tiles_m * tiles_n,
                               &blocks)) != cudaSuccess ||
      (err = cudaMemsetAsync(ticket, 0, sizeof(int), s)) != cudaSuccess)
    return err;
  kernel<<<blocks, THREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), static_cast<bf16*>(staging),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch,
      (int)segments, (int)m, (int)N, (int)K, (int)tiles_m, (int)tiles_n);
  return cudaGetLastError();
}
