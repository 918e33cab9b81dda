// Multi-rank ring reduce-scatter with world simulated ranks on one card:
// world - 1 ring steps of add-and-forward, then each rank's own chunk. x
// (world, world cn): rank r's contribution, world chunks of cn elements;
// staging (world, world - 1, cn): staging[r][s] is what rank r's left
// neighbour pushed at ring step s; out (world, cn), rank r's chunk r of the
// sum. f32 or bf16.
//
// Replaces: triton_distributed_tpu/kernels/reduce_scatter.py:90
//   _ring_rs_kernel (via ring_reduce_scatter :203 at world > 1). Its order:
//   at step s = 0 .. world - 2 rank r takes chunk c = (r - s - 1) mod world,
//   adds x[r][c] and (for s > 0) staging[r][s - 1] in f32, rounds the sum to
//   x's dtype (common.reduce_rows_tiled, common.py:265) and pushes it to rank
//   r + 1's staging[s]; then out[r] = round(x[r][r] + staging[r][world -
//   2]) (:104-127). Every hop rounds, so a bf16 result is not the one-shot
//   fold's: each method is held against its own plain version.
//
// What bounds it on the H100: bytes. The function reads every rank's x once
//   and writes every rank's chunk once: world (world + 1) cn elements. The
//   ring's pushes are scratch that stands in for the link (NVLink is not
//   exercised on one card).
//
// What this design does about it: this is the reduce-scatter leg of
//   twoshot_ar.cu without its allgather. The ranks are a field of each work
//   item of one persistent grid (gemm_tile.cuh persistent_blocks), an item
//   being one piece (about 16 KB) of one chunk at one ring step of one
//   rank, and an atomic ticket hands the items out by ring step: every
//   rank's step 0, then step 1, ..., then the final reduce. An item of step
//   s waits only on the flag that an item of step s - 1 raises (the piece
//   it reads has landed), through language.cuh; those items were handed
//   out before it and run on blocks that hold them, so no wait can
//   deadlock, whatever the dispatch order. A step item adds in f32 and
//   rounds (vec.cuh add_rows), stores its piece straight into the right
//   neighbour's staging slot, meets its block at a barrier and releases the
//   piece's flag to the call's epoch; a final item writes its rank's output.
//   delay_ns holds back every item of step 0 (the ring's first producers)
//   before it stores (a test of the waits: the result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"
#include "vec.cuh"

namespace {

namespace lang = tdt::lang;
using tdt::vec::add_rows;
using tdt::vec::Vec;
constexpr int kThreads = 256;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    ring_rs_kernel(const T* __restrict__ x, T* staging, T* __restrict__ out,
                   uint32_t* flags, int* ticket, uint32_t epoch, long long cn,
                   long long piece, int n_pieces, int world,
                   unsigned long long delay_ns) {
  const int W = world, peers = W - 1;
  const int per_step = W * n_pieces;
  const int total = W * per_step;     // world - 1 ring steps, final reduce
  const size_t n = (size_t)W * cn;    // elements of one rank's x
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    const int step = t / per_step, r = (t / n_pieces) % W, q = t % n_pieces;
    const long long p0 = (long long)q * piece;
    const long long len = min(piece, cn - p0);
    if (step > 0) {  // the left neighbour's push of step - 1 has landed
      if (threadIdx.x == 0)
        lang::wait(flags + ((size_t)r * peers + step - 1) * n_pieces + q,
                   epoch);
      __syncthreads();
      lang::consume_token();
    } else {
      lang::sleep_ns(delay_ns);
    }
    const T* prev =
        step > 0 ? staging + ((size_t)r * peers + step - 1) * cn + p0
                 : nullptr;
    if (step == peers) {  // the own chunk, fully reduced
      add_rows<T, VEC>(out + (size_t)r * cn + p0,
                       x + (size_t)r * n + (size_t)r * cn + p0, false, prev,
                       len);
      continue;  // take_ticket starts at a barrier
    }
    const int right = (r + 1) % W, c = ((r - step - 1) % W + W) % W;
    add_rows<T, VEC>(staging + ((size_t)right * peers + step) * cn + p0,
                     x + (size_t)r * n + (size_t)c * cn + p0, false, prev,
                     len);
    __syncthreads();  // every thread's stores precede the release
    if (threadIdx.x == 0) {
      __threadfence();
      lang::notify(flags + ((size_t)right * peers + step) * n_pieces + q,
                   epoch);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* staging, void* out, void* flags,
                   void* ticket, unsigned epoch, long long cn,
                   long long piece, int world, unsigned long long delay_ns,
                   cudaStream_t s) {
  using tdt::gemm::aligned16;
  constexpr int P = Vec<T>::N;
  const long long n_pieces = (cn + piece - 1) / piece;
  const bool vec = cn % P == 0 && piece % P == 0 && aligned16(x) &&
                   aligned16(out) && aligned16(staging);
  auto kernel = vec ? ring_rs_kernel<T, true> : ring_rs_kernel<T, false>;
  unsigned blocks = 0;
  cudaError_t err = tdt::gemm::persistent_blocks(
      kernel, kThreads, 0, (long long)world * world * n_pieces, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(staging), static_cast<T*>(out),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch, cn,
      piece, (int)n_pieces, world, delay_ns);
  return cudaGetLastError();
}

}  // namespace

// x (world, world cn), staging (world, world - 1, cn), out (world, cn);
// flags (world x (world - 1) x ceil(cn / piece), uint32, raised to epoch);
// ticket (one int32 of scratch, zeroed here on the stream); dtype 0 f32, 1
// bf16; delay_ns holds the ring's first producers back (0 in use).
extern "C" int tdt_ring_rs(const void* x, void* staging, void* out,
                           void* flags, void* ticket, unsigned epoch,
                           long long world, long long cn, long long piece,
                           int dtype, unsigned long long delay_ns,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 2 || cn <= 0 || piece <= 0 || !staging || world > 4096)
    return cudaErrorInvalidValue;
  if (world * world * ((cn + piece - 1) / piece) > INT32_MAX)
    return cudaErrorInvalidValue;
  if (dtype == tdt::kF32)
    return launch<float>(x, staging, out, flags, ticket, epoch, cn, piece,
                         (int)world, delay_ns, s);
  if (dtype == tdt::kBF16)
    return launch<__nv_bfloat16>(x, staging, out, flags, ticket, epoch, cn,
                                 piece, (int)world, delay_ns, s);
  return cudaErrorInvalidValue;
}
