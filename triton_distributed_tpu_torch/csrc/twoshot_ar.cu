// Multi-rank two-shot all-reduce with world simulated ranks on one card: a
// ring reduce-scatter, then a ring allgather. x (world, M, ...) with M =
// world m, seen as world chunks of cn = m x (trailing) elements; out (world,
// M, ...), every rank's copy the same bits; staging (world, world - 1, cn):
// staging[r][s] is what rank r's left neighbour pushed at ring step s. f32
// or bf16.
//
// Replaces: triton_distributed_tpu/kernels/allreduce.py:209
//   _twoshot_ar_kernel (via twoshot_all_reduce :253 at world > 1). Its
//   order: at step s = 0 .. world - 2 rank r takes chunk c = (r - s - 1)
//   mod world, adds x[r][c] and (for s > 0) staging[r][s - 1] in f32,
//   rounds the sum to x's dtype (common.reduce_rows_tiled) and pushes it to
//   rank r + 1's staging[s]; then out[r][chunk r] = round(x[r][r] +
//   staging[r][world - 2]); then world - 1 ring steps forward the finished
//   chunks: at step s rank r sends chunk (r - s) mod world to rank r + 1.
//
// What bounds it on the H100: bytes. The function reads every rank's x once
//   and writes every rank's output once: 2 world M (trailing) elements. The
//   ring's pushes are scratch that stands in for the link (NVLink is not
//   exercised on one card).
//
// What this design does about it: the TPU kernel runs the ring as a
//   sequence of DMAs and semaphore waits in one program per chip. Here the
//   ranks are a field of each work item of one persistent grid
//   (gemm_tile.cuh persistent_blocks), an item being one piece (about 16
//   KB) of one chunk at one ring step of one rank, and an atomic ticket
//   hands the items out by ring step: every rank's reduce-scatter step 0,
//   then step 1, ..., the final reduce, then the allgather's step 0, 1, ...
//   An item of step s waits only on a flag that an item of step s - 1
//   raises (the piece it reads has landed), through language.cuh; those
//   items were handed out before it and run on blocks that hold them, so
//   no wait can deadlock, whatever the dispatch order. A reduce item adds
//   in f32 and rounds, stores its piece straight into the right
//   neighbour's staging slot (or its own output), meets its block at a
//   barrier and releases the piece's flag to the call's epoch; an allgather
//   item copies a finished piece into the right neighbour's output the
//   same way. delay_ns holds back every item of the reduce-scatter's step 0
//   (the ring's first producers) before it stores (a test of the waits: the
//   result must not change).
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
    twoshot_ar_kernel(const T* __restrict__ x, T* staging, T* out,
                      uint32_t* rs_flags, uint32_t* ag_flags, int* ticket,
                      uint32_t epoch, long long cn, long long piece,
                      int n_pieces, int world, unsigned long long delay_ns) {
  const int W = world, peers = W - 1;
  const int per_step = W * n_pieces;
  const int total = (2 * W - 1) * per_step;  // RS, final reduce, AG
  const size_t n = (size_t)W * cn;           // elements of one rank's x
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    const int step = t / per_step, r = (t / n_pieces) % W, q = t % n_pieces;
    const int right = (r + 1) % W;
    const long long p0 = (long long)q * piece;
    const long long len = min(piece, cn - p0);
    uint32_t* flag;
    if (step < peers) {  // reduce-scatter step s = step
      const int s = step, c = ((r - s - 1) % W + W) % W;
      const T* prev = nullptr;
      if (s > 0) {
        if (threadIdx.x == 0)
          lang::wait(rs_flags + ((size_t)r * peers + s - 1) * n_pieces + q,
                     epoch);
        __syncthreads();
        lang::consume_token();
        prev = staging + ((size_t)r * peers + s - 1) * cn + p0;
      } else {
        lang::sleep_ns(delay_ns);
      }
      add_rows<T, VEC>(staging + ((size_t)right * peers + s) * cn + p0,
                       x + (size_t)r * n + (size_t)c * cn + p0, false, prev,
                       len);
      flag = rs_flags + ((size_t)right * peers + s) * n_pieces + q;
    } else if (step == peers) {  // the own chunk, fully reduced
      if (threadIdx.x == 0)
        lang::wait(rs_flags + ((size_t)r * peers + peers - 1) * n_pieces + q,
                   epoch);
      __syncthreads();
      lang::consume_token();
      add_rows<T, VEC>(out + (size_t)r * n + (size_t)r * cn + p0,
                       x + (size_t)r * n + (size_t)r * cn + p0, false,
                       staging + ((size_t)r * peers + peers - 1) * cn + p0,
                       len);
      flag = ag_flags + ((size_t)r * W + r) * n_pieces + q;
    } else {  // allgather step s: rank r forwards chunk (r - s) mod W
      const int s = step - W, c = ((r - s) % W + W) % W;
      if (threadIdx.x == 0)
        lang::wait(ag_flags + ((size_t)r * W + c) * n_pieces + q, epoch);
      __syncthreads();
      lang::consume_token();
      add_rows<T, VEC>(out + (size_t)right * n + (size_t)c * cn + p0,
                       out + (size_t)r * n + (size_t)c * cn + p0, true,
                       nullptr, len);
      flag = ag_flags + ((size_t)right * W + c) * n_pieces + q;
    }
    __syncthreads();  // every thread's stores precede the release
    if (threadIdx.x == 0) {
      __threadfence();
      lang::notify(flag, epoch);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* staging, void* out, void* rs_flags,
                   void* ag_flags, void* ticket, unsigned epoch, long long cn,
                   long long piece, int world, unsigned long long delay_ns,
                   cudaStream_t s) {
  using tdt::gemm::aligned16;
  constexpr int P = Vec<T>::N;
  const long long n_pieces = (cn + piece - 1) / piece;
  const bool vec = cn % P == 0 && piece % P == 0 && aligned16(x) &&
                   aligned16(out) && aligned16(staging);
  auto kernel = vec ? twoshot_ar_kernel<T, true>
                    : twoshot_ar_kernel<T, false>;
  unsigned blocks = 0;
  cudaError_t err = tdt::gemm::persistent_blocks(
      kernel, kThreads, 0, (2LL * world - 1) * world * n_pieces, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(staging), static_cast<T*>(out),
      static_cast<uint32_t*>(rs_flags), static_cast<uint32_t*>(ag_flags),
      static_cast<int*>(ticket), epoch, cn, piece, (int)n_pieces, world,
      delay_ns);
  return cudaGetLastError();
}

}  // namespace

// x, out (world, world cn), staging (world, world - 1, cn); rs_flags (world
// x (world - 1) x ceil(cn / piece)) and ag_flags (world x world x ceil(cn /
// piece)), uint32, raised to epoch; ticket (one int32 of scratch, zeroed
// here on the stream); dtype 0 f32, 1 bf16; delay_ns holds the ring's first
// producers back (0 in use).
extern "C" int tdt_twoshot_ar(const void* x, void* staging, void* out,
                              void* rs_flags, void* ag_flags, void* ticket,
                              unsigned epoch, long long world, long long cn,
                              long long piece, int dtype,
                              unsigned long long delay_ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (world < 2 || cn <= 0 || piece <= 0 || !staging || world > 4096)
    return cudaErrorInvalidValue;
  if ((2 * world - 1) * world * ((cn + piece - 1) / piece) > INT32_MAX)
    return cudaErrorInvalidValue;
  if (dtype == tdt::kF32)
    return launch<float>(x, staging, out, rs_flags, ag_flags, ticket, epoch,
                         cn, piece, (int)world, delay_ns, s);
  if (dtype == tdt::kBF16)
    return launch<__nv_bfloat16>(x, staging, out, rs_flags, ag_flags, ticket,
                                 epoch, cn, piece, (int)world, delay_ns, s);
  return cudaErrorInvalidValue;
}
