// One-chip GEMM-RS loopback: every row segment's partial product A[src] @ B
// is computed; the remote segments 1..S-1 push each finished tile, cast to
// the output dtype, into staging[src - 1] and raise that tile's flag; the
// own segment 0 folds them per tile in a fixed order. A (S m, K), B (K, N),
// out (m, N) = A[0] @ B + sum over src of bf16(A[src] @ B), bf16 in and out.
//
// Replaces: triton_distributed_tpu/kernels/gemm_reduce_scatter.py:270
//   _gemm_rs_loopback_kernel (via gemm_rs_loopback :330).
//
// What bounds it on the H100: the operations of all S partial products
//   (2 S m K N, the full matmul's), 989 TFLOP/s dense bf16. The staging
//   adds a write and a read of (S - 1) m N bf16 elements (2 x 29 MB at the
//   Qwen3-32B TP=8 down-projection shape, ~0.018 ms of HBM time).
//
// What this design does about it: the loopback is one output segment of a
//   world-S GEMM-RS, so it runs gemm_rs.cuh's items as that call's owner 0
//   (make_loopback_geometry): the sources are A's S row segments, each read
//   by A's tensor map as a plane of (m, K), one B plane serves every
//   source, and only owner 0 folds, in the order src = 0 (f32) then 1 ..
//   S - 1 (each rounded to bf16), as the TPU kernel's fold. The TPU
//   kernel's parity send tiles and their reclaim waits answer VMEM scarcity
//   and are gone. bf16 that TMA can read runs the 128 x 128 wgmma tile fed
//   by TMA (wgmma_tile.cuh): where m is a multiple of 128 (bench.py's m =
//   512) the owner's product tile is its fold item, staged in shared memory
//   while it waits on the S - 1 pushed tiles of its rows, so no f32 scratch
//   is written; otherwise source 0's product tiles write f32 scratch and
//   separate fold items read it back. Rows TMA cannot read take
//   gemm_tile.cuh's mma.sync tile in the same one launch. The folds wait
//   on tiles that other blocks of this kernel produce, so the grid is
//   persistent (no larger than the card holds at once) and hands out items
//   by an atomic ticket, every fold after the products it waits on: no
//   deadlock, whatever the dispatch order. The ticket lives in a persistent
//   buffer (kernels/_signal.py arrivals) that the block taking the last
//   ticket leaves at 0, the shared-memory attribute is raised once and the
//   block count cached: a call is one device operation, the launch.
//   delay_ns holds every product tile back before it releases its flag (a
//   test of the waits: the result must not change).
#include "gemm_rs.cuh"

namespace {

TDT_RS_KERNELS(gemm_rs_loopback, true)

}  // namespace

// a (segments m, K), b (K, N), out (m, N), staging (segments - 1, m, N),
// own (m, N) f32 or null on the wgmma items with m a multiple of 128;
// flags (segments x ceil(m / 128) x ceil(N / 128), uint32, raised to
// epoch; the f32 tile's 64 for f32); ticket (one int32, 0 on entry and left
// at 0); dtype 0 f32, 1 bf16; tma 1 when TMA can read every bf16 operand
// (K and N multiples of 8, K > 0, 16-byte aligned pointers: the wgmma
// tile), 0 for the mma.sync tile; delay_ns holds every product tile back
// (0 in use).
extern "C" int tdt_gemm_rs_loopback(const void* a, const void* b, void* out,
                                    void* staging, void* own, void* flags,
                                    void* ticket, unsigned epoch,
                                    long long segments, long long m,
                                    long long N, long long K, int dtype,
                                    int tma, unsigned long long delay_ns,
                                    void* stream) {
  return gemm_rs_loopback_launch(a, b, out, staging, own, flags, ticket,
                                 epoch, segments, 1, m, K, N, dtype, tma,
                                 delay_ns, static_cast<cudaStream_t>(stream));
}
