// One-chip one-shot all-reduce loopback: world - 1 simulated peers push
// this card's buffer into a staging slot each, raising an arrival flag per
// chunk, and a fold sums the own buffer and the slots in a fixed order.
// x (n elements, any trailing shape flattened), staging (world - 1, n),
// out (n) = cast(f32(x) + f32(staging[0]) + ... + f32(staging[world - 2])),
// which is world * x: every slot carries x. f32 or bf16.
//
// Replaces: triton_distributed_tpu/kernels/allreduce.py:158
//   _oneshot_ar_loopback_kernel (via oneshot_ar_loopback :174), whose fold
//   is common.reduce_slots_tiled (common.py:231) with me = 0: the own
//   contribution first, read straight from x, then the slots in rank
//   order, then ONE cast.
//
// What bounds it on the H100: bytes. The staging is written once and read
//   once, x read once and out written once: (2 (world - 1) + 2) n bytes of
//   the element size, 20.97 MB at bench.py's (128, 5,120) bf16 at world 8,
//   ~6.3 us at 3.35 TB/s. No arithmetic to speak of.
//
// What this design does about it: the TPU kernel starts world - 1 local
//   DMAs and waits on their semaphores; on this card a device-local copy
//   runs on the SMs (ag_gemm_loopback.cu), so the pushes are work items of
//   the kernel itself. One persistent grid (gemm_tile.cuh
//   persistent_blocks) hands out items by an atomic ticket: first the
//   producer items, chunk-major (for chunk c, slot 0 .. world - 2: copy
//   x's chunk into staging[slot] with language.cuh's putmem_signal, which
//   raises flag (c, slot) to the call's epoch), then one fold item per
//   chunk: one thread waits on the chunk's world - 1 flags, the block
//   meets at a barrier, and each thread folds 16-byte vectors (eight bf16
//   or four f32) in f32 registers in the fixed order above, staged values
//   loaded through L2 only. A producer never waits and a block takes a
//   ticket only while it runs, so every flag a fold waits on belongs to a
//   running block: no deadlock, whatever the dispatch order. The TPU
//   kernel's VMEM row tiles (stage_row_tile) are the chunks here. delay_ns
//   holds every producer item back before its copy (a test of the waits:
//   the result must not change).
#include "gemm_tile.cuh"
#include "language.cuh"

namespace {

namespace lang = tdt::lang;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T load_cg(const T* p);
template <>
__device__ __forceinline__ float load_cg<float>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ __nv_bfloat16 load_cg<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// 16 bytes <-> their elements in f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(uint4 u, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&u);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static uint4 store(const float* f) {
    const float4 v = make_float4(f[0], f[1], f[2], f[3]);
    return *reinterpret_cast<const uint4*>(&v);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(uint4 u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

// out[e0, e0 + len) = cast(f32(x) + f32(staging[0]) + ...), in that order.
template <typename T, bool VEC>
__device__ __forceinline__ void fold(const T* __restrict__ x,
                                     const T* staging, T* __restrict__ out,
                                     long long n, int slots, long long e0,
                                     long long len) {
  if constexpr (VEC) {
    constexpr int P = Vec<T>::N;
    for (long long i = threadIdx.x; i < len / P; i += blockDim.x) {
      const long long e = e0 + i * P;
      float acc[P], f[P];
      Vec<T>::load(*reinterpret_cast<const uint4*>(x + e), acc);
      for (int s = 0; s < slots; ++s) {
        Vec<T>::load(
            __ldcg(reinterpret_cast<const uint4*>(staging + s * n + e)), f);
#pragma unroll
        for (int k = 0; k < P; ++k) acc[k] += f[k];
      }
      *reinterpret_cast<uint4*>(out + e) = Vec<T>::store(acc);
    }
  } else {
    for (long long i = threadIdx.x; i < len; i += blockDim.x) {
      const long long e = e0 + i;
      float acc = tdt::to_f32(x[e]);
      for (int s = 0; s < slots; ++s)
        acc += tdt::to_f32(load_cg(staging + s * n + e));
      out[e] = tdt::from_f32<T>(acc);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    ar_loopback_kernel(const T* __restrict__ x, T* staging,
                       T* __restrict__ out, uint32_t* flags, int* ticket,
                       uint32_t epoch, long long n, long long chunk,
                       int n_chunks, int slots,
                       unsigned long long delay_ns) {
  const int producers = n_chunks * slots;
  const int total = producers + n_chunks;
  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket);
    if (t >= total) return;
    if (t < producers) {  // push chunk c into slot s, then raise (c, s)
      const int c = t / slots, s = t % slots;
      const long long e0 = (long long)c * chunk;
      const long long len = min(chunk, n - e0);
      lang::sleep_ns(delay_ns);
      lang::putmem_signal(staging + s * n + e0, x + e0, len * sizeof(T),
                          flags + t, epoch);
      continue;
    }
    const int c = t - producers;
    if (threadIdx.x == 0)
      for (int s = 0; s < slots; ++s)
        lang::wait(flags + (size_t)c * slots + s, epoch);
    __syncthreads();
    lang::consume_token();
    const long long e0 = (long long)c * chunk;
    fold<T, VEC>(x, staging, out, n, slots, e0, min(chunk, n - e0));
    // take_ticket starts at a barrier: nothing here is read again.
  }
}

template <typename T>
cudaError_t launch(const void* x, void* staging, void* out, void* flags,
                   void* ticket, unsigned epoch, long long n, long long chunk,
                   int slots, unsigned long long delay_ns, cudaStream_t s) {
  using tdt::gemm::aligned16;
  constexpr int P = Vec<T>::N;
  const long long n_chunks = (n + chunk - 1) / chunk;
  const bool vec = n % P == 0 && chunk % P == 0 && aligned16(x) &&
                   aligned16(out) && (slots == 0 || aligned16(staging));
  auto kernel = vec ? ar_loopback_kernel<T, true>
                    : ar_loopback_kernel<T, false>;
  unsigned blocks = 0;
  cudaError_t err = tdt::gemm::persistent_blocks(
      kernel, kThreads, 0, n_chunks * (slots + 1), &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(staging), static_cast<T*>(out),
      static_cast<uint32_t*>(flags), static_cast<int*>(ticket), epoch, n,
      chunk, (int)n_chunks, slots, delay_ns);
  return cudaGetLastError();
}

}  // namespace

// x, out (n elements), staging (world - 1, n; may be null at world 1),
// flags (ceil(n / chunk) * (world - 1) of them, uint32, raised to epoch),
// ticket (one int32 of scratch, zeroed here on the stream); dtype 0 f32,
// 1 bf16; delay_ns holds every producer item back (0 in use).
extern "C" int tdt_oneshot_ar_loopback(const void* x, void* staging,
                                       void* out, void* flags, void* ticket,
                                       unsigned epoch, long long n,
                                       long long chunk, long long world,
                                       int dtype,
                                       unsigned long long delay_ns,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || chunk <= 0 || world < 1 || (world > 1 && !staging))
    return cudaErrorInvalidValue;
  if (((n + chunk - 1) / chunk) * world > INT32_MAX)
    return cudaErrorInvalidValue;
  const int slots = (int)(world - 1);
  if (dtype == tdt::kF32)
    return launch<float>(x, staging, out, flags, ticket, epoch, n, chunk,
                         slots, delay_ns, s);
  if (dtype == tdt::kBF16)
    return launch<__nv_bfloat16>(x, staging, out, flags, ticket, epoch, n,
                                 chunk, slots, delay_ns, s);
  return cudaErrorInvalidValue;
}
