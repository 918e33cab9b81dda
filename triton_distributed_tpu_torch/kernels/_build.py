"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object file (all files at once, in parallel), and the objects are linked
into ONE shared library with a plain C interface, loaded with ``ctypes``.
No source includes PyTorch's headers, so a build takes seconds.

The build runs at first use, never at import, into ``build/torch_kernels/``
beside the package (listed in ``.gitignore``). The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
A failed build raises with nvcc's output.

C interface conventions (shared by every ``csrc`` file): pointers and the
CUDA stream are ``void*`` (declared ``c_void_p`` here, so a 64-bit address
is never cut to 32 bits), sizes and strides are ``long long``, and each
entry point returns the ``cudaError_t`` of ``cudaGetLastError()`` right
after its launch; ``check`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# Keys of one split of the split-KV decode (csrc/flash_decode.cuh SPLIT,
# compiled in from here; sp_attention.decode_splits counts with it).
DECODE_SPLIT = 256
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              f"-DTDT_DECODE_SPLIT={DECODE_SPLIT}"]

P, I64, I32, U32, U64, F32 = (ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong,
                              ctypes.c_float)

# C entry points: name -> argtypes (restype is always int = cudaError_t).
SIGNATURES = {
    # a, b, c, M, N, K, dtype (0 fp32, 1 bf16), tma (bf16: the
    # warp-specialised wgmma GEMM), stream
    "tdt_matmul": [P, P, P, I64, I64, I64, I32, I32, P],
    # q, k, v, o, rows (nullable (3, B) int32: offset, kv_len, q_len),
    # offset, kv_len, q_len, B, L, Hq, Hkv, S, dh,
    # k batch/seq/head strides, scale, dtype, tma (bf16 at head_dim 128:
    # the wgmma tile), ticket, stream
    "tdt_flash_prefill": [P, P, P, P, P, I32, I32, I32,
                          I64, I64, I64, I64, I64, I64,
                          I64, I64, I64, F32, I32, I32, P, P],
    # q, k, v, out, lse, kv_lens (nullable (B,) int32), kv_len,
    # B, Hq, Hkv, S, dh, k batch/seq/head strides, scale, dtype, split
    # partials, arrival counters (both nullable at one split), splits,
    # stream
    "tdt_flash_decode": [P, P, P, P, P, P, I32,
                         I64, I64, I64, I64, I64, I64, I64, I64, F32, I32,
                         P, P, I64, P],
    # q, k_pool, v_pool, k_scale, v_scale (nullable), tables, rows ((3, B)
    # int32: kv_len - q_len, kv_len, q_len), out, B, L, Hq, Hkv, n_blocks,
    # block_size, max_blocks, dh, scale, q dtype, pool dtype, the decode's
    # split partials and arrival counters (nullable), splits, stream
    "tdt_paged_attention": [P, P, P, P, P, P, P, P,
                            I64, I64, I64, I64, I64, I64, I64, I64, F32,
                            I32, I32, P, P, I64, P],
    # x, w, out, counts ((E,) int32), E, cap, d, f, dtype, stream
    "tdt_grouped_gemm": [P, P, P, P, I64, I64, I64, I64, I32, P],
    # a, staging (null: bare), b, out, flags, ticket, epoch, M, cols, n, K,
    # chunk rows, tma (the wgmma tile), producer delay (ns), stream
    "tdt_ag_gemm_loopback": [P, P, P, P, P, P, U32, I64, I64, I64, I64, I64,
                             I32, U64, P],
    # c, a, b, out, M, n, K, col_start, stream
    "tdt_matmul_tail_into": [P, P, P, P, I64, I64, I64, I64, P],
    # a, b, out, staging, own (f32; null where the owner's product is
    # folded in place), flags, ticket, epoch, segments, m, N, K, dtype, tma
    # (bf16: the wgmma tile), producer delay (ns), stream
    "tdt_gemm_rs_loopback": [P, P, P, P, P, P, P, U32, I64, I64, I64, I64,
                             I32, I32, U64, P],
    # c, a, b, out, s (nullable f32 scalar), s value, M, N, K, stream
    "tdt_fused_step": [P, P, P, P, P, F32, I64, I64, I64, P],
    # x, staging (null at world 1), out, flags, ticket (arrival cells), n,
    # chunk elements, chunks, world, blocks
    # (tdt_oneshot_ar_loopback_blocks), dtype, producer delay (ns), stream
    "tdt_oneshot_ar_loopback": [P, P, P, P, P, I64, I64, I64, I64, I64, I32,
                                U64, P],
    # chunks, world, dtype, out: the persistent grid's block count (uint32)
    "tdt_oneshot_ar_loopback_blocks": [I64, I64, I32, P],
    # sends, recvs (host arrays of device pointers), row bytes, piece rows
    # (host int64 arrays), n_payloads, send_counts, count cells,
    # recv_counts, flags, ticket, epoch, world, capacity, chunk rows, stream
    "tdt_a2a_loopback": [P, P, P, P, I64, P, P, P, P, P, U32, I64, I64, I64,
                         P],
    # x, queue, out, signals, world, n_chunks, chunk bytes, odd ranks'
    # producer delay (ns), stream
    "tdt_notify_wait": [P, P, P, P, I64, I64, I64, U64, P],
    # The multi-rank kernels over world simulated ranks on one card.
    # a, staging, b, out, flags, ticket, epoch, world, m, K, n, cols, chunk
    # rows, dtype, tma (bf16: the wgmma tile), producer delay (ns), stream
    "tdt_ag_gemm": [P, P, P, P, P, P, U32, I64, I64, I64, I64, I64, I64, I32,
                    I32, U64, P],
    # a, b, out, staging, own (f32; null where the owner's product is
    # folded in place), flags, ticket, epoch, world, M, k, N, dtype, tma
    # (bf16: the wgmma tile), producer delay (ns), stream
    "tdt_gemm_rs": [P, P, P, P, P, P, P, U32, I64, I64, I64, I64, I32, I32,
                    U64, P],
    # x, staging, out, flags, ticket, epoch, world, n, chunk elements,
    # dtype, producer delay (ns), stream
    "tdt_oneshot_ar": [P, P, P, P, P, U32, I64, I64, I64, I32, U64, P],
    # x, staging, out, reduce-scatter flags, allgather flags, ticket, epoch,
    # world, chunk elements, piece elements, dtype, producer delay (ns),
    # stream
    "tdt_twoshot_ar": [P, P, P, P, P, P, U32, I64, I64, I64, I32, U64, P],
    # sends, recvs (host arrays of device pointers), row bytes, piece rows
    # (host int64 arrays), n_payloads, send_counts, count cells,
    # recv_counts, flags, ticket, epoch, world, capacity, chunk rows,
    # producer delay (ns), stream
    "tdt_ep_a2a": [P, P, P, P, I64, P, P, P, P, P, U32, I64, I64, I64, U64,
                   P],
    # x, staging, out, flags, ticket, epoch, world, segment elements, chunk
    # elements, dtype, producer delay (ns), stream
    "tdt_oneshot_rs": [P, P, P, P, P, U32, I64, I64, I64, I32, U64, P],
    # x, staging, out, flags, ticket, epoch, world, chunk elements, piece
    # elements, dtype, producer delay (ns), stream
    "tdt_ring_rs": [P, P, P, P, P, U32, I64, I64, I64, I32, U64, P],
    # grids, staging, w, out, flags, ticket, epoch, world, E, cap, d, f,
    # experts and rows per producer chunk, dtype, tma (bf16: the wgmma
    # tile), producer delay (ns), stream
    "tdt_ag_group_gemm": [P, P, P, P, P, P, U32, I64, I64, I64, I64, I64,
                          I64, I64, I32, I32, U64, P],
    # act, w, out, staging, own (f32; null where the owner's product is
    # folded in place), flags, ticket, epoch, world, E, cap, f, d, dtype,
    # tma (bf16: the wgmma tile), producer delay (ns), stream
    "tdt_group_gemm_rs": [P, P, P, P, P, P, P, U32, I64, I64, I64, I64, I64,
                          I32, I32, U64, P],
    # x, out, flags, ticket (arrival cells), world, shard bytes, piece
    # bytes, pieces a shard, blocks (tdt_ring_ag_blocks), producer delay
    # (ns), stream
    "tdt_ring_ag": [P, P, P, P, I64, I64, I64, I64, I64, U64, P],
    # world, pieces a shard, out: the persistent grid's block count (uint32)
    "tdt_ring_ag_blocks": [I64, I64, P],
    # x, out, world, shard bytes, piece bytes, producer delay (ns), stream
    "tdt_a2a_ag": [P, P, I64, I64, I64, U64, P],
    # x, staging, out, flags, ticket, epoch (nullable int32 on the card),
    # epoch value, world, shard bytes, piece bytes, pieces a shard, blocks
    # (tdt_ll_allgather_blocks), producer delay (ns), stream
    "tdt_ll_allgather": [P, P, P, P, P, P, I64, I64, I64, I64, I64, I64, U64,
                         P],
    # world, pieces a shard, out: the persistent grid's block count (uint32)
    "tdt_ll_allgather_blocks": [I64, I64, P],
    # q, k, v, k_full, v_full, out, lse (nullable), offsets ((2, world)
    # int32: row, col), flags, ticket, epoch, world, H, m, m_kv, dh,
    # causal, scale, dtype, producer delay (ns), stream
    "tdt_sp_ag_attn": [P, P, P, P, P, P, P, P, P, P, U32, I64, I64, I64,
                       I64, I64, I32, F32, I32, U64, P],
}


BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc per file, all started together)
    and link them into one library. Returns its path; raises on failure."""
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libtdt_torch_{_digest(srcs)}.so"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        nvcc = nvcc_path()
        procs = []
        for src in srcs:
            obj = BUILD_DIR / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors, objs = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- {src.name} (rc {proc.returncode})\n{out}")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = lib.with_suffix(".tmp.so")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib)
    return lib


class _Library:
    """The loaded kernel library, built and opened on first ``get()``."""

    def __init__(self):
        self._lib = None

    def get(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


_LIBRARY = _Library()


def lib():
    return _LIBRARY.get()


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def persistent_blocks(entry: str, device: torch.device, *args) -> int:
    """The block count of a kernel's persistent grid, from its C entry
    ``entry`` (``args``, then a pointer it writes the uint32 count to), on
    ``device``: one occupancy query, which a caller's launch plan keeps."""
    blocks = ctypes.c_uint(0)
    with torch.cuda.device(device):
        check(getattr(lib(), entry)(*args, ctypes.byref(blocks)), entry)
    return blocks.value


def stream_ptr(t) -> int:
    """The raw handle of the current stream of ``t``'s device (the same
    value as ``torch.cuda.current_stream(t.device).cuda_stream``, without
    building the stream object: a short call's host path pays for it)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


class Kernel:
    """One hand-written kernel of the port: where its source is, which TPU
    kernel it replaces, and how many times its wrapper launched it. The
    count is a plain int that only the wrapper's launch adds to; a run
    resets it to 0 before the path it wants to check (``reset_counts``)."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name, self.source, self.replaces = name, source, replaces
        self.route = "cuda"
        self.launches = 0


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    KERNELS[name] = Kernel(name, source, replaces)
    return KERNELS[name]


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


# Element types of the C interface (csrc/common.cuh kF32 .. kFP8). int8 and
# fp8 are KV wire types: only the paged-attention pools take them.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
FLOAT_TYPES = (torch.float32, torch.bfloat16)


def tma_rows(row_elems, *ts) -> int:
    """1 when TMA can read every one of the tensors ``ts`` (the ``wgmma``
    tiles' operands): every base 16-byte aligned and every row length in
    ``row_elems`` a whole number of 16-byte units of bf16; else 0, and the
    kernel runs the same items on its ``mma.sync`` tile. Decided from the
    shapes and pointers before the launch, and passed to it."""
    return int(all(n % 8 == 0 for n in row_elems)
               and all(t.data_ptr() % 16 == 0 for t in ts))


def dtype_code(t, allowed=FLOAT_TYPES) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"the CUDA kernels take {[str(d) for d in allowed]} "
                        f"here, got {t.dtype}")
    return DTYPE_CODES[t.dtype]
