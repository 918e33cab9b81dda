"""GEMM + reduce-scatter at world 1, and the one-chip GEMM-RS loopback.

Counterpart of ``triton_distributed_tpu/kernels/gemm_reduce_scatter.py``:
at world 1 ``gemm_rs_device`` (:190) is the single-card matmul.
``gemm_rs_loopback`` (:330) runs on ``csrc/gemm_rs_loopback.cu``: every
row segment's partial product, the remote ones pushed tile by tile through
a staging buffer with a flag per tile, folded into the own segment in a
fixed order. The overlapped multi-rank kernel is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal
from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    TILE_N,
    _check_bf16_cuda,
    ag_gemm_single_chip,
)

GEMM_RS_LOOPBACK = _build.register(
    "gemm_rs_loopback",
    "triton_distributed_tpu_torch/csrc/gemm_rs_loopback.cu",
    "triton_distributed_tpu/kernels/gemm_reduce_scatter.py:270")

# Output tile height of the CUDA GEMM tiles (csrc/gemm_tile.cuh BM).
TILE_M = 128


@dataclasses.dataclass(frozen=True)
class GEMMRSConfig:
    """Column granularity of GEMM-RS (JAX ``GEMMRSConfig`` :46): ``N`` must
    be a multiple of ``block_n``. ``None`` resolves to the CUDA tile's
    width when it divides ``N``, else to ``N``; the CUDA tiles themselves
    are fixed at 128 x 128 and mask ragged edges."""

    block_n: int | None = None

    def n_tiles(self, n: int) -> int:
        if self.block_n is None or n % self.block_n:
            raise ValueError(f"N {n} not divisible by block_n {self.block_n}")
        return n // self.block_n

    def resolve(self, n: int) -> "GEMMRSConfig":
        if self.block_n is not None:
            return self
        return GEMMRSConfig(block_n=TILE_N if n % TILE_N == 0 else n)


def gemm_rs_device(a_local: torch.Tensor, b_local: torch.Tensor, *,
                   world: int = 1) -> torch.Tensor:
    """GEMM-RS ``(M, k_local) x (k_local, N) -> (M/world, N)``. Only world 1
    is ported: it is ``ag_gemm_single_chip``."""
    if world != 1:
        raise NotImplementedError(
            "gemm_rs_device at world > 1 (the overlapped reduce-scatter "
            "kernel) is not ported yet: ROADMAP.md Queue 1 item 11 / Queue 2 "
            "row 13")
    return ag_gemm_single_chip(a_local, b_local)


def gemm_rs_loopback_ref(a: torch.Tensor, b: torch.Tensor, *,
                         segments: int) -> torch.Tensor:
    """Plain version, in the kernel's order and rounding: the own segment's
    partial ``A[0] @ B`` in f32, then ``+=`` each remote partial
    ``A[dst] @ B`` for dst = 1 .. segments-1 in order, each one rounded to
    the output dtype first (the staged tile), then one cast."""
    m = a.shape[0] // segments
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    bf = b.float()
    acc = torch.matmul(a[:m].float(), bf)
    for dst in range(1, segments):
        part = torch.matmul(a[dst * m:(dst + 1) * m].float(), bf)
        acc += part.to(out_dtype).float()
    return acc.to(out_dtype)


def gemm_rs_loopback_cuda(a: torch.Tensor, b: torch.Tensor, *,
                          segments: int) -> torch.Tensor:
    """Launch ``csrc/gemm_rs_loopback.cu`` (bf16) on the current stream:
    a persistent grid no larger than the card holds at once, producer tiles
    handed out before the owner's by an atomic ticket."""
    _check_bf16_cuda("gemm_rs_loopback_cuda", a, b)
    M, k = a.shape
    n = b.shape[1]
    m = M // segments
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    staging = torch.empty((max(segments - 1, 1), m, n), dtype=a.dtype,
                          device=a.device)
    flags = _signal.flags(a.device, "gemm_rs_loopback",
                          (segments - 1) * tiles)
    ticket = torch.empty(1, dtype=torch.int32, device=a.device)
    err = _build.lib().tdt_gemm_rs_loopback(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), staging.data_ptr(),
        flags.data_ptr(), ticket.data_ptr(), _signal.next_epoch(a.device),
        segments, m, n, k, _build.stream_ptr(a))
    _build.check(err, "tdt_gemm_rs_loopback")
    GEMM_RS_LOOPBACK.launches += 1
    return out


def gemm_rs_loopback(a: torch.Tensor, b: torch.Tensor, *, segments: int = 8,
                     config: GEMMRSConfig | None = None) -> torch.Tensor:
    """One-chip self-loopback GEMM-RS (JAX :330): ``a`` (M, k) with M =
    segments * m, ``b`` (k, N). Every segment's partial ``A[seg] @ B`` is
    computed (the full matmul's FLOPs); the segments-1 remote partials go
    tile by tile through a staging buffer, each tile flagged when it lands,
    and fold into the own segment in a fixed order. Returns ``(m, N)`` =
    ``(sum of A row blocks) @ B`` with each remote partial rounded to the
    output dtype."""
    M, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"K mismatch: A has {k}, B has {k2}")
    if segments < 1 or M % segments:
        raise ValueError(f"M {M} not divisible by segments {segments}")
    (config or GEMMRSConfig()).resolve(n).n_tiles(n)  # divisibility check
    if a.is_cuda:
        return gemm_rs_loopback_cuda(a, b, segments=segments)
    return gemm_rs_loopback_ref(a, b, segments=segments)
