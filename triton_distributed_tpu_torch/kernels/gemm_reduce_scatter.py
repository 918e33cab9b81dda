"""GEMM + reduce-scatter at world 1, and the one-chip GEMM-RS loopback.

Counterpart of ``triton_distributed_tpu/kernels/gemm_reduce_scatter.py``:
at world 1 ``gemm_rs_device`` (:190) is the single-card matmul.
``gemm_rs_loopback`` (:330) runs on ``csrc/gemm_rs_loopback.cu``: every
row segment's partial product, the remote ones pushed tile by tile through
a staging buffer with a flag per tile, folded into the own segment in a
fixed order, as the items of ``csrc/gemm_rs.cuh`` for one owner of a
world-S call. Its staging is a persistent workspace and its ticket a
persistent arrival cell that the kernel leaves at 0: a call allocates only
its output.

At world > 1 the ranks are simulated on one card (``runtime/mesh.py``):
``gemm_rs_device`` takes every rank's shards stacked, a (world, M, k_local)
and b (world, k_local, N), and returns every rank's segment of the reduced
product, (world, M / world, N), on ``csrc/gemm_rs.cu`` (``_gemm_rs_kernel``
:76): each rank's partial products, the remote segments rounded to the
output dtype and pushed into their owners' staging slots, flagged tile by
tile, and each owner's fold in the fixed order src = 0 .. world - 1, in f32,
cast once (:124-160). One card stands in for the group: the pushes go
through device memory, not NVLink. The host wrapper ``gemm_rs`` (:451)
takes JAX's global shapes.
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
from triton_distributed_tpu_torch.runtime.mesh import World
from triton_distributed_tpu_torch.runtime.symm import get_scratch

GEMM_RS_LOOPBACK = _build.register(
    "gemm_rs_loopback",
    "triton_distributed_tpu_torch/csrc/gemm_rs_loopback.cu",
    "triton_distributed_tpu/kernels/gemm_reduce_scatter.py:270")
GEMM_RS = _build.register(
    "gemm_rs", "triton_distributed_tpu_torch/csrc/gemm_rs.cu",
    "triton_distributed_tpu/kernels/gemm_reduce_scatter.py:76")

# Output tile height of the CUDA GEMM tiles (csrc/gemm_tile.cuh BM), and
# the f32 tile's side (FT).
TILE_M = 128
F32_TILE = 64


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
                   world: int = 1,
                   config: GEMMRSConfig | None = None) -> torch.Tensor:
    """GEMM + reduce-scatter (JAX :171). At world 1 ``(M, k) x (k, N) ->
    (M, N)``: ``ag_gemm_single_chip``, ``config`` unused (as in JAX). At
    world > 1 every rank's shards stacked: a (world, M, k_local), b (world,
    k_local, N) -> (world, M / world, N), rank d's segment of the sum of
    every rank's partial product. The kernel on CUDA tensors (f32 or bf16,
    one dtype), the plain version on CPU ones. ``M % world`` raises JAX's
    ``ValueError``."""
    if world == 1:
        return ag_gemm_single_chip(a_local, b_local)
    if (a_local.dim() != 3 or b_local.dim() != 3
            or a_local.shape[0] != world or b_local.shape[0] != world):
        raise ValueError(f"gemm_rs_device at world {world} takes stacked "
                         f"a (world, M, k_local) and b (world, k_local, N), "
                         f"got {tuple(a_local.shape)} and "
                         f"{tuple(b_local.shape)}")
    _, M, k = a_local.shape
    _, k2, n = b_local.shape
    if k != k2:
        raise ValueError(f"K mismatch: A has {k}, B has {k2}")
    if M % world:
        raise ValueError(f"M {M} not divisible by world {world}")
    (config or GEMMRSConfig()).resolve(n).n_tiles(n)  # divisibility check
    if a_local.is_cuda:
        return gemm_rs_cuda(a_local, b_local)[0]
    return gemm_rs_ref(a_local, b_local)


def gemm_rs_partials(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every rank's partial product in f32: (world, M, N)."""
    return torch.matmul(a.float(), b.float())


def gemm_rs_fold(partials: torch.Tensor, out_dtype: torch.dtype, *,
                 return_staging: bool = False):
    """The fold of the plain version, in the kernel's order and rounding
    (JAX :124-160), over every rank's f32 partials (world, M, N): rank d
    starts an f32 accumulator at 0 and adds, for src = 0 .. world - 1, its
    own partial of segment d in f32 or rank src's rounded to ``out_dtype``
    (the pushed tile), then casts once. Returns (world, M / world, N);
    ``return_staging`` also the (world, world - 1, m, N) pushes,
    ``staging[d][peer_slot(src, d)]``."""
    world, M, n = partials.shape
    m = M // world
    seg = partials.reshape(world, world, m, n)      # [src, dst]
    dev = partials.device
    out = torch.empty((world, m, n), dtype=out_dtype, device=dev)
    staging = torch.empty((world, max(world - 1, 1), m, n), dtype=out_dtype,
                          device=dev)
    for d in range(world):
        acc = torch.zeros((m, n), dtype=torch.float32, device=dev)
        for src in range(world):
            if src == d:
                acc = acc + seg[d, d]
            else:
                pushed = seg[src, d].to(out_dtype)
                staging[d, src - (src > d)] = pushed
                acc = acc + pushed.float()
        out[d] = acc.to(out_dtype)
    return (out, staging) if return_staging else out


def gemm_rs_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the multi-rank kernel: ``gemm_rs_fold`` of
    ``gemm_rs_partials``, in the promoted dtype."""
    return gemm_rs_fold(gemm_rs_partials(a, b),
                        torch.promote_types(a.dtype, b.dtype))


def rs_plan(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
            staging: torch.Tensor,
            own_shape) -> tuple[int, torch.Tensor | None]:
    """``(tma, own)`` of a GEMM-RS or GroupGEMM-RS launch, decided from the
    shapes and pointers before it: ``tma`` 1 for a bf16 call whose operands
    TMA can read and whose tiles leave as 16-byte vectors (k and N multiples
    of 8, every pointer 16-byte aligned: the ``wgmma`` items), else 0 (the
    ``gemm_tile.cuh`` items); ``own`` the f32 scratch of the owners'
    partials, ``own_shape``, or None where the ``wgmma`` items fold the
    owner's product in place (segments of whole 128-row tiles)."""
    tma = (_build.tma_rows((a.shape[-1], b.shape[-1]), a, b, out, staging)
           if a.dtype == torch.bfloat16 else 0)
    if tma and own_shape[-2] % TILE_M == 0:
        return tma, None
    return tma, torch.empty(own_shape, dtype=torch.float32, device=a.device)


def gemm_rs_cuda(a: torch.Tensor, b: torch.Tensor, *,
                 staging: torch.Tensor | None = None,
                 producer_delay_ns: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/gemm_rs.cu`` on the current stream: a (world, M, k),
    b (world, k, N), one dtype (f32 or bf16), contiguous. Returns ``(out,
    staging)``: out (world, M / world, N), staging (world, world - 1,
    M / world, N) the pushed partials as ``gemm_rs_fold`` gives them.
    ``staging`` (default: a new buffer) and ``producer_delay_ns`` (every
    product tile sleeps that long before it releases its flag) let a test
    poison the slots and hold the partials back. bf16 runs the ``wgmma``
    items where ``rs_plan`` says TMA can read every operand, the
    ``mma.sync`` tile otherwise, in the same one launch."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("gemm_rs_cuda takes two tensors on one CUDA device")
    if a.dtype != b.dtype:
        raise TypeError(f"gemm_rs operands differ in dtype: {a.dtype} vs "
                        f"{b.dtype}")
    code = _build.dtype_code(a)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm_rs_cuda takes row-major contiguous operands")
    world, M, k = a.shape
    n = b.shape[2]
    if world < 2 or tuple(b.shape[:2]) != (world, k) or M % world:
        raise ValueError(f"gemm_rs_cuda shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    m = M // world
    shape = (world, world - 1, m, n)
    if staging is None:
        staging = torch.empty(shape, dtype=a.dtype, device=a.device)
    elif (tuple(staging.shape) != shape or staging.dtype != a.dtype
          or staging.device != a.device or not staging.is_contiguous()):
        raise ValueError(f"staging must be a contiguous {shape} {a.dtype} "
                         f"tensor on {a.device}")
    tile = TILE_M if a.dtype == torch.bfloat16 else F32_TILE
    tiles = world * -(-M // tile) * -(-n // tile)
    flags = _signal.flags(a.device, "gemm_rs", tiles)
    ticket = torch.empty(1, dtype=torch.int32, device=a.device)
    out = torch.empty((world, m, n), dtype=a.dtype, device=a.device)
    tma, own = rs_plan(a, b, out, staging, (world, m, n))
    err = _build.lib().tdt_gemm_rs(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), staging.data_ptr(),
        None if own is None else own.data_ptr(), flags.data_ptr(),
        ticket.data_ptr(), _signal.next_epoch(a.device), world, M, k, n,
        code, tma, producer_delay_ns, _build.stream_ptr(a))
    _build.check(err, "tdt_gemm_rs")
    GEMM_RS.launches += 1
    return out, staging


def gemm_rs(a: torch.Tensor, b: torch.Tensor, *, world: int,
            config: GEMMRSConfig | None = None) -> torch.Tensor:
    """Standalone GEMM-RS over ``world`` simulated ranks (JAX :451): a
    global (M, K) sharded on K, b global (K, N) sharded on K; returns the
    global (M, N) = a @ b, sharded on M."""
    w = World(world)
    if world == 1:
        return gemm_rs_device(a, b)
    out = gemm_rs_device(w.split(a, 1), w.split(b, 0), world=world,
                         config=config)
    return w.join(out, 0)


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
                          segments: int,
                          staging: torch.Tensor | None = None,
                          producer_delay_ns: int = 0) -> torch.Tensor:
    """Launch ``csrc/gemm_rs_loopback.cu`` (bf16) on the current stream,
    one device operation: a persistent grid no larger than the card holds
    at once, every fold after the product tiles it waits on by an atomic
    ticket (the stream's persistent one, left at 0 by the kernel). The
    ``wgmma`` items where TMA can read every operand (``_build.tma_rows``),
    the ``mma.sync`` items otherwise. ``staging`` (segments - 1, m, N)
    (default: the stream's persistent workspace) and ``producer_delay_ns``
    (every product tile sleeps that long before it releases its flag) let
    a test poison the slots and hold the pushes back."""
    _check_bf16_cuda("gemm_rs_loopback_cuda", a, b)
    M, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k or segments < 1 or M % segments:
        raise ValueError(f"gemm_rs_loopback_cuda shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}, segments {segments}")
    m = M // segments
    dev, stream = a.device, _build.stream_ptr(a)
    shape = (max(segments - 1, 1), m, n)
    if staging is None:
        staging = _workspace("staging", shape, a.dtype, dev, stream)
    elif (tuple(staging.shape) != shape or staging.dtype != a.dtype
          or staging.device != dev or not staging.is_contiguous()):
        raise ValueError(f"staging must be a contiguous {shape} {a.dtype} "
                         f"tensor on {dev}")
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    tma = _build.tma_rows((k, n), a, b, out, staging) if k else 0
    own = (None if tma and m % TILE_M == 0 else
           _workspace("own", (m, n), torch.float32, dev, stream))
    tiles = segments * -(-m // TILE_M) * -(-n // TILE_N)
    flags = _signal.flags(dev, GEMM_RS_LOOPBACK.name, tiles, stream)
    ticket = _signal.arrivals(dev, GEMM_RS_LOOPBACK.name, 1, stream)
    err = _build.lib().tdt_gemm_rs_loopback(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), staging.data_ptr(),
        None if own is None else own.data_ptr(), flags.data_ptr(),
        ticket.data_ptr(), _signal.next_epoch(dev), segments, m, n, k,
        _build.dtype_code(a), tma, producer_delay_ns, stream)
    _build.check(err, "tdt_gemm_rs_loopback")
    GEMM_RS_LOOPBACK.launches += 1
    return out


def _workspace(part: str, shape, dtype, device, stream) -> torch.Tensor:
    """The loopback's persistent scratch ``part`` of ``shape`` on this
    stream (``runtime/symm.py`` ``get_scratch``): grown on demand, never
    zeroed (every element the kernel reads it wrote first in the call)."""
    numel = 1
    for d in shape:
        numel *= d
    ws = get_scratch(f"{GEMM_RS_LOOPBACK.name}:{part}", numel, dtype,
                     world=1, device=device, stream=stream)
    return ws.array[0, :numel].view(shape)


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
