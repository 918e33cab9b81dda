"""Allgather: ring and direct push over simulated ranks.

Counterpart of ``triton_distributed_tpu/kernels/allgather.py``. At world 1
``ring_all_gather`` (:196) and ``a2a_all_gather`` (:207) return their input
(``_ag_call`` :163-164). At world > 1 the ranks are simulated on one card:
they take every rank's shard stacked, ``(world, m, ...)``, and return every
rank's gathered copy, ``(world, world * m, ...)`` (segment s of each copy
is rank s's shard), on ``csrc/ring_ag.cu`` (``_ring_ag_kernel`` :87: world
- 1 ring steps, each forwarding the chunk that arrived at the step before)
and ``csrc/a2a_ag.cu`` (``_a2a_ag_kernel`` :125: every rank pushes its
shard straight into every peer's output). Both compute one function, so
one plain version, ``all_gather_ref``, holds both. The host wrapper
``all_gather`` (:221) takes the stacked shards and returns the gathered
``(world * m, ...)``, by the method ``choose_all_gather_method`` (:62) picks
from the perf model. One card stands in for the group: the pushes go
through device memory, not NVLink. A call allocates only its output and
makes one device operation: the launch geometry is a plan cached per
stacked shape, dtype and device (``ag_plan``), and the ring's ticket and
flags are arrival cells (``_signal.arrivals``) that the kernel leaves at
0. The 2-D exchange (a ``dcn_axis``) is not ported and raises
``NotImplementedError``; ``method="ring_2d"`` without one raises JAX's
``ValueError``.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal
from triton_distributed_tpu_torch.kernels.allreduce import (
    _check_world,
    _stacked,
)

RING_AG = _build.register(
    "ring_ag", "triton_distributed_tpu_torch/csrc/ring_ag.cu",
    "triton_distributed_tpu/kernels/allgather.py:87")
A2A_AG = _build.register(
    "a2a_ag", "triton_distributed_tpu_torch/csrc/a2a_ag.cu",
    "triton_distributed_tpu/kernels/allgather.py:125")

# Bytes one work item of the direct push copies: a piece of one rank's
# shard.
PIECE_BYTES = 16384
# Bytes of one ring piece. The ring's time at a small shard is its world -
# 1 dependent hops, each copying one piece; smaller pieces put more chains
# in flight and make each hop's copy shorter, larger ones hand out fewer
# tickets. RING_PIECE_SMALL up to RING_SMALL_SHARD bytes a shard (a decode
# activation), RING_PIECE above it.
RING_PIECE_SMALL, RING_PIECE, RING_SMALL_SHARD = 16384, 65536, 1 << 20


class AllGatherMethod(enum.Enum):
    """The JAX method enum (:51): direct push, the 1-D ring, the 2-D ring
    over a dcn axis (not ported) and the low-latency allgather
    (``kernels/ll_allgather.py``)."""

    AUTO = "auto"
    ALL2ALL = "all2all"
    RING_1D = "ring_1d"
    RING_2D = "ring_2d"
    LL = "ll"


def choose_all_gather_method(world: int, nbytes: int, num_slices: int = 1,
                             *, hw=None) -> AllGatherMethod:
    """AUTO's rule (JAX :62-79): the 2-D ring across slices; direct push at
    world <= 2; else whichever the perf model (``runtime/perf_model.py``,
    this card's figures unless ``hw`` is given) estimates faster for one
    ``nbytes`` shard, the push on a tie."""
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    if num_slices > 1:
        return AllGatherMethod.RING_2D
    if world <= 2:
        return AllGatherMethod.ALL2ALL
    push = pm.est_push_all_gather(nbytes, world, hw)
    ring = pm.est_ring_all_gather(nbytes, world, hw)
    return AllGatherMethod.ALL2ALL if push <= ring else AllGatherMethod.RING_1D


def all_gather_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of both allgathers: ``x`` (world, m, ...) -> every
    rank's gathered copy (world, world m, ...), each the shards in rank
    order."""
    world = x.shape[0]
    flat = x.reshape(1, world * x.shape[1], *x.shape[2:])
    return flat.expand(world, *flat.shape[1:]).clone()


def ring_piece(seg: int) -> int:
    """Bytes of one piece of ``csrc/ring_ag.cu`` for a shard of ``seg``
    bytes."""
    return RING_PIECE_SMALL if seg <= RING_SMALL_SHARD else RING_PIECE


@dataclasses.dataclass(frozen=True)
class AGPlan:
    """The launch geometry of the two allgathers for one stacked shape and
    dtype on one device: the output's shape, the bytes of a shard, and the
    ring's piece, pieces a shard, persistent grid (one occupancy query)
    and flags (world x (world - 2) x pieces: steps 0 .. world - 3 raise
    one a piece, the last step none). The direct push keeps its own
    ``PIECE_BYTES`` and grid (``csrc/a2a_ag.cu``)."""

    out_shape: tuple
    seg: int
    piece: int
    n_pieces: int
    blocks: int
    n_flags: int


_AG_PLANS: dict[tuple, AGPlan] = {}


def ag_plan(x: torch.Tensor) -> AGPlan:
    """The cached plan of a call on ``x`` (world, m, ...), made on first
    use: the checks of the shape and one occupancy query."""
    key = (x.shape, x.dtype, x.device)
    plan = _AG_PLANS.get(key)
    if plan is None:
        world = x.shape[0]
        _stacked("all_gather_cuda", x, world)
        if world < 2:
            raise ValueError("the allgather kernels take world >= 2 shards")
        seg = x[0].numel() * x.element_size()
        piece = ring_piece(seg)
        n_pieces = -(-seg // piece)
        blocks = _build.persistent_blocks("tdt_ring_ag_blocks", x.device,
                                          world, n_pieces)
        plan = _AG_PLANS[key] = AGPlan(
            (world, world * x.shape[1], *x.shape[2:]), seg, piece, n_pieces,
            blocks, world * (world - 2) * n_pieces)
    return plan


def _ag_cuda(name: str, kernel: _build.Kernel, x: torch.Tensor, out,
             producer_delay_ns: int) -> torch.Tensor:
    """Launch one of the two allgather kernels on the current stream: the
    cached plan, the output, the stream and (for the ring) its arrival
    cells, then one ``ctypes`` call."""
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous CUDA tensor of world "
                         f">= 2 shards")
    plan = ag_plan(x)
    if out is None:
        out = torch.empty(plan.out_shape, dtype=x.dtype, device=x.device)
    elif (out.shape != plan.out_shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {plan.out_shape} "
                         f"{x.dtype} tensor on {x.device}")
    stream = _build.stream_ptr(x)
    if kernel is RING_AG:
        # Cell 0 the ticket, cells 1 .. the flags.
        cells = _signal.arrivals(x.device, kernel.name, 1 + plan.n_flags,
                                 stream).data_ptr()
        err = _build.lib().tdt_ring_ag(
            x.data_ptr(), out.data_ptr(), cells + 4, cells, x.shape[0],
            plan.seg, plan.piece, plan.n_pieces, plan.blocks,
            producer_delay_ns, stream)
        _build.check(err, "tdt_ring_ag")
    else:
        err = _build.lib().tdt_a2a_ag(x.data_ptr(), out.data_ptr(),
                                      x.shape[0], plan.seg, PIECE_BYTES,
                                      producer_delay_ns, stream)
        _build.check(err, "tdt_a2a_ag")
    kernel.launches += 1
    return out


def ring_all_gather_cuda(x: torch.Tensor, *, out=None,
                         producer_delay_ns: int = 0) -> torch.Tensor:
    """Launch ``csrc/ring_ag.cu`` on the current stream: ``x`` (world, m,
    ...) contiguous, any dtype. Returns every rank's gathered copy (world,
    world m, ...). ``out`` (default: a new buffer) and ``producer_delay_ns``
    (the ring's first pushes and the own copies sleep that long) let a test
    poison the output and hold the ring back; the result must not change."""
    return _ag_cuda("ring_all_gather_cuda", RING_AG, x, out,
                    producer_delay_ns)


def a2a_all_gather_cuda(x: torch.Tensor, *, out=None,
                        producer_delay_ns: int = 0) -> torch.Tensor:
    """Launch ``csrc/a2a_ag.cu`` on the current stream, with
    ``ring_all_gather_cuda``'s contract (every push sleeps
    ``producer_delay_ns``)."""
    return _ag_cuda("a2a_all_gather_cuda", A2A_AG, x, out, producer_delay_ns)


def _ag(name: str, cuda, x_local: torch.Tensor, world: int) -> torch.Tensor:
    _check_world(world)
    if world == 1:
        return x_local
    _stacked(name, x_local, world)
    if x_local.is_cuda:
        return cuda(x_local.contiguous())
    return all_gather_ref(x_local)


def ring_all_gather(x_local: torch.Tensor, *, world: int = 1) -> torch.Tensor:
    """Bandwidth-optimal ring allgather (JAX :196). At world 1 ``x_local``
    is returned as is; at world > 1 it is every rank's shard stacked,
    (world, m, ...), and the result every rank's gathered copy, (world,
    world m, ...): the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    return _ag("ring_all_gather", ring_all_gather_cuda, x_local, world)


def a2a_all_gather(x_local: torch.Tensor, *, world: int = 1) -> torch.Tensor:
    """Latency-optimal direct-push allgather (JAX :207), stacked in and out
    as ``ring_all_gather``."""
    return _ag("a2a_all_gather", a2a_all_gather_cuda, x_local, world)


def all_gather(x_stacked: torch.Tensor, *, world: int,
               method: AllGatherMethod | str = AllGatherMethod.AUTO,
               dcn_axis: str | None = None) -> torch.Tensor:
    """Standalone allgather (JAX :221): ``x_stacked`` (world, m, ...), rank
    r's shard at index r; returns the gathered (world m, ...), rank 0's
    copy (every rank's holds the same bits). AUTO asks
    ``choose_all_gather_method`` with one rank's bytes, by the figures of
    the card the tensor is on (a CPU tensor, which runs the plain version,
    by the H100 SXM's). Every method but the ring runs the direct push,
    ``"ll"`` too, as JAX's ``_build_ag`` does (the LL kernel needs a
    persistent staging: ``kernels.ll_allgather``). ``"ring_2d"`` without a
    ``dcn_axis`` raises JAX's ``ValueError``; a ``dcn_axis`` (the 2-D
    exchange) raises ``NotImplementedError``: its inter-slice leg cannot be
    checked on one card."""
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    if x_stacked.dim() < 2 or x_stacked.shape[0] != world:
        raise ValueError(f"all_gather at world {world} takes every rank's "
                         f"shard stacked, (world, m, ...), got "
                         f"{tuple(x_stacked.shape)}")
    method = AllGatherMethod(method)
    if dcn_axis is not None:
        raise NotImplementedError("the 2-D allgather (ring_2d over a dcn "
                                  "axis) is not ported: see ROADMAP.md")
    if method is AllGatherMethod.RING_2D:
        raise ValueError("method ring_2d needs dcn_axis (a (dcn, ici) "
                         "mesh; see runtime.mesh.make_2d_mesh)")
    if method is AllGatherMethod.AUTO:
        method = choose_all_gather_method(
            world, x_stacked[0].numel() * x_stacked.element_size(),
            hw=None if x_stacked.is_cuda else pm.H100_SXM)
    # Every method but the ring runs the direct push, LL too (JAX :267-273).
    run = ring_all_gather if method is AllGatherMethod.RING_1D else \
        a2a_all_gather
    out = run(x_stacked, world=world)
    return out[0] if world > 1 else out.reshape(-1, *x_stacked.shape[2:])
