"""Low-latency allgather into persistent double-buffered staging.

Counterpart of ``triton_distributed_tpu/kernels/ll_allgather.py``. At world
1 ``ll_all_gather_device`` (:98) returns its input and the staging
(:107-108). At world > 1 the ranks are simulated on one card: it takes
every rank's shard stacked, ``(world, m, ...)``, the staging ``(world, 2,
world - 1, m, ...)`` (``make_ll_staging``, a ``runtime/symm.py``
workspace) and the call's epoch, and returns every rank's gathered copy
``(world, world * m, ...)`` and the staging, on ``csrc/ll_allgather.cu``
(``_ll_ag_kernel`` :55): epoch parity p picks the staging half, every rank
pushes its shard into slot ``peer_slot(me, peer)`` of every peer's half p,
its own shard goes straight to its output, and each rank copies every
arrived slot into the output segment of its source. The staging is
updated in place (JAX aliases it input to output); the other half is
never read or written. The host ``ll_all_gather`` (:153) rebinds the
workspace and returns the gathered ``(world * m, ...)``. The 2-D variant
(``ll_all_gather_2d_device``) is not ported and raises.

The epoch is an operand, a Python int or a 0-d int32 tensor on the card
that the kernel reads there, so a captured graph can advance it without
the host. No flag of an earlier call can satisfy a wait of a later one,
whatever the caller does with the epoch: every consumer item resets the
flag it waited on after its copy, so every call ends with its flags at 0.

A call allocates only the output it returns and makes one device
operation, the launch: the launch geometry is a plan cached per stacked
shape, dtype and device (``ll_plan``), and the flags and the ticket are
persistent per-stream buffers (``_signal``) that the kernel leaves at 0.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal
from triton_distributed_tpu_torch.kernels.allgather import (
    PIECE_BYTES,
    all_gather_ref,
)
from triton_distributed_tpu_torch.kernels.allreduce import (
    _check_world,
    _stacked,
)
from triton_distributed_tpu_torch.runtime import symm

LL_AG = _build.register(
    "ll_allgather", "triton_distributed_tpu_torch/csrc/ll_allgather.cu",
    "triton_distributed_tpu/kernels/ll_allgather.py:55")


def _check_staging(name: str, x: torch.Tensor, staging: torch.Tensor):
    world = x.shape[0]
    shape = (world, 2, world - 1, *x.shape[1:])
    if (tuple(staging.shape) != shape or staging.dtype != x.dtype
            or staging.device != x.device):
        raise ValueError(f"{name}: staging must be a {shape} {x.dtype} "
                         f"tensor on {x.device} (make_ll_staging), got "
                         f"{tuple(staging.shape)} {staging.dtype} on "
                         f"{staging.device}")


def ll_all_gather_ref(x: torch.Tensor, staging: torch.Tensor, epoch):
    """Plain version: writes slot ``peer_slot(src, dst) = src - (src >
    dst)`` of every rank dst's half ``epoch % 2`` of ``staging`` with
    ``x[src]``, in place, and returns (every rank's gathered copy (world,
    world m, ...), staging)."""
    world = x.shape[0]
    _check_staging("ll_all_gather_ref", x, staging)
    p = int(epoch) % 2
    for dst in range(world):
        srcs = [s for s in range(world) if s != dst]
        staging[dst, p] = x[srcs]
    return all_gather_ref(x), staging


@dataclasses.dataclass(frozen=True)
class LLPlan:
    """The launch geometry of ``ll_all_gather_cuda`` for one stacked shape
    and dtype on one device: the output's and the staging's shapes, the
    bytes and pieces of a shard, the persistent grid's block count, and the
    flags a call raises and lowers."""

    out_shape: tuple
    staging_shape: tuple
    seg: int
    n_pieces: int
    blocks: int
    n_flags: int


_LL_PLANS: dict[tuple, LLPlan] = {}


def ll_plan(x: torch.Tensor) -> LLPlan:
    """The cached plan of a call on ``x`` (world, m, ...) (made on first
    use: the checks of the shape and one occupancy query)."""
    key = (x.shape, x.dtype, x.device)
    plan = _LL_PLANS.get(key)
    if plan is None:
        world = x.shape[0]
        _stacked("ll_all_gather_cuda", x, world)
        if world < 2 or not x.is_cuda:
            raise ValueError("ll_all_gather_cuda takes a CUDA tensor of "
                             "world >= 2 shards")
        seg = x[0].numel() * x.element_size()
        n_pieces = -(-seg // PIECE_BYTES)
        blocks = _build.persistent_blocks("tdt_ll_allgather_blocks",
                                          x.device, world, n_pieces)
        plan = LLPlan((world, world * x.shape[1], *x.shape[2:]),
                      (world, 2, world - 1, *x.shape[1:]), seg, n_pieces,
                      blocks, world * 2 * (world - 1) * n_pieces)
        _LL_PLANS[key] = plan
    return plan


def ll_all_gather_cuda(x: torch.Tensor, staging: torch.Tensor, epoch, *,
                       out=None, producer_delay_ns: int = 0):
    """Launch ``csrc/ll_allgather.cu`` on the current stream: ``x`` (world,
    m, ...) contiguous, any dtype; ``staging`` (world, 2, world - 1, m,
    ...) contiguous, written in place; ``epoch`` an int or a 0-d int32
    tensor on x's card. Returns (out (world, world m, ...), staging).
    ``out`` (default: a new buffer) and ``producer_delay_ns`` (every push
    sleeps that long) let a test poison the output and hold the pushes
    back; the result must not change."""
    plan = ll_plan(x)
    dev = x.device
    if not x.is_contiguous():
        raise ValueError("ll_all_gather_cuda takes a contiguous x")
    if (staging.shape != plan.staging_shape or staging.dtype != x.dtype
            or staging.device != dev or not staging.is_contiguous()):
        raise ValueError(f"ll_all_gather_cuda: staging must be a contiguous "
                         f"{plan.staging_shape} {x.dtype} tensor on {dev} "
                         f"(make_ll_staging), got {tuple(staging.shape)} "
                         f"{staging.dtype} on {staging.device}")
    epoch_ptr, epoch_val = None, 0
    if isinstance(epoch, torch.Tensor):
        if (epoch.numel() != 1 or epoch.dtype != torch.int32
                or epoch.device != dev):
            raise ValueError(f"ll_all_gather_cuda: a tensor epoch must be "
                             f"one int32 on {dev}")
        epoch_ptr = epoch.data_ptr()
    else:
        epoch_val = int(epoch)
    if out is None:
        out = torch.empty(plan.out_shape, dtype=x.dtype, device=dev)
    elif (out.shape != plan.out_shape or out.dtype != x.dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {plan.out_shape} "
                         f"{x.dtype} tensor on {dev}")
    stream = _build.stream_ptr(x)
    flags = _signal.flags(dev, LL_AG.name, plan.n_flags, stream)
    ticket = _signal.arrivals(dev, LL_AG.name, 1, stream)
    err = _build.lib().tdt_ll_allgather(
        x.data_ptr(), staging.data_ptr(), out.data_ptr(), flags.data_ptr(),
        ticket.data_ptr(), epoch_ptr, epoch_val, x.shape[0], plan.seg,
        PIECE_BYTES, plan.n_pieces, plan.blocks, producer_delay_ns, stream)
    _build.check(err, "tdt_ll_allgather")
    LL_AG.launches += 1
    return out, staging


def ll_all_gather_device(x_local: torch.Tensor, staging: torch.Tensor,
                         epoch, *, world: int = 1):
    """Low-latency allgather (JAX :98). At world 1 returns ``(x_local,
    staging)``. At world > 1 ``x_local`` is every rank's shard stacked,
    (world, m, ...), ``staging`` the (world, 2, world - 1, m, ...)
    workspace and ``epoch`` the call counter (int or 0-d int32 tensor);
    returns (every rank's gathered copy (world, world m, ...), staging):
    the kernel on CUDA tensors, the plain version on CPU ones. Thread the
    returned staging (the same tensor) into the next call."""
    _check_world(world)
    if world == 1:
        return x_local, staging
    _stacked("ll_all_gather_device", x_local, world)
    if x_local.is_cuda:
        return ll_all_gather_cuda(x_local.contiguous(), staging, epoch)
    return ll_all_gather_ref(x_local, staging, epoch)


def make_ll_staging(local_shape, dtype, *, world: int, axis: str = "tp",
                    name: str = "ll_ag",
                    device=None) -> symm.SymmetricWorkspace:
    """The persistent double-buffered staging of ``ll_all_gather`` (JAX
    :139): a workspace of per-rank shape (2, world - 1, *local_shape), two
    epoch-parity halves of world - 1 source slots, on the card unless
    ``device`` names another."""
    return symm.get_workspace(
        name, (2, max(world - 1, 1), *tuple(local_shape)), dtype,
        world=world, axis=axis, device=device)


def ll_all_gather(x_stacked: torch.Tensor,
                  staging_ws: symm.SymmetricWorkspace, epoch, *,
                  world: int) -> torch.Tensor:
    """Stacked-convention LL allgather (JAX :153): ``x_stacked`` (world,
    m, ...) -> the gathered (world m, ...), rank 0's copy (every rank's
    holds the same bits). Rebinds ``staging_ws.array`` to the returned
    staging, so successive calls reuse one buffer."""
    out, staging_ws.array = ll_all_gather_device(
        x_stacked, staging_ws.array, epoch, world=world)
    return out[0] if world > 1 else out.reshape(-1, *x_stacked.shape[2:])


def ll_all_gather_2d_device(*args, **kwargs):
    """JAX :220: the LL allgather within a slice and one collective across
    slices. Not ported: the inter-slice leg needs NCCL across cards (see
    ROADMAP.md)."""
    raise NotImplementedError("ll_all_gather_2d_device (the 2-D LL "
                              "allgather over a dcn axis) is not ported: "
                              "see ROADMAP.md")
