"""All-reduce at world 1, and the one-chip one-shot all-reduce loopback.

Counterpart of ``triton_distributed_tpu/kernels/allreduce.py``. At world 1
``oneshot_all_reduce`` (:109) and ``twoshot_all_reduce`` (:253) are the
identity (:115-116, :257-258), which is all ``mode="ar"`` needs on one
card; the multi-rank kernels (``_oneshot_ar_kernel`` :74,
``_twoshot_ar_kernel`` :209) are not ported yet. ``oneshot_ar_loopback``
(:174) runs on ``csrc/oneshot_ar_loopback.cu``: world - 1 simulated peers
push this card's buffer into staging slots, each chunk flagged when it
lands, and a fixed-order f32 fold returns ``world * x``. It prices the
all-reduce machinery beside the small-M GEMMs of the ar mode (``bench.py``'s
M = 128 arm).
"""

from __future__ import annotations

import enum

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal

ONESHOT_AR_LOOPBACK = _build.register(
    "oneshot_ar_loopback",
    "triton_distributed_tpu_torch/csrc/oneshot_ar_loopback.cu",
    "triton_distributed_tpu/kernels/allreduce.py:158")

# Bytes of x one producer item pushes (whole rows, at least one): at
# bench.py's (128, 5,120) bf16 one row, so world 8 gives 896 pushes and 128
# folds, about one wave of resident blocks.
CHUNK_BYTES = 16384


class AllReduceMethod(enum.Enum):
    """The JAX method enum (:44): one-shot (push to every peer, reduce
    locally) and two-shot (ring reduce-scatter + all-gather)."""

    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"


def _multi_rank(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} at world > 1 (the multi-rank all-reduce kernels) is not "
        f"ported yet: ROADMAP.md Queue 1 item 11 / Queue 2 row 14")


def oneshot_all_reduce(x_local: torch.Tensor, *,
                       world: int = 1) -> torch.Tensor:
    """Latency-optimal all-reduce of ``x_local`` (m, ...) over ``world``
    ranks. At world 1 it is the identity (JAX :115)."""
    if world == 1:
        return x_local
    raise _multi_rank("oneshot_all_reduce")


def twoshot_all_reduce(x_local: torch.Tensor, *,
                       world: int = 1) -> torch.Tensor:
    """Bandwidth-optimal all-reduce (ring RS + ring AG). At world 1 it is
    the identity (JAX :257)."""
    if world == 1:
        return x_local
    raise _multi_rank("twoshot_all_reduce")


def _check_world(world: int) -> None:
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")


def oneshot_ar_loopback_ref(x: torch.Tensor, *,
                            world: int = 8) -> torch.Tensor:
    """Plain version, in the kernel's order and rounding: the own buffer in
    f32, then ``+=`` each of the world - 1 staged copies in rank order, then
    one cast (``common.reduce_slots_tiled`` with me = 0)."""
    _check_world(world)
    own = x.float()
    acc = own.clone()
    for _ in range(world - 1):
        acc += own
    return acc.to(x.dtype)


def oneshot_ar_loopback_cuda(x: torch.Tensor, *, world: int = 8,
                             staging: torch.Tensor | None = None,
                             producer_delay_ns: int = 0) -> torch.Tensor:
    """Launch ``csrc/oneshot_ar_loopback.cu`` on the current stream (f32 or
    bf16, any trailing shape). ``staging`` (default: a new buffer of shape
    (world - 1, *x.shape), discarded) and ``producer_delay_ns`` (every
    producer item sleeps that long before its copy) let a test poison the
    slots and hold the pushes back; the result must not change."""
    _check_world(world)
    if not x.is_cuda:
        raise ValueError("oneshot_ar_loopback_cuda takes a CUDA tensor")
    code = _build.dtype_code(x)
    if not x.is_contiguous() or x.dim() < 1 or x.numel() == 0:
        raise ValueError("oneshot_ar_loopback_cuda takes a contiguous, "
                         f"non-empty (m, ...) tensor, got {tuple(x.shape)}")
    shape = (world - 1, *x.shape)
    if staging is None:
        staging = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif (tuple(staging.shape) != shape or staging.dtype != x.dtype
          or staging.device != x.device or not staging.is_contiguous()):
        raise ValueError(f"staging must be a contiguous {shape} "
                         f"{x.dtype} tensor on {x.device}")
    n = x.numel()
    row = n // x.shape[0]
    chunk = max(1, CHUNK_BYTES // (row * x.element_size())) * row
    n_chunks = -(-n // chunk)
    flags = _signal.flags(x.device, "oneshot_ar_loopback",
                          n_chunks * (world - 1))
    ticket = torch.empty(1, dtype=torch.int32, device=x.device)
    out = torch.empty_like(x)
    err = _build.lib().tdt_oneshot_ar_loopback(
        x.data_ptr(), staging.data_ptr() if world > 1 else None,
        out.data_ptr(), flags.data_ptr(), ticket.data_ptr(),
        _signal.next_epoch(x.device), n, chunk, world, code,
        producer_delay_ns, _build.stream_ptr(x))
    _build.check(err, "tdt_oneshot_ar_loopback")
    ONESHOT_AR_LOOPBACK.launches += 1
    return out


def oneshot_ar_loopback(x: torch.Tensor, *, world: int = 8) -> torch.Tensor:
    """One-chip SELF-LOOPBACK one-shot all-reduce (JAX :174): the staging
    pushes, per-source arrival waits and fixed-order f32 fold of
    ``oneshot_all_reduce``, with every slot carrying this card's own buffer,
    so the result is ``world * x``. A CUDA tensor runs the kernel, a CPU
    tensor the plain version."""
    if x.is_cuda:
        return oneshot_ar_loopback_cuda(x, world=world)
    return oneshot_ar_loopback_ref(x, world=world)
