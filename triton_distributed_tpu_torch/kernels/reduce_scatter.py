"""Reduce-scatter: one-shot and ring over simulated ranks.

Counterpart of ``triton_distributed_tpu/kernels/reduce_scatter.py``. At
world 1 ``oneshot_reduce_scatter`` (:193) and ``ring_reduce_scatter``
(:203) return their input (``_rs_call`` :138-139). At world > 1 the ranks
are simulated on one card: they take every rank's contribution stacked,
``(world, world * m, ...)``, and return every rank's segment of the sum,
``(world, m, ...)`` (rank r's at index r), on ``csrc/oneshot_rs.cu``
(``_oneshot_rs_kernel`` :49: every rank pushes each foreign segment into
its owner's staging slot, and each owner folds the world terms in rank
order) and ``csrc/ring_rs.cu`` (``_ring_rs_kernel`` :90: world - 1 ring
hops of add-and-forward, each rounding to x's dtype). The host wrapper
``reduce_scatter`` (:217) takes the stacked contributions and returns the
global ``(world * m, ...)``, by the method the perf model picks (:243-247).
One card stands in for the group: the pushes go through device memory, not
NVLink. The 2-D exchange (``method="ring_2d"``, a ``dcn_axis``) is not
ported and raises.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal
from triton_distributed_tpu_torch.kernels.allreduce import (
    _check_world,
    _chunk,
    _stacked,
    oneshot_all_reduce_ref,
    twoshot_all_reduce_ref,
)

ONESHOT_RS = _build.register(
    "oneshot_rs", "triton_distributed_tpu_torch/csrc/oneshot_rs.cu",
    "triton_distributed_tpu/kernels/reduce_scatter.py:49")
RING_RS = _build.register(
    "ring_rs", "triton_distributed_tpu_torch/csrc/ring_rs.cu",
    "triton_distributed_tpu/kernels/reduce_scatter.py:90")

METHODS = ("oneshot", "ring")


def _segment_rows(name: str, x: torch.Tensor, world: int) -> int:
    """Rows of one segment; JAX's ``ValueError`` when the leading dim does
    not split into ``world`` segments (:140-141)."""
    _stacked(name, x, world)
    if x.shape[1] % world:
        raise ValueError(f"leading dim {x.shape[1]} not divisible by world "
                         f"{world}")
    return x.shape[1] // world


def oneshot_reduce_scatter_ref(x: torch.Tensor, *,
                               return_staging: bool = False):
    """Plain version of the one-shot reduce-scatter, in the kernel's order
    and rounding (``common.reduce_slots_tiled``): segment d of the f32 sum
    ``x[0] + x[1] + ...`` in rank order, cast once. Returns (world, m,
    ...); ``return_staging`` also the (world, world - 1, m, ...) pushes,
    ``staging[d][peer_slot(src, d)]`` = segment d of ``x[src]``."""
    world = x.shape[0]
    m = _segment_rows("oneshot_reduce_scatter_ref", x, world)
    out = oneshot_all_reduce_ref(x)[0].reshape(world, m, *x.shape[2:])
    if not return_staging:
        return out
    seg = x.reshape(world, world, m, *x.shape[2:])        # [src, owner]
    staging = torch.stack([seg[[s for s in range(world) if s != d], d]
                           for d in range(world)])
    return out, staging


def ring_reduce_scatter_ref(x: torch.Tensor, *,
                            return_staging: bool = False):
    """Plain version of the ring reduce-scatter, step by step in the
    kernel's order and rounding: the reduce-scatter leg of
    ``twoshot_all_reduce_ref``, which runs the same ring (at step s rank r
    adds its chunk (r - s - 1) mod world to what its left neighbour pushed,
    in f32, rounds and pushes it right; then its own chunk). Returns
    (world, m, ...), rank r's chunk r; ``return_staging`` also the ring's
    (world, world - 1, m, ...) pushes, ``staging[r][s]`` what rank r
    received at step s."""
    world = x.shape[0]
    m = _segment_rows("ring_reduce_scatter_ref", x, world)
    full, staging = twoshot_all_reduce_ref(x, return_staging=True)
    out = full[0].reshape(world, m, *x.shape[2:])
    return (out, staging) if return_staging else out


def _rs_cuda(name: str, fn: str, kernel: _build.Kernel, x: torch.Tensor,
             staging, producer_delay_ns: int):
    """Launch one of the two reduce-scatter kernels on the current
    stream."""
    world = x.shape[0]
    m = _segment_rows(name, x, world)
    if world < 2 or not x.is_cuda:
        raise ValueError(f"{name} takes a CUDA tensor of world >= 2 "
                         f"contributions")
    code = _build.dtype_code(x)
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous x")
    shape = (world, world - 1, m, *x.shape[2:])
    if staging is None:
        staging = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif (tuple(staging.shape) != shape or staging.dtype != x.dtype
          or staging.device != x.device or not staging.is_contiguous()):
        raise ValueError(f"staging must be a contiguous {shape} {x.dtype} "
                         f"tensor on {x.device}")
    n = x[0].numel() // world                  # elements of one segment
    chunk = _chunk(n, n // m, x.element_size())
    flags = _signal.flags(x.device, kernel.name,
                          world * (world - 1) * -(-n // chunk))
    ticket = torch.empty(1, dtype=torch.int32, device=x.device)
    out = torch.empty((world, m, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    err = getattr(_build.lib(), fn)(
        x.data_ptr(), staging.data_ptr(), out.data_ptr(), flags.data_ptr(),
        ticket.data_ptr(), _signal.next_epoch(x.device), world, n, chunk,
        code, producer_delay_ns, _build.stream_ptr(x))
    _build.check(err, fn)
    kernel.launches += 1
    return out, staging


def oneshot_reduce_scatter_cuda(x: torch.Tensor, *, staging=None,
                                producer_delay_ns: int = 0
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/oneshot_rs.cu`` on the current stream: ``x`` (world,
    world m, ...) f32 or bf16, contiguous. Returns ``(out, staging)``: out
    (world, m, ...), staging (world, world - 1, m, ...) every pushed
    segment as ``oneshot_reduce_scatter_ref`` gives them. ``staging``
    (default: a new buffer) and ``producer_delay_ns`` (every producer item
    sleeps that long before its copy) let a test poison the slots and hold
    the pushes back; the result must not change."""
    return _rs_cuda("oneshot_reduce_scatter_cuda", "tdt_oneshot_rs",
                    ONESHOT_RS, x, staging, producer_delay_ns)


def ring_reduce_scatter_cuda(x: torch.Tensor, *, staging=None,
                             producer_delay_ns: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ring_rs.cu`` on the current stream: ``x`` (world,
    world m, ...) f32 or bf16, contiguous. Returns ``(out, staging)``,
    staging (world, world - 1, m, ...) the ring's pushes as
    ``ring_reduce_scatter_ref`` gives them. ``staging`` and
    ``producer_delay_ns`` (the ring's first pushes sleep that long) let a
    test poison the slots and hold the ring back."""
    return _rs_cuda("ring_reduce_scatter_cuda", "tdt_ring_rs", RING_RS, x,
                    staging, producer_delay_ns)


def oneshot_reduce_scatter(x_local: torch.Tensor, *,
                           world: int = 1) -> torch.Tensor:
    """Scatter + local-reduce reduce-scatter (JAX :193). At world 1
    ``x_local`` is returned as is (JAX :138). At world > 1 ``x_local`` is
    every rank's contribution stacked, (world, world m, ...), and the
    result every rank's segment of the sum, (world, m, ...): the kernel on
    a CUDA tensor, the plain version on a CPU one. JAX's ``ValueError``
    when world m does not split."""
    _check_world(world)
    if world == 1:
        return x_local
    _segment_rows("oneshot_reduce_scatter", x_local, world)
    if x_local.is_cuda:
        return oneshot_reduce_scatter_cuda(x_local)[0]
    return oneshot_reduce_scatter_ref(x_local)


def ring_reduce_scatter(x_local: torch.Tensor, *,
                        world: int = 1) -> torch.Tensor:
    """Bandwidth-optimal ring reduce-scatter (JAX :203), stacked in and out
    as ``oneshot_reduce_scatter``."""
    _check_world(world)
    if world == 1:
        return x_local
    _segment_rows("ring_reduce_scatter", x_local, world)
    if x_local.is_cuda:
        return ring_reduce_scatter_cuda(x_local)[0]
    return ring_reduce_scatter_ref(x_local)


def choose_reduce_scatter_method(world: int, per_dev_nbytes: int, *,
                                 hw=None) -> str:
    """AUTO's rule (JAX :243-247): one-shot when the perf model
    (``runtime/perf_model.py``, this card's figures unless ``hw`` is given)
    estimates it no slower than the ring for one rank's contribution of
    ``per_dev_nbytes``, else the ring."""
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    one = pm.est_oneshot_reduce_scatter(per_dev_nbytes, world, hw)
    ring = pm.est_ring_reduce_scatter(per_dev_nbytes, world, hw)
    return "oneshot" if one <= ring else "ring"


def reduce_scatter(x_stacked: torch.Tensor, *, world: int,
                   method: str = "auto",
                   dcn_axis: str | None = None) -> torch.Tensor:
    """Standalone reduce-scatter (JAX :217): ``x_stacked`` (world, world m,
    ...), rank r's contribution at index r; returns the global (world m,
    ...) whose segment r is the sum of every rank's segment r. AUTO asks
    ``choose_reduce_scatter_method`` with one rank's bytes, by the figures
    of the card the tensor is on (a CPU tensor, which runs the plain
    versions, by the H100 SXM's, the card the kernels are built for). The
    2-D exchange (``method="ring_2d"``, a ``dcn_axis``) raises
    ``NotImplementedError``: its inter-slice leg cannot be checked on one
    card."""
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    if x_stacked.dim() < 2 or x_stacked.shape[0] != world:
        raise ValueError(f"reduce_scatter at world {world} takes every "
                         f"rank's contribution stacked, (world, world * m, "
                         f"...), got {tuple(x_stacked.shape)}")
    if dcn_axis is not None or method == "ring_2d":
        raise NotImplementedError("the 2-D reduce-scatter (ring_2d over a "
                                  "dcn axis) is not ported")
    if method == "auto":
        method = choose_reduce_scatter_method(
            world, x_stacked[0].numel() * x_stacked.element_size(),
            hw=None if x_stacked.is_cuda else pm.H100_SXM)
    if method not in METHODS:
        raise ValueError(f"unknown reduce_scatter method {method!r}: "
                         f"expected 'auto', 'oneshot', 'ring', or 'ring_2d'")
    run = oneshot_reduce_scatter if method == "oneshot" else \
        ring_reduce_scatter
    return run(x_stacked, world=world).reshape(x_stacked.shape[1:])
