"""AllGather layer: one object in front of every allgather variant.

Counterpart of ``triton_distributed_tpu/layers/allgather_layer.py``: the
layer owns a persistent LL staging workspace of its own and the epoch
counter, and dispatches ring, direct push or low latency per call, or by
message size (AUTO). At world > 1 the ranks are simulated on one card, so
``__call__`` takes every rank's shard stacked, ``(world, m, ...)``, and
returns every rank's gathered copy, ``(world, world * m, ...)``.
"""

from __future__ import annotations

import itertools

import torch

from triton_distributed_tpu_torch.kernels.allgather import (
    AllGatherMethod,
    a2a_all_gather,
    choose_all_gather_method,
    ring_all_gather,
)
from triton_distributed_tpu_torch.kernels.ll_allgather import (
    ll_all_gather_device,
    make_ll_staging,
)


def _ll_wins(world: int, nbytes: int, hw=None) -> bool:
    """LL against the best stateless method by the perf model (JAX :26):
    LL drops the entry barrier but pays the staging-to-output copy, so
    decode-size messages go LL and large ones to the ring or the push."""
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    ll = pm.est_ll_all_gather(nbytes, world, hw)
    best = min(pm.est_push_all_gather(nbytes, world, hw),
               pm.est_ring_all_gather(nbytes, world, hw))
    return ll <= best


_INSTANCES = itertools.count()


class AllGatherLayer:
    """Stateful per-shape allgather front end (JAX :41): the local shape and
    dtype of one rank's shard, and the world. Each instance has a staging
    of its own (two layers sharing one, with independent epoch counters,
    would corrupt each other's gathers), on the card unless ``device``
    names another."""

    def __init__(self, local_shape, dtype, *, world: int = 1,
                 axis: str = "tp", name: str | None = None, device=None):
        self.world = world
        self.axis = axis
        self.local_shape = tuple(local_shape)
        self.dtype = dtype
        if name is None:
            name = f"ag_layer#{next(_INSTANCES)}"
        self._ws = make_ll_staging(self.local_shape, dtype, world=world,
                                   axis=axis, name=name, device=device)
        self.epoch = 0

    def staging(self) -> torch.Tensor:
        """The persistent staging, (world, 2, world - 1, *local_shape): pass
        it to ``__call__`` for the LL method."""
        return self._ws.array

    def rebind_staging(self, staging: torch.Tensor) -> None:
        """Store the staging an LL call returned, for the next call."""
        self._ws.array = staging

    def next_epoch(self) -> int:
        e = self.epoch
        self.epoch += 1
        return e

    def __call__(self, x_local: torch.Tensor, *,
                 method: AllGatherMethod | str = AllGatherMethod.AUTO,
                 staging=None, epoch=None):
        """Allgather of the stacked shards. With ``staging`` the result is
        always ``(gathered, staging)`` (the stateless methods hand the
        staging back unchanged), without it the gathered tensor alone (JAX
        :88-97). An explicitly requested method is honoured; AUTO picks LL
        only with a staging and an epoch and when the perf model says it
        wins for one rank's bytes (by the figures of the card the tensor is
        on; a CPU tensor, which runs the plain versions, by the H100
        SXM's)."""
        from triton_distributed_tpu_torch.runtime import perf_model as pm

        method = AllGatherMethod(method)
        world = self.world
        nbytes = (x_local[0] if world > 1 else x_local).numel() * \
            x_local.element_size()
        hw = None if x_local.is_cuda else pm.H100_SXM
        if method is AllGatherMethod.AUTO:
            if (staging is not None and epoch is not None
                    and _ll_wins(world, nbytes, hw)):
                method = AllGatherMethod.LL
            else:
                method = choose_all_gather_method(world, nbytes, hw=hw)
        if method is AllGatherMethod.LL:
            if staging is None or epoch is None:
                raise ValueError("LL allgather needs staging + epoch "
                                 "(layer.staging() / layer.next_epoch())")
            return ll_all_gather_device(x_local, staging, epoch, world=world)
        if method is AllGatherMethod.RING_1D:
            out = ring_all_gather(x_local, world=world)
        elif method is AllGatherMethod.ALL2ALL:
            out = a2a_all_gather(x_local, world=world)
        else:  # RING_2D: JAX :134-137
            raise ValueError(
                f"AllGatherLayer spans one mesh axis; method {method.value!r} "
                f"is not supported here (use kernels.collective_2d for the "
                f"hierarchical 2D path)")
        return (out, staging) if staging is not None else out
