"""Persistent workspaces: what the LL allgather needs of the symmetric heap.

Counterpart of ``triton_distributed_tpu/runtime/symm.py`` (:34-85). There
a workspace is one array sharded over a mesh axis, each device owning an
identically laid out block that peers address by device id. Here the
ranks are simulated on one card, so a workspace is one tensor of shape
``(world, *local_shape)``, rank r's block at index r, allocated once per
key and reused: the LL allgather's staging must outlive every call, since
peers push into it without an entry barrier. A scratch workspace
(``get_scratch``) is the same kind of buffer for data that no call reads
back from an earlier one (the one-shot all-reduce's staging): one per
stream, grown to the largest call, so that a call allocates none.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass
class SymmetricWorkspace:
    """A persistent rank-stacked buffer ``array[world, *local_shape]``,
    rank r owning block ``[r]``."""

    name: str
    array: torch.Tensor
    axis: str
    # Views of ``array`` its users keep by a key of theirs (shapes), so
    # that they die with it.
    views: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(self.array.shape[1:])

    def zero(self) -> "SymmetricWorkspace":
        self.array.zero_()
        return self


_REGISTRY: dict[tuple, SymmetricWorkspace] = {}


def get_workspace(name: str, local_shape, dtype, *, world: int,
                  axis: str = "tp", zero: bool = False,
                  device=None) -> SymmetricWorkspace:
    """Get or create the workspace of this key: a zeroed ``(world,
    *local_shape)`` tensor on ``device`` (the card unless named). The same
    key returns the same object; ``zero`` zeroes an existing one."""
    dev = resolve_device(device)
    key = (name, world, tuple(local_shape), dtype, axis, dev)
    ws = _REGISTRY.get(key)
    if ws is None:
        ws = SymmetricWorkspace(
            name, torch.zeros((world, *local_shape), dtype=dtype, device=dev),
            axis)
        _REGISTRY[key] = ws
    elif zero:
        ws.zero()
    return ws


_SCRATCH: dict[tuple, SymmetricWorkspace] = {}


def get_scratch(name: str, numel: int, dtype, *, world: int, device=None,
                stream: int = 0, axis: str = "tp") -> SymmetricWorkspace:
    """The persistent scratch workspace of this key and stream: a
    ``(world, cap)`` tensor with ``cap >= numel`` elements a rank, contents
    unspecified. A call that needs more than ``cap`` replaces it with one
    of ``numel`` (the old one's memory returns to the allocator once no
    caller holds it), so the workspace holds the largest call's size.
    Calls on one stream run in order, so they may share it; another stream
    gets its own."""
    dev = device if isinstance(device, torch.device) else resolve_device(
        device)
    key = (name, world, dtype, axis, dev, stream)
    ws = _SCRATCH.get(key)
    if ws is None or ws.array.shape[1] < numel:
        ws = SymmetricWorkspace(
            name, torch.empty((world, numel), dtype=dtype, device=dev), axis)
        _SCRATCH[key] = ws
    return ws


def clear_workspaces() -> None:
    """Drop every registered workspace and scratch workspace (their memory
    returns to the allocator once no caller holds them)."""
    _REGISTRY.clear()
    _SCRATCH.clear()
