"""The simulated world: every rank of a tensor-parallel group in one process.

Counterpart of ``triton_distributed_tpu/runtime/mesh.py``. There a mesh
axis spreads the ranks over chips and ``PartitionSpec``s place each
array's shards. Here the ranks live on one card: a sharded array is held as
its rank stack, a new dimension of size ``world`` holding rank r's shard at
index r, and a replicated one is held once. ``World.split`` turns a global
array sharded on one dimension into its stack, ``World.join`` joins a stack
back: dimension 0 for ``P(axis, None)``, 1 for ``P(None, axis)``, 3 for the
KV cache's kv heads (``KVCache.spec``), one more behind a leading layer
dimension.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class World:
    """``size`` simulated ranks along the mesh axis ``axis``."""

    size: int
    axis: str = "tp"

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"world size must be >= 1, got {self.size}")

    def split(self, x: torch.Tensor, dim: int, at: int = 0) -> torch.Tensor:
        """The rank stack of ``x`` sharded on ``dim``: rank r's shard (the
        r-th of ``size`` equal blocks of ``dim``) at index r of a new
        dimension at position ``at`` of the result. Contiguous."""
        dim %= x.dim()
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} is not "
                             f"divisible by world {self.size}")
        x = x.reshape(*x.shape[:dim], self.size, n // self.size,
                      *x.shape[dim + 1:])
        return x.movedim(dim, at).contiguous()

    def join(self, stacked: torch.Tensor, dim: int,
             at: int = 0) -> torch.Tensor:
        """Inverse of ``split``: the global array whose dimension ``dim``
        holds the shards of the rank dimension ``at`` in rank order."""
        if stacked.shape[at] != self.size:
            raise ValueError(f"dimension {at} of {tuple(stacked.shape)} is "
                             f"not the world ({self.size})")
        x = stacked.movedim(at, dim)
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + 2:])
