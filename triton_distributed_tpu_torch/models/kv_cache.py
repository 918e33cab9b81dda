"""Preallocated KV cache.

Counterpart of ``triton_distributed_tpu/models/kv_cache.py``: per-layer
(batch, max_length, n_kv_heads, head_dim) arrays stacked as
(n_layers, B, max_length, Hkv, dh), with a monotonic ``offset``.

Where the JAX cache is a functional pytree that XLA updates in place through
buffer donation, this one is mutable: the layers write the new keys and
values into ``k``/``v`` in place (``layers.nn.cache_update``) and the
engine advances ``offset``, a plain Python int.

For a world of simulated ranks on one card the cache keeps the global
layout: rank r owns kv heads ``[r Hkv / world, (r + 1) Hkv / world)`` of
index 3, where the JAX ``KVCache.spec`` shards them; the heads must split
evenly, as JAX's placement demands.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor       # (n_layers, B, max_length, n_kv_heads, head_dim)
    v: torch.Tensor       # same
    offset: int = 0       # tokens already cached

    @classmethod
    def create(cls, config, batch_size: int, *, device: torch.device,
               max_length: int | None = None,
               world: int = 1) -> "KVCache":
        shape = (config.n_layers, batch_size,
                 max_length or config.max_length,
                 config.n_kv_heads, config.head_dim)
        if config.n_kv_heads % world:
            raise ValueError(
                f"the cache shards its kv heads over the ranks, so the "
                f"global size of its dimension 3 should be divisible by "
                f"{world}, but it is equal to {config.n_kv_heads} (full "
                f"shape: {shape})")
        return cls(k=torch.zeros(shape, dtype=config.dtype, device=device),
                   v=torch.zeros(shape, dtype=config.dtype, device=device))

    def clear(self) -> "KVCache":
        """Forget the cached tokens (the arrays are overwritten as the next
        prompt is written)."""
        self.offset = 0
        return self
