"""Sequence-parallel GQA flash-decode layer.

Counterpart of ``triton_distributed_tpu/layers/sp_flash_decode_layer.py``
(``SpGQAFlashDecodeAttention`` :25): each rank masks its shard of a
preallocated cache by the global valid length, computes its split-KV
partial, and the partials are gathered (ring, or LL with a staging) and
merged by log-sum-exp (``kernels.sp_attention.flash_decode_device``). At
world > 1 the ranks are simulated on one card: the cache shards come
stacked, ``(world, B, Hkv, m_kv, dh)``, and every rank's output is
returned, ``(world, B, Hq, dh)``. The multi-slice variant (``dcn_axis``)
is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.kernels.sp_attention import (
    flash_decode_device,
)


@dataclasses.dataclass(frozen=True)
class SpGQAFlashDecodeAttention:
    """Static decode-attention config (JAX :25): query heads, kv heads,
    head_dim, the sequence-parallel world and its axis."""

    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    axis: str = "sp"
    dcn_axis: str | None = None
    world: int = 1

    def __post_init__(self):
        if self.num_q_heads % self.num_kv_heads:
            raise ValueError(
                f"q heads {self.num_q_heads} not divisible by kv heads "
                f"{self.num_kv_heads}")

    def __call__(self, q, k_cache_local, v_cache_local, *, kv_len=None,
                 ll_staging=None, ll_epoch=None):
        """q (B, Hq, dh); k/v_cache_local the cache's sequence shards
        (world, B, Hkv, m_kv, dh) at world > 1, (B, Hkv, m_kv, dh) at world
        1. ``kv_len`` is the GLOBAL valid length (an int, or a (B,) tensor
        of one per row); rank r keeps ``clip(kv_len - r m_kv, 0, m_kv)`` of
        its shard (JAX :57-61), so the last ranks may keep none, and a rank
        that keeps none adds nothing. None = the full cache. With
        ``ll_staging`` / ``ll_epoch`` the partials ride the LL allgather
        and the result is (out, staging)."""
        if self.dcn_axis is not None:
            raise NotImplementedError(
                "SpGQAFlashDecodeAttention over a dcn axis (the 2-D SP "
                "decode) is not ported: see ROADMAP.md")
        local_len = None
        if kv_len is not None:
            m_kv = k_cache_local.shape[-2]
            kv = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
            ranks = torch.arange(self.world, dtype=torch.int32,
                                 device=q.device)
            local_len = (kv.reshape(1, -1) - ranks[:, None] * m_kv).clamp(
                0, m_kv)
            local_len = local_len[0] if self.world == 1 else local_len
            if kv.dim() == 0:
                local_len = local_len[..., 0]
        return flash_decode_device(q, k_cache_local, v_cache_local,
                                   world=self.world, kv_len=local_len,
                                   ll_staging=ll_staging, ll_epoch=ll_epoch)
