"""Tensor-parallel GQA attention.

Counterpart of ``triton_distributed_tpu/layers/tp_attn.py`` (``TPAttn``):

  ``dist_fwd`` - AG-GEMM(x, w_qkv) -> q/k RMSNorm, RoPE, cache write ->
                 flash attention -> GEMM-RS(out, w_o); at world 1 the
                 projections are the single-card matmul kernel and the
                 attention is the flash prefill / flash decode kernel.
  ``ar_fwd``   - the all-reduce mode: ``torch.matmul`` projections (plain
                 XLA in the JAX layer, :258-276), the same flash and paged
                 attention kernels, then the one-shot all-reduce of the
                 o_proj partial, the identity at world 1.
  ``xla_fwd``  - the golden: ``torch.matmul`` projections and the dense
                 attention (``use_flash_decode=False``).

The fused ``w_qkv`` keeps the JAX layout: (d_model, (Hq + 2*Hkv) * dh),
[q | k | v] inside each rank's shard (``pack_qkv``), which at world 1 is the
plain concatenation. Two cache layouts share one pipeline, as in JAX: the
contiguous cache (``Engine``) and the block-paged pool of the serving path
(``block_tables`` given, attention through ``nn.paged_attn_with_cache``,
whose fused kernel also serves the ``xla`` golden, as the JAX layer's
does). Caches and pools are written in place (the JAX layer returns new
arrays that XLA writes in place through donation).

At ``world`` > 1 the ranks are simulated on one card (``runtime/mesh.py``):
``w_qkv`` is held as its rank stack (world, d_model, q_l + 2 kv_l) and
``w_o`` as (world, q_l, d_model); the norms once. Rank r owns query heads
``[r Hq / world, (r + 1) Hq / world)`` and kv heads likewise, contiguous in
the global head order, so the ranks' attention is ONE launch over all heads
of the global-layout cache (B, S, Hkv, dh): GQA's q head h -> kv head
h // (Hq / Hkv) is the same map inside every rank. ``dist_fwd`` takes the
batch-sharded hidden state as (B, L, d), rank r's rows ``[r B / world,
(r + 1) B / world)``, and returns it so; ``ar_fwd`` and ``xla_fwd`` take
and return the replicated (B, L, d), held once.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.kernels.allgather_gemm import ag_gemm_device
from triton_distributed_tpu_torch.kernels.allreduce import oneshot_all_reduce
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    gemm_rs_device,
)
from triton_distributed_tpu_torch.layers import nn


@dataclasses.dataclass(frozen=True)
class TPAttn:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e6
    rope_scaling: tuple | None = None
    qk_norm: bool = True
    rms_eps: float = 1e-6
    world: int = 1

    def sizes(self, world: int = 1):
        """(q_size, kv_size) per rank of ``world`` (world 1: the whole
        layer's). Raises JAX's ``ValueError`` when the heads do not split."""
        if self.n_heads % world or self.n_kv_heads % world:
            raise ValueError(
                f"heads ({self.n_heads}, {self.n_kv_heads}) not divisible by "
                f"world {world}")
        return (self.n_heads // world * self.head_dim,
                self.n_kv_heads // world * self.head_dim)

    @staticmethod
    def pack_qkv(wq, wk, wv, world: int = 1):
        """Fuse (..., d, Hq*dh), (..., d, Hkv*dh), (..., d, Hkv*dh) into
        the JAX layout (..., d, (Hq + 2 Hkv) dh) whose ``world`` column
        shards are each [q_r | k_r | v_r] (JAX :70)."""
        parts = [w.reshape(*w.shape[:-1], world, w.shape[-1] // world)
                 for w in (wq, wk, wv)]
        out = torch.cat(parts, dim=-1)
        return out.reshape(*out.shape[:-2], -1)

    def unpack_qkv(self, w_qkv, world: int = 1):
        """Inverse of ``pack_qkv`` -> (wq, wk, wv) (JAX :84)."""
        qs, kvs = self.sizes(world)
        w = w_qkv.reshape(*w_qkv.shape[:-1], world, qs + 2 * kvs)
        return tuple(p.reshape(*w_qkv.shape[:-1], -1)
                     for p in torch.split(w, [qs, kvs, kvs], dim=-1))

    def _global_heads(self, qkv: torch.Tensor) -> torch.Tensor:
        """Every rank's local projection (world, N, q_l + 2 kv_l) -> the
        global [q | k | v] (N, (Hq + 2 Hkv) dh), heads in global order."""
        qs, kvs = self.sizes(self.world)
        n = qkv.shape[1]
        return torch.cat([p.transpose(0, 1).reshape(n, -1) for p in
                          torch.split(qkv, [qs, kvs, kvs], dim=-1)], dim=-1)

    def _rank_heads(self, out: torch.Tensor) -> torch.Tensor:
        """The attention output (N, Hq dh) in global head order -> each
        rank's heads (world, N, q_l), the o_proj's row shards."""
        n = out.shape[0]
        return out.reshape(n, self.world, -1).transpose(0, 1).contiguous()

    def _qkv_to_attn(self, params, qkv, k_cache, v_cache, offset, *,
                     use_flash_decode: bool = True, seq_lens=None,
                     block_tables=None, slot_mask=None,
                     paged_attn: str = "fused", kv_scales=None,
                     paged_step=None):
        """qkv (B, L, q_size + 2*kv_size) -> attention output (B, L, q_size).

        In order: q/k RMSNorm over head_dim (f32 weights), RoPE at positions
        ``offset + arange(L)`` (per row when ``offset`` is a (B,) tensor),
        the in-place cache write, then GQA attention with
        ``scale = head_dim ** -0.5`` (q head h reads kv head h // g).

        Contiguous (``block_tables`` None): k/v_cache (B, S, Hkv, dh).
        Paged: k/v_cache are one layer of the pool (n_blocks, block_size,
        Hkv, dh), ``offset`` the (B,) per-slot depth; ``slot_mask`` (B,)
        and ``seq_lens`` (B,) drop the writes of dead slots and padding
        rows; ``kv_scales`` (k_scale, v_scale) marks an int8/fp8 pool whose
        rows are quantized at the write; ``paged_step`` is the step's
        ``nn.PagedStep`` (the caller builds it once for every layer; None
        builds it here)."""
        B, L, _ = qkv.shape
        qs, kvs = self.sizes()
        dh = self.head_dim
        q = qkv[..., :qs].reshape(B, L, -1, dh)
        k = qkv[..., qs:qs + kvs].reshape(B, L, -1, dh)
        v = qkv[..., qs + kvs:].reshape(B, L, -1, dh)
        if self.qk_norm:
            q = nn.rms_norm(q, params["q_norm"], self.rms_eps)
            k = nn.rms_norm(k, params["k_norm"], self.rms_eps)
        steps = torch.arange(L, device=qkv.device)
        if isinstance(offset, torch.Tensor):
            positions = offset.reshape(-1, 1).long() + steps      # (1|B, L)
        else:
            positions = offset + steps[None]
        cos, sin = nn.rope_angles(positions, dh, self.rope_theta,
                                  self.rope_scaling)
        q = nn.apply_rope(q, cos, sin)
        k = nn.apply_rope(k, cos, sin)
        if block_tables is None:
            if kv_scales is not None:
                raise ValueError("kv_scales requires the paged cache layout "
                                 "(block_tables)")
            nn.cache_update(k_cache, k, offset)
            nn.cache_update(v_cache, v, offset)
            out = nn.attn_with_cache(q, k_cache, v_cache, offset,
                                     scale=dh ** -0.5,
                                     use_flash_decode=use_flash_decode,
                                     seq_lens=seq_lens)
            return out.reshape(B, L, qs)
        if paged_step is None:
            paged_step = nn.paged_step(block_tables, offset, L,
                                       *k_cache.shape[:2],
                                       slot_mask=slot_mask, seq_lens=seq_lens)
        ks, vs = kv_scales if kv_scales is not None else (None, None)
        nn.paged_cache_write(k_cache, k, paged_step.write, scale_pool=ks)
        nn.paged_cache_write(v_cache, v, paged_step.write, scale_pool=vs)
        out = nn.paged_attn_with_cache(
            q, k_cache, v_cache, block_tables, offset, scale=dh ** -0.5,
            slot_mask=slot_mask, use_flash_decode=use_flash_decode,
            seq_lens=seq_lens, paged_attn=paged_attn, kv_scales=kv_scales,
            slots=paged_step.slots)
        return out.reshape(B, L, qs)

    def dist_fwd(self, params, x, k_cache, v_cache, offset, **attn_kw):
        """x: (B, L, d) -> (B, L, d); the layer's caches are written in
        place at ``[offset, offset + L)``. ``attn_kw`` takes the keywords
        of ``_qkv_to_attn`` (``seq_lens``, ``block_tables``, ``slot_mask``,
        ``paged_attn``, ``kv_scales``, ``paged_step``). At world > 1 (JAX
        :228): AG-GEMM of every rank's rows against its ``w_qkv`` shard,
        attention of every rank's heads, GEMM-RS back to its rows."""
        B, L, d = x.shape
        w = self.world
        if w == 1:
            qkv = ag_gemm_device(x.reshape(B * L, d),
                                 params["w_qkv"]).reshape(B, L, -1)
            out = self._qkv_to_attn(params, qkv, k_cache, v_cache, offset,
                                    **attn_kw)
            return gemm_rs_device(out.reshape(B * L, -1),
                                  params["w_o"]).reshape(B, L, d)
        qkv = ag_gemm_device(x.reshape(w, B // w * L, d), params["w_qkv"],
                             world=w)
        qkv = self._global_heads(qkv).reshape(B, L, -1)
        out = self._qkv_to_attn(params, qkv, k_cache, v_cache, offset,
                                **attn_kw)
        return gemm_rs_device(self._rank_heads(out.reshape(B * L, -1)),
                              params["w_o"], world=w).reshape(B, L, d)

    def _local_products(self, params, x):
        """``torch.matmul`` QKV of the replicated x: (B, L, q|k|v) in the
        global head order (every rank's product at world > 1)."""
        B, L, d = x.shape
        qkv = torch.matmul(x.reshape(B * L, d), params["w_qkv"])
        if self.world > 1:
            qkv = self._global_heads(qkv)
        return qkv.reshape(B, L, -1)

    def _o_partials(self, params, out):
        """``torch.matmul`` o_proj of the attention output (N, Hq dh): the
        (N, d) product at world 1, every rank's partial (world, N, d)
        above."""
        if self.world > 1:
            out = self._rank_heads(out)
        return torch.matmul(out, params["w_o"])

    def ar_fwd(self, params, x, k_cache, v_cache, offset, **attn_kw):
        """x: (B, L, d) replicated -> replicated out, with ``dist_fwd``'s
        cache writes and keywords: ``torch.matmul`` QKV, ``_qkv_to_attn``
        (the flash and paged kernels), ``torch.matmul`` o_proj, then the
        one-shot all-reduce of the partials (JAX :258); at world > 1 the
        model goes on from rank 0's copy (every copy is the same bits)."""
        B, L, d = x.shape
        qkv = self._local_products(params, x)
        out = self._qkv_to_attn(params, qkv, k_cache, v_cache, offset,
                                **attn_kw)
        partial = self._o_partials(params, out.reshape(B * L, -1))
        out = oneshot_all_reduce(partial, world=self.world)
        if self.world > 1:
            out = out[0]
        return out.reshape(B, L, d)

    def xla_fwd(self, params, x, k_cache, v_cache, offset, **attn_kw):
        """Golden: ``torch.matmul`` projections and dense attention on the
        contiguous cache; on the paged pool ``paged_attn`` still picks the
        read (the JAX ``xla_fwd`` does the same). At world > 1 the ranks'
        o_proj partials are summed in f32 (JAX's ``psum_scatter``)."""
        B, L, d = x.shape
        qkv = self._local_products(params, x)
        out = self._qkv_to_attn(params, qkv, k_cache, v_cache, offset,
                                use_flash_decode=False, **attn_kw)
        out = self._o_partials(params, out.reshape(B * L, -1))
        if self.world > 1:
            out = out.float().sum(0).to(x.dtype)
        return out.reshape(B, L, d)
