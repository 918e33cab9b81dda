"""GQA attention at world 1.

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
[q | k | v] inside each rank's shard, which at world 1 is the plain
concatenation. Two cache layouts share one pipeline, as in JAX: the
contiguous cache (``Engine``) and the block-paged pool of the serving path
(``block_tables`` given, attention through ``nn.paged_attn_with_cache``,
whose fused kernel also serves the ``xla`` golden, as the JAX layer's
does). Caches and pools are written in place (the JAX layer returns new
arrays that XLA writes in place through donation).
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

    def sizes(self):
        """(q_size, kv_size)."""
        return self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim

    @staticmethod
    def pack_qkv(wq, wk, wv):
        """Fuse (..., d, Hq*dh), (..., d, Hkv*dh), (..., d, Hkv*dh) into
        (..., d, q|k|v)."""
        return torch.cat([wq, wk, wv], dim=-1)

    def unpack_qkv(self, w_qkv):
        """Inverse of ``pack_qkv`` -> (wq, wk, wv)."""
        qs, kvs = self.sizes()
        return torch.split(w_qkv, [qs, kvs, kvs], dim=-1)

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
        ``paged_attn``, ``kv_scales``, ``paged_step``)."""
        B, L, d = x.shape
        qkv = ag_gemm_device(x.reshape(B * L, d),
                             params["w_qkv"]).reshape(B, L, -1)
        out = self._qkv_to_attn(params, qkv, k_cache, v_cache, offset,
                                **attn_kw)
        return gemm_rs_device(out.reshape(B * L, -1),
                              params["w_o"]).reshape(B, L, d)

    def ar_fwd(self, params, x, k_cache, v_cache, offset, **attn_kw):
        """x: (B, L, d) replicated -> replicated out, with ``dist_fwd``'s
        cache writes and keywords: ``torch.matmul`` QKV, ``_qkv_to_attn``
        (the flash and paged kernels), ``torch.matmul`` o_proj, then the
        one-shot all-reduce of the partial."""
        B, L, d = x.shape
        qkv = torch.matmul(x.reshape(B * L, d),
                           params["w_qkv"]).reshape(B, L, -1)
        out = self._qkv_to_attn(params, qkv, k_cache, v_cache, offset,
                                **attn_kw)
        partial = torch.matmul(out.reshape(B * L, -1), params["w_o"])
        return oneshot_all_reduce(partial).reshape(B, L, d)

    def xla_fwd(self, params, x, k_cache, v_cache, offset, **attn_kw):
        """Golden: ``torch.matmul`` projections and dense attention on the
        contiguous cache; on the paged pool ``paged_attn`` still picks the
        read (the JAX ``xla_fwd`` does the same)."""
        B, L, d = x.shape
        qkv = torch.matmul(x.reshape(B * L, d),
                           params["w_qkv"]).reshape(B, L, -1)
        out = self._qkv_to_attn(params, qkv, k_cache, v_cache, offset,
                                use_flash_decode=False, **attn_kw)
        return torch.matmul(out.reshape(B * L, -1),
                            params["w_o"]).reshape(B, L, d)
