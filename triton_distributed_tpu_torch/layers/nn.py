"""Shared neural-net ops for the model layers.

Counterpart of ``triton_distributed_tpu/layers/nn.py``: RMSNorm, RoPE
tables (with llama3 scaling), rotate-half RoPE, the contiguous cache write
and ``attn_with_cache``. The paged-pool and KV-quantization functions come
with the serving slice.

``attn_with_cache`` routes by the device of its tensors. On a CUDA tensor
every prefill (L > 1) with ``use_flash_decode=True`` goes to the flash
prefill kernel and every decode step (L == 1) with ``use_flash_decode=True``
to the flash decode kernel; on a CPU tensor the kernels' plain versions run.
The JAX package's two extra gates (Mosaic's tile alignment for prefill,
S >= 4096 for decode) follow from the TPU and do not carry over.
``use_flash_decode=False`` is the dense golden, f32 probabilities always.
"""

from __future__ import annotations

import math

import torch

from triton_distributed_tpu_torch.kernels.sp_attention import (
    flash_decode_local,
    flash_prefill,
)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last dim, f32 math, cast back to x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                rope_scaling=None):
    """cos/sin tables for rotate-half RoPE. positions: (..., L) int ->
    cos, sin each (..., L, head_dim//2) f32. ``rope_scaling`` is the
    llama3 ``(factor, low_freq_factor, high_freq_factor,
    original_max_position)`` frequency scaling."""
    exps = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=positions.device) / head_dim)
    inv_freq = 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)
    if rope_scaling is not None:
        factor, low_f, high_f, orig_ctx = rope_scaling
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = orig_ctx / low_f
        high_wl = orig_ctx / high_f
        smooth = (orig_ctx / wavelen - low_f) / (high_f - low_f)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(wavelen < high_wl, inv_freq,
                               torch.where(wavelen > low_wl,
                                           inv_freq / factor, smoothed))
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half RoPE (HF Qwen/Llama half-split convention).
    x: (..., L, H, dh); cos/sin: (..., L, dh//2), broadcast over heads."""
    dh = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : dh // 2], xf[..., dh // 2:]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def cache_update(cache: torch.Tensor, new: torch.Tensor, offset):
    """Write ``new`` (B, L, H, dh) into ``cache`` (B, S, H, dh) at ``offset``
    along the sequence dim, IN PLACE (the JAX version returns a new array
    that XLA writes in place through donation); returns ``cache``.

    ``offset`` is an int (one slice write for the whole batch) or a (B,)
    tensor of per-row offsets."""
    B, L = new.shape[:2]
    if isinstance(offset, torch.Tensor) and offset.dim() > 0:
        pos = offset.to(torch.long)[:, None] + torch.arange(
            L, device=cache.device)[None]
        rows = torch.arange(B, device=cache.device)[:, None]
        cache[rows, pos] = new.to(cache.dtype)
        return cache
    offset = int(offset)
    if offset + L > cache.shape[1]:
        raise ValueError(f"cache write [{offset}, {offset + L}) past the "
                         f"cache length {cache.shape[1]}")
    cache[:, offset:offset + L] = new.to(cache.dtype)
    return cache


def attn_with_cache(q, k_cache, v_cache, offset, *, scale: float,
                    use_flash_decode: bool = True, seq_lens=None):
    """GQA attention of new queries against a static-length KV cache.

    q: (B, L, Hq, dh) rope'd queries; k/v_cache: (B, S, Hkv, dh), already
    holding the new keys; offset: int or (B,) cache length BEFORE this
    call; seq_lens: (B,) varlen prefill lengths (L > 1 only).
    -> (B, L, Hq, dh) in q.dtype."""
    B, L, Hq, dh = q.shape
    if seq_lens is not None and L == 1:
        raise ValueError("seq_lens is a varlen-PREFILL feature (L > 1)")
    if use_flash_decode and L == 1:
        kv_len = offset + 1
        out, _ = flash_decode_local(q.reshape(B, Hq, dh), k_cache, v_cache,
                                    kv_len=kv_len, scale=scale,
                                    kv_layout="bshd")
        return out.reshape(B, L, Hq, dh).to(q.dtype)
    if use_flash_decode:
        return flash_prefill(q, k_cache, v_cache, offset=offset,
                             seq_lens=seq_lens, scale=scale,
                             kv_layout="bshd")
    return dense_attn_with_cache(q, k_cache, v_cache, offset, scale=scale,
                                 seq_lens=seq_lens)


def dense_attn_with_cache(q, k_cache, v_cache, offset, *, scale: float,
                          seq_lens=None):
    """The golden: dense masked softmax over the whole cache with f32
    scores and f32 probabilities (the JAX ``attn_with_cache`` with
    ``use_flash_decode=False``)."""
    B, L, Hq, dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    off_rows = torch.as_tensor(offset, dtype=torch.long,
                               device=q.device).reshape(-1)
    qr = q.float().reshape(B, L, Hkv, g, dh)
    scores = torch.einsum("blhgd,bshd->blhgs", qr, k_cache.float()) * scale
    q_pos = off_rows[:, None] + torch.arange(L, device=q.device)   # (1|B, L)
    key_pos = torch.arange(S, device=q.device)
    mask = key_pos[None, None, :] <= q_pos[..., None]
    if seq_lens is not None:
        seq_lens = torch.as_tensor(seq_lens, dtype=torch.long,
                                   device=q.device)
        kv_lens = off_rows + seq_lens
        mask = (mask & (key_pos[None, None, :] < kv_lens[:, None, None])
                & (torch.arange(L, device=q.device)[None, :, None]
                   < seq_lens[:, None, None]))
    scores = torch.where(mask[:, :, None, None, :], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("blhgs,bshd->blhgd", p, v_cache.float())
    if seq_lens is not None:
        valid_row = (torch.arange(L, device=q.device)[None, :]
                     < seq_lens[:, None])
        out = torch.where(valid_row[..., None, None, None], out, 0.0)
    return out.reshape(B, L, Hq, dh).to(q.dtype)
