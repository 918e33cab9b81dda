"""Shared neural-net ops for the model layers.

Counterpart of ``triton_distributed_tpu/layers/nn.py``: RMSNorm, RoPE
tables (with llama3 scaling), rotate-half RoPE, the contiguous cache write
and ``attn_with_cache``; for the serving path, the rowmax:v1 KV
quantization, the paged pool write (``paged_cache_update``) and
``paged_attn_with_cache``, and ``paged_step``, the pool addressing a
serving step builds once for all its layers. The JAX version's comm-ledger record (:314-344)
comes with ``obs/``.

``attn_with_cache`` routes by the device of its tensors. On a CUDA tensor
every prefill (L > 1) with ``use_flash_decode=True`` goes to the flash
prefill kernel and every decode step (L == 1) with ``use_flash_decode=True``
to the flash decode kernel; on a CPU tensor the kernels' plain versions run.
The JAX package's two extra gates (Mosaic's tile alignment for prefill,
S >= 4096 for decode) follow from the TPU and do not carry over.
``use_flash_decode=False`` is the dense golden, f32 probabilities always.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from triton_distributed_tpu_torch.kernels.paged_attention import (
    PagedSlots,
    paged_attention_slots,
    paged_slots,
)
from triton_distributed_tpu_torch.kernels.sp_attention import (
    flash_decode_local,
    flash_prefill,
    paged_gather_kv,
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


# Symmetric per-row quantization range by wire dtype: int8 uses [-127, 127]
# (dropping -128 keeps dequantization sign-symmetric); float8_e4m3fn
# saturates at +-448.
_KV_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def _kv_qmax(wire_dtype) -> float:
    try:
        return _KV_QMAX[wire_dtype]
    except KeyError:
        raise ValueError(f"no quantization range for wire dtype "
                         f"{wire_dtype!r}; expected one of "
                         f"{sorted(map(str, _KV_QMAX))}") from None


def quantize_kv_rows(new: torch.Tensor, wire_dtype):
    """Per-row symmetric absmax KV quantization (scheme ``rowmax:v1``).

    ``new`` (..., head_dim) -> ``(q, scale)``: ``q`` in ``wire_dtype``,
    ``scale`` (...,) f32 with ``dequantize_kv_rows(q, scale) ~= new``. One
    scale per (token row, kv head), so an append never requantizes a stored
    row. int8 rounds half to even (``torch.round``, as ``jnp.round``) and
    clips to [-127, 127]; all-zero rows get scale 0 and dequantize to exact
    zeros."""
    qmax = _kv_qmax(wire_dtype)
    xf = new.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / qmax
    inv = torch.where(amax > 0.0, qmax / torch.clamp(amax, min=1e-30),
                      torch.zeros_like(amax))
    q = xf * inv[..., None]
    if wire_dtype == torch.int8:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(wire_dtype), scale


def dequantize_kv_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_kv_rows``: (..., dh) wire values and (...,)
    f32 scales -> f32, the expression the paged kernel applies after each
    load."""
    return q.float() * scale[..., None]


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


@dataclasses.dataclass(frozen=True)
class PagedWrite:
    """Where one step's new K/V rows land in a block-paged pool (n_blocks,
    block_size, ...): ``idx`` (B*L,) the flat pool row of each token, every
    dropped token sent to the row of the step's first kept token;
    ``keep`` (B*L,) bool; ``first`` (1,) that first kept token (0 when none
    is kept), ``first_idx`` (1,) its row, ``any_keep`` () bool. It depends
    on the step alone, so K, V, their scales and every layer share it."""

    idx: torch.Tensor
    keep: torch.Tensor
    first: torch.Tensor
    first_idx: torch.Tensor
    any_keep: torch.Tensor


def paged_write_index(block_tables, offsets, L: int, n_blocks: int,
                      block_size: int, write_mask=None) -> PagedWrite:
    """The ``PagedWrite`` of an L-token write; the arguments are those of
    ``paged_cache_update``."""
    dev = block_tables.device
    bs = block_size
    offs = torch.as_tensor(offsets, device=dev).long().reshape(-1)
    pos = offs[:, None] + torch.arange(L, device=dev)[None]          # (B, L)
    slot = torch.clamp(pos // bs, max=block_tables.shape[1] - 1)
    blk = torch.gather(block_tables.long(), 1, slot)                 # (B, L)
    keep = blk < n_blocks
    if write_mask is not None:
        wm = write_mask if write_mask.dim() == 2 else write_mask[:, None]
        keep = keep & wm
    keep = keep.reshape(-1)
    idx = (blk * bs + pos % bs).reshape(-1)
    # The first kept row (row 0 when none is kept), as a (1,) index: a 0-d
    # tensor index would be read back to the host.
    first = torch.argmax(keep.to(torch.uint8)).reshape(1)
    first_idx = torch.clamp(idx[first], 0, n_blocks * bs - 1)
    return PagedWrite(idx=torch.where(keep, idx, first_idx), keep=keep,
                      first=first, first_idx=first_idx, any_keep=keep.any())


def paged_cache_write(pool, new, where: PagedWrite, scale_pool=None):
    """``paged_cache_update`` at addresses already built
    (``paged_write_index``)."""
    B, L = new.shape[:2]
    n_blocks, bs = pool.shape[:2]
    if scale_pool is None:
        rows = [(pool, new.reshape(B * L, *new.shape[2:]).to(pool.dtype))]
    else:
        q, scales = quantize_kv_rows(new, pool.dtype)
        rows = [(pool, q.reshape(B * L, *q.shape[2:])),
                (scale_pool, scales.reshape(B * L, *scales.shape[2:]))]
    for dst, val in rows:
        flat = dst.view(n_blocks * bs, *dst.shape[2:])
        fill = torch.where(where.any_keep, val[where.first],
                           flat[where.first_idx])
        keep_v = where.keep.reshape(-1, *([1] * (val.dim() - 1)))
        flat.index_put_((where.idx,), torch.where(keep_v, val, fill))
    return pool if scale_pool is None else (pool, scale_pool)


def paged_cache_update(pool, new, block_tables, offsets, write_mask=None,
                       scale_pool=None):
    """Write ``new`` (B, L, H, dh) into one layer of a block-paged pool
    (n_blocks, block_size, H, dh), IN PLACE: token (b, l) lands at line
    ``(offsets[b] + l) % block_size`` of block
    ``block_tables[b, (offsets[b] + l) // block_size]`` (the table slot
    clamped to its width). Returns ``pool``, or ``(pool, scale_pool)``.

    ``write_mask`` (B,) or (B, L) bool DROPS masked writes, as the JAX
    scatter with ``mode="drop"`` does, and so do writes whose block is
    outside the pool. A dropped write is not clamped or written back: a
    dead slot's table may name block 0 while a live sequence writes block 0
    in the same step. Every dropped row is instead sent to the index and
    value of the step's first kept row, a duplicate of a write that happens
    anyway (with no kept row, to its own index with the value already
    there). The shapes never depend on the mask, and nothing is read back
    to the host.

    ``scale_pool`` (n_blocks, block_size, H) f32 marks the pool quantized:
    ``new`` is quantized per row (``quantize_kv_rows``) to the pool's
    dtype, and the row scales go through the identical indices, so a row
    and its scale never land in different blocks."""
    where = paged_write_index(block_tables, offsets, new.shape[1],
                              pool.shape[0], pool.shape[1], write_mask)
    return paged_cache_write(pool, new, where, scale_pool)


@dataclasses.dataclass(frozen=True)
class PagedStep:
    """The pool addressing of one serving step: where its tokens' K/V rows
    land (``write``) and the paged kernel's per-slot operands (``slots``).
    ``Qwen3.forward`` builds it once per step (``paged_step``); every
    layer's writes and fused reads use it."""

    write: PagedWrite
    slots: PagedSlots


def paged_step(block_tables, offsets, L: int, n_blocks: int,
               block_size: int, *, slot_mask=None, seq_lens=None) -> PagedStep:
    """``PagedStep`` of an L-token step: ``offsets`` (B,) the cache length
    before the step, ``seq_lens`` (B,) live tokens per row (None = all L),
    ``slot_mask`` (B,) bool. Dead slots and padding rows write nothing."""
    B = block_tables.shape[0]
    dev = block_tables.device
    wm = slot_mask
    if seq_lens is not None:
        tok_valid = torch.arange(L, device=dev)[None] < seq_lens[:, None]
        wm = tok_valid if wm is None else wm[:, None] & tok_valid
    off = torch.as_tensor(offsets, dtype=torch.int32,
                          device=dev).reshape(-1).expand(B)
    q_lens = (torch.full((B,), L, dtype=torch.int32, device=dev)
              if seq_lens is None else
              torch.as_tensor(seq_lens, dtype=torch.int32,
                              device=dev).reshape(-1).expand(B))
    return PagedStep(
        write=paged_write_index(block_tables, offsets, L, n_blocks,
                                block_size, wm),
        slots=paged_slots(block_tables, off + q_lens, L, q_lens=q_lens,
                          slot_mask=slot_mask))


def paged_attn_with_cache(q, k_pool, v_pool, block_tables, offset, *,
                          scale: float, slot_mask=None,
                          use_flash_decode: bool = True, seq_lens=None,
                          paged_attn: str = "fused", kv_scales=None,
                          slots: PagedSlots | None = None):
    """GQA attention of new queries against one layer of a block-paged KV
    pool, the paged twin of ``attn_with_cache``.

    ``paged_attn="fused"`` (the serving path) reads the pool through the
    paged kernel (``paged_attention_slots``) at every step shape, with
    ``slots`` the step's ``PagedSlots`` (None builds them here);
    ``"gather"`` is the oracle: ``paged_gather_kv`` views (dequantized with
    ``dequantize_kv_rows`` when ``kv_scales`` is given) through the dense
    ``attn_with_cache``.

    q: (B, L, Hq, dh) rope'd, the new K/V already in the pool
    (``paged_cache_update``); block_tables (B, max_blocks) int32; offset:
    int or (B,), the cache length BEFORE this step; seq_lens (B,) live
    query rows per slot (None = all L); slot_mask (B,) bool (dead rows are
    garbage the caller discards). kv_scales: (k_scale, v_scale), each
    (n_blocks, block_size, Hkv) f32, marks the pool int8/fp8. Returns
    (B, L, Hq, dh) in q.dtype."""
    if paged_attn not in ("fused", "gather"):
        raise ValueError(
            f"paged_attn must be 'fused' or 'gather', got {paged_attn!r}")
    quant = kv_scales is not None
    if quant and kv_scales[0].shape != k_pool.shape[:3]:
        raise ValueError(f"kv_scales shape {tuple(kv_scales[0].shape)} does "
                         f"not match pool rows {tuple(k_pool.shape[:3])}")
    if paged_attn == "fused":
        if slots is None:
            slots = paged_step(block_tables, offset, q.shape[1],
                               *k_pool.shape[:2],
                               slot_mask=slot_mask, seq_lens=seq_lens).slots
        return paged_attention_slots(
            q, k_pool, v_pool, slots, scale=scale,
            k_scale=kv_scales[0] if quant else None,
            v_scale=kv_scales[1] if quant else None)
    k_view = paged_gather_kv(k_pool, block_tables, slot_mask=slot_mask)
    v_view = paged_gather_kv(v_pool, block_tables, slot_mask=slot_mask)
    if quant:
        k_view = dequantize_kv_rows(k_view, paged_gather_kv(
            kv_scales[0], block_tables, slot_mask=slot_mask))
        v_view = dequantize_kv_rows(v_view, paged_gather_kv(
            kv_scales[1], block_tables, slot_mask=slot_mask))
        # The f32 views meet the queries in f32 (the dense JAX einsum
        # promotes the same way; the flash kernels take one dtype).
        out = attn_with_cache(q.float(), k_view, v_view, offset, scale=scale,
                              use_flash_decode=use_flash_decode,
                              seq_lens=seq_lens)
        return out.to(q.dtype)
    return attn_with_cache(q, k_view, v_view, offset, scale=scale,
                           use_flash_decode=use_flash_decode,
                           seq_lens=seq_lens)
