"""Single-card flash attention: causal varlen GQA prefill and split-KV
decode against a contiguous KV cache.

Counterpart of ``triton_distributed_tpu/kernels/sp_attention.py``:

- ``flash_prefill`` (:412) -> ``csrc/flash_prefill.cu``, replacing
  ``_flash_prefill_kernel`` (:308);
- ``flash_decode_local`` (:654) -> ``csrc/flash_decode.cu``, replacing both
  ``_flash_decode_kernel`` (:511) and ``_flash_decode_bd_kernel`` (:567).
  The block-diagonal variant is a layout trick for the TPU's matrix unit;
  one CUDA kernel serves both contracts, with the cache layout passed as
  strides.

The JAX prefill returns None on shapes Mosaic cannot tile
(``prefill_alignment_issue``); the CUDA kernel masks ragged edges, so the
port's ``flash_prefill`` always answers.

Each entry point takes CUDA tensors to the kernel and CPU tensors to the
plain version beside it (``flash_prefill_ref``, ``flash_decode_ref``). The
sequence-parallel multi-rank kernels are not ported yet. ``paged_gather_kv``
(:800), the paged pool's table walk, is the serving path's reference
oracle.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels import _build

FLASH_PREFILL = _build.register(
    "flash_prefill", "triton_distributed_tpu_torch/csrc/flash_prefill.cu",
    "triton_distributed_tpu/kernels/sp_attention.py:308")
# Replaces _flash_decode_bd_kernel (:567), the variant the main path reaches
# (Hkv * g >= 16 in the bshd layout), and _flash_decode_kernel (:511).
FLASH_DECODE = _build.register(
    "flash_decode", "triton_distributed_tpu_torch/csrc/flash_decode.cu",
    "triton_distributed_tpu/kernels/sp_attention.py:567")


# Query heads per kv head that the kernels are instantiated for (a divisor
# of flash_prefill.cu's 64-row tile, and flash_decode.cu's dispatch).
_GQA_GROUPS = (1, 2, 4, 8, 16)


def _to_bshd(cache: torch.Tensor, kv_layout: str) -> torch.Tensor:
    if kv_layout == "bshd":
        return cache
    if kv_layout == "bhsd":
        return cache.transpose(1, 2)
    raise ValueError(f"unknown kv_layout {kv_layout!r}")


def _rows(offset, kv_len, seq_lens, B: int, L: int, device):
    """Per-row (offsets, kv_lens, q_lens) as in the JAX ``flash_prefill``:
    plain ints when every row shares them, else (B,) int32 tensors."""
    per_row = isinstance(offset, torch.Tensor) and offset.dim() > 0
    offset = 0 if offset is None else offset
    if seq_lens is not None:
        if kv_len is not None:
            raise ValueError("pass kv_len OR seq_lens, not both")
        seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=device)
        if seq_lens.shape != (B,):
            raise ValueError(f"seq_lens {tuple(seq_lens.shape)} != ({B},)")
        offs = torch.as_tensor(offset, dtype=torch.int32,
                               device=device).reshape(-1).expand(B)
        return offs, offs + seq_lens, seq_lens
    if per_row or isinstance(kv_len, torch.Tensor):
        offs = torch.as_tensor(offset, dtype=torch.int32,
                               device=device).reshape(-1).expand(B)
        kvl = (offs + L if kv_len is None else torch.as_tensor(
            kv_len, dtype=torch.int32, device=device).reshape(-1).expand(B))
        return offs, kvl, torch.full((B,), L, dtype=torch.int32,
                                     device=device)
    offset = int(offset)
    return offset, offset + L if kv_len is None else int(kv_len), L


def flash_prefill_ref(q, k_cache, v_cache, *, offset=None, kv_len=None,
                      seq_lens=None, scale: float | None = None,
                      kv_layout: str = "bshd") -> torch.Tensor:
    """Plain version of the prefill kernel, with the same contract as
    ``flash_prefill``. f32 math; cache rows at or past a row's ``kv_len``
    are replaced by zeros with ``where`` before they meet a probability, so
    garbage (NaN) there cannot leak; padding query rows return zeros."""
    B, L, Hq, dh = q.shape
    k_cache = _to_bshd(k_cache, kv_layout)
    v_cache = _to_bshd(v_cache, kv_layout)
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = dh ** -0.5 if scale is None else scale
    offs, kvl, qln = _rows(offset, kv_len, seq_lens, B, L, q.device)
    offs, kvl, qln = (torch.as_tensor(x, dtype=torch.int32,
                                      device=q.device).reshape(-1).expand(B)
                      for x in (offs, kvl, qln))
    key_pos = torch.arange(S, device=q.device)
    rows = torch.arange(L, device=q.device)
    q_pos = offs[:, None] + rows[None]                                # (B, L)
    key_ok = key_pos[None] < kvl[:, None]                             # (B, S)
    valid = ((key_pos[None, None] <= q_pos[..., None])
             & key_ok[:, None]
             & (rows[None, :, None] < qln[:, None, None]))            # (B,L,S)
    qf = q.float().reshape(B, L, Hkv, g, dh)
    kf = torch.where(key_ok[..., None, None], k_cache.float(), 0.0)
    vf = torch.where(key_ok[..., None, None], v_cache.float(), 0.0)
    scores = torch.einsum("blhgd,bshd->blhgs", qf, kf) * scale
    vmask = valid[:, :, None, None, :]
    scores = torch.where(vmask, scores, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(vmask, torch.exp(scores - m), 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("blhgs,bshd->blhgd", p, vf) / den
    return out.reshape(B, L, Hq, dh).to(q.dtype)


def flash_prefill_cuda(q, k_cache, v_cache, *, offset=None, kv_len=None,
                       seq_lens=None, scale: float | None = None,
                       kv_layout: str = "bshd") -> torch.Tensor:
    """Launch ``csrc/flash_prefill.cu``: one block per (row, kv head,
    q tile); see ``flash_prefill`` for the contract."""
    B, L, Hq, dh = q.shape
    k_cache = _to_bshd(k_cache, kv_layout)
    v_cache = _to_bshd(v_cache, kv_layout)
    _check_attn_operands(q, k_cache, v_cache, "flash_prefill")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    offs, kvl, qln = _rows(offset, kv_len, seq_lens, B, L, q.device)
    rows_ptr = None
    if isinstance(offs, torch.Tensor):
        rows = torch.stack([offs, kvl, qln]).to(torch.int32).contiguous()
        rows_ptr = rows.data_ptr()
        offs = kvl = qln = 0
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    sb, ss, sh = k_cache.stride(0), k_cache.stride(1), k_cache.stride(2)
    err = _build.lib().tdt_flash_prefill(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        rows_ptr, offs, kvl, qln, B, L, Hq, Hkv, S, dh, sb, ss, sh,
        float(scale), _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(err, "tdt_flash_prefill")
    FLASH_PREFILL.launches += 1
    return out


def flash_prefill(q, k_cache, v_cache, *, offset=None, kv_len=None,
                  seq_lens=None, scale: float | None = None,
                  kv_layout: str = "bshd") -> torch.Tensor:
    """Causal GQA prefill attention against a (possibly longer) KV cache.

    q: (B, L, Hq, dh), queries of row b at positions
    ``[offset[b], offset[b] + L)``; k/v_cache: (B, S, Hkv, dh) (``bshd``) or
    (B, Hkv, S, dh) (``bhsd``), already holding the new keys. ``kv_len``
    masks cache positions >= it (default offset + L). ``seq_lens`` (B,)
    turns on varlen mode: row b's valid queries are its first
    ``seq_lens[b]``, its cache mask is ``offset + seq_lens[b]``, and padding
    query rows return exact zeros. ``offset`` is an int or a (B,) tensor.
    Returns (B, L, Hq, dh) in q.dtype."""
    if q.shape[2] % k_cache.shape[2 if kv_layout == "bshd" else 1]:
        raise ValueError("q heads not divisible by kv heads")
    if q.is_cuda:
        return flash_prefill_cuda(q, k_cache, v_cache, offset=offset,
                                  kv_len=kv_len, seq_lens=seq_lens,
                                  scale=scale, kv_layout=kv_layout)
    return flash_prefill_ref(q, k_cache, v_cache, offset=offset,
                             kv_len=kv_len, seq_lens=seq_lens, scale=scale,
                             kv_layout=kv_layout)


def _decode_kv_lens(kv_len, B: int, S: int, device):
    """kv_len -> an int (shared by every row) or a (B,) int32 tensor."""
    if kv_len is None:
        return S
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() > 0:
        return torch.as_tensor(kv_len, dtype=torch.int32,
                               device=device).reshape(-1).expand(B)
    return int(kv_len)


def flash_decode_ref(q, k_cache, v_cache, *, kv_len=None,
                     scale: float | None = None, kv_layout: str = "bhsd"):
    """Plain version of the decode kernel: ``(out (B, Hq, dh) f32,
    lse (B, Hq) f32)`` over cache positions ``< kv_len`` per row."""
    B, Hq, dh = q.shape
    k_cache = _to_bshd(k_cache, kv_layout)
    v_cache = _to_bshd(v_cache, kv_layout)
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = dh ** -0.5 if scale is None else scale
    kvl = torch.as_tensor(_decode_kv_lens(kv_len, B, S, q.device),
                          dtype=torch.int32,
                          device=q.device).reshape(-1).expand(B)
    key_ok = torch.arange(S, device=q.device)[None] < kvl[:, None]    # (B, S)
    kf = torch.where(key_ok[..., None, None], k_cache.float(), 0.0)
    vf = torch.where(key_ok[..., None, None], v_cache.float(), 0.0)
    qf = q.float().reshape(B, Hkv, g, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, kf) * scale
    vmask = key_ok[:, None, None, :]
    scores = torch.where(vmask, scores, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(vmask, torch.exp(scores - m_safe), 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p, vf) / den
    lse = (m + torch.log(den))[..., 0]
    return out.reshape(B, Hq, dh), lse.reshape(B, Hq)


def flash_decode_cuda(q, k_cache, v_cache, *, kv_len=None,
                      scale: float | None = None, kv_layout: str = "bhsd"):
    """Launch ``csrc/flash_decode.cu``: one block per (row, kv head); see
    ``flash_decode_local`` for the contract."""
    B, Hq, dh = q.shape
    k_cache = _to_bshd(k_cache, kv_layout)
    v_cache = _to_bshd(v_cache, kv_layout)
    _check_attn_operands(q, k_cache, v_cache, "flash_decode")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    kvl = _decode_kv_lens(kv_len, B, S, q.device)
    lens_ptr = None
    if isinstance(kvl, torch.Tensor):
        kvl = kvl.contiguous()
        lens_ptr, kv_scalar = kvl.data_ptr(), 0
    else:
        kv_scalar = kvl
    out = torch.empty((B, Hq, dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    sb, ss, sh = k_cache.stride(0), k_cache.stride(1), k_cache.stride(2)
    err = _build.lib().tdt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lse.data_ptr(), lens_ptr, kv_scalar, B, Hq, Hkv, S, dh, sb, ss, sh,
        float(scale), _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(err, "tdt_flash_decode")
    FLASH_DECODE.launches += 1
    return out, lse


def flash_decode_local(q, k_cache, v_cache, *, kv_len=None,
                       scale: float | None = None, kv_layout: str = "bhsd"):
    """Single-card split-KV GQA decode.

    q: (B, Hq, dh); k/v_cache: (B, Hkv, S, dh) (``bhsd``) or (B, S, Hkv, dh)
    (``bshd``, the engine's cache layout). ``kv_len`` (int or (B,) tensor)
    masks cache positions >= it per row; None = the whole cache. Returns
    ``(out (B, Hq, dh) f32, lse (B, Hq) f32)``, the partial pair a
    multi-rank combine merges."""
    Hkv = k_cache.shape[1 if kv_layout == "bhsd" else 2]
    if q.shape[1] % Hkv:
        raise ValueError(f"q heads {q.shape[1]} not divisible by kv heads "
                         f"{Hkv}")
    if q.is_cuda:
        return flash_decode_cuda(q, k_cache, v_cache, kv_len=kv_len,
                                 scale=scale, kv_layout=kv_layout)
    return flash_decode_ref(q, k_cache, v_cache, kv_len=kv_len, scale=scale,
                            kv_layout=kv_layout)


def paged_gather_kv(pool, block_tables, *, slot_mask=None):
    """Gather one layer of a block-paged pool into the contiguous per-slot
    layout (JAX ``paged_gather_kv`` :800): pool (n_blocks, block_size, ...)
    and block_tables (B, max_blocks) int32 -> (B, max_blocks * block_size,
    ...), slot b's tokens in sequence order. Table entries are clamped to
    ``[0, n_blocks)`` (the JAX ``mode="clip"``); ``slot_mask`` (B,) bool
    routes dead slots' reads to block 0, so a freed slot's stale entries
    never touch blocks since handed to live sequences. Works for the
    (n_blocks, block_size, Hkv) scale arenas too. The reference path only:
    the serving steps read the pool through ``paged_attention``."""
    if block_tables.dtype != torch.int32:
        raise TypeError(f"block_tables must be int32 (got "
                        f"{block_tables.dtype}), as KVPool.padded_tables "
                        f"emits them")
    B, nb = block_tables.shape
    if slot_mask is not None:
        block_tables = torch.where(slot_mask[:, None], block_tables, 0)
    idx = block_tables.reshape(-1).long().clamp(0, pool.shape[0] - 1)
    return pool.index_select(0, idx).reshape(B, nb * pool.shape[1],
                                             *pool.shape[2:])


def _check_attn_operands(q, k, v, name: str) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name}: q, k and v must all be CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    _build.dtype_code(q)
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    if k.shape != v.shape or k.stride() != v.stride():
        raise ValueError(f"{name}: k and v caches differ in shape or layout")
    if k.stride(-1) != 1:
        raise ValueError(f"{name}: the cache's head_dim must be contiguous")
    dh = q.shape[-1]
    if k.shape[0] != q.shape[0] or k.shape[-1] != dh:
        raise ValueError(f"{name}: cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if dh > 128 or dh % 8:
        raise ValueError(f"{name}: head_dim {dh} must be a multiple of 8 and "
                         f"at most 128")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    g = q.shape[-2] // k.shape[2]
    if g not in _GQA_GROUPS:
        raise ValueError(f"{name}: {g} query heads per kv head; the kernel "
                         f"takes {_GQA_GROUPS}")
