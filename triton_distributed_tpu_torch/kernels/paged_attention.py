"""Paged attention: GQA attention of an L-token query block per slot, read
straight from a block-paged KV pool.

Counterpart of ``triton_distributed_tpu/kernels/paged_attention.py``:
``paged_attention`` (:402) and ``paged_decode_attention`` (:613). The
hand-written ``csrc/paged_attention.cu`` replaces ``_paged_attn_kernel``
(:248) in its unquantized and int8/fp8 builds, at every query length:
decode (L == 1), chunked prefill and ragged mixed steps.

``tuned_paged_tile`` and the analyzer registrations (:121-240, :636-828)
are the TPU's tile tuning and VMEM analysis; the CUDA kernel's tiles are
fixed, and neither is ported (see ROADMAP.md).

``paged_attention`` takes CUDA tensors to the kernel and CPU tensors to the
plain version ``paged_attention_ref``; a CUDA tensor the kernel does not
take raises. A serving step builds the per-slot operands once
(``paged_slots``) and each layer calls ``paged_attention_slots`` with them.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels.sp_attention import (
    _GQA_GROUPS,
    decode_scratch,
    decode_splits,
    flash_prefill_ref,
    paged_gather_kv,
)

PAGED_ATTENTION = _build.register(
    "paged_attention", "triton_distributed_tpu_torch/csrc/paged_attention.cu",
    "triton_distributed_tpu/kernels/paged_attention.py:248")

# Wire types of a quantized pool (per-row f32 scales beside it).
QUANT_TYPES = (torch.int8, torch.float8_e4m3fn)


def _check(q, k_pool, k_scale, v_scale) -> None:
    """The contract both paths share (the JAX ``paged_attention`` checks;
    ``paged_slots`` checks the table)."""
    Hq, Hkv = q.shape[2], k_pool.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not divisible by kv heads {Hkv}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is not None:
        if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_scale.shape:
            raise ValueError(f"scale shape {tuple(k_scale.shape)} != pool "
                             f"rows {tuple(k_pool.shape[:3])}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError(f"scales must be float32, got {k_scale.dtype}")


def _lens(kv_lens, q_lens, B: int, L: int, device):
    """(kv_lens, q_lens) as (B,) int32 tensors; q_lens None = all L live."""
    kv = torch.as_tensor(kv_lens, dtype=torch.int32,
                         device=device).reshape(-1).expand(B)
    if q_lens is None:
        return kv, torch.full((B,), L, dtype=torch.int32, device=device)
    return kv, torch.as_tensor(q_lens, dtype=torch.int32,
                               device=device).reshape(-1).expand(B)


def _route_dead_slots(block_tables, slot_mask):
    if slot_mask is None:
        return block_tables
    return torch.where(slot_mask[:, None], block_tables, 0)


@dataclasses.dataclass(frozen=True)
class PagedSlots:
    """The per-slot operands of a paged-attention call: ``tables``
    (B, max_blocks) int32 with dead slots routed to block 0, ``kv_lens``
    and ``q_lens`` (B,) int32, and the kernel's ``rows`` (3, B) int32
    [first query position, kv_len, q_len], where a slot with no live query
    row reads kv_len 0 and does no work. They depend on the step alone, so
    a serving step builds them once and every layer shares them."""

    tables: torch.Tensor
    kv_lens: torch.Tensor
    q_lens: torch.Tensor
    rows: torch.Tensor


def paged_slots(block_tables, kv_lens, L: int, *, q_lens=None,
                slot_mask=None) -> PagedSlots:
    """``PagedSlots`` of an L-token query block; the arguments are those of
    ``paged_attention``."""
    if block_tables.dtype != torch.int32:
        raise TypeError(f"block_tables must be int32 (got "
                        f"{block_tables.dtype}): a float or int64 table cast "
                        f"silently would read the wrong blocks")
    B = block_tables.shape[0]
    tables = _route_dead_slots(block_tables, slot_mask).contiguous()
    kv, ql = _lens(kv_lens, q_lens, B, L, block_tables.device)
    kv_eff = torch.where(ql > 0, kv, 0)
    rows = torch.stack([kv_eff - ql, kv_eff, ql]).to(torch.int32)
    return PagedSlots(tables=tables, kv_lens=kv, q_lens=ql, rows=rows)


def paged_attention_ref(q, k_pool, v_pool, block_tables, kv_lens, *,
                        q_lens=None, slot_mask=None,
                        scale: float | None = None, k_scale=None,
                        v_scale=None) -> torch.Tensor:
    """Plain version of the kernel, with the contract of
    ``paged_attention``: the slots' pool rows gathered through the table
    (``paged_gather_kv``), dequantized as ``float(wire) * scale``, then the
    f32, ``where``-masked causal attention of ``flash_prefill_ref`` with
    row b's queries at ``kv_lens[b] - q_lens[b] + j``. Rows at or past a
    slot's kv_len are replaced by zeros before they meet a probability, so
    garbage in the pool cannot leak."""
    _check(q, k_pool, k_scale, v_scale)
    return _ref(q, k_pool, v_pool, paged_slots(
        block_tables, kv_lens, q.shape[1], q_lens=q_lens,
        slot_mask=slot_mask), scale, k_scale, v_scale)


def _ref(q, k_pool, v_pool, slots: PagedSlots, scale, k_scale, v_scale):
    k = paged_gather_kv(k_pool, slots.tables)
    v = paged_gather_kv(v_pool, slots.tables)
    if k_scale is not None:
        k = k.float() * paged_gather_kv(k_scale, slots.tables)[..., None]
        v = v.float() * paged_gather_kv(v_scale, slots.tables)[..., None]
    return flash_prefill_ref(q, k, v, offset=slots.kv_lens - slots.q_lens,
                             seq_lens=slots.q_lens, scale=scale)


def paged_decode_splits(block_tables: torch.Tensor, block_size: int) -> int:
    """Splits of the decode (L == 1) kernel over these tables:
    ``decode_splits`` of the static max_blocks x block_size positions,
    never of the device-held kv_lens, so a serving step reads nothing back
    and stays capturable."""
    return decode_splits(block_tables.shape[1] * block_size)


def paged_attention_cuda(q, k_pool, v_pool, block_tables, kv_lens, *,
                         q_lens=None, slot_mask=None,
                         scale: float | None = None, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on CUDA tensors; see
    ``paged_attention`` for the contract."""
    _check(q, k_pool, k_scale, v_scale)
    return _launch(q, k_pool, v_pool, paged_slots(
        block_tables, kv_lens, q.shape[1], q_lens=q_lens,
        slot_mask=slot_mask), scale, k_scale, v_scale)


def _launch(q, k_pool, v_pool, slots: PagedSlots, scale, k_scale, v_scale):
    B, L, Hq, dh = q.shape
    n_blocks, bs, Hkv, _ = k_pool.shape
    quant = k_scale is not None
    tables, rows = slots.tables, slots.rows
    tensors = [q, k_pool, v_pool, tables, rows] + (
        [k_scale, v_scale] if quant else [])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda: every operand must be a "
                         "CUDA tensor on q's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda: operands must be contiguous")
    if k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError("paged_attention_cuda: k and v pools differ")
    if k_pool.shape[3] != dh or tables.shape[0] != B:
        raise ValueError(f"paged_attention_cuda: pool {tuple(k_pool.shape)} "
                         f"/ tables {tuple(tables.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if quant != (k_pool.dtype in QUANT_TYPES):
        raise TypeError(f"paged_attention_cuda: a {k_pool.dtype} pool "
                        f"{'needs' if not quant else 'takes no'} scales")
    if not quant and k_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention_cuda: an unquantized pool holds "
                        f"q's dtype {q.dtype}, got {k_pool.dtype}")
    if dh > 128 or dh % 8:
        raise ValueError(f"paged_attention_cuda: head_dim {dh} must be a "
                         f"multiple of 8 and at most 128")
    if Hq // Hkv not in _GQA_GROUPS:
        raise ValueError(f"paged_attention_cuda: {Hq // Hkv} query heads per "
                         f"kv head; the kernel takes {_GQA_GROUPS}")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention_cuda: q and the pools must be "
                         "16-byte aligned")
    q_code = _build.dtype_code(q)
    kv_code = _build.dtype_code(k_pool, allowed=tuple(_build.DTYPE_CODES))
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    splits = paged_decode_splits(tables, bs) if L == 1 else 1
    part, arrivals = decode_scratch("paged_attention_arrivals", splits, B,
                                    Hq, Hkv, dh, q.device)
    err = _build.lib().tdt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        tables.data_ptr(), rows.data_ptr(), out.data_ptr(), B, L, Hq, Hkv,
        n_blocks, bs, tables.shape[1], dh, float(scale), q_code, kv_code,
        None if part is None else part.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(), splits,
        _build.stream_ptr(q))
    _build.check(err, "tdt_paged_attention")
    PAGED_ATTENTION.launches += 1
    return out


def paged_attention_slots(q, k_pool, v_pool, slots: PagedSlots, *,
                          scale: float | None = None, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """``paged_attention`` with its per-slot operands already built
    (``paged_slots``): a CUDA ``q`` launches the kernel, a CPU one runs the
    plain version."""
    _check(q, k_pool, k_scale, v_scale)
    run = _launch if q.is_cuda else _ref
    return run(q, k_pool, v_pool, slots, scale, k_scale, v_scale)


def paged_attention(q, k_pool, v_pool, block_tables, kv_lens, *,
                    q_lens=None, slot_mask=None, scale: float | None = None,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """GQA attention of an L-token query block per slot over a block-paged
    KV pool: decode (L == 1), chunked prefill and ragged mixed steps.

    q: (B, L, Hq, dh), rope'd, the new tokens' K/V already in the pool
    (``layers.nn.paged_cache_update`` runs first). k/v_pool:
    (n_blocks, block_size, Hkv, dh), one layer. block_tables:
    (B, max_blocks) int32; slot b's sequence occupies
    ``block_tables[b, :ceil(kv_lens[b] / block_size)]``, later entries are
    allocator padding and are never followed. kv_lens: int or (B,), each
    slot's valid cache length INCLUDING this step's tokens. q_lens: (B,)
    live query rows per slot (None = all L): row j of slot b sits at
    position ``kv_lens[b] - q_lens[b] + j`` and attends causally up to
    itself; rows past q_lens[b] return exact zeros. slot_mask: (B,) bool;
    dead slots' tables are routed to block 0 and their rows are garbage the
    caller discards. k/v_scale: (n_blocks, block_size, Hkv) f32 per-row
    scales of an int8/fp8 pool, dequantized as ``float(wire) * scale``.
    Returns (B, L, Hq, dh) in q.dtype."""
    return paged_attention_slots(
        q, k_pool, v_pool, paged_slots(block_tables, kv_lens, q.shape[1],
                                       q_lens=q_lens, slot_mask=slot_mask),
        scale=scale, k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, kv_lens, *,
                           slot_mask=None, scale: float | None = None):
    """The single-token entry point: q (B, Hq, dh) -> (B, Hq, dh), with
    ``kv_lens`` the cache length including the token just written; otherwise
    ``paged_attention`` at L == 1."""
    B, Hq, dh = q.shape
    out = paged_attention(q[:, None], k_pool, v_pool, block_tables, kv_lens,
                          slot_mask=slot_mask, scale=scale)
    return out.reshape(B, Hq, dh)
