"""Single-card flash attention: causal varlen GQA prefill and split-KV
decode against a contiguous KV cache.

Counterpart of ``triton_distributed_tpu/kernels/sp_attention.py``:

- ``flash_prefill`` (:412) -> ``csrc/flash_prefill.cu``, replacing
  ``_flash_prefill_kernel`` (:308); bf16 at head_dim 128 that TMA can read
  on the ``wgmma`` tile of ``csrc/attn_wgmma.cuh``
  (``flash_prefill_wgmma_items`` and ``prefill_wgmma_tile`` mirror its
  items), the rest on ``csrc/flash_prefill.cuh``'s tiles;
- ``flash_decode_local`` (:654) -> ``csrc/flash_decode.cu``, replacing both
  ``_flash_decode_kernel`` (:511) and ``_flash_decode_bd_kernel`` (:567).
  The block-diagonal variant is a layout trick for the TPU's matrix unit;
  one CUDA kernel serves both contracts, with the cache layout passed as
  strides.

The JAX prefill returns None on shapes Mosaic cannot tile
(``prefill_alignment_issue``); the CUDA kernel masks ragged edges, so the
port's ``flash_prefill`` always answers.

Each entry point takes CUDA tensors to the kernel and CPU tensors to the
plain version beside it (``flash_prefill_ref``, ``flash_decode_ref``).
``paged_gather_kv`` (:800), the paged pool's table walk, is the serving
path's reference oracle.

Sequence parallelism at world > 1, the ranks simulated on one card (every
rank's shard in a rank stack, ``(world, ...)``):

- ``flash_decode_device`` (:861): one ``flash_decode_local`` launch over
  every rank's cache shard, the (out, lse) partials packed in JAX's wire
  format (``_pack_decode_partial`` :850), exchanged over the ring
  allgather (``kernels/allgather.py``) or the LL one
  (``kernels/ll_allgather.py``), and merged by log-sum-exp in torch ops
  (JAX merges in ``jnp`` outside any kernel);
- ``sp_ag_attention_device`` (:147) -> ``csrc/sp_ag_attn.cu``, replacing
  ``_sp_attn_kernel`` (:47): the KV allgather overlapped into a
  streaming-softmax attention.

The 2-D variants (``flash_decode_2d_device``, ``sp_ag_attention_2d_device``)
are not ported and raise: their inter-slice leg needs NCCL across cards.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal

FLASH_PREFILL = _build.register(
    "flash_prefill", "triton_distributed_tpu_torch/csrc/flash_prefill.cu",
    "triton_distributed_tpu/kernels/sp_attention.py:308")
# Replaces _flash_decode_bd_kernel (:567), the variant the main path reaches
# (Hkv * g >= 16 in the bshd layout), and _flash_decode_kernel (:511).
FLASH_DECODE = _build.register(
    "flash_decode", "triton_distributed_tpu_torch/csrc/flash_decode.cu",
    "triton_distributed_tpu/kernels/sp_attention.py:567")
SP_AG_ATTN = _build.register(
    "sp_ag_attn", "triton_distributed_tpu_torch/csrc/sp_ag_attn.cu",
    "triton_distributed_tpu/kernels/sp_attention.py:47")

# JAX's mask value (:44): a softmax state that has seen no key keeps it as
# its max, so an empty shard's partial has lse ~ -1e30 and merge weight 0.
_NEG_INF = -1e30


# Query heads per kv head that the kernels are instantiated for (a divisor
# of flash_prefill.cu's 64-row tile, and flash_decode.cu's dispatch).
_GQA_GROUPS = (1, 2, 4, 8, 16)

# Keys of one split of the split-KV decode, in the contiguous and the
# paged instantiation alike (the build compiles it into the kernel).
DECODE_SPLIT = _build.DECODE_SPLIT


def decode_splits(S: int) -> int:
    """Splits of the decode kernel over a cache of S positions (the
    contiguous cache's length, or max_blocks x block_size of a paged
    table): ceil(S / DECODE_SPLIT), at least 1. A static shape only, never
    the valid lengths, which live on the device."""
    return max(1, -(-S // DECODE_SPLIT))


def flash_decode_splits(k_cache: torch.Tensor,
                        kv_layout: str = "bhsd") -> int:
    """Splits of ``flash_decode_cuda`` over this cache: ``decode_splits``
    of its length."""
    return decode_splits(_to_bshd(k_cache, kv_layout).shape[1])


def decode_scratch(name: str, splits: int, B: int, Hq: int, Hkv: int,
                   dh: int, device) -> tuple[torch.Tensor | None,
                                             torch.Tensor | None]:
    """``(partials, arrivals)`` of a decode launch over ``splits`` splits:
    f32 partials (B, Hq, splits, dh + 2) from ``torch.empty`` and the (B,
    Hkv) arrival counters of ``name`` (``_signal.arrivals``: the last block
    of each (row, kv head) resets its counter); both None at one split."""
    if splits == 1:
        return None, None
    part = torch.empty((B, Hq, splits, dh + 2), dtype=torch.float32,
                       device=device)
    return part, _signal.arrivals(device, name, B * Hkv)


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


def prefill_mask(offset, kv_len, seq_lens, B: int, L: int, S: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """The prefill's mask, as the plain version applies it: ``(valid,
    key_ok)``, valid (B, L, S) where query j of row b may see key s (s at
    or before its position, s below the row's kv_len, j below its q_len)
    and key_ok (B, S) where key s lies below the row's kv_len."""
    offs, kvl, qln = _rows(offset, kv_len, seq_lens, B, L, device)
    offs, kvl, qln = (torch.as_tensor(x, dtype=torch.int32,
                                      device=device).reshape(-1).expand(B)
                      for x in (offs, kvl, qln))
    key_pos = torch.arange(S, device=device)
    rows = torch.arange(L, device=device)
    q_pos = offs[:, None] + rows[None]                                # (B, L)
    key_ok = key_pos[None] < kvl[:, None]                             # (B, S)
    valid = ((key_pos[None, None] <= q_pos[..., None])
             & key_ok[:, None]
             & (rows[None, :, None] < qln[:, None, None]))            # (B,L,S)
    return valid, key_ok


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
    valid, key_ok = prefill_mask(offset, kv_len, seq_lens, B, L, S,
                                 q.device)
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


PREFILL_WGMMA_ROWS = 128  # query rows of a wgmma tile
PREFILL_WGMMA_KEYS = 128  # keys of one of its chunks


def prefill_wgmma_ready(q, k_cache, scale: float) -> int:
    """1 when a call runs the ``wgmma`` tile: bf16 at head_dim 128, a
    positive scale, and the (bshd view of the) cache's batch, sequence and
    head strides whole numbers of 16-byte units (q is contiguous and every
    base 16-byte aligned already); else 0, and the call keeps
    ``flash_prefill.cuh``'s tiles."""
    return int(q.dtype == torch.bfloat16 and q.shape[-1] == 128
               and scale > 0
               and all(st % 8 == 0 for st in k_cache.stride()[:3]))


def flash_prefill_wgmma_items(B: int, L: int, Hq: int,
                              Hkv: int) -> list[tuple]:
    """The ``wgmma`` prefill kernel's tiles in ticket order (``csrc/
    flash_prefill.cu``): ``(b, h, qt)``, tile qt of batch row b's kv head
    h, one (b, h)'s tiles in a row, latest (the heaviest under the causal
    mask) first."""
    ppt = PREFILL_WGMMA_ROWS // (Hq // Hkv)
    n_tiles = -(-L // ppt)
    return [(b, h, qt) for b in range(B) for h in range(Hkv)
            for qt in reversed(range(n_tiles))]


def prefill_wgmma_tile(qt: int, h: int, *, L: int, Hq: int, Hkv: int,
                       S: int, offset: int, kv_len: int,
                       q_len: int) -> dict:
    """What tile qt of kv head h computes for a batch row of the given
    offset, kv_len and q_len (``csrc/flash_prefill.cu`` ``attend``):
    ``rows``, its 128 (position, q head) pairs in shared-memory order
    (positions at or past L are loaded as zeros and never stored);
    ``keys``, each row's key limit (it sees keys [0, limit): the causal
    frontier and kv_len, 0 for a padding row); ``chunks``, the 128-key
    chunks it loads; ``boundary``, the chunk whose V rows at or past kv_len
    are zeroed before any product reads them (None when no loaded chunk
    straddles kv_len)."""
    g = Hq // Hkv
    ppt = PREFILL_WGMMA_ROWS // g
    p0 = qt * ppt
    kv_len = min(kv_len, S)
    q_len = min(q_len, L)
    q_hi = min(p0 + ppt, q_len)
    kv_hi = min(kv_len, offset + q_hi) if q_hi > p0 else 0
    chunks = -(-kv_hi // PREFILL_WGMMA_KEYS) if kv_hi > 0 else 0
    rows = [(p0 + r // g, h * g + r % g) for r in range(PREFILL_WGMMA_ROWS)]
    keys = [max(0, min(offset + p + 1, kv_len)) if p < q_hi else 0
            for p, _ in rows]
    boundary = None
    for j in range(chunks):
        if kv_len - j * PREFILL_WGMMA_KEYS < PREFILL_WGMMA_KEYS:
            boundary = j
    return dict(rows=rows, keys=keys, chunks=chunks, boundary=boundary)


def flash_prefill_cuda(q, k_cache, v_cache, *, offset=None, kv_len=None,
                       seq_lens=None, scale: float | None = None,
                       kv_layout: str = "bshd") -> torch.Tensor:
    """Launch ``csrc/flash_prefill.cu``; see ``flash_prefill`` for the
    contract. bf16 at head_dim 128 that TMA can read
    (``prefill_wgmma_ready``) runs the ``wgmma`` tile on one persistent
    grid whose ticket is the stream's (``_signal.arrivals``, left at 0 by
    the kernel): with integer offsets a call is one device operation. The
    rest run one block per (row, kv head, q tile)."""
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
    stream = _build.stream_ptr(q)
    tma = prefill_wgmma_ready(q, k_cache, scale)
    ticket = (_signal.arrivals(q.device, FLASH_PREFILL.name, 1, stream)
              .data_ptr() if tma else None)
    err = _build.lib().tdt_flash_prefill(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        rows_ptr, offs, kvl, qln, B, L, Hq, Hkv, S, dh, sb, ss, sh,
        float(scale), _build.dtype_code(q), tma, ticket, stream)
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


def flash_decode_split_ref(q, k_cache, v_cache, *, kv_len=None,
                           scale: float | None = None,
                           kv_layout: str = "bhsd",
                           split: int = DECODE_SPLIT):
    """The split-and-merge algebra of the decode kernel, in torch: each
    split of ``split`` keys gives a partial (m, l, acc) over its keys below
    kv_len (m = -inf, l = 0 when it holds none), and the partials are
    folded in split order, a partial at -inf weighing 0; out = acc /
    max(l, 1e-30), lse = m + log(max(l, 1e-30)). f32, the contract of
    ``flash_decode_ref``: a model of the kernel, not its plain version."""
    B, Hq, dh = q.shape
    k_cache = _to_bshd(k_cache, kv_layout).float()
    v_cache = _to_bshd(v_cache, kv_layout).float()
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    kvl = torch.as_tensor(_decode_kv_lens(kv_len, B, S, q.device),
                          dtype=torch.int32,
                          device=q.device).reshape(-1).expand(B)
    qf = q.float().reshape(B, Hkv, Hq // Hkv, dh) * scale
    neg = torch.tensor(float("-inf"), device=q.device)
    m = torch.full((B, Hkv, Hq // Hkv), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, Hq // Hkv, dh), device=q.device)
    for s0 in range(0, S, split):
        pos = torch.arange(s0, min(s0 + split, S), device=q.device)
        ok = pos[None] < kvl[:, None]                              # (B, n)
        kf = torch.where(ok[..., None, None], k_cache[:, s0:s0 + split], 0.)
        vf = torch.where(ok[..., None, None], v_cache[:, s0:s0 + split], 0.)
        sc = torch.einsum("bhgd,bshd->bhgs", qf, kf)
        sc = torch.where(ok[:, None, None, :], sc, neg)
        ms = sc.amax(dim=-1)                  # -inf: no key of the split
        p = torch.where(ms[..., None] == neg, 0.,
                        torch.exp(sc - ms[..., None]))
        ls = p.sum(dim=-1)
        accs = torch.einsum("bhgs,bshd->bhgd", p, vf)
        M = torch.maximum(m, ms)
        wa = torch.where(m == neg, 0., torch.exp(m - M))
        wb = torch.where(ms == neg, 0., torch.exp(ms - M))
        l = l * wa + ls * wb
        acc = acc * wa[..., None] + accs * wb[..., None]
        m = M
    den = l.clamp_min(1e-30)
    out = acc / den[..., None]
    return out.reshape(B, Hq, dh), (m + torch.log(den)).reshape(B, Hq)


def flash_decode_cuda(q, k_cache, v_cache, *, kv_len=None,
                      scale: float | None = None, kv_layout: str = "bhsd"):
    """Launch ``csrc/flash_decode.cu``: split-KV, ``decode_splits(S)``
    blocks per (row, kv head); see ``flash_decode_local`` for the
    contract."""
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
    if any(st % 8 for st in (sb, ss, sh)):
        raise ValueError(f"flash_decode: cache strides {(sb, ss, sh)} must "
                         f"be multiples of 8 elements (16-byte rows)")
    splits = decode_splits(S)
    part, arrivals = decode_scratch("flash_decode_arrivals", splits, B, Hq,
                                    Hkv, dh, q.device)
    err = _build.lib().tdt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lse.data_ptr(), lens_ptr, kv_scalar, B, Hq, Hkv, S, dh, sb, ss, sh,
        float(scale), _build.dtype_code(q),
        None if part is None else part.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(), splits,
        _build.stream_ptr(q))
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


# ---------------------------------------------------------------------------
# Sequence parallelism over simulated ranks
# ---------------------------------------------------------------------------


def decode_partial_feat(dh: int) -> int:
    """Width of a packed (out, lse) decode-partial row (JAX :842): dh + 1
    rounded up to 128. An LL staging for the partial exchange is sized by
    it."""
    return ((dh + 1 + 127) // 128) * 128


def _pack_decode_partial(out: torch.Tensor, lse: torch.Tensor,
                         dh: int) -> torch.Tensor:
    """The decode partials' wire format (JAX :850): rows ``[out | lse |
    0-pad]`` of width ``decode_partial_feat(dh)``, one per (row, head) of
    ``out (..., dh)``. An lse below JAX's -1e30 (a shard that saw no key)
    is sent as -1e30, as JAX's kernel leaves it."""
    rows = out.numel() // dh
    packed = torch.zeros(rows, decode_partial_feat(dh), dtype=out.dtype,
                         device=out.device)
    packed[:, :dh] = out.reshape(rows, dh)
    packed[:, dh] = lse.reshape(rows).clamp_min(_NEG_INF)
    return packed


def flash_decode_device(q, k_cache_local, v_cache_local, *, world: int = 1,
                        kv_len=None, scale: float | None = None,
                        ll_staging=None, ll_epoch=None):
    """Distributed decode attention with the KV sequence sharded over the
    ranks (JAX :861).

    World 1: q (B, Hq, dh), k/v_cache_local (B, Hkv, m_kv, dh), ``kv_len``
    the valid length (int or (B,)); returns ``flash_decode_local``'s out in
    q's dtype. World > 1: q (B, Hq, dh) shared by every rank,
    k/v_cache_local every rank's shard stacked, (world, B, Hkv, m_kv, dh),
    ``kv_len`` each rank's LOCAL valid length (an int for every rank, a
    (world,) tensor, or (world, B) for one per row); one
    ``flash_decode_local`` launch over all world B rows, the partials
    packed (``_pack_decode_partial``) and gathered over the ring allgather,
    or over the LL allgather when ``ll_staging`` (world, 2, world - 1, B
    Hq, decode_partial_feat(dh)) and ``ll_epoch`` are given, then merged by
    log-sum-exp. Returns every rank's output (world, B, Hq, dh), and the
    staging with ``ll_staging``."""
    return _sp_decode(q, k_cache_local, v_cache_local, world, kv_len, scale,
                      ll_staging, ll_epoch, plain=False)


def flash_decode_device_ref(q, k_cache_local, v_cache_local, *,
                            world: int = 1, kv_len=None,
                            scale: float | None = None, ll_staging=None,
                            ll_epoch=None):
    """The plain pipeline of ``flash_decode_device`` on any device: the
    same steps through the plain versions of its kernels
    (``flash_decode_ref``, ``all_gather_ref``, ``ll_all_gather_ref``)."""
    return _sp_decode(q, k_cache_local, v_cache_local, world, kv_len, scale,
                      ll_staging, ll_epoch, plain=True)


def _sp_decode(q, k, v, world, kv_len, scale, ll_staging, ll_epoch, plain):
    from triton_distributed_tpu_torch.kernels import allgather as ag
    from triton_distributed_tpu_torch.kernels import ll_allgather as ll

    local = flash_decode_ref if plain else flash_decode_local
    B, H, dh = q.shape
    if world == 1:
        out = local(q, k, v, kv_len=kv_len, scale=scale)[0].to(q.dtype)
        return (out, ll_staging) if ll_staging is not None else out
    if k.dim() != 5 or k.shape[0] != world:
        raise ValueError(f"flash_decode_device at world {world} takes every "
                         f"rank's cache shard stacked, (world, B, Hkv, m_kv, "
                         f"dh), got {tuple(k.shape)}")
    feat = decode_partial_feat(dh)
    if ll_staging is not None and ll_staging.shape[-1] != feat:
        raise ValueError(
            f"ll_staging feature width {ll_staging.shape[-1]} != "
            f"decode_partial_feat({dh}) = {feat}; size the staging as "
            f"make_ll_staging((B*H, decode_partial_feat(dh)), ...) — the "
            f"packed (out, lse) rows are lane-padded")
    rows = world * B
    lens = None
    if kv_len is not None:
        lens = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
        lens = lens.reshape(-1, 1) if lens.dim() < 2 else lens
        lens = lens.expand(world, B).reshape(rows)
    out, lse = local(q.expand(world, B, H, dh).reshape(rows, H, dh),
                     k.reshape(rows, *k.shape[2:]),
                     v.reshape(rows, *v.shape[2:]), kv_len=lens, scale=scale)
    packed = _pack_decode_partial(out, lse, dh).reshape(world, B * H, feat)
    if ll_staging is not None:
        exchange = ll.ll_all_gather_ref if plain else \
            lambda x, s, e: ll.ll_all_gather_device(x, s, e, world=world)
        gathered, ll_staging = exchange(packed, ll_staging, ll_epoch)
    else:
        gathered = (ag.all_gather_ref(packed) if plain
                    else ag.ring_all_gather(packed, world=world))
    gathered = gathered.reshape(world, world, B, H, feat)   # [rank, source]
    outs, lses = gathered[..., :dh], gathered[..., dh]
    w = torch.softmax(lses, dim=1)[..., None]
    out = (w * outs).sum(dim=1).to(q.dtype)
    return (out, ll_staging) if ll_staging is not None else out


def flash_decode_2d_device(*args, **kwargs):
    """JAX :927: the decode partials merged within a slice, then across
    slices over a dcn axis. Not ported: the inter-slice leg needs NCCL
    across cards (see ROADMAP.md)."""
    raise NotImplementedError("flash_decode_2d_device (SP decode over a dcn "
                              "axis) is not ported: see ROADMAP.md")


def _single_device_attn(q, k, v, *, causal: bool, scale: float):
    """World-1 SP prefill (JAX :292), as torch ops where JAX uses ``jnp``:
    q/k/v (H, m, dh), dense softmax attention in f32."""
    scores = torch.einsum("hmd,hnd->hmn", q.float(), k.float()) * scale
    if causal:
        m, n = scores.shape[-2:]
        mask = (torch.arange(m, device=q.device)[:, None]
                >= torch.arange(n, device=q.device)[None, :])
        scores = torch.where(mask, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("hmn,hnd->hmd", p, v.float()).to(q.dtype)


def _sp_offsets(world: int, m: int, row_offset, col_offset) -> list:
    """Each rank's first global q row (default r m) and the global column
    of its gathered keys' first (default 0), as two lists of ints: an int
    applies to every rank, a sequence or tensor gives one per rank."""
    def per_rank(x, default):
        if x is None:
            return default
        if isinstance(x, torch.Tensor):
            x = x.tolist()
        if isinstance(x, int):
            return [x] * world
        if len(x) != world:
            raise ValueError(f"an offset per rank: {world} values, got "
                             f"{len(x)}")
        return [int(v) for v in x]

    return [per_rank(row_offset, [r * m for r in range(world)]),
            per_rank(col_offset, [0] * world)]


def sp_ag_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None, row_offset=None,
                        col_offset=None, return_partials: bool = False):
    """Plain version of the SP prefill in the kernel's order: per rank, the
    segments own first, a streaming softmax in f32 carried across them
    (segments right of the rank's last row skipped when causal), heads in
    groups sized to keep the scores near 1 GiB. q (world, H, m, dh), k/v
    (world, H, m_kv, dh); returns out (world, H, m, dh) in q's dtype, and
    with ``return_partials`` the lse (world, H, m) f32 (a row that saw no
    key: -1e30, JAX's value)."""
    world, H, m, dh = q.shape
    m_kv = k.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    rows0, cols0 = _sp_offsets(world, m, row_offset, col_offset)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((world, H, m), dtype=torch.float32, device=q.device)
    hc = max(1, min(H, (1 << 28) // (m * m_kv)))
    keys = torch.arange(m_kv, device=q.device)
    for r in range(world):
        qpos = rows0[r] + torch.arange(m, device=q.device)
        for h0 in range(0, H, hc):
            hs = slice(h0, h0 + hc)
            qf = q[r, hs].float() * scale
            n = qf.shape[0]
            acc = torch.zeros(n, m, dh, device=q.device)
            mx = torch.full((n, m, 1), float("-inf"), device=q.device)
            den = torch.zeros(n, m, 1, device=q.device)
            for s in range(world):
                src = (r + s) % world
                cb = cols0[r] + src * m_kv
                if causal and cb > rows0[r] + m - 1:
                    continue
                sc = torch.einsum("hmd,hnd->hmn", qf, k[src, hs].float())
                if causal:
                    valid = (cb + keys)[None, :] <= qpos[:, None]
                    sc = sc.masked_fill(~valid, float("-inf"))
                new = torch.maximum(mx, sc.amax(-1, keepdim=True))
                safe = torch.where(torch.isfinite(new), new, 0.0)
                corr = torch.exp(mx - safe)
                p = torch.exp(sc - safe)
                den = den * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum("hmn,hnd->hmd", p,
                                                v[src, hs].float())
                mx = new
                del sc, p
            d = den.clamp_min(1e-30)
            out[r, hs] = (acc / d).to(q.dtype)
            lse[r, hs] = (torch.where(torch.isfinite(mx), mx, _NEG_INF)
                          + torch.log(d))[..., 0]
    return (out, lse) if return_partials else out


# Query rows of a tile of the wgmma kernel (bf16 at head_dim 128), and the
# heads whose pushes it hands out ahead of their attend items.
SP_WGMMA_ROWS = 128
SP_PUSH_LOOKAHEAD = 2


def sp_ag_attn_items(world: int, H: int, m: int,
                     lookahead: int = SP_PUSH_LOOKAHEAD) -> list[tuple]:
    """The wgmma kernel's work items in ticket order (``wg_item_of`` in
    ``csrc/sp_ag_attn.cu``): ``("push", src, h)`` copies rank src's K and
    V of head h into every rank's staging and raises the flags (dst, src,
    h) for every dst; ``("attend", r, h, qt)`` is rank r's 128-row q tile
    qt of head h, which waits on the flags (r, src, h) of the segments it
    reads. The pushes of heads 0 .. lookahead - 1 first, then for each head
    h the pushes of head h + lookahead (while there is one) and h's attend
    items, ranks and tiles latest first, one (rank, head)'s tiles in a
    row."""
    n_tiles = -(-m // SP_WGMMA_ROWS)
    la = min(lookahead, H)
    items = [("push", s, h) for h in range(la) for s in range(world)]
    for h in range(H):
        if h + la < H:
            items += [("push", s, h + la) for s in range(world)]
        items += [("attend", r, h, qt) for r in reversed(range(world))
                  for qt in reversed(range(n_tiles))]
    return items


def sp_ag_attention_cuda(q, k, v, *, causal: bool = True,
                         scale: float | None = None, row_offset=None,
                         col_offset=None, return_partials: bool = False,
                         k_full=None, v_full=None,
                         producer_delay_ns: int = 0):
    """Launch ``csrc/sp_ag_attn.cu`` on the current stream: q (world, H, m,
    dh), k/v (world, H, m_kv, dh), contiguous, f32 or bf16, dh a multiple
    of 8 up to 128 (bf16 at 128 on the wgmma tile, in the item order of
    ``sp_ag_attn_items``; the ticket is the stream's persistent one, left
    at 0 by the kernel). Returns (out (world, H, m, dh), lse (world, H, m) f32
    or None, k_full, v_full): the staging (world, world, H, m_kv, dh), rank
    dst's gathered K and V at [dst] (default: new buffers). ``k_full``,
    ``v_full`` and ``producer_delay_ns`` (every producer item sleeps that
    long) let a test poison the staging and hold the copies back; the
    result must not change."""
    world, H, m, dh = q.shape
    m_kv = k.shape[2]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("sp_ag_attention_cuda takes CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("sp_ag_attention_cuda: q/k/v dtypes differ")
    if (k.shape != v.shape or k.shape[:2] != (world, H) or k.shape[3] != dh
            or not all(t.is_contiguous() for t in (q, k, v))):
        raise ValueError(f"sp_ag_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"contiguous (world, H, m, dh) and (world, H, m_kv, "
                         f"dh)")
    if dh > 128 or dh % 8:
        raise ValueError(f"sp_ag_attention_cuda: head_dim {dh} must be a "
                         f"multiple of 8 and at most 128")
    code = _build.dtype_code(q)
    shape = (world, world, H, m_kv, dh)
    stages = []
    for buf in (k_full, v_full):
        if buf is None:
            buf = torch.empty(shape, dtype=q.dtype, device=q.device)
        elif (tuple(buf.shape) != shape or buf.dtype != q.dtype
              or buf.device != q.device or not buf.is_contiguous()):
            raise ValueError(f"k_full / v_full must be contiguous {shape} "
                             f"{q.dtype} tensors on {q.device}")
        stages.append(buf)
    scale = dh ** -0.5 if scale is None else scale
    offs = torch.tensor(_sp_offsets(world, m, row_offset, col_offset),
                        dtype=torch.int32).to(q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((world, H, m), dtype=torch.float32, device=q.device)
           if return_partials else None)
    stream = _build.stream_ptr(q)
    flags = _signal.flags(q.device, SP_AG_ATTN.name, world * world * H,
                          stream)
    ticket = _signal.arrivals(q.device, SP_AG_ATTN.name, 1, stream)
    err = _build.lib().tdt_sp_ag_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), stages[0].data_ptr(),
        stages[1].data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), offs.data_ptr(),
        flags.data_ptr(), ticket.data_ptr(), _signal.next_epoch(q.device),
        world, H, m, m_kv, dh, int(causal), float(scale), code,
        producer_delay_ns, stream)
    _build.check(err, "tdt_sp_ag_attn")
    SP_AG_ATTN.launches += 1
    return out, lse, stages[0], stages[1]


def sp_ag_attention_device(q_local, k_local, v_local, *, world: int = 1,
                           causal: bool = True, scale: float | None = None,
                           row_offset=None, col_offset=None,
                           return_partials: bool = False):
    """SP prefill attention with the KV allgather overlapped (JAX :147).

    At world 1, q/k/v_local (H, m, dh): without partials or offsets the
    dense attention in torch ops (``_single_device_attn``, as JAX uses
    ``jnp``), else the kernel path over a stack of one. At world > 1 every
    rank's shard stacked, q (world, H, m, dh), k/v (world, H, m_kv, dh):
    each rank's q rows attended over every rank's keys, causal by global
    position. ``row_offset`` / ``col_offset``: each rank's first global q
    row (default r m) and its gathered keys' first global column (default
    0), an int for every rank or one per rank. Returns out (world, H, m,
    dh), and with ``return_partials`` also the lse (world, H, m) f32: the
    kernel on CUDA tensors, the plain version on CPU ones."""
    H, m, dh = q_local.shape[-3:]
    scale = dh ** -0.5 if scale is None else scale
    if world == 1 and q_local.dim() == 3:
        if not return_partials and row_offset is None and col_offset is None:
            return _single_device_attn(q_local, k_local, v_local,
                                       causal=causal, scale=scale)
        res = sp_ag_attention_device(
            q_local[None], k_local[None], v_local[None], world=1,
            causal=causal, scale=scale, row_offset=row_offset,
            col_offset=col_offset, return_partials=return_partials)
        return (res[0][0], res[1][0]) if return_partials else res[0]
    if q_local.dim() != 4 or q_local.shape[0] != world:
        raise ValueError(f"sp_ag_attention_device at world {world} takes "
                         f"every rank's shard stacked, (world, H, m, dh), "
                         f"got {tuple(q_local.shape)}")
    kw = dict(causal=causal, scale=scale, row_offset=row_offset,
              col_offset=col_offset, return_partials=return_partials)
    if q_local.is_cuda:
        out, lse = sp_ag_attention_cuda(q_local.contiguous(),
                                        k_local.contiguous(),
                                        v_local.contiguous(), **kw)[:2]
        return (out, lse) if return_partials else out
    return sp_ag_attention_ref(q_local, k_local, v_local, **kw)


def sp_ag_attention_2d_device(*args, **kwargs):
    """JAX :240: the intra-slice overlap kernel plus a slice-level ring over
    a dcn axis. Not ported: the inter-slice leg needs NCCL across cards
    (see ROADMAP.md)."""
    raise NotImplementedError("sp_ag_attention_2d_device (SP prefill over a "
                              "dcn axis) is not ported: see ROADMAP.md")
