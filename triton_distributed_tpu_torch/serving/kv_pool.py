"""Block-paged KV pool: the device arenas and the host-side allocator.

Counterpart of ``triton_distributed_tpu/serving/kv_pool.py``. One fixed
device allocation of ``n_blocks`` KV blocks per layer,

    k, v: (n_layers, n_blocks, block_size, n_kv_heads, head_dim)

(plus per-row f32 scale arenas (n_layers, n_blocks, block_size,
n_kv_heads) when the pool stores int8/fp8), and a plain-Python free-list
allocator mapping sequences onto blocks. A sequence of ``n`` tokens owns
``ceil(n / block_size)`` blocks, listed in order in its block table; the
serving steps consume only the resulting (block_tables, offsets, slot_mask)
data, so allocation churn never changes a shape.

Where the JAX pool is a functional pytree updated through buffer donation,
this one is written in place: the steps write the arenas, and a
copy-on-write adoption copies one block of every layer with an in-place
slice copy.

Prefix caching (``prefix_cache.py``) adds a third block state beside free
and owned: CACHE-RESIDENT, with a reference count (the number of sequence
tables containing the block). ``ensure`` adopts cached blocks by
reference or by copy-on-write, ``release`` decrements instead of freeing,
and unreferenced residents are the LRU eviction pool that ``ensure``
reclaims through the attached cache. ``check_invariants`` proves the
partition free / private-owned / cached exact after every mutation.

Not ported: the fault site of ``ensure`` (:275-276, with ``resilience/``),
``geometry`` (checkpoint manifests) and ``reclaim_to``/``headroom_frac``
(the adaptive controller), all listed in ROADMAP.md.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

from triton_distributed_tpu_torch.runtime.device import resolve_device

#: Wire dtypes the pool can quantize KV storage into. "fp8" is the serving
#: alias for float8_e4m3fn.
KV_WIRE_DTYPES = {
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
    "float8_e4m3fn": torch.float8_e4m3fn,
}

#: Version tag of the per-row symmetric absmax scheme
#: (``layers.nn.quantize_kv_rows``); part of ``kv_fingerprint``.
KV_QUANT_SCHEME = "rowmax:v1"


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as numpy/JAX spell it ("bfloat16", "int8", ...)."""
    return str(dtype).removeprefix("torch.")


def resolve_kv_dtype(config, kv_dtype):
    """Map a ``kv_dtype`` value to ``(torch.dtype, quantized)``: None (or
    the model dtype, as a dtype or by name) is unquantized storage in
    ``config.dtype``; "int8"/"fp8" (or those dtypes) are quantized wire
    formats."""
    if kv_dtype is None:
        return config.dtype, False
    if isinstance(kv_dtype, str):
        if kv_dtype in KV_WIRE_DTYPES:
            return KV_WIRE_DTYPES[kv_dtype], True
        if kv_dtype == dtype_name(config.dtype):
            return config.dtype, False
    elif kv_dtype == config.dtype:
        return config.dtype, False
    elif kv_dtype in (torch.int8, torch.float8_e4m3fn):
        return kv_dtype, True
    raise ValueError(
        f"unsupported kv_dtype {kv_dtype!r}: expected None, "
        f"{sorted(KV_WIRE_DTYPES)}, or the model dtype "
        f"{dtype_name(config.dtype)!r}")


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """THE block-rounding rule, ``ceil(n_tokens / block_size)``, shared by
    allocation (``KVPool.blocks_for``) and admission (``Scheduler.admit``)."""
    return math.ceil(n_tokens / block_size)


@dataclasses.dataclass
class PagedKVState:
    """Device half of the pool. Quantized pools carry the two scale arenas;
    unquantized ones have None there."""

    k: torch.Tensor   # (n_layers, n_blocks, block_size, n_kv_heads, head_dim)
    v: torch.Tensor
    k_scale: torch.Tensor | None = None   # (n_layers, n_blocks, bs, Hkv)
    v_scale: torch.Tensor | None = None


class KVPool:
    """Fixed block pool + free-list allocator + per-sequence block tables.

    ``n_blocks`` blocks of ``block_size`` tokens on ``device`` (default the
    card; no card raises); ``max_seq_len`` bounds one sequence and sets the
    fixed table width (``max_blocks_per_seq``) the steps see."""

    def __init__(self, config, *, n_blocks: int, block_size: int = 16,
                 max_seq_len: int | None = None, device=None,
                 kv_dtype=None):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError(f"bad pool geometry ({n_blocks=}, {block_size=})")
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.max_seq_len = max_seq_len or config.max_length
        self.max_blocks_per_seq = math.ceil(self.max_seq_len / block_size)
        self.kv_dtype, self.kv_quant = resolve_kv_dtype(config, kv_dtype)
        device = resolve_device(device)
        shape = (config.n_layers, n_blocks, block_size, config.n_kv_heads,
                 config.head_dim)
        k = torch.zeros(shape, dtype=self.kv_dtype, device=device)
        v = torch.zeros(shape, dtype=self.kv_dtype, device=device)
        ks = vs = None
        if self.kv_quant:
            ks = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            vs = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        self.state = PagedKVState(k=k, v=v, k_scale=ks, v_scale=vs)
        # LIFO free list, low block ids first out.
        self._free: list[int] = list(range(n_blocks - 1, -1, -1))
        self._tables: dict[object, list[int]] = {}
        # Cache residency: block id -> refcount (tables containing it);
        # refcount 0 = unreferenced but resident (LRU-evictable).
        self._cached: dict[int, int] = {}
        # Cached block -> kv_fingerprint() at promotion; adoption refuses a
        # block recorded under another wire format.
        self._cached_fp: dict[int, str] = {}
        self._cache = None        # attached RadixPrefixCache (LRU reclaim)

    # -- allocator ----------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        """Blocks resident in the prefix cache (referenced or not)."""
        return len(self._cached)

    @property
    def n_reclaimable(self) -> int:
        """Cache-resident blocks with refcount 0: what an LRU pass could
        free right now."""
        return sum(1 for r in self._cached.values() if r == 0)

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_needed(n_tokens, self.block_size)

    def kv_fingerprint(self) -> str:
        """Wire-format identity of the pool's KV bytes, ``dtype:scheme``
        (e.g. "int8:rowmax:v1", "bfloat16:none"): adoption of a cached
        block is legal only between identical fingerprints."""
        scheme = KV_QUANT_SCHEME if self.kv_quant else "none"
        return f"{dtype_name(self.kv_dtype)}:{scheme}"

    def ensure(self, seq_id, n_tokens: int, *, adopt=(),
               cow_src: int | None = None) -> bool:
        """Grow ``seq_id``'s table until it covers ``n_tokens`` tokens.
        Returns False, allocating and adopting NOTHING, when the free list
        (after an LRU reclaim through the attached prefix cache) cannot
        cover the growth.

        ``adopt`` (admission only: the sequence must be new) lists
        cache-resident blocks that become the table's prefix by REFERENCE
        (increfed, never written: the engine starts prefill past them).
        ``cow_src`` names one more resident block whose prefix only partly
        matches: it is adopted by COPY-ON-WRITE into a fresh private block
        (every layer's K/V rows, and scales, copied on the device), which
        the sequence may then overwrite."""
        if n_tokens > self.max_seq_len:
            raise ValueError(f"sequence length {n_tokens} exceeds pool "
                             f"max_seq_len {self.max_seq_len}")
        table = self._tables.get(seq_id)
        adopt = list(adopt)
        adopting = bool(adopt) or cow_src is not None
        if adopting and table is not None:
            raise ValueError(
                f"cache adoption for {seq_id!r} is admission-time only: "
                f"the sequence already owns a table")
        here = self.kv_fingerprint()
        for b in adopt + ([cow_src] if cow_src is not None else []):
            if b not in self._cached:
                raise KeyError(f"adopting block {b} that is not "
                               f"cache-resident")
            fp = self._cached_fp.get(b, here)
            if fp != here:
                raise ValueError(
                    f"adopting block {b} quantized as {fp!r} into a "
                    f"{here!r} pool: mixed-dtype adoption would hand the "
                    f"sequence bytes from an incompatible wire format")
        n_cow = 1 if cow_src is not None else 0
        have = len(table) if table is not None else len(adopt) + n_cow
        need = self.blocks_for(n_tokens) - have   # fresh private blocks
        if adopting and need < 0:
            raise ValueError("adopted prefix longer than the sequence")
        draw = need + n_cow                       # drawn from the free list
        if draw <= 0 and not adopting:
            return True
        if draw > len(self._free) and self._cache is not None:
            # LRU reclaim, never of the blocks this call adopts.
            pinned = frozenset(adopt)
            if cow_src is not None:
                pinned |= {cow_src}
            self._cache.evict(draw - len(self._free), exclude=pinned)
        if draw > len(self._free):
            return False
        new_blocks: list[int] = []
        if cow_src is not None:
            dst = self._free.pop()
            self._copy_block_device(cow_src, dst)
            new_blocks.append(dst)
        new_blocks.extend(self._free.pop() for _ in range(need))
        if table is None:
            for b in adopt:
                self._cached[b] += 1
            table = self._tables[seq_id] = list(adopt)
        table.extend(new_blocks)
        return True

    def release(self, seq_id) -> None:
        """Return ``seq_id``'s PRIVATE blocks to the free list and decref
        its cache-resident ones (they stay resident for the next match).
        An unknown or already released ``seq_id`` raises before anything
        changes."""
        table = self._tables.pop(seq_id, None)
        if table is None:
            raise KeyError(
                f"release of unknown seq_id {seq_id!r}: never allocated or "
                f"already released (double release?)")
        for b in reversed(table):
            r = self._cached.get(b)
            if r is None:
                self._free.append(b)
            else:
                if r <= 0:
                    raise AssertionError(f"cached block {b} refcount "
                                         f"underflow")
                self._cached[b] = r - 1

    def truncate(self, seq_id, n_tokens: int) -> int:
        """Shrink ``seq_id``'s table to exactly ``blocks_for(n_tokens)``
        blocks (``n_tokens`` >= 1, never growing), freeing PRIVATE tail
        blocks and decrefing cached ones. Rows past ``n_tokens`` inside the
        last kept block stay: the step operands exclude them and the next
        token overwrites them. Returns the blocks freed."""
        table = self._tables.get(seq_id)
        if table is None:
            raise KeyError(
                f"truncate of unknown seq_id {seq_id!r}: never allocated "
                f"or already released")
        if n_tokens < 1:
            raise ValueError(
                f"truncate to {n_tokens} tokens would leave an empty "
                f"table; use release() to retire the sequence")
        keep = self.blocks_for(n_tokens)
        if keep > len(table):
            raise ValueError(
                f"truncate cannot grow: {seq_id!r} owns {len(table)} "
                f"blocks, {n_tokens} tokens need {keep}")
        freed = 0
        while len(table) > keep:
            b = table.pop()
            r = self._cached.get(b)
            if r is None:
                self._free.append(b)
                freed += 1
            else:
                if r <= 0:
                    raise AssertionError(f"cached block {b} refcount "
                                         f"underflow")
                self._cached[b] = r - 1
        return freed

    # -- prefix-cache residency (prefix_cache.py drives these) --------------

    def attach_cache(self, cache) -> None:
        """Register the prefix cache as this pool's LRU reclaim provider
        (one per pool; None detaches)."""
        if cache is not None and self._cache is not None:
            raise RuntimeError("pool already has an attached prefix cache")
        self._cache = cache

    def is_cached(self, block: int) -> bool:
        return block in self._cached

    def refs(self, block: int) -> int:
        """Refcount of a cache-resident block (KeyError if not cached)."""
        return self._cached[block]

    def promote_to_cached(self, seq_id, block: int) -> None:
        """Move one of ``seq_id``'s PRIVATE blocks into cache residency
        (refcount 1, dropping to 0 at the table's release)."""
        table = self._tables.get(seq_id)
        if table is None or block not in table:
            raise KeyError(f"promote of block {block} not owned by "
                           f"{seq_id!r}")
        if block in self._cached:
            raise ValueError(f"block {block} is already cache-resident")
        self._cached[block] = 1
        self._cached_fp[block] = self.kv_fingerprint()

    def uncache(self, block: int) -> None:
        """Eviction endpoint: drop residency of an UNREFERENCED cached
        block and free it."""
        r = self._cached.get(block)
        if r is None:
            raise KeyError(f"uncache of non-resident block {block}")
        if r:
            raise ValueError(f"uncache of block {block} with {r} live "
                             f"references")
        del self._cached[block]
        self._cached_fp.pop(block, None)
        self._free.append(block)

    def _copy_block_device(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src``'s K/V rows of every layer into
        ``dst``, in place, and in a quantized pool its scale rows with them
        (a wire row without its scale is garbage)."""
        st = self.state
        for arena in (st.k, st.v, st.k_scale, st.v_scale):
            if arena is not None:
                arena[:, dst].copy_(arena[:, src])

    def fragmentation(self) -> dict:
        """Free-list shape: ``free_blocks``, ``largest_free_run`` (longest
        run of consecutive free ids), ``frag_frac`` (1 - run/free) and
        ``cached_blocks``."""
        free = sorted(self._free)
        longest = run = 0
        prev = None
        for b in free:
            run = run + 1 if prev is not None and b == prev + 1 else 1
            longest = max(longest, run)
            prev = b
        frag = 0.0 if not free else 1.0 - longest / len(free)
        return {"free_blocks": len(free), "largest_free_run": longest,
                "frag_frac": round(frag, 4),
                "cached_blocks": len(self._cached)}

    def table(self, seq_id) -> list[int]:
        return list(self._tables.get(seq_id, ()))

    def padded_tables(self, seq_ids) -> np.ndarray:
        """(len(seq_ids), max_blocks_per_seq) int32 slot-ordered tables,
        zero-padded (None = empty slot): the fixed-shape step operand. An
        unknown non-None seq_id raises (an all-zero row would read another
        sequence's block 0)."""
        out = np.zeros((len(seq_ids), self.max_blocks_per_seq), np.int32)
        for row, sid in enumerate(seq_ids):
            if sid is None:
                continue
            t = self._tables.get(sid)
            if t is None:
                raise KeyError(
                    f"padded_tables for unknown seq_id {sid!r}: never "
                    f"allocated or already released")
            out[row, :len(t)] = t
        return out

    def check_invariants(self) -> None:
        """Allocator soundness, raising AssertionError on a breach: free,
        private-owned and cached partition the pool exactly, each cached
        block's refcount equals its table occurrences, no table is empty,
        fingerprints track residency, and the scale arenas exist iff the
        pool is quantized, shaped like the K/V arenas minus head_dim."""
        owned = [b for t in self._tables.values() for b in t]
        occ = collections.Counter(owned)
        private = [b for b in owned if b not in self._cached]
        free_set = set(self._free)
        st = self.state
        checks = [
            (len(set(private)) == len(private), "private block owned twice"),
            (len(free_set) == len(self._free), "free list duplicate"),
            (not (set(owned) & free_set), "block both free and owned"),
            (not (set(self._cached) & free_set),
             "block both free and cached"),
            (len(private) + len(self._cached) + len(self._free)
             == self.n_blocks, "blocks leaked"),
            (all(0 <= b < self.n_blocks
                 for b in owned + self._free + list(self._cached)),
             "block id out of range"),
            (set(self._cached_fp) == set(self._cached),
             "cached-block fingerprints out of sync with residency"),
            (st.k.dtype == self.kv_dtype,
             f"pool arena dtype {st.k.dtype} != declared {self.kv_dtype}"),
        ]
        checks += [(occ.get(b, 0) == r,
                    f"cached block {b}: refcount {r} != {occ.get(b, 0)} "
                    f"table occurrences")
                   for b, r in self._cached.items()]
        empty = [sid for sid, t in self._tables.items() if not t]
        checks.append((not empty, f"empty (stale) tables for seq_ids "
                                  f"{empty!r}"))
        if self.kv_quant:
            checks.append((st.k_scale is not None and st.v_scale is not None
                           and st.k_scale.shape == st.v_scale.shape
                           == st.k.shape[:-1]
                           and st.k_scale.dtype == torch.float32,
                           "quantized pool scale arenas missing or "
                           "misshapen"))
        else:
            checks.append((st.k_scale is None and st.v_scale is None,
                           "unquantized pool carrying scale arenas"))
        for ok, msg in checks:
            if not ok:
                raise AssertionError(msg)
