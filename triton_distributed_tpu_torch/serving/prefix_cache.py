"""Radix-tree prefix cache: content-addressed, ref-counted KV block reuse.

Counterpart of ``triton_distributed_tpu/serving/prefix_cache.py``, kept
whole as plain Python except the fault sites of ``match``/``match_len``
(:169-170, :195-196), which port with ``resilience/``; ``metrics`` is a
plain counter dict until ``obs/metrics`` is ported.

Production traffic shares long prompt prefixes — chat system prompts,
few-shot templates, multi-turn continuations — yet a plain paged pool
re-prefills every admitted request from token 0. SGLang's RadixAttention
showed that a radix tree over token sequences turns vLLM-style block
sharing into an automatic, eviction-aware cache; this module is that
design on the repo's terms: the tree, the refcounts, and the LRU are all
HOST-SIDE DATA between steps, so cache hits and misses flow into
the engine as nothing but different (offsets, block_tables) operands and
the two serving steps keep their shapes.

Structure
  The tree is keyed on BLOCK-GRANULAR token-id chunks: each node owns one
  pool block and the tuple of (at most ``block_size``) token ids whose KV
  that block holds; a node's path from the root spells the full token
  prefix, so lookup is content-addressed — same tokens, same KV, whoever
  computed it. Children are keyed by their exact chunk tuple (a dict), so
  two sequences that share part of a block and then diverge simply hang
  two sibling nodes (different blocks — their KV really is different from
  the divergence point on) off the same parent; full-chunk descent is one
  hash probe per block. Partial chunks (a sequence's tail that fills only
  part of a block) are always leaves: a child's KV must start at a block
  boundary, so nothing can extend below a partial node.

Sharing rules
  * FULL-chunk matches are adopted by REFERENCE: the pool increfs the
    block into the new sequence's table and the engine starts prefill
    after it. Adopted blocks are never written (the sequence's first
    uncached token lands in the next, private, block).
  * A PARTIAL match — the lookup diverges mid-block, or ends inside a
    block — is adopted by COPY-ON-WRITE: ``KVPool.ensure`` copies the
    source block's rows into a fresh private block on device (an
    in-place block copy; see ``_copy_block_device``) and the sequence
    overwrites the copy's tail. The resident original is untouched, so
    every other reader keeps bit-identical KV.
  * Finished sequences INSERT: walking the tree with the tokens they
    actually computed, each chunk not yet present donates the sequence's
    own block (``KVPool.promote_to_cached`` — no copy, the KV is already
    in place); chunks already present keep the tree's copy and the
    sequence's duplicate goes back to the free list at release.

Eviction
  Unreferenced-but-resident blocks form the LRU pool. ``evict`` removes
  stalest LEAVES first (an interior node outlives its subtree, so every
  resident path stays matchable root-to-node), and ``KVPool.ensure`` pulls
  through it automatically when the free list runs short — a cold burst
  steals block-by-block from the coldest cached prefixes.

Bit-identity
  KV for token t is a deterministic function of the token prefix and
  absolute position, and the engine's chunked prefill / decode paths are
  row-independent and bit-identical to each other (the serving test
  suite's standing guarantee), so cached-prefix decode emits exactly the
  tokens cold-prefill decode would — tests/test_prefix_cache.py proves it
  end-to-end through preemption churn (the port's
  tests/test_torch_serving.py holds the same).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PrefixMatch:
    """One lookup result: what ``KVPool.ensure`` should adopt.

    ``blocks``   full-chunk cache blocks, adopted by reference (increfed).
    ``cow_src``  block whose prefix only partially matches — adopted by
                 copy-on-write (None when the match ends on a boundary).
    ``cow_valid`` tokens of ``cow_src`` that match (0 when no cow).
    ``match_len`` total cached tokens: ``len(blocks) * block_size +
                 cow_valid`` — the engine's prefill start offset.
    """

    blocks: list
    cow_src: int | None
    cow_valid: int
    match_len: int


class _Node:
    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent):
        self.key = key            # tuple of <= block_size token ids
        self.block = block        # pool block id holding this chunk's KV
        self.parent = parent
        self.children = {}        # exact chunk tuple -> _Node
        self.last_used = 0        # logical LRU clock


class RadixPrefixCache:
    """The tree + LRU + pool-residency manager. Construction attaches the
    cache to ``pool`` as its reclaim provider. ``metrics`` (a dict of
    counters, usually the BatchEngine's) receives the ``prefix_*``
    counters; None disables them. ``enabled`` is a host-side toggle:
    flipping it changes no step, so cold and warm passes run the same
    steps."""

    def __init__(self, pool, *, metrics=None):
        self.pool = pool
        self.block_size = pool.block_size
        self.metrics = metrics
        self.enabled = True
        self._root = _Node((), -1, None)
        self._clock = 0
        self._n_nodes = 0
        pool.attach_cache(self)

    def __len__(self) -> int:
        """Resident nodes (== cache-resident blocks)."""
        return self._n_nodes

    def _inc(self, name: str, amount: int = 1) -> None:
        if self.metrics is not None:
            self.metrics[name] = self.metrics.get(name, 0) + amount

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    # -- lookup --------------------------------------------------------------

    def _walk(self, tokens):
        """Longest cached prefix of ``tokens``: the full-chunk node path,
        plus the best partial continuation (the child of the last matched
        node sharing the longest head of the remaining tokens)."""
        bs = self.block_size
        node, nodes, pos = self._root, [], 0
        while len(tokens) - pos >= bs:
            child = node.children.get(tuple(tokens[pos:pos + bs]))
            if child is None:
                break
            nodes.append(child)
            node = child
            pos += bs
        rest = tuple(tokens[pos:pos + bs])
        best, best_len = None, 0
        if rest:
            for key, child in node.children.items():
                n = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    n += 1
                if n > best_len:
                    best, best_len = child, n
        return nodes, best, best_len

    def match(self, tokens, *, max_len: int | None = None) -> PrefixMatch:
        """Longest cached prefix of ``tokens[:max_len]`` as a
        ``PrefixMatch`` for ``KVPool.ensure``. Callers cap ``max_len`` at
        ``len(tokens) - 1``: at least one prompt token must be recomputed
        so the admission still produces first-token logits."""
        if not self.enabled:
            return PrefixMatch([], None, 0, 0)
        self._inc("prefix_lookups")
        toks = list(tokens if max_len is None else tokens[:max_len])
        if not toks:
            return PrefixMatch([], None, 0, 0)
        nodes, tail, tail_valid = self._walk(toks)
        for nd in nodes:
            self._touch(nd)
        if tail is not None and tail_valid:
            self._touch(tail)
        return PrefixMatch(
            blocks=[nd.block for nd in nodes],
            cow_src=tail.block if tail is not None and tail_valid else None,
            cow_valid=tail_valid if tail is not None else 0,
            match_len=(len(nodes) * self.block_size
                       + (tail_valid if tail is not None else 0)))

    def match_len(self, tokens, *, max_len: int | None = None) -> int:
        """Budget probe for ``Scheduler.admit``: cached-prefix length in
        tokens, with NO LRU or refcount side effects (admission may probe
        many queued requests it never pops)."""
        if not self.enabled:
            return 0
        toks = list(tokens if max_len is None else tokens[:max_len])
        if not toks:
            return 0
        nodes, tail, tail_valid = self._walk(toks)
        return (len(nodes) * self.block_size
                + (tail_valid if tail is not None else 0))

    # -- insertion -----------------------------------------------------------

    def insert(self, seq_id, tokens) -> int:
        """Absorb ``seq_id``'s computed KV into the tree: walk
        ``tokens`` chunk-by-chunk against the sequence's block table and
        promote every block whose chunk is not yet cached
        (``KVPool.promote_to_cached`` — residency transfer, no copy).
        Chunks already present keep the tree's existing block; the
        sequence's duplicate stays private and frees at release. Returns
        the number of blocks newly promoted.

        ``tokens`` must be exactly the tokens whose KV the table holds
        (the engine passes ``(ctx + output)[:offset]``); the caller
        releases the table AFTERWARDS, dropping each promoted block's
        refcount to its resident-only 0."""
        if not self.enabled:
            return 0
        bs = self.block_size
        table = self.pool.table(seq_id)
        node, pos, idx, created = self._root, 0, 0, 0
        n = len(tokens)
        while pos < n and idx < len(table):
            chunk = tuple(tokens[pos:pos + bs])
            child = node.children.get(chunk)
            if child is None:
                blk = table[idx]
                if self.pool.is_cached(blk):
                    # Defensive: an adopted block must sit on the path its
                    # tokens spell; never promote twice.
                    break
                if len(chunk) < bs and any(
                        k[:len(chunk)] == chunk for k in node.children):
                    break   # a longer cached block already covers this tail
                child = _Node(chunk, blk, node)
                node.children[chunk] = child
                self.pool.promote_to_cached(seq_id, blk)
                self._n_nodes += 1
                created += 1
            self._touch(child)
            if len(chunk) < bs:
                break       # partial chunks are always leaves
            node, pos, idx = child, pos + bs, idx + 1
        if created:
            self._inc("prefix_inserted_blocks", created)
        return created

    # -- eviction ------------------------------------------------------------

    def evict(self, n_blocks: int, *, exclude=frozenset()) -> int:
        """LRU eviction: free up to ``n_blocks`` UNREFERENCED resident
        blocks, stalest LEAVES first (interior nodes outlive their
        subtrees so every surviving path stays matchable), skipping
        ``exclude`` (blocks an in-flight ``ensure`` is about to adopt).
        Returns how many blocks actually went back to the free list.

        The scan is O(nodes) per evicted block — fine at pool scale
        (hundreds of blocks); swap in a heap if pools grow 100x."""
        freed = 0
        while freed < n_blocks:
            victim = None
            for nd in self._iter_nodes():
                if nd.children or nd.block in exclude:
                    continue
                if self.pool.refs(nd.block) != 0:
                    continue
                if victim is None or nd.last_used < victim.last_used:
                    victim = nd
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self.pool.uncache(victim.block)
            self._n_nodes -= 1
            freed += 1
        if freed:
            self._inc("prefix_evicted_blocks", freed)
        return freed

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    def drop(self) -> int:
        """Evict every unreferenced resident block (tests, or an operator
        reclaiming the whole cache under memory pressure). Referenced
        blocks survive — their readers are still decoding."""
        return self.evict(self._n_nodes)

    def stats(self) -> dict:
        return {"nodes": self._n_nodes,
                "resident_blocks": self.pool.n_cached,
                "reclaimable_blocks": self.pool.n_reclaimable}
