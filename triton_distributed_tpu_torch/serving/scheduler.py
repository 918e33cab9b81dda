"""Iteration-level request scheduler (Orca-style continuous batching).

Counterpart of ``triton_distributed_tpu/serving/scheduler.py``, kept whole
as plain Python (the port imports nothing of the JAX package); only the
trace hook of ``admit`` (:223-226) waits for ``obs/``, and
``event_sink`` stays.

Scheduling happens BETWEEN engine iterations, on host: after every
step the engine asks the scheduler which waiting requests to admit into
free slots (and, under memory pressure, which running request to evict).
Requests therefore join and leave the batch at token granularity instead of
batch granularity — the Orca insight — while the step itself never
changes shape (``serving/batch_engine.py``).

Policies (deliberately simple, swappable):
  queue      priority-then-FIFO: a binary heap on (-priority, arrival_seq).
             Equal-priority traffic is exact FIFO; higher ``priority``
             values jump the line.
  admission  admit the head request only if the KV pool can hold its WHOLE
             prompt plus one generated token right now (all blocks are
             allocated at admission). With a prefix cache attached, fully
             cached blocks are adopted by reference instead of allocated,
             so admission charges only the uncached suffix (the
             ``match_len`` probe). No lookahead reservation for future
             decode growth — that's what preemption is for.
  preemption ``select_victim``: lowest priority first, latest-admitted
             first among equals (LIFO — the youngest request has the least
             sunk prefill work to throw away). Eviction is by RECOMPUTE:
             the victim's blocks are freed and the request re-queued with
             its generated tokens appended to the prompt, preserving its
             original arrival_seq, so under greedy sampling its remaining
             output is unchanged (the re-prefill of prompt+generated yields
             the same next token the evicted decode would have).
  aging      a request preempted ``preemption_cap`` times becomes
             NON-EVICTABLE: without the cap, a low-priority request under
             sustained higher-priority pressure livelocks (evict ->
             requeue -> re-prefill -> evict, forever, burning recompute
             each lap). ``select_victim(..., preemption_cap=n)`` skips
             aged requests; the batch engine falls back to ignoring the
             cap only when EVERY candidate is aged (liveness beats
             fairness — somebody must yield or no slot can grow).
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import itertools

from triton_distributed_tpu_torch.serving.kv_pool import blocks_needed


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` grows on preemption (recompute);
    ``output`` accumulates every generated token across preemptions."""

    req_id: object
    prompt: list[int]
    max_new_tokens: int
    priority: int = 0                 # higher = more important
    arrival_seq: int | None = None    # set once, at first submit
    output: list[int] = dataclasses.field(default_factory=list)
    # host-clock timestamps (time.monotonic), filled by the batch engine
    submit_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None
    n_preemptions: int = 0
    # resilience: "pending" -> "ok" | "failed"; ``error`` holds the reason
    # when the batch engine quarantines the request instead of crashing.
    status: str = "pending"
    error: str | None = None
    # Journey trace context (obs/journey.JourneyContext): rides ON the
    # request so hop numbering survives preemption, drain, and
    # cross-replica requeue — one id space per request across the fleet.
    journey: object | None = None
    # Billing identity for the efficiency ledger's per-tenant cost table.
    # Rides on the request (like ``journey``) so cost attribution follows
    # the request across preemption, drain, and cross-replica requeue —
    # the ledger bills the replica where the work actually ran.
    tenant: str | None = None

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - len(self.output)

    @property
    def context_len(self) -> int:
        """Tokens to prefill at (re-)admission: the original prompt plus
        everything generated before a preemption (eviction-by-recompute)."""
        return len(self.prompt) + len(self.output)

    # -- checkpoint wire format (resilience/checkpoint.py) ------------------
    # Host-side truth only: ``journey`` is deliberately excluded (a restored
    # request begins a FRESH timeline with phase="restore" — hop causality
    # across a crash is the journal's job, not the tracer's), and the
    # monotonic timestamps are dropped (meaningless in the next process).

    def to_wire(self) -> dict:
        return {
            "req_id": self.req_id,
            "prompt": [int(t) for t in self.prompt],
            "max_new_tokens": int(self.max_new_tokens),
            "priority": int(self.priority),
            "arrival_seq": self.arrival_seq,
            "output": [int(t) for t in self.output],
            "n_preemptions": int(self.n_preemptions),
            "status": self.status,
            "error": self.error,
            "tenant": self.tenant,
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "Request":
        return cls(
            req_id=wire["req_id"],
            prompt=list(wire["prompt"]),
            max_new_tokens=wire["max_new_tokens"],
            priority=wire.get("priority", 0),
            arrival_seq=wire.get("arrival_seq"),
            output=list(wire.get("output", ())),
            n_preemptions=wire.get("n_preemptions", 0),
            status=wire.get("status", "pending"),
            error=wire.get("error"),
            tenant=wire.get("tenant"),
        )


class Scheduler:
    """Priority-FIFO waiting queue + admission control + victim selection."""

    def __init__(self, *, preemption_cap: int | None = 4):
        self._heap: list[tuple[int, int, Request]] = []
        self._seq = itertools.count()
        # After this many evictions a request ages out of the victim pool
        # (see module docstring). None disables aging.
        self.preemption_cap = preemption_cap
        # Optional ``(kind, **fields)`` callable (the batch engine wires the
        # blackbox's ``record``): scheduling decisions land in the same
        # flight recorder as the request lifecycle. None = off.
        self.event_sink = None

    def __len__(self) -> int:
        return len(self._heap)

    def submit(self, req: Request) -> None:
        if req.arrival_seq is None:
            req.arrival_seq = next(self._seq)
        heapq.heappush(self._heap, (-req.priority, req.arrival_seq, req))

    # A preempted request keeps its arrival_seq, so it re-enters the queue
    # at its original FIFO position within its priority class.
    requeue = submit

    def peek(self) -> Request | None:
        return self._heap[0][2] if self._heap else None

    def pending(self) -> list[Request]:
        """The waiting requests, in heap (not pop) order — a read-only view
        for ownership audits (``Fleet.check_invariants``) and health
        tables; never mutates the queue."""
        return [req for _, _, req in self._heap]

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def backlog_tokens(self) -> int:
        """Total context tokens (prompt + accumulated output) waiting to
        be prefilled — the queue-side half of the adaptive controller's
        prefill-backlog observation."""
        return sum(req.context_len for _, _, req in self._heap)

    def admit(self, *, free_slots: int, free_blocks: int,
              block_size: int | None = None, blocks_for=None,
              match_len=None) -> list[Request]:
        """Head-of-line admission: pop requests while a slot is free and the
        pool can hold the request's UNCACHED suffix plus one generated
        token right now. Stops at the first request that does not fit (no
        skip-ahead — skipping would starve big requests).

        Block accounting is delegated so admission and allocation can never
        disagree on rounding: pass ``blocks_for`` as the ``KVPool`` itself
        (or any ``n_tokens -> n_blocks`` callable); ``block_size`` alone
        keeps the legacy signature, routing through the same
        ``kv_pool.blocks_needed`` the pool uses.

        ``match_len`` (a ``Request -> int`` probe, usually
        ``RadixPrefixCache.match_len`` over the request's context) is the
        prefix-cache discount: FULL cached blocks are adopted by reference
        rather than allocated, so a mostly-cached request is charged only
        ``matched // block_size`` fewer blocks — a CoW tail block still
        costs one fresh block, so partial matches discount nothing. The
        probe is advisory (eviction between probe and ``ensure`` can
        shrink the real match); the engine re-matches at adoption time and
        requeues on a genuine shortfall."""
        if blocks_for is None:
            if block_size is None:
                raise TypeError("admit() requires blocks_for (a KVPool or "
                                "n_tokens->n_blocks callable) or block_size")
            bf = functools.partial(blocks_needed, block_size=block_size)
            bs = block_size
        elif callable(blocks_for):
            bf = blocks_for
            bs = block_size
        else:                          # duck-typed KVPool
            bf = blocks_for.blocks_for
            bs = blocks_for.block_size
        if match_len is not None and bs is None:
            raise TypeError("match_len discounting needs block_size (or a "
                            "pool-shaped blocks_for)")
        admitted: list[Request] = []
        budget = free_blocks
        while len(admitted) < free_slots and self._heap:
            head = self.peek()
            need = bf(head.context_len + 1)
            if match_len is not None:
                # Engine caps adoption at context_len-1 (at least one token
                # must be recomputed for first-token logits) — mirror it.
                matched = min(int(match_len(head)),
                              max(head.context_len - 1, 0))
                need -= matched // bs
            if need > budget:
                break
            budget -= need
            admitted.append(self.pop())
        if admitted and self.event_sink is not None:
            self.event_sink("schedule_admit", admitted=len(admitted),
                            waiting=len(self._heap),
                            free_slots=free_slots, blocks_left=budget)
        return admitted

    @staticmethod
    def select_victim(running, *, exclude=(), preemption_cap=None):
        """Pick the eviction victim among ``running`` (iterable of
        (key, Request, admit_seq)): lowest priority, then latest admitted.
        With ``preemption_cap``, requests already preempted that many times
        are aged out of the candidate pool (anti-starvation). Returns the
        winning key, or None if nothing is evictable."""
        best = None
        for key, req, admit_seq in running:
            if key in exclude:
                continue
            if (preemption_cap is not None
                    and req.n_preemptions >= preemption_cap):
                continue
            rank = (req.priority, -admit_seq)
            if best is None or rank < best[0]:
                best = (rank, key)
        return None if best is None else best[1]
