"""Continuous-batching engine: two fixed-shape steps, slot churn as data.

Counterpart of the core of ``triton_distributed_tpu/serving/batch_engine.py``.
A fixed bank of ``n_slots`` sequence slots runs through two steps built once
from the model ``Engine`` (``Engine.make_paged_step``):

  decode step  (n_slots, 1) token ids: one token for every slot;
  mixed step   (n_slots, prefill_chunk) ids: chunked varlen prefill rows
               and 1-token decode rows in the same iteration (Orca-style
               iteration-level batching), ``seq_lens`` the live tokens.

Their operands (slot mask, per-slot offsets, block tables of width
``max_blocks_per_seq``, per-row seq_lens) are plain data: requests arriving,
finishing, or being preempted and re-admitted never change a shape, and
nothing inside a step reads a value back to the host (tokens are read after
the step). That is what a CUDA-graph capture of the two steps needs, the
counterpart of the JAX engine's one compile per step (``trace_counts``).

KV lives in the block-paged ``KVPool`` (bf16/f32, or int8/fp8 rows with
per-row scales); when the pool runs dry the scheduler evicts by recompute
and the victim's re-prefill reproduces its greedy continuation exactly.
Under greedy sampling the batched run emits the same tokens as independent
per-request ``Engine.serve`` runs (tests/test_torch_serving.py).

Not ported yet (ROADMAP.md Queue 1 items 6-8): speculation; the watchdog,
SLO, controller, incidents, efficiency ledger, journeys, blackbox and tail
sampling; the fault plane with retries, quarantine and ``nan_guard``; the
journal, ``drain``/``adopt``/``share_steps_from`` and the stats snapshots;
``admission_pressure``.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from triton_distributed_tpu_torch.models.sampling import sample_token
from triton_distributed_tpu_torch.serving.kv_pool import KVPool
from triton_distributed_tpu_torch.serving.prefix_cache import RadixPrefixCache
from triton_distributed_tpu_torch.serving.scheduler import Request, Scheduler


@dataclasses.dataclass
class _Slot:
    """Host bookkeeping for one occupied batch slot."""

    req: Request
    admit_seq: int
    ctx: list[int]          # prompt + pre-preemption output: what to prefill
    offset: int = 0         # tokens written into the pool so far
    last_tok: int = 0       # pending decode input (valid once offset>=len(ctx))

    @property
    def prefilling(self) -> bool:
        return self.offset < len(self.ctx)


class BatchEngine:
    """Continuous-batching server over an ``Engine``'s model, params and
    device.

    ``n_slots``       fixed batch width of both steps.
    ``n_blocks``      KV pool size; defaults to full residency for every
                      slot (no preemption). Size it below
                      ``n_slots * ceil(max_seq_len / block_size)`` to
                      oversubscribe.
    ``prefill_chunk`` prompt tokens consumed per row per mixed step, and
                      the mixed step's fixed ids width.
    ``kv_dtype``      None stores KV in the model dtype; "int8"/"fp8" store
                      quantized rows plus per-(row, kv head) f32 scales,
                      quantized at the write and dequantized inside the
                      paged kernel.
    ``paged_attn``    "fused" (the paged kernel) or "gather" (the oracle).
    ``prefix_cache``  attach a ``RadixPrefixCache``: finished requests
                      donate their blocks, and admissions sharing a cached
                      prefix adopt them and start prefill at the match.
    ``seed``          seeds the ``torch.Generator`` the steps sample from
                      when ``engine.temperature > 0`` (one draw per step).

    ``metrics`` counts ``preemptions``, ``prefix_hits``,
    ``prefix_cached_tokens``, ``decode_steps``, ``prefill_steps`` and the
    other events below; ``step_shapes`` holds the operand signatures
    (shapes and dtypes) each step was called with, and ``trace_counts``
    counts them per step: the shapes a JAX step would have been traced
    for, so it stays {"decode": 1, "prefill": 1} through any churn."""

    def __init__(self, engine, *, n_slots: int = 8,
                 n_blocks: int | None = None, block_size: int = 16,
                 prefill_chunk: int = 32, max_seq_len: int | None = None,
                 kv_dtype=None, seed: int = 0, paged_attn: str = "fused",
                 prefix_cache: bool = True):
        if paged_attn not in ("fused", "gather"):
            raise ValueError(
                f"paged_attn must be 'fused' or 'gather', got {paged_attn!r}")
        self.engine = engine
        self.device = engine.device
        self.paged_attn = paged_attn
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        max_seq_len = max_seq_len or engine.max_length
        if n_blocks is None:
            n_blocks = n_slots * -(-max_seq_len // block_size)
        self.pool = KVPool(engine.config, n_blocks=n_blocks,
                           block_size=block_size, max_seq_len=max_seq_len,
                           device=self.device, kv_dtype=kv_dtype)
        self.scheduler = Scheduler()
        self.metrics: collections.Counter = collections.Counter()
        self.prefix_cache = (RadixPrefixCache(self.pool,
                                              metrics=self.metrics)
                             if prefix_cache else None)
        self.step_shapes: dict[str, set] = {"decode": set(), "prefill": set()}
        self._slots: list[_Slot | None] = [None] * n_slots
        self._admit_seq = 0
        self._req_counter = 0
        self._finished: dict[object, Request] = {}
        self._generator = (
            torch.Generator(device=self.device).manual_seed(seed)
            if engine.temperature > 0.0 else None)
        self._build_steps()

    # -- the two steps --------------------------------------------------------

    def _build_steps(self):
        eng = self.engine
        V = eng.config.vocab_size
        quant = self.pool.kv_quant
        fwd_decode = eng.make_paged_step("decode", paged_attn=self.paged_attn,
                                         kv_quant=quant)
        fwd_mixed = eng.make_paged_step("prefill", paged_attn=self.paged_attn,
                                        kv_quant=quant)
        temperature, top_p = eng.temperature, eng.top_p
        pool = self.pool

        def decode_step(tok, offsets, block_tables, slot_mask):
            ids = torch.clamp(tok, 0, V - 1)[:, None]
            logits = fwd_decode(ids, pool.state, offsets, block_tables,
                                slot_mask)
            return sample_token(logits, self._generator,
                                temperature=temperature, top_p=top_p)

        def mixed_step(ids, offsets, block_tables, slot_mask, seq_lens):
            logits = fwd_mixed(torch.clamp(ids, 0, V - 1), pool.state,
                               offsets, block_tables, slot_mask, seq_lens)
            return sample_token(logits, self._generator,
                                temperature=temperature, top_p=top_p)

        self._decode_step = decode_step
        self._mixed_step = mixed_step

    @property
    def trace_counts(self) -> dict[str, int]:
        return {k: len(v) for k, v in self.step_shapes.items()}

    # -- request lifecycle ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               req_id=None) -> object:
        """Queue one request; returns its id (the pool's seq id)."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens>=1")
        total = len(prompt) + max_new_tokens
        if total > self.pool.max_seq_len:
            raise ValueError(f"prompt+max_new_tokens ({total}) exceeds pool "
                             f"max_seq_len ({self.pool.max_seq_len})")
        if self.pool.blocks_for(total) > self.pool.n_blocks:
            raise ValueError(f"request needs {self.pool.blocks_for(total)} "
                             f"blocks; pool has {self.pool.n_blocks} total")
        if req_id is None:
            req_id = f"req-{self._req_counter}"
        self._req_counter += 1
        self.scheduler.submit(Request(
            req_id=req_id, prompt=prompt, max_new_tokens=max_new_tokens,
            priority=priority, submit_t=time.monotonic()))
        return req_id

    def _probe_match_len(self, req: Request) -> int:
        """Side-effect-free cached-prefix probe for the admission budget."""
        return self.prefix_cache.match_len(
            req.prompt + req.output, max_len=max(req.context_len - 1, 0))

    def _admit(self):
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return
        # Unreferenced cached blocks are one eviction away from the free
        # list, so the budget counts them as available.
        avail = self.pool.n_free + self.pool.n_reclaimable
        caching = (self.prefix_cache is not None
                   and self.prefix_cache.enabled)
        admitted = self.scheduler.admit(
            free_slots=len(free), free_blocks=avail, blocks_for=self.pool,
            match_len=self._probe_match_len if caching else None)
        for req in admitted:
            ctx = req.prompt + req.output
            # Match right before ensure: the probe above was advisory, but
            # nothing evicts between this match and the ensure that adopts
            # it. Capped one token short, so the admission still computes
            # first-token logits.
            m = (self.prefix_cache.match(ctx, max_len=len(ctx) - 1)
                 if caching else None)
            if m is not None and m.match_len == 0:
                m = None
            ok = self.pool.ensure(
                req.req_id, len(ctx) + 1,
                adopt=m.blocks if m is not None else (),
                cow_src=m.cow_src if m is not None else None)
            if not ok:
                # The probe over-promised; nothing was allocated. Back to
                # its FIFO position, retried next step.
                self.scheduler.requeue(req)
                self.metrics["admissions_deferred"] += 1
                continue
            matched = m.match_len if m is not None else 0
            self._slots[free.pop(0)] = _Slot(req=req,
                                             admit_seq=self._admit_seq,
                                             ctx=ctx, offset=matched)
            self._admit_seq += 1
            self.metrics["requests_admitted"] += 1
            if caching:
                if matched:
                    self.metrics["prefix_hits"] += 1
                    if m.cow_src is not None:
                        self.metrics["prefix_cow_adoptions"] += 1
                self.metrics["prefix_cached_tokens"] += matched
                self.metrics["prefix_uncached_tokens"] += len(ctx) - matched

    def _preempt(self, idx: int):
        s = self._slots[idx]
        self.pool.release(s.req.req_id)
        s.req.n_preemptions += 1
        self.scheduler.requeue(s.req)
        self._slots[idx] = None
        self.metrics["preemptions"] += 1

    def _ensure_or_preempt(self, idx: int) -> bool:
        """Grow slot ``idx``'s table for its next token, evicting victims
        (possibly ``idx`` itself) until it fits. Victims honour the
        scheduler's aging cap unless every candidate has aged out."""
        s = self._slots[idx]
        while True:
            if self.pool.ensure(s.req.req_id, s.offset + 1):
                return True
            running = [(j, t.req, t.admit_seq)
                       for j, t in enumerate(self._slots) if t is not None]
            victim = Scheduler.select_victim(
                running, preemption_cap=self.scheduler.preemption_cap)
            if victim is None:
                victim = Scheduler.select_victim(running)
                self.metrics["aging_overridden"] += 1
            self._preempt(victim)
            if victim == idx:
                return False

    def _finish(self, idx: int):
        s = self._slots[idx]
        s.req.finish_t = time.monotonic()
        s.req.status = "ok"
        if self.prefix_cache is not None and self.prefix_cache.enabled:
            # Pool positions 0..offset-1 hold the KV of the token stream's
            # first ``offset`` tokens (the last emitted token was never
            # written); donate them before the release.
            toks = (s.req.prompt + s.req.output)[:s.offset]
            self.prefix_cache.insert(s.req.req_id, toks)
        self.pool.release(s.req.req_id)
        self._slots[idx] = None
        self._finished[s.req.req_id] = s.req
        self.metrics["requests_completed"] += 1

    def _record_token(self, s: _Slot, tok: int):
        s.req.output.append(tok)
        s.last_tok = tok
        self.metrics["tokens_generated"] += 1
        if s.req.first_token_t is None:
            s.req.first_token_t = time.monotonic()

    # -- iteration ------------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: admit, fund the decode rows' next token
        (preempting if the pool is full), run one step. Returns False when
        there is nothing to run."""
        self._admit()
        for i in range(self.n_slots):
            s = self._slots[i]
            if s is not None and not s.prefilling:
                self._ensure_or_preempt(i)
        active = [s for s in self._slots if s is not None]
        if not active:
            return False
        if any(s.prefilling for s in active):
            self._run_mixed()
        else:
            self._run_decode()
        return True

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _operands(self):
        sids = [s.req.req_id if s is not None else None for s in self._slots]
        offsets = np.array([s.offset if s else 0 for s in self._slots],
                           np.int32)
        mask = np.array([s is not None for s in self._slots], bool)
        tables = self.pool.padded_tables(sids)
        return (self._to_device(offsets), self._to_device(tables),
                self._to_device(mask))

    def _record_shapes(self, kind: str, operands) -> None:
        self.step_shapes[kind].add(tuple(
            (tuple(t.shape), t.dtype) for t in operands))

    def _run_decode(self):
        tok = self._to_device(np.array(
            [s.last_tok if s else 0 for s in self._slots], np.int32))
        operands = (tok, *self._operands())
        self._record_shapes("decode", operands)
        nxt = self._decode_step(*operands).tolist()    # host read after
        self.metrics["decode_steps"] += 1
        self.metrics["decode_rows"] += sum(s is not None for s in self._slots)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            s.offset += 1
            self._record_token(s, nxt[i])
            if s.req.remaining_new == 0:
                self._finish(i)

    def mixed_operands(self):
        """The mixed step's operands for the slots as they stand, without
        running it: ``(ids, offsets, block_tables, slot_mask, seq_lens)``
        on the device, ids (n_slots, prefill_chunk) with each prefilling
        row's next chunk and each decoding row's pending token."""
        L = self.prefill_chunk
        ids = np.zeros((self.n_slots, L), np.int32)
        seq_lens = np.zeros((self.n_slots,), np.int32)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.prefilling:
                take = min(L, len(s.ctx) - s.offset)
                ids[i, :take] = s.ctx[s.offset:s.offset + take]
                seq_lens[i] = take
            else:
                ids[i, 0] = s.last_tok
                seq_lens[i] = 1
        offsets, tables, mask = self._operands()
        return (self._to_device(ids), offsets, tables, mask,
                self._to_device(seq_lens))

    def _run_mixed(self):
        operands = self.mixed_operands()
        self._record_shapes("prefill", operands)
        nxt = self._mixed_step(*operands).tolist()     # host read after
        seq_lens = operands[-1].tolist()
        self.metrics["prefill_steps"] += 1
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.prefilling:
                self.metrics["prefill_tokens"] += seq_lens[i]
            else:
                self.metrics["decode_rows"] += 1
            s.offset += seq_lens[i]
            if s.offset < len(s.ctx):
                continue            # mid-prompt: the row's logits are interim
            self._record_token(s, nxt[i])
            if s.req.remaining_new == 0:
                self._finish(i)

    # -- run loop -------------------------------------------------------------

    def run(self, max_steps: int | None = None) -> dict:
        """Step until idle (or ``max_steps``); returns
        ``{req_id: [generated token ids]}`` of every finished request."""
        steps = 0
        while max_steps is None or steps < max_steps:
            if not self.step():
                if len(self.scheduler):
                    raise RuntimeError(
                        "requests are queued but none fits an idle engine")
                break
            steps += 1
        return {rid: list(req.output)
                for rid, req in self._finished.items()}

    @property
    def finished(self) -> dict:
        return dict(self._finished)
