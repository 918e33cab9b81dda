"""The port's serving path (slice 2) on the CPU.

1. Allocator soundness: ``KVPool.check_invariants`` holds after every
   mutation of a seeded churn of ensure / grow / finish-and-insert /
   preempt-release / truncate, with prefix-cache adoption by reference and
   by copy-on-write (the mirror of the JAX ``test_serving.py:70``).
2. Scheduling decisions: on one seeded op stream the port's ``KVPool``,
   ``RadixPrefixCache`` and ``Scheduler`` make exactly the decisions of
   the JAX classes (tables, free lists, refcounts, matches, admissions,
   victims).
3. ``BatchEngine`` emits the per-request ``Engine`` tokens (greedy, fp32
   ``tiny``) through staggered arrivals, chunked prefill and preemption,
   with both step shapes fixed through the churn and no kernel launch on
   the CPU.
4. ``BatchEngine`` emits the JAX ``BatchEngine``'s tokens on the same
   weights and request stream, in ``dist`` and ``xla``, for unquantized
   fp32 pools and int8/fp8 pools. The JAX side reads its pool through the
   gather oracle: its own tests hold its fused kernel token-identical to
   it (``test_paged_attention.py:418``), the port's
   ``test_torch_paged_attention.py`` holds the kernel's plain version
   against that kernel directly, and a fused JAX engine costs ~12 s in the
   Pallas interpreter.
5. Prefix cache: warm == cold tokens, int8/fp8 included, with hits.
6. The pool addressing is built once per step, not once per layer.
All token comparisons are exact."""

import jax
import numpy as np
import pytest
import torch

from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.runtime.mesh import make_mesh
from triton_distributed_tpu.serving import BatchEngine as JaxBatchEngine
from triton_distributed_tpu.serving import KVPool as JaxKVPool
from triton_distributed_tpu.serving import RadixPrefixCache as JaxCache
from triton_distributed_tpu.serving import Request as JaxRequest
from triton_distributed_tpu.serving import Scheduler as JaxScheduler
from triton_distributed_tpu_torch import (
    BatchEngine,
    Engine,
    KVPool,
    ModelConfig,
    RadixPrefixCache,
    Request,
    Scheduler,
    params_from_jax,
)
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.layers import nn as tnn

CFG = ModelConfig.from_name("tiny")


@pytest.fixture(scope="module")
def jax_setup():
    """A world-1 mesh, the JAX tiny config and its random weights, and the
    port's copy of the same weights."""
    mesh = make_mesh({"tp": 1}, devices=jax.devices()[:1], set_default=False)
    jcfg = JaxConfig.from_name("tiny")
    jeng = JaxEngine(jcfg, mesh=mesh, mode="xla", block_n=8)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), CFG,
                             device="cpu")
    return mesh, jcfg, jeng.params, params


@pytest.fixture(scope="module")
def engine():
    return Engine(CFG, mode="dist", device="cpu", seed=0)


# -- 1. allocator soundness ---------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pool_invariants_under_cache_adoption_churn(kv_dtype):
    pool = KVPool(CFG, n_blocks=12, block_size=4, max_seq_len=32,
                  device="cpu", kv_dtype=kv_dtype)
    cache = RadixPrefixCache(pool)
    rng = np.random.default_rng(42)
    live: dict[str, list[int]] = {}
    next_id = 0

    def check():
        pool.check_invariants()
        f = pool.fragmentation()
        assert f["free_blocks"] == pool.n_free
        assert f["cached_blocks"] == pool.n_cached

    for _ in range(300):
        op = rng.choice(["admit", "grow", "finish", "preempt", "truncate"])
        if op == "admit" and len(live) < 4:
            base = [int(t) for t in
                    rng.integers(0, 8, size=int(rng.integers(6, 20)))]
            if rng.random() < 0.6 and live:
                base = next(iter(live.values()))[:len(base)] or base
            sid = f"s{next_id}"
            next_id += 1
            m = cache.match(base, max_len=len(base) - 1)
            if pool.ensure(sid, len(base) + 1, adopt=m.blocks,
                           cow_src=m.cow_src):
                live[sid] = base
        elif op == "grow" and live:
            sid = list(live)[int(rng.integers(len(live)))]
            toks = live[sid]
            if len(toks) < 28:
                toks.append(int(rng.integers(0, 8)))
                if not pool.ensure(sid, len(toks) + 1):
                    pool.release(sid)
                    del live[sid]
        elif op == "finish" and live:
            sid = list(live)[int(rng.integers(len(live)))]
            cache.insert(sid, live[sid])
            pool.release(sid)
            del live[sid]
        elif op == "preempt" and live:
            sid = list(live)[int(rng.integers(len(live)))]
            pool.release(sid)
            del live[sid]
        elif op == "truncate" and live:
            sid = list(live)[int(rng.integers(len(live)))]
            keep = int(rng.integers(1, len(live[sid]) + 1))
            pool.truncate(sid, keep)
            live[sid] = live[sid][:keep]
        check()
    for sid in list(live):
        pool.release(sid)
    check()
    assert pool.n_free + pool.n_reclaimable == pool.n_blocks
    cache.drop()
    check()
    assert pool.n_free == pool.n_blocks and pool.n_cached == 0
    with pytest.raises(KeyError):
        pool.release("s0")


def test_cow_copies_every_layer_and_its_scales():
    pool = KVPool(CFG, n_blocks=4, block_size=4, max_seq_len=16,
                  device="cpu", kv_dtype="fp8")
    st = pool.state
    for t in (st.k, st.v):
        t.copy_(torch.randn(t.shape).to(t.dtype))
    st.k_scale.copy_(torch.rand(st.k_scale.shape))
    st.v_scale.copy_(torch.rand(st.v_scale.shape))
    before = [t.clone() for t in (st.k, st.v, st.k_scale, st.v_scale)]
    pool._copy_block_device(2, 0)
    for t, old in zip((st.k, st.v, st.k_scale, st.v_scale), before):
        assert torch.equal(t[:, 0].view(torch.uint8)
                           if t.dtype == torch.float8_e4m3fn else t[:, 0],
                           old[:, 2].view(torch.uint8)
                           if old.dtype == torch.float8_e4m3fn else old[:, 2])
        assert torch.equal(t[:, 1:].float(), old[:, 1:].float())
    assert pool.kv_fingerprint() == "float8_e4m3fn:rowmax:v1"


# -- 2. the same decisions as the JAX classes ---------------------------------

def _state(pool, seqs):
    return ({s: pool.table(s) for s in seqs}, list(pool._free),
            dict(pool._cached))


def test_pool_cache_and_scheduler_decisions_match_jax(jax_setup):
    _, jcfg, _, _ = jax_setup
    pools = (JaxKVPool(jcfg, n_blocks=10, block_size=4, max_seq_len=32),
             KVPool(CFG, n_blocks=10, block_size=4, max_seq_len=32,
                    device="cpu"))
    caches = (JaxCache(pools[0]), RadixPrefixCache(pools[1]))
    scheds = (JaxScheduler(), Scheduler())
    req_cls = (JaxRequest, Request)
    rng = np.random.default_rng(7)
    live: dict[str, list[int]] = {}
    base = [int(t) for t in rng.integers(0, 6, size=12)]
    for step in range(150):
        op = rng.choice(["admit", "grow", "finish", "preempt", "queue"])
        if op == "admit" and len(live) < 4:
            n = int(rng.integers(5, 16))
            toks = (base[:n] if rng.random() < 0.5 else
                    [int(t) for t in rng.integers(0, 6, size=n)])
            sid = f"s{step}"
            results = []
            for pool, cache in zip(pools, caches):
                m = cache.match(toks, max_len=len(toks) - 1)
                results.append((m.blocks, m.cow_src, m.match_len,
                                pool.ensure(sid, len(toks) + 1,
                                            adopt=m.blocks,
                                            cow_src=m.cow_src)))
            assert results[0] == results[1]
            if results[0][-1]:
                live[sid] = toks
        elif op == "grow" and live:
            sid = sorted(live)[int(rng.integers(len(live)))]
            live[sid].append(int(rng.integers(0, 6)))
            oks = [p.ensure(sid, len(live[sid]) + 1) for p in pools]
            assert oks[0] == oks[1]
            if not oks[0]:
                for p in pools:
                    p.release(sid)
                del live[sid]
        elif op in ("finish", "preempt") and live:
            sid = sorted(live)[int(rng.integers(len(live)))]
            for pool, cache in zip(pools, caches):
                if op == "finish":
                    cache.insert(sid, live[sid])
                pool.release(sid)
            del live[sid]
        elif op == "queue":
            prio = int(rng.integers(0, 3))
            plen = int(rng.integers(3, 14))
            for s, cls in zip(scheds, req_cls):
                s.submit(cls(req_id=step, prompt=[1] * plen,
                             max_new_tokens=2, priority=prio))
            free = int(rng.integers(0, 6))
            got = [[r.req_id for r in s.admit(
                free_slots=2, free_blocks=free, blocks_for=pool,
                match_len=lambda r: int(r.req_id) % 5)]
                for s, pool in zip(scheds, pools)]
            assert got[0] == got[1]
            running = [[(i, cls(req_id=i, prompt=[1], max_new_tokens=1,
                                priority=i % 3, n_preemptions=i % 5), i)
                        for i in range(6)] for cls in req_cls]
            assert (JaxScheduler.select_victim(running[0], exclude=(5,),
                                               preemption_cap=4)
                    == Scheduler.select_victim(running[1], exclude=(5,),
                                               preemption_cap=4))
        assert _state(pools[0], live) == _state(pools[1], live)
        assert len(caches[0]) == len(caches[1])
        pools[1].check_invariants()


# -- 3. BatchEngine == per-request Engine --------------------------------------

def _golden(engine, prompt, gen):
    return engine.serve(np.asarray([prompt], np.int32), gen)[0].tolist()


def _stream(be, prompts, gens):
    """Staggered arrivals: two requests, two steps, one more, a step, the
    rest; then run to completion."""
    rids = [be.submit(prompts[0], gens[0]), be.submit(prompts[1], gens[1])]
    be.step()
    be.step()
    rids.append(be.submit(prompts[2], gens[2]))
    be.step()
    rids += [be.submit(p, g) for p, g in zip(prompts[3:], gens[3:])]
    out = be.run(max_steps=1000)
    return [out[r] for r in rids]


@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_batch_engine_matches_engine_through_churn(engine, mode):
    eng = Engine(CFG, mode=mode, device="cpu", params=engine.params)
    rng = np.random.default_rng(0)
    lens, gens = [9, 13, 7, 11, 6], [5, 7, 4, 6, 5]
    prompts = [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in lens]
    # 3 slots, chunks of 4 (< every prompt), 10 blocks of 4: oversubscribed
    be = BatchEngine(eng, n_slots=3, n_blocks=10, block_size=4,
                     prefill_chunk=4)
    _build.reset_counts()
    outs = _stream(be, prompts, gens)
    assert be.metrics["preemptions"] > 0, "pool sized to force preemption"
    for out, p, g in zip(outs, prompts, gens):
        assert out == _golden(eng, p, g)
    # Both steps saw exactly one operand signature each through the churn.
    assert be.trace_counts == {"decode": 1, "prefill": 1}
    assert all(k.launches == 0 for k in _build.KERNELS.values())
    be.pool.check_invariants()
    assert be.pool.n_free + be.pool.n_reclaimable == be.pool.n_blocks
    assert be.metrics["requests_completed"] == len(prompts)
    assert be.metrics["tokens_generated"] == sum(gens)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_pool_addressing_is_built_once_per_step(engine, monkeypatch, kv):
    """The paged addressing (write rows, the kernel's per-slot operands)
    depends on the step alone: ``Qwen3.forward`` builds it once per step
    and no layer builds its own."""
    calls = []
    real = tnn.paged_step

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tnn, "paged_step", counted)
    be = BatchEngine(engine, n_slots=2, block_size=4, prefill_chunk=4,
                     kv_dtype=kv)
    for n in (6, 3):
        be.submit(list(range(1, n + 1)), 3)
    be.run()
    steps = be.metrics["decode_steps"] + be.metrics["prefill_steps"]
    assert be.metrics["decode_steps"] and be.metrics["prefill_steps"]
    assert len(calls) == steps


def test_batch_engine_rejects_bad_requests(engine):
    be = BatchEngine(engine, n_slots=2, n_blocks=4, block_size=4,
                     max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        be.submit([1] * 15, 2)
    with pytest.raises(ValueError, match="non-empty"):
        be.submit([], 2)
    with pytest.raises(ValueError, match="paged_attn"):
        BatchEngine(engine, paged_attn="turbo")
    assert be.run() == {}


# -- 4. BatchEngine == the JAX BatchEngine -------------------------------------

@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_batch_engine_matches_jax_batch_engine(jax_setup, mode, kv):
    mesh, jcfg, jparams, params = jax_setup
    rng = np.random.default_rng(1)
    lens, gens = [9, 5, 12, 7], [4, 5, 3, 4]
    prompts = [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in lens]
    kw = dict(n_slots=3, n_blocks=9, block_size=4, prefill_chunk=8,
              kv_dtype=kv)
    jeng = JaxEngine(jcfg, mesh=mesh, mode=mode, params=jparams, block_n=8)
    jbe = JaxBatchEngine(jeng, paged_attn="gather", windowed_metrics=False,
                         blackbox=False, tail_sampling=False, journey=False,
                         efficiency=False, incidents=False, **kw)
    want = _stream(jbe, prompts, gens)
    be = BatchEngine(Engine(CFG, mode=mode, device="cpu", params=params),
                     **kw)
    got = _stream(be, prompts, gens)
    assert [list(map(int, w)) for w in want] == got
    assert be.metrics["preemptions"] == jbe.metrics.as_dict()["preemptions"]


# -- 5. prefix cache: warm == cold ---------------------------------------------

@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_prefix_cache_warm_equals_cold(engine, kv):
    rng = np.random.default_rng(11)
    shared = rng.integers(0, CFG.vocab_size, size=8).tolist()
    prompts = [shared + rng.integers(0, CFG.vocab_size, size=3).tolist()
               for _ in range(3) for _ in (0, 1)]
    outs = {}
    for caching in (False, True):
        be = BatchEngine(engine, n_slots=3, n_blocks=9, block_size=4,
                         prefill_chunk=8, kv_dtype=kv, prefix_cache=caching)
        rids = [be.submit(p, 6) for p in prompts]
        done = be.run(max_steps=1000)
        outs[caching] = [done[r] for r in rids]
        be.pool.check_invariants()
        if caching:
            assert be.metrics["prefix_hits"] > 0
            assert be.metrics["prefix_cached_tokens"] > 0
    assert outs[True] == outs[False]
    if kv is None:
        for out, p in zip(outs[True], prompts):
            assert out == _golden(engine, p, 6)
