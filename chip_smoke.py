"""Drive the PyTorch/H100 port's main path on one card and check it.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one NVIDIA Hopper
card. The script builds the CUDA kernels from
``triton_distributed_tpu_torch/csrc/`` (into ``build/torch_kernels/``) and
runs these phases, each printing its own line; any failure raises and the
script exits non-zero without its result line:

1. kernels against their plain versions at the slices' shapes, on seeded
   inputs (bf16 output ``atol=rtol=2e-2``, fp32 output ``atol=rtol=1e-4``),
   the paged kernel at Qwen3-1.7B geometry for a decode and a ragged mixed
   step over bf16, int8 and fp8 pools (shuffled tables, a dead slot, NaN
   in every block no live table reaches), each live slot held at 1% (decode)
   or 2% (mixed) of its own max |output|;
2. small fp32 engines (``tiny`` and a head_dim-128 config):
   ``Engine(mode="dist")`` must produce the same tokens as
   ``Engine(mode="xla")`` (prefill M = 64 goes through the matmul kernel);
   ``BatchEngine`` must produce each request's per-request ``Engine``
   tokens with chunked prefill and a forced preemption, and its int8/fp8
   pools must give the same tokens warm (prefix cache hit) as cold;
3. full width, slice 1: Qwen3-1.7B (28 layers, bf16, random weights from a
   seed) serves 4 requests of 2,048 prompt tokens and 64 new tokens
   through ``Engine.serve``; the kernels' launch counts are reset just
   before and read just after, and the prefill logits are held against
   the xla golden (cosine >= 0.999, max |diff| <= 5% of max |logit|);
3b. full width, slice 2: ``BatchEngine(n_slots=8, block_size=16,
   prefill_chunk=256, max_seq_len=4096)`` serves 16 seeded requests (256
   to 2,048 prompt tokens, four opening with a 1,024-token prefix of an
   earlier request, 32 new tokens each) over bf16, int8 and fp8 pools;
   the launch counts of each run must be exact (paged attention 28 per
   step, matmul 4 x 28 per mixed step, the flash kernels none), and one
   mixed step's logits through the kernels are held against the xla
   golden's gather oracle (same bars as phase 3);
4. times of each kernel, its plain version and one PyTorch call computing
   the same function (CUDA events, L2 flushed before each launch), beside
   the least time the card could take for the same work.

The second-to-last line is the JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. No card, or no package beside the script,
means a non-zero exit and no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Qwen3-1.7B at full width: the slice's shapes.
B, L0, GEN = 4, 2048, 64
D, DFF, HQ, HKV, DH, S = 2048, 6144, 16, 8, 128, 4096
PROJECTIONS = {"qkv": (B * L0, D, (HQ + 2 * HKV) * DH),
               "o": (B * L0, HQ * DH, D),
               "gate_up": (B * L0, D, 2 * DFF),
               "down": (B * L0, DFF, D)}
DECODE_KV_LENS = [2049, 2080, 2111, 1999]
VARLEN = dict(offset=512, seq_lens=[2048, 1531, 777, 1])
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SLICE1_KERNELS = ("matmul", "flash_prefill", "flash_decode")

# The paged kernel at Qwen3-1.7B geometry: 8 slots, tables of 256 blocks of
# 16 (4,096 positions). Decode: ragged kv_lens, slot 7 dead. Mixed: a
# 512-token chunk with ragged q_lens (0 and 1 included), offsets up to
# ~3,000, slot 6 dead.
PAGED = dict(Hq=HQ, Hkv=HKV, dh=DH, bs=16, max_blocks=256)
PAGED_CASES = {
    "decode": dict(L=1, kv_lens=[1, 100, 517, 1024, 2049, 3001, 4096, 777],
                   q_lens=[1] * 8, dead=(7,)),
    "mixed": dict(L=512, kv_lens=[512, 1300, 2997, 3001, 18, 0, 2700, 364],
                  q_lens=[512, 300, 17, 1, 1, 0, 200, 64], dead=(6,)),
}
POOLS = (None, "int8", "fp8")
WIRE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# The paged kernel's bar, per live slot: max |got - want| <= the fraction
# times that slot's max |want|. A long slot's output is small (std about
# sqrt(e / kv_len)), so one absolute bar for every slot would be as large
# as the values of the 4,096-key slot. Decode keeps P in f32 (only the bf16
# output is rounded); the mixed step's bf16 path rounds P to bf16 for
# mma.sync.
PAGED_SLOT_TOL = {"decode": 1e-2, "mixed": 2e-2}

# Phase 3b: the serving path at full width.
SERVE = dict(n_slots=8, block_size=16, prefill_chunk=256, max_seq_len=4096)
SERVE_REQUESTS, SERVE_GEN, SHARED_PREFIX = 16, 32, 1024


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_close(name, got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{name}: {m}")
    return (got.float() - want.float()).abs().max().item()


class Timer:
    """Mean device time of one call: CUDA events around each launch, the
    L2 cache flushed before each (a 256 MB write), after warm-up."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    x = torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


# -- phase 1 -----------------------------------------------------------------

def phase_kernels(gen, tg, tsp):
    err = {"matmul": 0.0, "flash_prefill": 0.0, "flash_decode": 0.0}
    inputs = {}
    for name, (M, K, N) in PROJECTIONS.items():
        a = randn(gen, M, K)
        b = randn(gen, K, N, scale=K ** -0.5)
        e = check_close(f"matmul {name}", tg.matmul_cuda(a, b),
                        tg.matmul_ref(a, b), torch.bfloat16)
        err["matmul"] = max(err["matmul"], e)
        inputs[f"matmul_{name}"] = (a, b)
        say(f"phase 1: matmul {name} ({M}x{K})x({K}x{N}) bf16 "
            f"max_abs_err={e:.4g}")
    a, b = randn(gen, 300, 200, dtype=torch.float32), randn(
        gen, 200, 333, dtype=torch.float32)
    e = check_close("matmul fp32", tg.matmul_cuda(a, b), tg.matmul_ref(a, b),
                    torch.float32)
    say(f"phase 1: matmul (300x200)x(200x333) fp32 max_abs_err={e:.4g}")

    q = randn(gen, B, L0, HQ, DH)
    k = randn(gen, B, S, HKV, DH)
    v = randn(gen, B, S, HKV, DH)
    k[:, L0:] = float("nan")
    v[:, L0:] = float("nan")
    out = tsp.flash_prefill(q, k, v, offset=0)
    assert torch.isfinite(out).all(), "flash prefill let the NaN tail in"
    e = check_close("flash_prefill", out, tsp.flash_prefill_ref(q, k, v,
                                                                offset=0),
                    torch.bfloat16)
    err["flash_prefill"] = e
    inputs["flash_prefill"] = (q, k, v)
    say(f"phase 1: flash_prefill B={B} L={L0} Hq={HQ} Hkv={HKV} dh={DH} "
        f"S={S} offset 0, NaN tail bf16 max_abs_err={e:.4g}")

    off = VARLEN["offset"]
    lens = torch.tensor(VARLEN["seq_lens"], dtype=torch.int32, device="cuda")
    kv2, vv2 = randn(gen, B, S, HKV, DH), randn(gen, B, S, HKV, DH)
    for row, n in enumerate(VARLEN["seq_lens"]):
        kv2[row, off + n:] = float("nan")
        vv2[row, off + n:] = float("nan")
    out = tsp.flash_prefill(q, kv2, vv2, offset=off, seq_lens=lens)
    assert torch.isfinite(out).all(), "varlen prefill let NaN in"
    for row, n in enumerate(VARLEN["seq_lens"]):
        assert (out[row, n:] == 0).all(), "padding rows must be exact zeros"
    e = check_close("flash_prefill varlen", out, tsp.flash_prefill_ref(
        q, kv2, vv2, offset=off, seq_lens=lens), torch.bfloat16)
    err["flash_prefill"] = max(err["flash_prefill"], e)
    say(f"phase 1: flash_prefill varlen offset {off} seq_lens "
        f"{VARLEN['seq_lens']} NaN tails bf16 max_abs_err={e:.4g}")
    qs, ks, vs = (randn(gen, 2, 37, 8, 128, dtype=torch.float32),
                  randn(gen, 2, 96, 4, 128, dtype=torch.float32),
                  randn(gen, 2, 96, 4, 128, dtype=torch.float32))
    e = check_close("flash_prefill fp32",
                    tsp.flash_prefill(qs, ks, vs, offset=11),
                    tsp.flash_prefill_ref(qs, ks, vs, offset=11),
                    torch.float32)
    say(f"phase 1: flash_prefill fp32 small max_abs_err={e:.4g}")

    qd = randn(gen, B, HQ, DH)
    kv_len = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device="cuda")
    kd, vd = randn(gen, B, S, HKV, DH), randn(gen, B, S, HKV, DH)
    for row, n in enumerate(DECODE_KV_LENS):
        kd[row, n:] = float("nan")
        vd[row, n:] = float("nan")
    inputs["flash_decode"] = (qd, kd, vd, kv_len)
    for layout in ("bshd", "bhsd"):
        kk, vv = ((kd, vd) if layout == "bshd" else
                  (kd.transpose(1, 2).contiguous(),
                   vd.transpose(1, 2).contiguous()))
        o, lse = tsp.flash_decode_local(qd, kk, vv, kv_len=kv_len,
                                        kv_layout=layout)
        ro, rlse = tsp.flash_decode_ref(qd, kk, vv, kv_len=kv_len,
                                        kv_layout=layout)
        e = max(check_close(f"flash_decode {layout} out", o, ro,
                            torch.float32),
                check_close(f"flash_decode {layout} lse", lse, rlse,
                            torch.float32))
        err["flash_decode"] = max(err["flash_decode"], e)
        say(f"phase 1: flash_decode {layout} B={B} S={S} kv_len "
            f"{DECODE_KV_LENS} bf16 in, f32 out max_abs_err={e:.4g}")
    torch.cuda.synchronize()
    return err, inputs


def paged_case(gen, quantize, *, L, kv_lens, q_lens, dead, kv):
    """Operands of ``paged_attention`` on the card: a shuffled pool with
    NaN in every block no live table reaches (NaN scales for int8/fp8),
    the dead slot's stale table naming live blocks, bf16 queries."""
    Hq, Hkv, dh, bs, mb = (PAGED[k] for k in
                           ("Hq", "Hkv", "dh", "bs", "max_blocks"))
    B = len(kv_lens)
    n_blocks = B * mb + 3
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator()
                          .manual_seed(L)) + 1
    tables = torch.zeros((B, mb), dtype=torch.int32)
    reached = torch.zeros(n_blocks, dtype=torch.bool)
    for b, n_tok in enumerate(kv_lens):
        n = math.ceil(n_tok / bs)
        rows = perm[:n] if b in dead else perm[b * mb:b * mb + n]
        tables[b, :n] = rows
        if b not in dead:
            reached[rows] = True
    unreached = (~reached).cuda()
    k = randn(gen, n_blocks, bs, Hkv, dh, dtype=torch.float32)
    v = randn(gen, n_blocks, bs, Hkv, dh, dtype=torch.float32)
    c = dict(q=randn(gen, B, L, Hq, dh), block_tables=tables.cuda(),
             kv_lens=torch.tensor(kv_lens, dtype=torch.int32, device="cuda"),
             q_lens=torch.tensor(q_lens, dtype=torch.int32, device="cuda"),
             slot_mask=torch.tensor([b not in dead for b in range(B)],
                                    device="cuda"))
    if kv is None:
        k[unreached] = float("nan")
        v[unreached] = float("nan")
        c.update(k_pool=k.bfloat16(), v_pool=v.bfloat16())
    else:
        (kq, ks), (vq, vs) = quantize(k, WIRE[kv]), quantize(v, WIRE[kv])
        ks[unreached] = float("nan")
        vs[unreached] = float("nan")
        c.update(k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs)
    return c


def phase_paged_kernel(gen, tpa, quantize):
    err, inputs = 0.0, {}
    for name, geo in PAGED_CASES.items():
        live = [b for b in range(8) if b not in geo["dead"]]
        for kv in POOLS:
            c = paged_case(gen, quantize, kv=kv, **geo)
            got = tpa.paged_attention(**c)
            want = tpa.paged_attention_ref(**c)
            torch.cuda.synchronize()
            if not torch.isfinite(got[live]).all():
                raise AssertionError(f"paged {name} {kv}: NaN reached a "
                                     f"live row")
            for b in live:
                if not (got[b, geo["q_lens"][b]:] == 0).all():
                    raise AssertionError(f"paged {name} {kv}: padding rows "
                                         f"of slot {b} are not zeros")
            e, worst = check_slots(f"paged_attention {name} {kv}", got, want,
                                   live, PAGED_SLOT_TOL[name])
            err = max(err, e)
            inputs[(name, kv)] = c
            say(f"phase 1: paged_attention {name} L={geo['L']} kv_lens "
                f"{geo['kv_lens']} q_lens {geo['q_lens']} dead "
                f"{list(geo['dead'])}, {kv or 'bf16'} pool, bf16 q: "
                f"max_abs_err={e:.4g}, worst slot's max err / max |want| "
                f"{worst:.4g} (bar {PAGED_SLOT_TOL[name]})")
    return err, inputs


def check_slots(name, got, want, live, frac):
    """Hold each live slot at ``frac`` of its own max |want|; returns the
    max abs error and the worst slot's ratio."""
    err, worst = 0.0, 0.0
    for b in live:
        d = (got[b].float() - want[b].float()).abs().max().item()
        top = want[b].float().abs().max().item()
        if d > frac * top:
            raise AssertionError(f"{name}: slot {b} max |diff| {d:.4g} > "
                                 f"{frac} x max |want| {top:.4g}")
        err, worst = max(err, d), max(worst, d / top if top else 0.0)
    return err, worst


# -- phase 2 -----------------------------------------------------------------

def phase_small_engines(Engine, BatchEngine, ModelConfig, kernels):
    configs = {
        "tiny": {},
        "dh128": dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
                      d_ff=512, vocab_size=512, max_length=64,
                      tie_embeddings=True),
    }
    for name, overrides in configs.items():
        cfg = ModelConfig.from_name("tiny", **overrides)
        ids = torch.randint(0, cfg.vocab_size, (8, 8), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(5), dtype=torch.int32)
        dist = Engine(cfg, mode="dist", device="cuda", seed=3)
        xla = Engine(cfg, mode="xla", device="cuda", params=dist.params)
        kernels.reset_counts()
        got = dist.serve(ids, 6)
        counts = {k: v.launches for k, v in kernels.KERNELS.items()}
        want = xla.serve(ids, 6)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 2 {name}: dist tokens {got.tolist()}"
                                 f" != xla tokens {want.tolist()}")
        if min(counts[k] for k in SLICE1_KERNELS) == 0:
            raise AssertionError(f"phase 2 {name}: a kernel never launched "
                                 f"{counts}")
        say(f"phase 2: {name} fp32 B=8 L0=8 gen 6: dist == xla tokens, "
            f"launches {counts}")
        small_serving(name, dist, BatchEngine, kernels)


def steps_never_sync(name, eng, BatchEngine, prompts):
    """Both serving steps, over an f32 and an int8 pool, run under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing inside a step
    reads a value back to the host (what a CUDA-graph capture needs)."""
    for kv in (None, "int8"):
        be = BatchEngine(eng, n_slots=3, block_size=4, prefill_chunk=4,
                         kv_dtype=kv)
        for p in prompts:
            be.submit(p, 4)
        be.step()
        ids, *ops = be.mixed_operands()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for paged, first in (("prefill", ids), ("decode", ids[:, :1])):
                step = eng.make_paged_step(paged, kv_quant=kv is not None)
                rest = ops if paged == "prefill" else ops[:-1]
                torch.argmax(step(first, be.pool.state, *rest), dim=-1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    say(f"phase 2: {name} decode and mixed steps (f32 and int8 pools) ran "
        f"with no host read-back")


def small_serving(name, eng, BatchEngine, kernels):
    """fp32 BatchEngine on a small config: per-request Engine tokens
    through chunked prefill and preemption; warm == cold on int8/fp8."""
    g = torch.Generator().manual_seed(9)
    V = eng.config.vocab_size
    prompts = [torch.randint(0, V, (n,), generator=g).tolist()
               for n in (7, 9, 5, 6)]
    be = BatchEngine(eng, n_slots=3, n_blocks=8, block_size=4,
                     prefill_chunk=4)
    rids = [be.submit(p, 6) for p in prompts]
    kernels.reset_counts()
    out = be.run(max_steps=500)
    launches = kernels.KERNELS["paged_attention"].launches
    for rid, p in zip(rids, prompts):
        want = eng.serve(torch.tensor([p], device=eng.device), 6)[0].tolist()
        if out[rid] != want:
            raise AssertionError(f"phase 2 {name}: BatchEngine {out[rid]} != "
                                 f"Engine {want}")
    if be.metrics["preemptions"] == 0 or launches == 0:
        raise AssertionError(f"phase 2 {name}: preemptions "
                             f"{be.metrics['preemptions']}, paged launches "
                             f"{launches}")
    say(f"phase 2: {name} BatchEngine == Engine tokens for 4 requests, "
        f"chunk 4, {be.metrics['preemptions']} preemptions, paged_attention "
        f"launches {launches}")
    steps_never_sync(name, eng, BatchEngine, prompts)
    shared = prompts[1] + prompts[0]
    for kv in ("int8", "fp8"):
        runs = []
        for cache in (False, True):
            be = BatchEngine(eng, n_slots=3, block_size=4, prefill_chunk=4,
                             kv_dtype=kv, prefix_cache=cache)
            first = be.submit(prompts[1] + prompts[2], 4)
            be.run()
            second = be.submit(shared, 4)
            be.run()
            runs.append((be.finished[first].output,
                         be.finished[second].output,
                         be.metrics["prefix_hits"]))
        if runs[0][:2] != runs[1][:2] or runs[1][2] == 0:
            raise AssertionError(f"phase 2 {name} {kv}: warm {runs[1]} != "
                                 f"cold {runs[0]}")
        say(f"phase 2: {name} {kv} pool: warm == cold tokens, prefix hits "
            f"{runs[1][2]}")


# -- phase 3 -----------------------------------------------------------------

def phase_full_width(Engine, ModelConfig, kernels):
    cfg = ModelConfig.from_name("qwen3-1.7b")
    t0 = time.perf_counter()
    eng = Engine(cfg, mode="dist", device="cuda", seed=0)
    torch.cuda.synchronize()
    say(f"phase 3: qwen3-1.7b random init {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ids = torch.randint(0, cfg.vocab_size, (B, L0), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7), dtype=torch.int32)
    eng.serve(ids[:, :128], 2)  # warm-up: kernel library, allocator
    torch.cuda.synchronize()

    kernels.reset_counts()
    t0 = time.perf_counter()
    tokens = eng.serve(ids, GEN)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    expected = {"matmul": 4 * cfg.n_layers, "flash_prefill": cfg.n_layers,
                "flash_decode": cfg.n_layers * (GEN - 1),
                "paged_attention": 0}
    say(f"phase 3: serve B={B} L0={L0} gen={GEN} launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if tokens.shape != (B, GEN) or tokens.dtype != torch.int32:
        raise AssertionError(f"tokens {tokens.shape} {tokens.dtype}")
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError("token ids out of range")

    t0 = time.perf_counter()
    logits, _ = eng.prefill(ids, eng.new_cache(B))
    first = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    xla = Engine(cfg, mode="xla", device="cuda", params=eng.params)
    x_logits, _ = xla.prefill(ids, xla.new_cache(B))
    if not (torch.isfinite(logits).all() and torch.isfinite(x_logits).all()):
        raise AssertionError("non-finite prefill logits")
    cos = torch.nn.functional.cosine_similarity(logits, x_logits, dim=-1)
    diff = (logits - x_logits).abs().max().item()
    top = x_logits.abs().max().item()
    say(f"phase 3: prefill logits dist vs xla: min cosine "
        f"{cos.min().item():.6f}, max |diff| {diff:.4g} = "
        f"{100 * diff / top:.3f}% of max |logit| {top:.4g}")
    if cos.min().item() < 0.999 or diff > 0.05 * top:
        raise AssertionError("prefill logits disagree with the xla golden")
    if not torch.equal(first.to(torch.int32), tokens[:, 0]):
        say("phase 3: note: first token of serve differs from the re-run "
            "prefill's argmax")
    x_tokens = xla.serve(ids, GEN)
    agree = (x_tokens == tokens).float().mean().item()
    decode_s = max(t_serve - ttft, 1e-9)
    say(f"phase 3: greedy tokens equal to xla's: {100 * agree:.1f}% of "
        f"{B}x{GEN} (information only)")
    say(f"phase 3: TTFT {ttft * 1e3:.2f} ms (prefill of {B}x{L0} + argmax), "
        f"serve {t_serve:.3f} s, decode {B * (GEN - 1) / decode_s:.1f} "
        f"tokens/s ({B} rows), on {card_line()}")
    del xla, x_logits
    decode_profile(eng, ids)
    return launches, eng


# -- phase 3b ----------------------------------------------------------------

def serving_prompts(vocab: int) -> list[list[int]]:
    """16 seeded prompts of 256..2,048 tokens; requests 12-15 open with the
    first 1,024 tokens of requests 0-3 (which carry 1,088..1,536)."""
    g = torch.Generator().manual_seed(11)

    def tokens(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    def length(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=g))

    prompts = [tokens(length(SHARED_PREFIX + 64, 1536)) for _ in range(4)]
    prompts += [tokens(length(256, 2048)) for _ in range(8)]
    prompts += [prompts[i][:SHARED_PREFIX] + tokens(length(256, 1024))
                for i in range(4)]
    return prompts


def logits_fused_vs_gather(eng, golden, BatchEngine, prompts, kv):
    """One mixed step (8 rows mid-prefill, after two chunks) through the
    serving step (the paged kernel, the matmul kernel) and through the
    gather oracle of the xla golden (the gathered view, dense attention,
    ``torch.matmul``), each on its own copy of the pool."""
    be = BatchEngine(eng, kv_dtype=kv, **SERVE)
    for p in prompts[:SERVE["n_slots"]]:
        be.submit(p, SERVE_GEN)
    be.step()
    be.step()
    ops = be.mixed_operands()
    quant = be.pool.kv_quant
    logits = {}
    for mode, engine in (("fused", eng), ("gather", golden)):
        st = be.pool.state
        pool = type(st)(*(None if t is None else t.clone()
                          for t in (st.k, st.v, st.k_scale, st.v_scale)))
        step = engine.make_paged_step("prefill", paged_attn=mode,
                                      kv_quant=quant)
        logits[mode] = step(ops[0], pool, *ops[1:])
        if mode == "fused":
            # Where a mixed step's time goes (it rewrites the same rows).
            device_profile("phase 3b", f"{kv or 'bf16'} mixed step, 8 rows "
                           f"x {SERVE['prefill_chunk']} tokens",
                           lambda: step(ops[0], pool, *ops[1:]), 1)
        del pool
    live = ops[-1] > 0
    fused, gather = logits["fused"][live], logits["gather"][live]
    if not (torch.isfinite(fused).all() and torch.isfinite(gather).all()):
        raise AssertionError(f"phase 3b {kv}: non-finite mixed-step logits")
    cos = torch.nn.functional.cosine_similarity(fused, gather, dim=-1)
    diff = (fused - gather).abs().max().item()
    top = gather.abs().max().item()
    say(f"phase 3b: {kv or 'bf16'} pool, one mixed step's logits, fused vs "
        f"gather: min cosine {cos.min().item():.6f}, max |diff| {diff:.4g} "
        f"= {100 * diff / top:.3f}% of max |logit| {top:.4g}")
    if cos.min().item() < 0.999 or diff > 0.05 * top:
        raise AssertionError(f"phase 3b {kv}: fused logits disagree with "
                             f"the gather oracle")


def phase_serving(eng, Engine, BatchEngine, kernels):
    """The slice-2 main path at full width, once per pool dtype."""
    prompts = serving_prompts(eng.config.vocab_size)
    L = eng.config.n_layers
    golden = Engine(eng.config, mode="xla", device=eng.device, params=eng.params)
    tokens, all_launches = {}, {}
    for kv in POOLS:
        logits_fused_vs_gather(eng, golden, BatchEngine, prompts, kv)
        torch.cuda.empty_cache()
        be = BatchEngine(eng, kv_dtype=kv, **SERVE)
        times = {"decode": [], "mixed": []}
        profiled, untimed_tokens = False, 0

        def drive(done):
            nonlocal profiled, untimed_tokens
            while not done():
                dec0 = be.metrics["decode_steps"]
                queue_empty = not len(be.scheduler)
                t0 = time.perf_counter()
                if not be.step():
                    return
                dt = time.perf_counter() - t0
                kind = ("decode" if be.metrics["decode_steps"] > dec0
                        else "mixed")
                times[kind].append(dt)
                if kind == "decode" and queue_empty and not profiled:
                    # The queue is empty and no row prefills: the next step
                    # is a decode step too.
                    profiled = True
                    tok0 = be.metrics["tokens_generated"]
                    device_profile("phase 3b", f"{kv or 'bf16'} decode step",
                                   be.step, 1)
                    untimed_tokens += be.metrics["tokens_generated"] - tok0

        torch.cuda.synchronize()
        kernels.reset_counts()
        rids = [be.submit(p, SERVE_GEN) for p in prompts[:12]]
        drive(lambda: all(r in be.finished for r in rids[:4]))
        rids += [be.submit(p, SERVE_GEN) for p in prompts[12:]]
        drive(lambda: False)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        m = be.metrics
        steps = m["decode_steps"] + m["prefill_steps"]
        expected = {"matmul": 4 * L * m["prefill_steps"], "flash_prefill": 0,
                    "flash_decode": 0, "paged_attention": L * steps}
        say(f"phase 3b: {kv or 'bf16'} pool: {m['requests_completed']} "
            f"requests, {m['decode_steps']} decode + {m['prefill_steps']} "
            f"mixed steps, launches {launches} (expected {expected})")
        if launches != expected:
            raise AssertionError(f"phase 3b {kv}: launch counts {launches} "
                                 f"!= {expected}")
        out = be.finished
        if (sorted(out) != sorted(rids)
                or any(len(out[r].output) != SERVE_GEN for r in rids)):
            raise AssertionError(f"phase 3b {kv}: not every request "
                                 f"finished with {SERVE_GEN} tokens")
        if not all(0 <= t < eng.config.vocab_size
                   for r in rids for t in out[r].output):
            raise AssertionError(f"phase 3b {kv}: token ids out of range")
        if m["prefix_hits"] == 0:
            raise AssertionError(f"phase 3b {kv}: no prefix-cache hit")
        tokens[kv] = [out[r].output for r in rids]
        wall = sum(times["decode"]) + sum(times["mixed"])
        agree = sum(a == b for x, y in zip(tokens[kv], tokens[None])
                    for a, b in zip(x, y)) / (SERVE_REQUESTS * SERVE_GEN)
        say(f"phase 3b: {kv or 'bf16'} pool: generated "
            f"{(m['tokens_generated'] - untimed_tokens) / wall:.1f} tokens/s"
            f" (timed steps; the profiled one left out), prompt "
            f"{m['prefill_tokens'] / max(sum(times['mixed']), 1e-9):.1f} "
            f"tokens/s over mixed-step time, mean decode step "
            f"{1e3 * sum(times['decode']) / max(len(times['decode']), 1):.2f}"
            f" ms, mean mixed step "
            f"{1e3 * sum(times['mixed']) / max(len(times['mixed']), 1):.2f} "
            f"ms, {wall:.3f} s in steps, preemptions {m['preemptions']}, "
            f"prefix hits {m['prefix_hits']} ({m['prefix_cached_tokens']} "
            f"cached tokens), tokens equal to the bf16 run "
            f"{100 * agree:.1f}% (information only), on {card_line()}")
        for k, n in launches.items():
            all_launches[k] = all_launches.get(k, 0) + n
        del be
        torch.cuda.empty_cache()
    return all_launches


def decode_profile(eng, ids, steps: int = 4):
    """Where the time goes: torch.profiler over one prefill and over a few
    decode steps after it, each summarised as wall time, device busy time
    and share, and the kernels that took the most device time."""
    kv = eng.new_cache(B)
    device_profile("phase 3", "prefill", lambda: eng.prefill(ids, kv), 1)
    logits, kv = eng.prefill(ids, kv.clear())
    tok = torch.argmax(logits, dim=-1)

    def step():
        nonlocal tok
        out, _ = eng.decode_step(tok, kv)
        tok = torch.argmax(out, dim=-1)

    step()
    device_profile("phase 3", "decode step", step, steps)


def device_profile(phase: str, label: str, fn, n: int):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels only: a CPU op's entry repeats the device time of the
    # kernels it launched.
    by_name = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0}
    busy = sum(by_name.values()) / 1e6
    if busy == 0:
        say(f"{phase}: {label} device busy share: not measured (the "
            f"profiler saw no device time)")
    else:
        top = sorted(by_name.items(), key=lambda item: -item[1])[:6]
        say(f"{phase}: profiled {label}: {wall / n * 1e3:.2f} ms wall, "
            f"device busy {busy / n * 1e3:.2f} ms ({100 * busy / wall:.1f}%);"
            f" top: " + "; ".join(f"{k[:60]} {v / n / 1e3:.3f} ms"
                                  for k, v in top))
    # The host's side of the same run: operators called, kernels launched
    # through the CUDA runtime, and the host time spent inside each
    # operator itself (profiler overhead included).
    cpu = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CPU]
    ops = sum(ev.count for ev in cpu if ev.key.startswith("aten::"))
    launches = sum(ev.count for ev in cpu if "LaunchKernel" in ev.key)
    host = sum(ev.self_cpu_time_total for ev in cpu) / 1e6
    top = sorted(cpu, key=lambda ev: -ev.self_cpu_time_total)[:6]
    say(f"{phase}: host side of {label}: {ops / n:.0f} aten operator calls "
        f"(nested included), {launches / n:.0f} runtime kernel launches, "
        f"{host / n * 1e3:.2f} ms self time in operators and runtime calls "
        f"({100 * host / wall:.1f}% of wall); top: "
        + "; ".join(f"{ev.key[:40]} x{ev.count // n} "
                    f"{ev.self_cpu_time_total / n / 1e3:.3f} ms"
                    for ev in top))


# -- phase 4 -----------------------------------------------------------------

def phase_times(inputs, tg, tsp):
    import torch.nn.functional as F

    timer = Timer("cuda")
    rows = {}
    ms = plain = lib = bnd = 0.0
    for name, (M, K, N) in PROJECTIONS.items():
        a, b = inputs[f"matmul_{name}"]
        t_k = timer(lambda: tg.matmul_cuda(a, b))
        t_p = timer(lambda: tg.matmul_ref(a, b), reps=3)
        t_l = timer(lambda: torch.matmul(a, b))
        t_b, _ = bound_ms(2 * M * N * K, 2 * (M * K + K * N + M * N),
                          torch.bfloat16)
        say(f"phase 4: matmul {name} ({M}x{K})x({K}x{N}): kernel {t_k:.4f} "
            f"ms, plain {t_p:.4f} ms, torch.matmul {t_l:.4f} ms, bound "
            f"{t_b:.4f} ms")
        ms, plain, lib, bnd = ms + t_k, plain + t_p, lib + t_l, bnd + t_b
    rows["matmul"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bnd, bound_by="operations")

    q, k, v = inputs["flash_prefill"]
    t_k = timer(lambda: tsp.flash_prefill(q, k, v, offset=0), reps=5)
    t_p = timer(lambda: tsp.flash_prefill_ref(q, k, v, offset=0), reps=2)
    qt = q.transpose(1, 2).contiguous()
    kt = k[:, :L0].transpose(1, 2).contiguous()
    vt = v[:, :L0].transpose(1, 2).contiguous()
    t_l = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=5)
    # Causal from offset 0: query j attends j + 1 keys, every (row, head).
    pairs = B * HQ * L0 * (L0 + 1) / 2
    nbytes = 2 * (2 * B * L0 * HQ * DH + 2 * B * L0 * HKV * DH)
    t_b, by = bound_ms(4 * DH * pairs, nbytes, torch.bfloat16)
    rows["flash_prefill"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                 bound_ms=t_b, bound_by=by)
    say(f"phase 4: flash_prefill B={B} L={L0} S={S}: kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, bound {t_b:.4f} ms ({by})")

    qd, kd, vd, kv_len = inputs["flash_decode"]
    t_k = timer(lambda: tsp.flash_decode_local(qd, kd, vd, kv_len=kv_len,
                                               kv_layout="bshd"), reps=50)
    t_p = timer(lambda: tsp.flash_decode_ref(qd, kd, vd, kv_len=kv_len,
                                             kv_layout="bshd"), reps=5)
    qdt = qd[:, :, None]
    kdt = torch.nan_to_num(kd).transpose(1, 2).contiguous()
    vdt = torch.nan_to_num(vd).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None] < kv_len[:, None])
    mask = mask[:, None, None, :]
    t_l = timer(lambda: F.scaled_dot_product_attention(
        qdt, kdt, vdt, attn_mask=mask, enable_gqa=True), reps=50)
    keys = sum(DECODE_KV_LENS)
    nbytes = (2 * keys * HKV * DH * 2 + B * HQ * DH * 2
              + B * HQ * (DH + 1) * 4)
    t_b, by = bound_ms(4 * HQ * DH * keys, nbytes, torch.bfloat16)
    rows["flash_decode"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=t_b, bound_by=by)
    say(f"phase 4: flash_decode B={B} S={S} kv_len {DECODE_KV_LENS} bshd: "
        f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, bound "
        f"{t_b:.4f} ms ({by})")
    return rows


def paged_times(inputs, tpa, sp_gather):
    """Phase 4 for the paged kernel: each case and pool dtype. The library
    yardstick is SDPA over the ALREADY GATHERED contiguous view (the gather
    and the dequantization are not timed): no PyTorch call reads a paged
    pool. The bound counts each live slot's K/V rows (and scales) once, q
    and out once, and 4 * dh operations per (query head, attended key)."""
    import torch.nn.functional as F

    timer = Timer("cuda")
    rows = {}
    Hq, Hkv, dh = PAGED["Hq"], PAGED["Hkv"], PAGED["dh"]
    for (name, kv), c in inputs.items():
        kvl, ql = c["kv_lens"].tolist(), c["q_lens"].tolist()
        B, L = c["q"].shape[:2]
        t_k = timer(lambda: tpa.paged_attention(**c), reps=20)
        t_p = timer(lambda: tpa.paged_attention_ref(**c), reps=2)
        tables = torch.where(c["slot_mask"][:, None], c["block_tables"], 0)
        views = []
        for pool, sc in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
            x = sp_gather(c[pool], tables)
            if sc in c:
                x = x.float() * sp_gather(c[sc], tables)[..., None]
            views.append(torch.nan_to_num(x.bfloat16()).transpose(1, 2)
                         .contiguous())
        S = views[0].shape[2]
        j = torch.arange(L, device="cuda")
        qpos = (c["kv_lens"] - c["q_lens"])[:, None] + j               # (B, L)
        mask = ((torch.arange(S, device="cuda")[None, None] <= qpos[..., None])
                & (j[None, :, None] < c["q_lens"][:, None, None]))[:, None]
        qt = c["q"].transpose(1, 2).contiguous()
        t_l = timer(lambda: F.scaled_dot_product_attention(
            qt, views[0], views[1], attn_mask=mask, enable_gqa=True), reps=20)
        # Dead slots' rows are garbage the caller discards: no work.
        live = c["slot_mask"].tolist()
        work = [(k, q) for k, q, m in zip(kvl, ql, live) if m and q > 0]
        keys = sum(k for k, _ in work)
        itemsize = c["k_pool"].element_size()
        nbytes = (2 * keys * Hkv * dh * itemsize
                  + (2 * keys * Hkv * 4 if "k_scale" in c else 0)
                  + sum(q for _, q in work) * Hq * dh * 2       # live q rows
                  + sum(live) * L * Hq * dh * 2)    # live slots' out rows
        pairs = sum(q * (k - q) + q * (q + 1) // 2 for k, q in work)
        t_b, by = bound_ms(4 * dh * Hq * pairs, nbytes, torch.bfloat16)
        rows[(name, kv)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=t_b, bound_by=by)
        say(f"phase 4: paged_attention {name} L={L} {kv or 'bf16'} pool: "
            f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, sdpa on the gathered "
            f"view {t_l:.4f} ms, bound {t_b:.4f} ms ({by})")
    # The record's row: the bf16 pool's decode and mixed steps together.
    bf16 = [rows[(name, None)] for name in PAGED_CASES]
    out = {key: sum(r[key] for r in bf16)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                     for r in bf16) else "operations"
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from triton_distributed_tpu_torch import BatchEngine, Engine, ModelConfig
    from triton_distributed_tpu_torch import kernels
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import paged_attention as tpa
    from triton_distributed_tpu_torch.kernels import sp_attention as tsp
    from triton_distributed_tpu_torch.layers.nn import quantize_kv_rows

    t_start = time.perf_counter()
    say(card_line())
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    say(f"build: {lib_path.name} from {len(_build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(0)
    err, inputs = phase_kernels(gen, tg, tsp)
    err["paged_attention"], paged_inputs = phase_paged_kernel(
        gen, tpa, quantize_kv_rows)
    phase_small_engines(Engine, BatchEngine, ModelConfig, kernels)
    launches, eng = phase_full_width(Engine, ModelConfig, kernels)
    for name, n in phase_serving(eng, Engine, BatchEngine, kernels).items():
        launches[name] += n
    del eng
    torch.cuda.empty_cache()
    times = phase_times(inputs, tg, tsp)
    times["paged_attention"] = paged_times(paged_inputs, tpa,
                                           tsp.paged_gather_kv)

    record = []
    for name, kern in kernels.KERNELS.items():
        row = times[name]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            if not math.isfinite(row[key]):
                raise AssertionError(f"{name} {key} is not finite")
        record.append(dict(
            name=name, route=kern.route, source=kern.source,
            replaces=kern.replaces, launches=launches[name],
            max_abs_err=err[name], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
