"""Drive the PyTorch/H100 port's main path on one card and check it.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one NVIDIA Hopper
card. The script builds the CUDA kernels from
``triton_distributed_tpu_torch/csrc/`` (into ``build/torch_kernels/``) and
runs these phases, each printing its own line; any failure raises and the
script exits non-zero without its result line:

1. kernels against their plain versions at the slice's shapes, on seeded
   inputs (bf16 output ``atol=rtol=2e-2``, fp32 output ``atol=rtol=1e-4``);
2. a small fp32 engine: ``Engine(mode="dist")`` must produce the same
   tokens as ``Engine(mode="xla")`` on the ``tiny`` and a head_dim-128
   config (prefill M = 64 goes through the matmul kernel);
3. full width: Qwen3-1.7B (28 layers, bf16, random weights from a seed)
   serves 4 requests of 2,048 prompt tokens and 64 new tokens through
   ``Engine.serve``; the kernels' launch counts are reset just before and
   read just after, and the prefill logits are held against the xla
   golden (cosine >= 0.999, max |diff| <= 5% of max |logit|);
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


# -- phase 2 -----------------------------------------------------------------

def phase_small_engines(Engine, ModelConfig, kernels):
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
        if min(counts.values()) == 0:
            raise AssertionError(f"phase 2 {name}: a kernel never launched "
                                 f"{counts}")
        say(f"phase 2: {name} fp32 B=8 L0=8 gen 6: dist == xla tokens, "
            f"launches {counts}")


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
                "flash_decode": cfg.n_layers * (GEN - 1)}
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
    return launches


def decode_profile(eng, ids, steps: int = 4):
    """Where the time goes: torch.profiler over one prefill and over a few
    decode steps after it, each summarised as wall time, device busy time
    and share, and the kernels that took the most device time."""
    kv = eng.new_cache(B)
    device_profile("prefill", lambda: eng.prefill(ids, kv), 1)
    logits, kv = eng.prefill(ids, kv.clear())
    tok = torch.argmax(logits, dim=-1)

    def step():
        nonlocal tok
        out, _ = eng.decode_step(tok, kv)
        tok = torch.argmax(out, dim=-1)

    step()
    device_profile("decode step", step, steps)


def device_profile(label: str, fn, n: int):
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
        say(f"phase 3: {label} device busy share: not measured (the "
            f"profiler saw no device time)")
        return
    top = sorted(by_name.items(), key=lambda item: -item[1])[:6]
    say(f"phase 3: profiled {label}: {wall / n * 1e3:.2f} ms wall, device "
        f"busy {busy / n * 1e3:.2f} ms ({100 * busy / wall:.1f}%); top: "
        + "; ".join(f"{k[:60]} {v / n / 1e3:.3f} ms" for k, v in top))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from triton_distributed_tpu_torch import Engine, ModelConfig
    from triton_distributed_tpu_torch import kernels
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import sp_attention as tsp

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
    phase_small_engines(Engine, ModelConfig, kernels)
    launches = phase_full_width(Engine, ModelConfig, kernels)
    times = phase_times(inputs, tg, tsp)

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
