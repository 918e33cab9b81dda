"""The one-chip AG-GEMM loopback and the dense flash prefill of one
checkout, timed at the shapes chip_smoke.py phases 4 and 5 give them,
each beside the library call that computes the same function, so that two
commits can be compared on one card.

    python3 scripts/torch_prefill_loopback_before_after.py  # this checkout
    python3 scripts/torch_prefill_loopback_before_after.py --root DIR

DIR holds a ``triton_distributed_tpu_torch`` package (for example an
earlier commit unpacked with ``git archive``). The script builds that
package's kernels with its own ``kernels/_build.py`` (into ``DIR/build/``)
and calls them through that package's wrappers:

- ``loopback staged`` / ``loopback bare``: ``ag_gemm_loopback_cuda`` and
  ``ag_gemm_segmented_bare_cuda`` at bench.py's Qwen3-32B TP=8 per-rank
  product, (4,096 x 5,120) x (5,120 x 3,200) bf16, 8 segments, all 3,200
  columns, beside ``torch.matmul(a, b)``;
- ``prefill phase 4`` and ``prefill gqa8``: ``flash_prefill`` at phase 1's
  Qwen3-1.7B shape (B 4 x L 2,048, 16 / 8 heads, dh 128, a cache of 4,096
  positions, NaN past L, offset 0) and at its Qwen3-30B-A3B shape (B 2,
  32 / 4 heads), beside SDPA (``is_causal``, ``enable_gqa``) over the
  cache's first L positions.

For each it prints one JSON object: ``ms``, CUDA events around each call
after an L2 flush (``chip_smoke.Timer``, the mean); ``device_ms``, the
kernel's device time alone (``chip_smoke.kernel_device_ms``); the library
call's two figures, and ``ms_over_library``. Each result is checked first
against its plain version (``chip_smoke.check_close``, bf16 2e-2; the
staged A equal to A; the prefill's output finite).

``--shared`` adds the device times of the kernels that share code with
these two: the bf16 paged mixed step (phase 1's "mixed" case, the
``mma.sync`` tile of ``flash_prefill.cuh``), the multi-rank AG-GEMM at
phase 7's (8, 512, 5,120) x (8, 5,120, 3,200) (``ag_gemm.cuh``'s items)
and the SP prefill at phase 10's 8 x (64, 4,096, 128), causal
(``attn_wgmma.cuh``). ``--ttft`` adds Qwen3-1.7B's TTFT as phase 3
measures it (random weights from seed 0, 4 prompts of 2,048 tokens,
prefill and argmax; the median of three). Both are informational.

Inputs come from seed 0, the same for every checkout; every line carries
the card's name and power limit. To compare commits A and B, run A, B, B,
A on one card, one after another. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """This checkout's chip_smoke.py, for its shapes, checks and timers (it
    imports only torch at its top; what it imports later comes from
    --root)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(rec: dict, card: str) -> None:
    if rec.get("library_ms"):
        rec["ms_over_library"] = rec["ms"] / rec["library_ms"]
    rec["card"] = card
    print(json.dumps(rec), flush=True)


def loopback_rows(smoke, label, card):
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg

    gen = torch.Generator(device="cuda").manual_seed(0)
    M, K, N, segs = smoke.AG_M, smoke.AG_K, smoke.AG_N, smoke.SEGMENTS
    a = smoke.randn(gen, M, K)
    b = smoke.randn(gen, K, N, scale=K ** -0.5)
    want = tg.matmul_ref(a, b)
    staged = lambda: tg.ag_gemm_loopback_cuda(a, b, segments=segs, cols=N)
    bare = lambda: tg.ag_gemm_segmented_bare_cuda(a, b, segments=segs,
                                                  cols=N)
    out, st = staged()
    smoke.check_close(f"{label} loopback staged", out, want, torch.bfloat16)
    if not torch.equal(st, a):
        raise AssertionError(f"{label}: the staged A differs from A")
    smoke.check_close(f"{label} loopback bare", bare(), want, torch.bfloat16)
    timer = smoke.Timer("cuda")
    lib = lambda: torch.matmul(a, b)
    t_l, t_ld = timer(lib, reps=20), smoke.call_device_ms(lib)
    for case, run in (("loopback staged", staged), ("loopback bare", bare)):
        emit({"root": label, "case": case, "ms": timer(run, reps=20),
              "device_ms": smoke.kernel_device_ms(run, "ag_loopback_kernel"),
              "library_ms": t_l, "library_device_ms": t_ld}, card)


def prefill_rows(smoke, label, card):
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import sp_attention as tsp

    L, S, dh = smoke.L0, smoke.S, smoke.DH
    timer = smoke.Timer("cuda")
    for case, B, Hq, Hkv in (("prefill phase 4", smoke.B, smoke.HQ,
                              smoke.HKV),
                             ("prefill gqa8", 2, smoke.GQA8["Hq"],
                              smoke.GQA8["Hkv"])):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q = smoke.randn(gen, B, L, Hq, dh)
        k, v = smoke.randn(gen, B, S, Hkv, dh), smoke.randn(gen, B, S, Hkv,
                                                            dh)
        k[:, L:] = float("nan")
        v[:, L:] = float("nan")
        run = lambda: tsp.flash_prefill(q, k, v, offset=0)
        got = run()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label} {case}: the NaN tail leaked")
        e = smoke.check_close(f"{label} {case}", got,
                              tsp.flash_prefill_ref(q, k, v, offset=0),
                              torch.bfloat16)
        del got
        qt = q.transpose(1, 2).contiguous()
        kt = k[:, :L].transpose(1, 2).contiguous()
        vt = v[:, :L].transpose(1, 2).contiguous()
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True,
                                                     enable_gqa=True)
        flops = 4 * dh * B * Hq * L * (L + 1) / 2
        rec = {"root": label, "case": case, "ms": timer(run, reps=10),
               "device_ms": smoke.kernel_device_ms(run, "flash_prefill"),
               "library_ms": timer(lib, reps=10),
               "library_device_ms": smoke.call_device_ms(lib),
               "max_abs_err": e}
        rec["device_tflops"] = flops / rec["device_ms"] / 1e9
        emit(rec, card)
        del q, k, v, qt, kt, vt
        smoke.free_card()


def shared_rows(smoke, label, card):
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import paged_attention as tpa
    from triton_distributed_tpu_torch.kernels import sp_attention as tsp
    from triton_distributed_tpu_torch.layers.nn import quantize_kv_rows

    gen = torch.Generator(device="cuda").manual_seed(0)
    geo = smoke.PAGED_CASES["mixed"]
    c = smoke.paged_case(gen, quantize_kv_rows, kv=None, **geo)
    smoke.check_paged(f"{label} mixed bf16", tpa, c, "mixed", geo)
    emit({"root": label, "case": "shared: bf16 mixed paged step",
          "device_ms": smoke.kernel_device_ms(
              lambda: tpa.paged_attention(**c), "flash_prefill_mma_kernel")},
         card)
    del c
    w, (m, K, n) = smoke.TP_WORLD, smoke.TP_AG
    a, b = smoke.randn(gen, w, m, K), smoke.randn(gen, w, K, n,
                                                  scale=K ** -0.5)
    out, _ = tg.ag_gemm_cuda(a, b, cols=n)
    smoke.check_close(f"{label} ag_gemm", out, tg.ag_gemm_ref(a, b,
                                                              cols=n)[0],
                      torch.bfloat16)
    emit({"root": label, "case": "shared: ag_gemm world 8",
          "device_ms": smoke.kernel_device_ms(
              lambda: tg.ag_gemm_cuda(a, b, cols=n), "ag_gemm_kernel")},
         card)
    del a, b, out
    q, k, v = (smoke.randn(gen, w, smoke.SP_HQ, smoke.SP_M, smoke.SP_DH)
               for _ in range(3))
    emit({"root": label, "case": "shared: sp_ag_attn 8 x 4,096",
          "device_ms": smoke.kernel_device_ms(
              lambda: tsp.sp_ag_attention_cuda(q, k, v), "sp_ag_attn",
              n=3)}, card)
    del q, k, v
    smoke.free_card()


def ttft_row(smoke, label, card):
    from triton_distributed_tpu_torch import Engine, ModelConfig

    cfg = ModelConfig.from_name("qwen3-1.7b")
    eng = Engine(cfg, mode="dist", device="cuda", seed=0)
    ids = torch.randint(0, cfg.vocab_size, (smoke.B, smoke.L0),
                        device="cuda", dtype=torch.int32,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7))
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng.prefill(ids, eng.new_cache(smoke.B))
        torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    emit({"root": label, "case": "ttft qwen3-1.7b 4 x 2,048",
          "ttft_ms": 1e3 * statistics.median(times[1:]),
          "runs_ms": [1e3 * t for t in times]}, card)
    del eng
    smoke.free_card()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding triton_distributed_tpu_torch")
    ap.add_argument("--label", default=None)
    ap.add_argument("--shared", action="store_true",
                    help="also time the kernels that share their code")
    ap.add_argument("--ttft", action="store_true",
                    help="also measure Qwen3-1.7B's TTFT")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    label = args.label or os.path.basename(root)
    sys.path.insert(0, root)
    smoke = load_smoke()
    from triton_distributed_tpu_torch.kernels import _build
    if not str(_build.CSRC).startswith(root):
        raise RuntimeError(f"imported {_build.CSRC}, not {root}'s package")
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.lib()
    print(json.dumps({"root": label, "build_s": time.perf_counter() - t0,
                      "card": card}), flush=True)
    loopback_rows(smoke, label, card)
    prefill_rows(smoke, label, card)
    if args.shared:
        shared_rows(smoke, label, card)
    if args.ttft:
        ttft_row(smoke, label, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
