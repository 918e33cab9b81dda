"""The single-card matmul (``csrc/matmul.cu``) and the one-chip GEMM-RS
loopback (``csrc/gemm_rs_loopback.cu``) of one checkout, timed at the
shapes chip_smoke.py and the card tests give them, each beside the library
call that computes the same function, so that two commits can be compared
on one card.

    python3 scripts/torch_matmul_rs_before_after.py  # this checkout
    python3 scripts/torch_matmul_rs_before_after.py --root DIR [--label X]
        [--shared] [--ttft] [--ptxas]

DIR holds a ``triton_distributed_tpu_torch`` package (for example an
earlier commit unpacked with ``git archive``). The script builds that
package's kernels with its own ``kernels/_build.py`` (into ``DIR/build/``)
and calls them through that package's wrappers:

- ``matmul qkv`` .. ``matmul down``: ``matmul_cuda`` at Qwen3-1.7B's four
  prefill projections (chip_smoke.py PROJECTIONS, M = 8,192); ``matmul
  bare AG`` / ``matmul bare RS``: phase 5's bare arms, (4,096 x 5,120) x
  (5,120 x 3,200) and (4,096 x 3,200) x (3,200 x 5,120); ``matmul
  MxKxN`` at M = 128 and 512 (N = 2,048 and 4,096, K = 2,048) and at every
  bf16 shape ``tests/test_torch_gpu.py`` runs; each beside
  ``torch.matmul(a, b)``;
- ``gemm_rs_loopback``: bench.py's one-chip GEMM-RS arm, (4,096 x 3,200) x
  (3,200 x 5,120), 8 segments, beside ``torch.addbmm`` over the segments.

For each it prints one JSON object: ``ms``, CUDA events around each call
after an L2 flush (``chip_smoke.Timer``, the mean); ``device_ms``, the
kernel's device time alone (``chip_smoke.kernel_device_ms``); the library
call's two figures, ``ms_over_library`` and the device TFLOP/s. Each
result is checked first against its plain version (``chip_smoke.
check_close``, bf16 2e-2).

``--shared`` adds the kernels that share code with these two: GEMM-RS
(phase 7's (8, 4,096, 3,200) x (8, 3,200, 5,120)) and GroupGEMM-RS (phase
9's prefill grids) on ``gemm_rs.cuh``'s items, the grouped GEMM at
capacity 2,048 (``gemm_tile.cuh``) and the AG-GEMM loopback (phase 5's,
``wgmma_tile.cuh``). ``--ttft`` adds Qwen3-1.7B's and Qwen3-30B-A3B's TTFT
as phases 3 and 3c measure them (random weights from seed 0, 4 prompts of
2,048 tokens, prefill and argmax; the median of three after a warm-up).
``--ptxas`` prints what ``nvcc -Xptxas -v`` says of the wgmma kernels of
the sources in PTXAS (registers, spills, and any C7520 "wgmma serialized"
line, which must not appear).

Inputs come from seed 0, the same for every checkout; every line carries
the card's name and power limit. To compare commits A and B, run A, B, B,
A on one card, one after another. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# M = 128 and 512 at two of Qwen3-1.7B's widths, then the bf16 shapes of
# tests/test_torch_gpu.py test_matmul_kernel_matches_plain.
SMALL = [(128, 2048, 2048), (128, 2048, 4096), (512, 2048, 2048),
         (512, 2048, 4096)]
TESTED = [(64, 128, 256), (130, 33, 77), (1000, 512, 1032),
          (64, 2048, 2048), (130, 2048, 2048), (1000, 2048, 2048),
          (8192, 2048, 2048), (64, 2048, 12288), (130, 2048, 12288),
          (1000, 2048, 12288), (8192, 2048, 12288), (1000, 33, 2048),
          (130, 2048, 77)]
PTXAS = ("matmul.cu", "gemm_rs_loopback.cu", "gemm_rs.cu",
         "group_gemm_rs.cu")
REPS = 20
# Calls timed a case below this many operations: launch-bound, so its
# events spread with the host; five times the calls steady the mean.
SMALL_FLOPS, SMALL_REPS = 2e9, 100


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


_TIMER = []


def timer_of(smoke):
    """One chip_smoke.Timer (its 256 MB flush buffer) for every case."""
    if not _TIMER:
        _TIMER.append(smoke.Timer("cuda"))
    return _TIMER[0]


def matmul_shapes(smoke) -> dict:
    shapes = {f"matmul {k}": v for k, v in smoke.PROJECTIONS.items()}
    shapes["matmul bare AG"] = (smoke.AG_M, smoke.AG_K, smoke.AG_N)
    shapes["matmul bare RS"] = (smoke.AG_M, smoke.RS_K, smoke.RS_N)
    for M, K, N in SMALL + TESTED:
        shapes.setdefault(f"matmul {M}x{K}x{N}", (M, K, N))
    return shapes


def matmul_rows(smoke, label, card):
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg

    timer = timer_of(smoke)
    for case, (M, K, N) in matmul_shapes(smoke).items():
        gen = torch.Generator(device="cuda").manual_seed(M + K + N)
        a = smoke.randn(gen, M, K)
        b = smoke.randn(gen, K, N, scale=K ** -0.5)
        run = lambda: tg.matmul_cuda(a, b)
        e = smoke.check_close(f"{label} {case}", run(), tg.matmul_ref(a, b),
                              torch.bfloat16)
        lib = lambda: torch.matmul(a, b)
        reps = SMALL_REPS if 2 * M * K * N < SMALL_FLOPS else REPS
        rec = {"root": label, "case": case, "ms": timer(run, reps=reps),
               "device_ms": smoke.kernel_device_ms(run, "matmul_"),
               "library_ms": timer(lib, reps=reps),
               "library_device_ms": smoke.call_device_ms(lib),
               "max_abs_err": e}
        rec["device_tflops"] = 2 * M * K * N / rec["device_ms"] / 1e9
        emit(rec, card)
        del a, b


def loopback_row(smoke, label, card):
    from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs

    gen = torch.Generator(device="cuda").manual_seed(0)
    M, K, N, S = smoke.AG_M, smoke.RS_K, smoke.RS_N, smoke.SEGMENTS
    a = smoke.randn(gen, M, K)
    b = smoke.randn(gen, K, N, scale=K ** -0.5)
    run = lambda: trs.gemm_rs_loopback(a, b, segments=S)
    e = smoke.check_close(f"{label} gemm_rs_loopback", run(),
                          trs.gemm_rs_loopback_ref(a, b, segments=S),
                          torch.bfloat16)
    z = torch.empty((M // S, N), dtype=torch.bfloat16, device="cuda")
    a3, b3 = a.view(S, M // S, K), b.expand(S, K, N)
    lib = lambda: torch.addbmm(z, a3, b3, beta=0)
    timer = timer_of(smoke)
    rec = {"root": label, "case": "gemm_rs_loopback",
           "ms": timer(run, reps=REPS),
           "device_ms": smoke.kernel_device_ms(run, "gemm_rs"),
           "library_ms": timer(lib, reps=REPS),
           "library_device_ms": smoke.call_device_ms(lib), "max_abs_err": e}
    rec["device_tflops"] = 2 * M * K * N / rec["device_ms"] / 1e9
    emit(rec, card)


def shared_rows(smoke, label, card):
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs
    from triton_distributed_tpu_torch.kernels import moe_overlap as tmo
    from triton_distributed_tpu_torch.kernels import moe_utils as tmu

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = timer_of(smoke)
    w, (M, k, N) = smoke.TP_WORLD, smoke.TP_RS
    a = smoke.randn(gen, w, M, k)
    b = smoke.randn(gen, w, k, N, scale=k ** -0.5)
    smoke.check_close(f"{label} gemm_rs", trs.gemm_rs_cuda(a, b)[0],
                      trs.gemm_rs_ref(a, b), torch.bfloat16)
    run = lambda: trs.gemm_rs_cuda(a, b)
    emit({"root": label, "case": "shared: gemm_rs world 8 prefill",
          "ms": timer(run, reps=REPS),
          "device_ms": smoke.kernel_device_ms(run, "gemm_rs_kernel")}, card)
    del a, b
    E, F, D, cap = smoke.MOE_E, 96, smoke.MOE_D, smoke.MT_PREFILL[1]
    act = smoke.randn(gen, w, E, w * cap, F)
    wd = smoke.randn(gen, w, E, F, D, scale=F ** -0.5)
    run = lambda: tmo.group_gemm_rs_cuda(act, wd)
    emit({"root": label, "case": "shared: group_gemm_rs prefill",
          "ms": timer(run, reps=REPS),
          "device_ms": smoke.kernel_device_ms(run, "group_gemm_rs_kernel")},
         card)
    del act, wd
    counts = smoke.moe_counts(2048, smoke.MOE_STEP_TOKENS[1])
    d, f = smoke.GROUPED["gate_up"]
    x, _, wg = smoke.grouped_case(counts, 2048, d, f, seed=2048 + d)
    run = lambda: tmu.grouped_gemm_skip(x, wg, counts)
    emit({"root": label, "case": "shared: grouped_gemm gate_up cap 2048",
          "ms": timer(run, reps=REPS)}, card)
    del x, wg
    a = smoke.randn(gen, smoke.AG_M, smoke.AG_K)
    b = smoke.randn(gen, smoke.AG_K, smoke.AG_N, scale=smoke.AG_K ** -0.5)
    run = lambda: tg.ag_gemm_loopback_cuda(a, b, segments=smoke.SEGMENTS,
                                           cols=smoke.AG_N)
    emit({"root": label, "case": "shared: ag_gemm_loopback staged",
          "ms": timer(run, reps=REPS),
          "device_ms": smoke.kernel_device_ms(run, "ag_loopback_kernel")},
         card)
    del a, b
    smoke.free_card()


def ttft_rows(smoke, label, card):
    from triton_distributed_tpu_torch import Engine, ModelConfig

    for name, kw in (("qwen3-1.7b", {}),
                     ("qwen3-30b-a3b", {"max_length": smoke.L0
                                        + smoke.MOE_GEN})):
        cfg = ModelConfig.from_name(name)
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg,
                                      moe_capacity_factor=smoke.MOE_FACTOR)
        eng = Engine(cfg, mode="dist", device="cuda", seed=0, **kw)
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
        emit({"root": label, "case": f"ttft {name} 4 x 2,048",
              "ttft_ms": 1e3 * statistics.median(times[1:]),
              "runs_ms": [1e3 * t for t in times]}, card)
        del eng, logits
        smoke.free_card()


def ptxas_report(_build) -> None:
    """nvcc -Xptxas -v on PTXAS, in parallel: each wgmma kernel's registers
    and spills, and every C7520 line."""
    out = Path(HERE) / "build" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = [(src, subprocess.Popen(
        [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-c", str(_build.CSRC / src), "-o",
         str(out / (src + ".o"))], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for src in PTXAS]
    for src, proc in procs:
        log, _ = proc.communicate()
        lines = log.splitlines()
        report = {"source": src, "rc": proc.returncode,
                  "c7520": [l for l in lines if "C7520" in l], "kernels": {}}
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and (
                    "wgmma" in line or "ws_kernel" in line):
                name = line.split("'")[1]
                report["kernels"][name] = " | ".join(
                    l.strip() for l in lines[i + 1:i + 4])
        print(json.dumps(report), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding triton_distributed_tpu_torch")
    ap.add_argument("--label", default=None)
    ap.add_argument("--shared", action="store_true",
                    help="also time the kernels that share their code")
    ap.add_argument("--ttft", action="store_true",
                    help="also measure Qwen3-1.7B's and Qwen3-30B-A3B's "
                         "TTFT")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v of the wgmma kernels")
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
    if args.ptxas:
        ptxas_report(_build)
    t0 = time.perf_counter()
    _build.lib()
    print(json.dumps({"root": label, "build_s": time.perf_counter() - t0,
                      "card": card}), flush=True)
    matmul_rows(smoke, label, card)
    loopback_row(smoke, label, card)
    if args.shared:
        shared_rows(smoke, label, card)
    if args.ttft:
        ttft_rows(smoke, label, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
