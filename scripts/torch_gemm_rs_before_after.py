"""GEMM-RS and GroupGEMM-RS of one checkout, timed at the shapes
chip_smoke.py gives them, so that two commits can be compared on one card.

    python3 scripts/torch_gemm_rs_before_after.py                # this one
    python3 scripts/torch_gemm_rs_before_after.py --root DIR     # another

DIR holds a ``triton_distributed_tpu_torch`` package (for example an
earlier commit unpacked with ``git archive``). The script builds that
package's ``csrc/gemm_rs.cu`` and ``csrc/group_gemm_rs.cu`` alone (one nvcc
each, started together) into a library of their two entry points, and
calls them through that package's own wrappers (``gemm_rs_cuda``,
``group_gemm_rs_cuda``), bf16, at four shapes:

- ``group_gemm_rs prefill``: chip_smoke.py phase 9's prefill, act (8, 128,
  1,024, 96) x w (8, 128, 96, 2,048) (Qwen3-30B-A3B's MoE layer at TP = 8,
  capacity 128);
- ``group_gemm_rs decode``: phase 9's decode, capacity 8: act (8, 128, 64,
  96);
- ``gemm_rs prefill``: phase 7's, 8 x (4,096, 3,200) x (3,200, 5,120)
  (Qwen3-32B at TP = 8, bench.py's shapes);
- ``gemm_rs decode``: phase 7's m = 1 case, 8 x (8, 3,200) x (3,200,
  5,120).

Each is timed with CUDA events around each call, the L2 flushed before it
(``chip_smoke.Timer``), and by the kernel's device time alone
(``chip_smoke.kernel_device_ms``); its output is held against the
package's plain version (max abs error printed). With ``--library`` the
library calls that compute the same function are timed too: the two-call
``torch.matmul(...).sum(0)`` and one call (``torch.addbmm`` over the rank
stack for GEMM-RS, ``torch.einsum("redcf,refn->decn", ...)`` for
GroupGEMM-RS). Inputs are made on the card from seed 0, the same for every
checkout. Prints one JSON object a case, with the card's name and power
limit. To compare commits A and B, run A, B, B, A on one card, one after
another. Needs one CUDA card and nvcc.

    python3 scripts/torch_gemm_rs_before_after.py --breakdown

times GroupGEMM-RS at the prefill and decode shapes on this checkout's
kernel and on copies of its ``csrc/`` whose ``gemm_rs.cuh`` wgmma items are
patched (the library's sources hold no switch): fold items that neither
wait nor load the pushes, product items that store no push, and product
and fold items that run only their MMA (and take their tickets, and
release their flags). Each variant's time against the kernel's says what
that part costs; only the kernel's results are right. Then, at
GroupGEMM-RS's and GEMM-RS's prefill, the ticket order the kernel picks
from the shapes forced both ways (the fused items in groups, or rank by
rank), and the kernel with a 96 KB ring at two blocks an SM in place of
its 64 KB ring at three.

    python3 scripts/torch_gemm_rs_before_after.py --root DIR --ttft

runs DIR's own ``chip_smoke.py`` phase 7 slice instead (Qwen3-32B at world
8 through ``Engine.serve``, dist and ar, on the package's whole kernel
library built from DIR's sources) for its TTFT: one prefill each, so run
A, B, B, A to see the spread.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("gemm_rs.cu", "group_gemm_rs.cu")
ENTRIES = ("tdt_gemm_rs", "tdt_group_gemm_rs")
REPS = 10
WORLD, E, F, D = 8, 128, 96, 2048          # phase 9 (MOE_E, f_local, d)
CAPS = {"prefill": 128, "decode": 8}
# Patches of csrc/gemm_rs.cuh's run_wg_items: (text, replacement), each
# text found exactly once.
NO_FOLD_LOADS = [
    ("    if (tid == 0) {\n      const int mt0",
     "    if (false) {\n      const int mt0"),
    ("          if (src >= W || src == d) continue;",
     "          if (true) continue;"),
    ("          if (src != d)\n"
     "            vec::Vec<bf16>::load(v[u], f);",
     "          if (src != d)\n"
     "            for (float& x : f) x = 0;")]
NO_PUSH_STORES = [("        if (!dst || n0 + c >= g.N) continue;",
                   "        if (true) continue;")]
OWN = ("    if (g.fused) product(plane, d * g.m + i0, n0);"
       "  // own partial: tile\n")
MMA_ONLY = NO_PUSH_STORES + [(OWN, OWN + "    continue;\n")]
BREAKDOWN = {"kernel": [], "no fold waits or loads": NO_FOLD_LOADS,
             "no push stores": NO_PUSH_STORES,
             "MMA, tickets and flags only": MMA_ONLY}
# The fused items' ticket order, which the kernel picks from the shapes,
# forced both ways, and the wgmma kernel with a 96 KB ring at two blocks
# an SM in place of its 64 KB at three (timed on GroupGEMM-RS and GEMM-RS
# at their prefill shapes).
GROUPED = "constexpr double GROUPED_BYTES = 16.0 * (1 << 20);"
RING = "constexpr int RING = 64 * 1024, BLOCKS = 3;"
CHOICES = {"tickets in groups": [(GROUPED, GROUPED.replace(
               "16.0 * (1 << 20)", "1e300"))],
           "tickets rank by rank": [(GROUPED, GROUPED.replace(
               "16.0 * (1 << 20)", "0"))],
           "96 KB ring, two blocks an SM": [(RING, RING.replace(
               "64 * 1024, BLOCKS = 3", "96 * 1024, BLOCKS = 2"))]}
RS = {"prefill": 4096, "decode": 8}        # phase 7: M a rank
RS_K, RS_N = 3200, 5120


def load_smoke(root: str = HERE):
    """chip_smoke.py of the checkout at root (by default this one, for its
    timers; it imports only torch at its top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched_csrc(_build, out_dir: str, patches) -> Path:
    """The package's csrc/, or a copy under out_dir with gemm_rs.cuh
    patched."""
    if not patches:
        return _build.CSRC
    csrc = Path(out_dir) / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    cuh = csrc / "gemm_rs.cuh"
    text = cuh.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"gemm_rs.cuh no longer holds {old!r} once")
        text = text.replace(old, new)
    cuh.write_text(text)
    return csrc


def build(_build, out_dir: str, patches=()) -> ctypes.CDLL:
    """The two sources of the package whose ``_build`` is given (patched),
    compiled with its flags and linked into one library (kept under a hash
    of its sources and flags); its entry points get the package's own
    argtypes."""
    os.makedirs(out_dir, exist_ok=True)
    csrc = patched_csrc(_build, out_dir, patches)
    h = hashlib.sha256(" ".join(_build.ARCH_FLAGS
                                + _build.NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode() + p.read_bytes())
    so = os.path.join(out_dir, f"librs_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        nvcc = _build.nvcc_path()
        procs = []
        for src in SOURCES:
            obj = os.path.join(out_dir, src.replace(".cu", ".o"))
            procs.append((obj, subprocess.Popen(
                [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
                 str(csrc), "-c", str(csrc / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {obj}:\n{log}")
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", so,
                        *(o for o, _ in procs)], check=True)
    lib = ctypes.CDLL(so)
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding triton_distributed_tpu_torch")
    ap.add_argument("--label", default=None)
    ap.add_argument("--library", action="store_true",
                    help="also time the library calls")
    ap.add_argument("--breakdown", action="store_true",
                    help="time GroupGEMM-RS with parts of its items cut")
    ap.add_argument("--ttft", action="store_true",
                    help="run the checkout's chip_smoke.py phase 7 slice")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    label = args.label or os.path.basename(root)
    sys.path.insert(0, root)
    smoke = load_smoke()
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs
    from triton_distributed_tpu_torch.kernels import moe_overlap as tmo
    if not str(_build.CSRC).startswith(root):
        raise RuntimeError(f"imported {_build.CSRC}, not {root}'s package")
    if args.ttft:
        from triton_distributed_tpu_torch import Engine, ModelConfig, kernels
        rs = load_smoke(root)
        rs.say(f"{label}: {rs.card_line()}")
        rs.phase_tp_slice(Engine, ModelConfig, kernels, rs.card_line())
        return 0

    t0 = time.perf_counter()
    _build._LIBRARY._lib = build(_build, os.path.join(
        root, "build", "gemm_rs_before_after"))
    built = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    timer = smoke.Timer("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.breakdown:
        return breakdown(_build, trs, tmo, smoke, timer, gen, root, label,
                         card)

    def case(name, run, ref, kernel, libs):
        got = run()[0]
        err = (got.float() - ref().float()).abs().max().item()
        del got
        rec = {"root": label, "case": name, "ms": timer(run, reps=REPS),
               "device_ms": smoke.kernel_device_ms(run, kernel, n=REPS),
               "max_abs_err": err}
        if args.library:
            for key, fn in libs.items():
                rec[key] = timer(fn, reps=REPS)
                rec[key + "_device"] = smoke.call_device_ms(fn, n=REPS)
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()

    w_down = smoke.randn(gen, WORLD, E, F, D, scale=F ** -0.5)
    for shape, cap in CAPS.items():
        act = smoke.randn(gen, WORLD, E, WORLD * cap, F)
        case(f"group_gemm_rs {shape}",
             lambda: tmo.group_gemm_rs_cuda(act, w_down),
             lambda: tmo.group_gemm_rs_ref(act, w_down),
             "group_gemm_rs_kernel",
             {"library_two_calls_ms":
              lambda: torch.matmul(act, w_down).sum(0),
              "library_one_call_ms":
              lambda: torch.einsum("redcf,refn->decn",
                                   act.view(WORLD, E, WORLD, cap, F),
                                   w_down)})
        del act
    del w_down
    b = smoke.randn(gen, WORLD, RS_K, RS_N, scale=RS_K ** -0.5)
    for shape, M in RS.items():
        a = smoke.randn(gen, WORLD, M, RS_K)
        z = torch.empty(M, RS_N, dtype=a.dtype, device=a.device)
        case(f"gemm_rs {shape}", lambda: trs.gemm_rs_cuda(a, b),
             lambda: trs.gemm_rs_ref(a, b), "gemm_rs_kernel",
             {"library_two_calls_ms": lambda: torch.matmul(a, b).sum(0),
              "library_one_call_ms":
              lambda: torch.addbmm(z, a, b, beta=0)})
        del a, z
    print(json.dumps({"root": label, "build_s": built, "card": card}),
          flush=True)
    return 0


def breakdown(_build, trs, tmo, smoke, timer, gen, root, label,
              card) -> int:
    """GroupGEMM-RS at the prefill and decode shapes on the kernel and on
    each patched variant of BREAKDOWN, then GroupGEMM-RS and GEMM-RS at
    their prefill shapes on each variant of CHOICES."""
    variants = {**BREAKDOWN, **CHOICES}
    libs = {name: build(_build, os.path.join(
        root, "build", "gemm_rs_breakdown", str(i)), patches)
        for i, (name, patches) in enumerate(variants.items())}
    w_down = smoke.randn(gen, WORLD, E, F, D, scale=F ** -0.5)
    acts = {shape: smoke.randn(gen, WORLD, E, WORLD * cap, F)
            for shape, cap in CAPS.items()}
    b = smoke.randn(gen, WORLD, RS_K, RS_N, scale=RS_K ** -0.5)
    a = smoke.randn(gen, WORLD, RS["prefill"], RS_K)
    for name, lib in libs.items():
        _build._LIBRARY._lib = lib
        cases = {f"group_gemm_rs {shape}": (
            lambda act=act: tmo.group_gemm_rs_cuda(act, w_down),
            "group_gemm_rs_kernel") for shape, act in acts.items()}
        if name in CHOICES:
            cases = {"group_gemm_rs prefill": cases["group_gemm_rs prefill"],
                     "gemm_rs prefill": (lambda: trs.gemm_rs_cuda(a, b),
                                         "gemm_rs_kernel")}
        for case, (run, kernel) in cases.items():
            print(json.dumps({
                "root": label, "variant": name, "case": case,
                "ms": timer(run, reps=REPS),
                "device_ms": smoke.kernel_device_ms(run, kernel, n=REPS),
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
