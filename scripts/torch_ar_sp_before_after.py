"""The multi-rank one-shot all-reduce and the SP all-gather prefill
attention of one checkout, timed at the shapes chip_smoke.py phases 7 and 10
give them, so that two commits can be compared on one card.

    python3 scripts/torch_ar_sp_before_after.py               # this one
    python3 scripts/torch_ar_sp_before_after.py --root DIR    # another

DIR holds a ``triton_distributed_tpu_torch`` package (for example an
earlier commit unpacked with ``git archive``). The script builds that
package's ``csrc/oneshot_ar.cu`` and ``csrc/sp_ag_attn.cu`` alone (one nvcc
each, started together) into a library of their two entry points, and calls
them through that package's own wrappers at five shapes:

- ``oneshot bench``: bench.py's all-reduce, world 8 x (128, 5,120) bf16,
  through ``oneshot_all_reduce(x, world=8)`` (the serving path) and
  ``oneshot_all_reduce_cuda(x)`` (a new staging each call);
- ``oneshot decode``: the ar serve's decode, world 8 x (8, 5,120) bf16, and
  ``oneshot ar prefill``: its prefill, world 8 x (8,192, 5,120) bf16 (4.7 GB
  of staging), the same two ways;
- ``sp prefill``: ``sp_ag_attention_cuda`` at world 8 x (64 heads, 4,096
  rows, dh 128) bf16, causal, Qwen3-32B's attention width;
- ``sp lse``: the same non-causal with the lse, at 8 heads x 512 rows.

For each it prints one JSON object with ``ms``, CUDA events around each
call after an L2 flush (``chip_smoke.Timer``, the mean), ``device_ms``, the
kernel's device time alone (``chip_smoke.kernel_device_ms``, or CUDA events
over back-to-back calls where the profiler keeps no record,
``chip_smoke.busy_device_ms``), and the library call that computes the same
function (``x.float().sum(0)``; ``scaled_dot_product_attention`` over the
gathered sequence) with the same two figures, and ``ms_over_library``. The
result is checked first: the all-reduce bit for bit against
``oneshot_all_reduce_ref`` (every staging slot too), the attention against
``sp_ag_attention_ref`` at 2e-2 on 4 of the heads. Inputs are made on the
card from seed 0, the same for every checkout; every line carries the
card's name and power limit. To compare commits A and B, run A, B, B, A on
one card, one after another. Needs one CUDA card and nvcc.

    python3 scripts/torch_ar_sp_before_after.py --breakdown

times ``sp prefill`` of this checkout on copies of ``csrc/`` patched one way
each (the wgmma path's sources; every patch must be found exactly once):
``no push copies`` (push items only raise their flags; K and V pre-staged
by a kernel call on the same buffers: the consumers alone), ``pushes
alone`` (no attend item runs: the producers alone), ``no mask`` (no chunk
applies the causal mask; its result is not checked), ``no softmax`` (P is
S unscaled and O is never rescaled: the products and the ring alone) and
``no products`` (no wgmma: the softmax and the ring alone), in turns, the
order reversed in the second round.
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
SOURCES = ("oneshot_ar.cu", "sp_ag_attn.cu")
ENTRIES = ("tdt_oneshot_ar", "tdt_sp_ag_attn")
WORLD, HIDDEN = 8, 5120
AR_ROWS = {"bench": 128, "decode": 8, "ar prefill": 8192}   # phase 7
SP_H, SP_M, SP_DH, SP_LSE = 64, 4096, 128, (8, 512)   # phase 10
REPS = 50
# Patches of the wgmma path (file, text, replacement).
NO_PUSH_COPIES = [("sp_ag_attn.cu", """  wg::bulk_copy(static_cast<bf16*>(P.k_full) + at, stride, W,
                static_cast<const bf16*>(P.k) + at, seg * sizeof(bf16),
                sm.base, cit);
  wg::bulk_copy(static_cast<bf16*>(P.v_full) + at, stride, W,
                static_cast<const bf16*>(P.v) + at, seg * sizeof(bf16),
                sm.base, cit);
""", "")]
PUSHES_ALONE = [("sp_ag_attn.cu",
                 "    attend(P, &tq, &tk, &tv, sm, it.r, it.h, it.qt, u, "
                 "tiles);\n", "")]
NO_MASK = [("sp_ag_attn.cu", "    lim[0] = (P.causal ?",
            "    lim[0] = lim[1] = tdt::attn::BKV;\n    return;\n"
            "    lim[0] = (P.causal ?")]
NO_SOFTMAX = [("attn_wgmma.cuh", """      if (mk)
        softmax<true>(sc, scale_log2, lim, corr);
      else
        softmax<false>(sc, scale_log2, lim, corr);
      wg::""", "      corr[0] = corr[1] = 1.f;\n      wg::")]
NO_PRODUCTS = [
    ("attn_wgmma.cuh",
     "      mma_ss_kmajor(sc, q_desc(sm, w, kk), k_desc(sm, s, kk), kk > 0);",
     ""),
    ("attn_wgmma.cuh", "      mma_rs_mnmajor(o, p[kk], v_desc(sm, s, kk));",
     "")]
BREAKDOWN = {"kernel": [], "no push copies": NO_PUSH_COPIES,
             "pushes alone": PUSHES_ALONE, "no mask": NO_MASK,
             "no softmax": NO_SOFTMAX, "no products": NO_PRODUCTS}


def load_smoke():
    """This checkout's chip_smoke.py, for its timers (it imports only torch
    at its top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched_csrc(_build, out_dir: str, patches) -> Path:
    """The package's csrc/, or a copy under out_dir with the patches
    applied (each text found exactly once in its file)."""
    if not patches:
        return _build.CSRC
    csrc = Path(out_dir) / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    for name, old, new in patches:
        path = csrc / name
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name} holds the patch text "
                               f"{text.count(old)} times, not once")
        path.write_text(text.replace(old, new))
    return csrc


def build(_build, out_dir: str, patches=()) -> ctypes.CDLL:
    """The two sources of the package whose ``_build`` is given (patched),
    compiled with its flags and linked into one library kept under a hash
    of its sources and flags; the entry points get the package's own
    argtypes."""
    os.makedirs(out_dir, exist_ok=True)
    csrc = patched_csrc(_build, out_dir, patches)
    h = hashlib.sha256(" ".join(_build.ARCH_FLAGS
                                + _build.NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode() + p.read_bytes())
    so = os.path.join(out_dir, f"libarsp_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        nvcc = _build.nvcc_path()
        procs = []
        for src in SOURCES:
            obj = os.path.join(out_dir, src.split(".")[0] + ".o")
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


def device_ms(smoke, fn, kernel: str, n: int) -> float:
    t = smoke.kernel_device_ms(fn, kernel, n=n)
    return t if t == t else smoke.busy_device_ms(fn, n=min(n, 3))


def sp_inputs(smoke, gen, H=SP_H, m=SP_M):
    return tuple(smoke.randn(gen, WORLD, H, m, SP_DH) for _ in range(3))


def sdpa_call(q, k, v, causal):
    qg, kg, vg = (t.permute(1, 0, 2, 3).reshape(1, t.shape[1], -1, SP_DH)
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qg, kg, vg, is_causal=causal)


def cases(smoke, tar, tsp, gen):
    """(name, kernel call, library call, check, kernel name, reps)."""
    out = []
    for label, rows in AR_ROWS.items():
        x = smoke.randn(gen, WORLD, rows, HIDDEN)

        def check(x=x):
            got, staging = tar.oneshot_all_reduce_cuda(x)
            pushed = torch.stack([torch.stack(
                [x[s] for s in range(WORLD) if s != d])
                for d in range(WORLD)])
            want = tar.oneshot_all_reduce_ref(x)
            return (torch.equal(got, want) and torch.equal(staging, pushed)
                    and torch.equal(tar.oneshot_all_reduce(x, world=WORLD),
                                    want))

        lib = (lambda x=x: x.float().sum(0))
        reps = REPS if rows < 1024 else 5
        out.append((f"oneshot {label} serving",
                    lambda x=x: tar.oneshot_all_reduce(x, world=WORLD), lib,
                    check, "oneshot_ar_kernel", reps))
        out.append((f"oneshot {label} cuda",
                    lambda x=x: tar.oneshot_all_reduce_cuda(x), lib,
                    lambda: True, "oneshot_ar_kernel", reps))
    q, k, v = sp_inputs(smoke, gen)

    def check_sp(q=q, k=k, v=v):
        heads = slice(0, 4)
        qs, ks, vs = (t[:, heads].contiguous() for t in (q, k, v))
        got = tsp.sp_ag_attention_cuda(qs, ks, vs)[0]
        want = tsp.sp_ag_attention_ref(qs, ks, vs)
        return bool(torch.allclose(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2))

    out.append(("sp prefill", lambda: tsp.sp_ag_attention_cuda(q, k, v),
                sdpa_call(q, k, v, True), check_sp, "sp_ag_attn", 3))
    h, m = SP_LSE
    qs, ks, vs = (t[:, :h, :m].contiguous() for t in (q, k, v))

    def check_lse(qs=qs, ks=ks, vs=vs):
        out, lse = tsp.sp_ag_attention_cuda(qs, ks, vs, causal=False,
                                            return_partials=True)[:2]
        want, want_lse = tsp.sp_ag_attention_ref(qs, ks, vs, causal=False,
                                                 return_partials=True)
        return bool(torch.allclose(out.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
                    and (lse - want_lse).abs().max().item() <= 1e-3)

    out.append(("sp lse", lambda: tsp.sp_ag_attention_cuda(
        qs, ks, vs, causal=False, return_partials=True),
        sdpa_call(qs, ks, vs, False), check_lse, "sp_ag_attn", 10))
    return out


def breakdown(_build, tsp, smoke, root, label, card) -> int:
    """``sp prefill`` on the kernel and each patched variant, in turns."""
    libs = {name: build(_build, os.path.join(
        root, "build", "ar_sp_breakdown", str(i)), patches)
        for i, (name, patches) in enumerate(BREAKDOWN.items())}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = sp_inputs(smoke, gen)
    _build._LIBRARY._lib = libs["kernel"]
    want, _, kf, vf = tsp.sp_ag_attention_cuda(q, k, v)
    for rnd in range(2):
        for variant in (list(libs) if rnd == 0 else list(libs)[::-1]):
            _build._LIBRARY._lib = libs[variant]
            run = (lambda: tsp.sp_ag_attention_cuda(q, k, v, k_full=kf,
                                                    v_full=vf))
            got = run()[0]
            if variant in ("kernel", "no push copies") and not torch.equal(
                    got, want):
                raise AssertionError(f"{label} {variant}: the result moved")
            print(json.dumps({
                "root": label, "variant": variant, "case": "sp prefill",
                "device_ms": device_ms(smoke, run, "sp_ag_attn", 3),
                "card": card}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding triton_distributed_tpu_torch")
    ap.add_argument("--label", default=None)
    ap.add_argument("--breakdown", action="store_true",
                    help="time the SP prefill's parts on patched copies")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    label = args.label or os.path.basename(root)
    sys.path.insert(0, root)
    smoke = load_smoke()
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allreduce as tar
    from triton_distributed_tpu_torch.kernels import sp_attention as tsp
    if not str(_build.CSRC).startswith(root):
        raise RuntimeError(f"imported {_build.CSRC}, not {root}'s package")
    card = smoke.card_line()
    if args.breakdown:
        return breakdown(_build, tsp, smoke, root, label, card)
    t0 = time.perf_counter()
    _build._LIBRARY._lib = build(_build, os.path.join(
        root, "build", "ar_sp_before_after"))
    built = time.perf_counter() - t0
    timer = smoke.Timer("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, run, lib, check, kernel, reps in cases(smoke, tar, tsp, gen):
        if not check():
            raise AssertionError(f"{label}: {name}: the kernel's result "
                                 f"differs from its plain version")
        warm = 2 if reps > 3 else 1
        rec = {"root": label, "case": name,
               "ms": timer(run, reps=reps, warmup=warm),
               "library_ms": timer(lib, reps=reps, warmup=warm)}
        rec["device_ms"] = device_ms(smoke, run, kernel, min(reps, 20))
        rec["library_device_ms"] = smoke.call_device_ms(lib, n=min(reps, 20))
        rec["ms_over_library"] = rec["ms"] / rec["library_ms"]
        rec["card"] = card
        print(json.dumps(rec), flush=True)
    print(json.dumps({"root": label, "build_s": built, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
