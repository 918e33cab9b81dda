"""The decode kernel of one checkout, timed at the shapes chip_smoke.py
gives it, so that two commits can be compared on one card.

    python3 scripts/torch_decode_before_after.py                # this checkout
    python3 scripts/torch_decode_before_after.py --root DIR     # another one

DIR holds a ``triton_distributed_tpu_torch`` package (for example an
earlier commit unpacked with ``git archive``). The script builds that
package's ``csrc/flash_decode.cu`` and ``csrc/paged_attention.cu`` alone
(one nvcc each, started together) into a library of their two entry
points, and calls them through that package's own wrappers. It times, with
CUDA events around each call and the L2 flushed before it
(``chip_smoke.Timer``), and gives the decode kernel's device time alone
(``chip_smoke.kernel_device_ms``):

- ``sp_decode``: the SP decode's one ``flash_decode_cuda`` launch of
  chip_smoke.py's phase 10 (8 ranks x 4 rows, 64 / 8 heads: a GQA group of
  8, 4,096 positions a rank, each global kv_len of ``SP_KV_LENS`` clipped
  per rank);
- ``flash_decode``: phase 4's ``flash_decode_local`` (4 rows, 16 / 8
  heads, 4,096 positions, kv_lens ``DECODE_KV_LENS``);
- ``paged``: phase 4's ``paged_attention(**case)`` of each case of
  ``PAGED_CASES`` and each pool (bf16, int8, fp8).

Inputs are made on the card from seed 0, the same for every checkout.
Prints one JSON object a case, with the card's name and power limit, then
the build's seconds. To compare commits A and B, run A, B, B, A on one
card, one after another. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("flash_decode.cu", "paged_attention.cu")
ENTRIES = ("tdt_flash_decode", "tdt_paged_attention")
REPS = 20


def load_smoke():
    """chip_smoke.py of this checkout, for its shapes, input makers and
    timers (it imports only torch at its top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(_build, out_dir: str) -> ctypes.CDLL:
    """The two decode sources of the package whose ``_build`` is given,
    compiled with its flags and linked into one library (kept under a hash
    of its sources and flags); its entry points get the package's own
    argtypes."""
    h = hashlib.sha256(" ".join(_build.ARCH_FLAGS
                                + _build.NVCC_FLAGS).encode())
    for p in sorted(_build.CSRC.glob("*.cu*")):
        h.update(p.name.encode() + p.read_bytes())
    so = os.path.join(out_dir, f"libdecode_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        compile_into(_build, out_dir, so)
    lib = ctypes.CDLL(so)
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def compile_into(_build, out_dir: str, so: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = []
    for src in SOURCES:
        obj = os.path.join(out_dir, src.replace(".cu", ".o"))
        procs.append((obj, subprocess.Popen(
            [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC), "-c", str(_build.CSRC / src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {obj}:\n{log}")
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", so,
                    *(o for o, _ in procs)], check=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding triton_distributed_tpu_torch")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    label = args.label or os.path.basename(root)
    sys.path.insert(0, root)
    smoke = load_smoke()
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import paged_attention as tpa
    from triton_distributed_tpu_torch.kernels import sp_attention as tsp
    from triton_distributed_tpu_torch.layers.nn import quantize_kv_rows
    if not str(_build.CSRC).startswith(root):
        raise RuntimeError(f"imported {_build.CSRC}, not {root}'s package")

    t0 = time.perf_counter()
    _build._LIBRARY._lib = build(_build, os.path.join(
        root, "build", "decode_before_after"))
    built = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    timer = smoke.Timer("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = smoke.randn

    def report(case, run, **extra):
        ms = timer(run, reps=REPS)
        dev = smoke.kernel_device_ms(run, "flash_decode_kernel") \
            if extra.pop("decode", True) else None
        print(json.dumps({"root": label, "case": case, "ms": ms,
                          "device_ms": dev, **extra, "card": card}),
              flush=True)

    # Phase 10: every rank's shard in one launch, a GQA group of 8.
    w, B, Hq, Hkv, dh = (smoke.SP_WORLD, smoke.SP_B, smoke.SP_HQ,
                         smoke.SP_HKV, smoke.SP_DH)
    m_kv = smoke.SP_CTX // w
    q = randn(gen, B, Hq, dh).expand(w, B, Hq, dh).reshape(w * B, Hq, dh)
    k = randn(gen, w * B, Hkv, m_kv, dh)
    v = randn(gen, w * B, Hkv, m_kv, dh)
    for kv_len in smoke.SP_KV_LENS:
        lens = smoke._local_lens(kv_len, m_kv)[:, None].expand(
            w, B).reshape(-1).contiguous()
        report(f"sp_decode kv_len {kv_len}",
               lambda: tsp.flash_decode_cuda(q, k, v, kv_len=lens),
               rows=w * B, heads=[Hq, Hkv], positions=m_kv)
    del q, k, v

    # Phase 4's contiguous decode at Qwen3-1.7B's heads.
    qd = randn(gen, smoke.B, smoke.HQ, smoke.DH)
    kd = randn(gen, smoke.B, smoke.S, smoke.HKV, smoke.DH)
    vd = randn(gen, smoke.B, smoke.S, smoke.HKV, smoke.DH)
    kv_len = torch.tensor(smoke.DECODE_KV_LENS, dtype=torch.int32,
                          device="cuda")
    report("flash_decode", lambda: tsp.flash_decode_local(
        qd, kd, vd, kv_len=kv_len, kv_layout="bshd"),
        kv_lens=smoke.DECODE_KV_LENS)
    del qd, kd, vd

    # Phase 4's paged cases, the call chip_smoke.py's record times.
    for name, geo in smoke.PAGED_CASES.items():
        for kv in smoke.POOLS:
            c = smoke.paged_case(gen, quantize_kv_rows, kv=kv, **geo)
            report(f"paged {name} {kv or 'bf16'}",
                   lambda: tpa.paged_attention(**c), decode=geo["L"] == 1)
    print(json.dumps({"root": label, "build_s": built}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
