"""Where AG-GroupGEMM spends its time: its producers and consumers alone.

    python3 scripts/torch_ag_group_gemm_breakdown.py   # one H100

``csrc/ag_group_gemm.cu`` at Qwen3-30B-A3B's prefill (world 8, 128
experts, capacity 128, d 2,048, f_local 96, bf16) writes 4.3 GB of staging
(every rank's gathered grids) and reads it back in its consumer tiles. This
script builds the kernel's source as the library does, and again from
copies of ``csrc/`` in which ``ag_gemm.cuh``'s item loop is patched (the
library's sources carry no measurement switch), and times, with CUDA events
around each call and the L2 flushed before it:

- the kernel as the library builds it, at producer chunks of 16 rows (the
  wrapper's ``producer_chunk``) and of whole experts (128 rows);
- the producers alone (the consumer tiles skipped);
- the consumers alone (the flags raised, nothing copied), reading the
  staging from device memory;
- the consumers alone over eight planes of staging and weights, which stay
  in L2;
- the decode shape (capacity 8).

A full kernel that takes the producers' time plus the consumers' says the
staged rows are read back from device memory, not L2. Prints one line a
variant with the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from triton_distributed_tpu_torch.kernels import _build  # noqa: E402
from triton_distributed_tpu_torch.kernels import moe_overlap  # noqa: E402

WORLD, E, D, F = 8, 128, 2048, 96
SHAPES = {"prefill": 128, "decode": 8}          # capacity
# Patches of csrc/ag_gemm.cuh's run_items: (text, replacement), each text
# found exactly once.
NO_TILES = ("    path.consume(d * g.E + e, m0, n0);\n",
            "    __syncthreads();\n")
NO_COPIES = ("      for (int e = ce * g.ec; e < min(g.E, (ce + 1) * g.ec); ++e)",
             "      if (false)  // the flags rise, nothing is copied\n"
             "      for (int e = ce * g.ec; e < min(g.E, (ce + 1) * g.ec); ++e)")
EIGHT_PLANES = ("    path.consume(d * g.E + e, m0, n0);\n",
                "    path.consume((d * g.E + e) % 8, m0, n0);\n")
VARIANTS = {                                     # name -> patches
    "kernel": [],
    "producers alone": [NO_TILES],
    "consumers alone": [NO_COPIES],
    "consumers alone, L2-resident": [NO_COPIES, EIGHT_PLANES],
}
REPS = 10


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def patched_csrc(out: Path, i: int, patches) -> Path:
    """csrc/ as it is, or a copy under out with ag_gemm.cuh patched."""
    if not patches:
        return _build.CSRC
    dst = out / f"csrc_{i}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    header = dst / "ag_gemm.cuh"
    text = header.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"ag_gemm.cuh no longer holds {old!r} once")
        text = text.replace(old, new)
    header.write_text(text)
    return dst


def build() -> dict:
    out = _build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        i = len(procs)
        csrc = patched_csrc(out, i, patches)
        lib = out / f"ag_{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
             "-shared", "-I", str(csrc), str(csrc / "ag_group_gemm.cu"),
             "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].tdt_ag_group_gemm.argtypes = \
            _build.SIGNATURES["tdt_ag_group_gemm"]
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    libs = build()
    where = card()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s "
          f"[{where}]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    epoch = [0]
    for label, cap in SHAPES.items():
        grids = torch.randn(WORLD, E, cap, D, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        w = (torch.randn(WORLD, E, D, F, generator=gen, device="cuda")
             * D ** -0.5).bfloat16()
        staging = torch.empty(WORLD, E, WORLD, cap, D, dtype=torch.bfloat16,
                              device="cuda")
        out = torch.empty(WORLD, E, WORLD * cap, F, dtype=torch.bfloat16,
                          device="cuda")
        flags = torch.zeros(WORLD * WORLD * E * cap, dtype=torch.int32,
                            device="cuda")
        ticket = torch.empty(1, dtype=torch.int32, device="cuda")
        want = moe_overlap.ag_group_gemm_ref(grids, w)
        chunks = [moe_overlap.producer_chunk(cap, D, 2)]
        if label == "prefill":
            chunks.append((1, cap))
        for name, lib in libs.items():
            if label == "decode" and name != "kernel":
                continue
            for ec, rows in chunks:
                if name != "kernel" and (ec, rows) != chunks[0]:
                    continue

                def run():
                    epoch[0] += 1
                    _build.check(lib.tdt_ag_group_gemm(
                        grids.data_ptr(), staging.data_ptr(), w.data_ptr(),
                        out.data_ptr(), flags.data_ptr(), ticket.data_ptr(),
                        epoch[0], WORLD, E, cap, D, F, ec, rows, 1, 1, 0,
                        stream), "tdt_ag_group_gemm")

                run()
                torch.cuda.synchronize()
                if name == "kernel":
                    err = (out.float() - want.float()).abs().max().item()
                    if not err <= 0.05:
                        raise AssertionError(f"{name}: max abs err {err}")
                total = 0.0
                for _ in range(REPS):
                    flush.zero_()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run()
                    end.record()
                    end.synchronize()
                    total += start.elapsed_time(end)
                print(f"{label} (capacity {cap}) {name}, producer chunks of "
                      f"{ec} expert(s) x {rows} rows: {total / REPS:.4f} ms "
                      f"[{where}]", flush=True)
        del grids, w, staging, out, flags, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
