"""A/B of the port's bf16 matmul kernel against its 64x32-warp-tile variant,
in one process on one card.

    python3 scripts/torch_matmul_tile_ab.py

Builds ``triton_distributed_tpu_torch/csrc/matmul.cu`` as committed (four
warps, a 64x64 tile each) and a variant with eight warps of 64x32 (the
same source with three constants changed) into ``build/torch_matmul_ab/``,
then times both at the four Qwen3-1.7B prefill projection shapes in turns
(A B, B A, ...; CUDA events, L2 flushed before each launch) and prints each
round's per-layer sum and the medians. The two outputs are held against
each other (bf16, atol=rtol=2e-2).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "triton_distributed_tpu_torch" / "csrc"
OUT = REPO / "build" / "torch_matmul_ab"
SHAPES = {"qkv": (8192, 2048, 4096), "o": (8192, 2048, 2048),
          "gate_up": (8192, 2048, 12288), "down": (8192, 6144, 2048)}
# committed 64x64 warp tile -> the 64x32 variant
W32_EDITS = [
    ("constexpr int THREADS = 128;", "constexpr int THREADS = 256;"),
    ("constexpr int MI = 4, NJ = 8;", "constexpr int MI = 4, NJ = 4;"),
    ("const int wm = warp / 2, wn = warp % 2;",
     "const int wm = warp / 4, wn = warp % 4;"),
    ("wn * 64", "wn * 32"),
]


def build(name: str, source: str):
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"matmul_{name}.cu", OUT / f"lib_{name}.so"
    src.write_text(source)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-I", str(CSRC), str(src), "-o", str(lib)], check=True)
    fn = ctypes.CDLL(str(lib)).tdt_matmul
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    committed = (CSRC / "matmul.cu").read_text()
    variant = committed
    for old, new in W32_EDITS:
        if old not in variant:
            raise RuntimeError(f"matmul.cu no longer holds {old!r}")
        variant = variant.replace(old, new)
    kernels = {"w64": build("w64", committed), "w32": build("w32", variant)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def launch(fn, a, b, c):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), a.shape[0],
                 b.shape[1], a.shape[1], 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    def time_ms(fn, a, b, c, reps=10):
        for _ in range(2):
            launch(fn, a, b, c)
        total = 0.0
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(fn, a, b, c)
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    runs = {name: [] for name in kernels}
    for _ in range(3):
        for order in (("w32", "w64"), ("w64", "w32")):
            per_layer = dict.fromkeys(order, 0.0)
            for M, K, N in SHAPES.values():
                a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
                b = (torch.randn(K, N, generator=gen, device="cuda")
                     * K ** -0.5).bfloat16()
                outs = {}
                for name in order:
                    outs[name] = torch.empty(M, N, device="cuda",
                                             dtype=torch.bfloat16)
                    per_layer[name] += time_ms(kernels[name], a, b,
                                               outs[name])
                torch.testing.assert_close(outs["w32"], outs["w64"],
                                           atol=2e-2, rtol=2e-2)
            for name in order:
                runs[name].append(per_layer[name])
            print(order, {k: round(v, 4) for k, v in per_layer.items()},
                  flush=True)
    for name, values in runs.items():
        print(f"{name}: per-layer ms {[round(v, 4) for v in values]}, "
              f"median {sorted(values)[len(values) // 2]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
