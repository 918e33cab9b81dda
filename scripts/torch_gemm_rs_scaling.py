"""Where GroupGEMM-RS spends its time: device time against K, d and E.

    python3 scripts/torch_gemm_rs_scaling.py     # on a machine with one H100

``csrc/group_gemm_rs.cu`` at Qwen3-30B-A3B's prefill (world 8, 128
experts, capacity 128, f_local 96, d 2,048) pushes 1.88e9 of its 2.15e9
partials into staging (16-byte vectors from each product tile) and folds
them back with the owners' own. This script times the kernel alone
(``torch.profiler``, the L2 flushed before each call, bf16) at that shape
and at shapes that change one factor:

- K (f_local) x4: the tiles' operations grow, their partials do not;
- d / 4: the partials shrink with the operations;
- E folded into the rows (one expert, ``gemm_rs.cu``'s geometry through the
  same items): the same partials and operations in fewer, taller products.

A time that follows the partials and not K says the pushes and the fold,
not the MMA, hold the kernel. Prints one line a shape, with the card's name
and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from triton_distributed_tpu_torch.kernels import (  # noqa: E402
    gemm_reduce_scatter,
    moe_overlap,
)

WORLD, E, CAP, F, D = 8, 128, 128, 96, 2048
REPS = 10


def device_ms(fn, kernel: str) -> float:
    """Mean device time of the kernel whose name holds ``kernel`` over
    REPS calls, each after a 256 MB write that flushes the L2 cache."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and kernel in ev.key]
    seen = sum(ev.count for ev in evs)
    if not seen:
        raise RuntimeError(f"the profiler saw no launch of {kernel}")
    return sum(ev.self_device_time_total for ev in evs) / seen / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gemm_rs_scaling: no CUDA device is visible",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    rows = WORLD * CAP
    for label, e, f, d in (("prefill", E, F, D), ("K x4", E, 4 * F, D),
                           ("d / 4", E, F, D // 4)):
        act, w = randn(WORLD, e, rows, f), randn(WORLD, e, f, d)
        t = device_ms(lambda: moe_overlap.group_gemm_rs_cuda(act, w),
                      "group_gemm_rs_kernel")
        print(f"group_gemm_rs {label}: act {tuple(act.shape)} x w "
              f"{tuple(w.shape)}: device {t:.4f} ms, "
              f"{WORLD * e * rows * d:.4g} partials, "
              f"{2 * WORLD * e * rows * f * d:.4g} operations [{card}]",
              flush=True)
        del act, w
    # E folded into M: one product per rank over all E x rows rows. Its
    # segments are (E cap) rows of every expert, so the partials and the
    # operations are the prefill's; only the products are taller.
    a, b = randn(WORLD, E * rows, F), randn(WORLD, F, D)
    t = device_ms(lambda: gemm_reduce_scatter.gemm_rs_cuda(a, b),
                  "gemm_rs_kernel")
    print(f"gemm_rs (E folded into M): a {tuple(a.shape)} x b "
          f"{tuple(b.shape)}: device {t:.4f} ms, "
          f"{WORLD * E * rows * D:.4g} partials [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
