"""Count the PyTorch operators one ``BatchEngine`` serving step dispatches.

    python3 scripts/torch_step_ops.py [--config tiny] [--device cpu]
                                      [--layers N] [--kv int8]

Builds a ``BatchEngine`` (4 slots, blocks of 4, chunks of 8) over random
weights, admits three requests, and counts every ATen operator called
(``TorchDispatchMode``, nested calls included) in one mixed step and in one
decode step after it, then times eight more decode steps without the
counter (host clock, the device synchronized after each) and prints their
median. On a CUDA device the kernels launched through the ctypes library
are not operators and are not counted; on the CPU their plain versions
are. The counts depend on the code, not on the device's speed, so two
trees can be compared on any machine; the times only within one call.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from triton_distributed_tpu_torch import BatchEngine, Engine, ModelConfig  # noqa: E402


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--kv", default=None, choices=[None, "int8", "fp8"])
    args = ap.parse_args()
    over = {} if args.layers is None else {"n_layers": args.layers}
    cfg = ModelConfig.from_name(args.config, **over)
    eng = Engine(cfg, mode="dist", device=args.device, seed=0)
    be = BatchEngine(eng, n_slots=4, block_size=4, prefill_chunk=8,
                     max_seq_len=64, kv_dtype=args.kv)
    g = torch.Generator().manual_seed(0)
    for n in (5, 11, 8):
        be.submit(torch.randint(0, cfg.vocab_size, (n,), generator=g), 16)
    be.step()                                    # warm-up: the first chunk
    seen = {}
    while len(seen) < 2:
        mixed_before = be.metrics["prefill_steps"]
        counter = CountOps()
        t0 = time.perf_counter()
        with counter:
            if not be.step():
                raise RuntimeError("the engine went idle before it ran a "
                                   "mixed and a decode step")
        if args.device != "cpu":
            torch.cuda.synchronize()
        kind = ("mixed" if be.metrics["prefill_steps"] > mixed_before
                else "decode")
        seen.setdefault(kind, (counter, time.perf_counter() - t0))
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        if not be.step():
            break
        if args.device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    for kind in ("mixed", "decode"):
        counter, wall = seen[kind]
        total = sum(counter.ops.values())
        top = ", ".join(f"{k} {n}" for k, n in counter.ops.most_common(6))
        print(f"{kind} step, {cfg.n_layers} layers, {args.device}, "
              f"kv {args.kv or cfg.dtype}: {total} ops "
              f"({total / cfg.n_layers:.1f} per layer), host wall "
              f"{wall * 1e3:.2f} ms under the counter; top: {top}",
              flush=True)
    print(f"decode steps without the counter: median "
          f"{1e3 * sorted(times)[len(times) // 2]:.2f} ms of {len(times)}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
