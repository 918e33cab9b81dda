"""Does a torch.profiler session lose the records of its work?

Runs, for SECONDS (default 300), rounds of four profiler sessions of 10
short kernels each (an in-place add on 4 MB) after a burst of 4096^2 f32
matmuls: one that launches at once, one that waits 50 ms first, one that
waits 50 ms after its synchronize and one that does both. Each round
prints, per session, the kernels recorded (of 10) and the gap from the
first add's host op to its kernel's start and from the last add's host op
end to its kernel's end (us); the end prints how many sessions of each
kind recorded nothing.

    python3 scripts/torch_profiler_pad_probe.py [SECONDS]

Needs one CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

LEAD_S = 0.05
KINDS = {"at once": (0.0, 0.0), "lead": (LEAD_S, 0.0),
         "tail": (0.0, LEAD_S), "lead and tail": (LEAD_S, LEAD_S)}


def session(x: torch.Tensor, lead: float, tail: float, n: int = 10):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(lead)
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(tail)
    evs = prof.events()
    gpu = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in evs if e.device_type == torch.autograd.DeviceType.CPU
           and e.name == "aten::add_"]
    gaps = None
    if gpu and cpu:
        gaps = (round(gpu[0].time_range.start - cpu[0].time_range.start, 1),
                round(gpu[-1].time_range.end - cpu[-1].time_range.end, 1))
    return len(gpu), gaps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    x = torch.zeros(1 << 20, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")
    empty = dict.fromkeys(KINDS, 0)
    rounds = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
        line = []
        for kind, (lead, tail) in KINDS.items():
            n, gaps = session(x, lead, tail)
            empty[kind] += n == 0
            line.append(f"{kind} {n} {gaps}")
        print(f"t={time.perf_counter() - t0:.1f} s round {rounds}: "
              + "; ".join(line), flush=True)
        rounds += 1
        time.sleep(1.0)
    print(f"{rounds} sessions of each kind; sessions that recorded no "
          f"kernel: {empty}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
