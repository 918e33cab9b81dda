"""The one-chip MoE dispatch loopback and the notify/wait ring of one
checkout, timed at the shapes chip_smoke.py phase 6 gives them, so that two
commits can be compared on one card.

    python3 scripts/torch_collectives_before_after.py               # this one
    python3 scripts/torch_collectives_before_after.py --root DIR    # another

DIR holds a ``triton_distributed_tpu_torch`` package (for example an
earlier commit unpacked with ``git archive``). The script builds that
package's ``csrc/a2a_loopback.cu`` and ``csrc/notify_wait.cu`` alone (one
nvcc each, started together) into a library of their two entry points, and
calls them through that package's own wrappers (``a2a_loopback_cuda``,
``producer_consumer_cuda``) at four shapes:

- ``a2a full``: bench.py's dispatch arm, world 8, capacity 128 (one chunk
  of 128 rows), fp8 tokens of 7,168 B and f32 scales of 128 columns, every
  slot full;
- ``a2a 13 rows``: the same at 13 rows a slot (~10% occupancy);
- ``ring tutorial``: the tutorial's (8, 16, 128) f32 in chunks of 4 rows;
- ``ring long``: (8, 16,384, 128) f32 in chunks of 64 rows (256 chunks a
  rank, each queue slot reused 128 times).

For each it prints one JSON object with (a) ``ms``, CUDA events around each
call after an L2 flush (``chip_smoke.Timer``, the mean; ``ms_median`` the
median call); (b) ``device_ms``, the
kernel's device time alone (``chip_smoke.kernel_device_ms``); (c)
``b2b_ms``, the host clock over 200 back-to-back calls with no flush and
one synchronize at the end, per call (``chip_smoke.b2b_ms``): what a
caller's loop sees, measured before the process runs ``torch.profiler``
(``b2b_after_profiler_ms``: the same loops after (b)). The
library call that computes the same function (``copy_`` of both payloads;
``torch.roll(x, 1, 0)``) gets the same three figures (``library_*``). The
result is checked first: the a2a bytes below every count and the counts,
the ring ``== roll(x, 1, 0)`` bit for bit. Inputs are made on the card from
seed 0, the same for every checkout; every line carries the card's name and
power limit. To compare commits A and B, run A, B, B, A on one card, one
after another. Needs one CUDA card and nvcc.

    python3 scripts/torch_collectives_before_after.py --split

cuts each call's host path into its parts, the wrapper's steps replayed one
by one with the host clock around each (200 calls, the mean of each part):
the Python checks and ``torch.as_tensor``, each allocation, the signals'
buffers and epoch, the ``ctypes`` arrays, and the C entry. The C entry is
cut further by a probe compiled with the checkout's own source (one
translation unit that includes it): ``persistent_blocks``'s occupancy
query, the ticket's ``cudaMemsetAsync`` where the entry makes one, and, for
scale, an empty kernel's ``<<<>>>`` launch and its cooperative launch.

    python3 scripts/torch_collectives_before_after.py --breakdown

times the dispatch loopback on copies of ``csrc/`` whose receivers wait on
the count flag alone (no piece flags; the result after the launch is the
same, since every piece item still runs), whose pieces then also move no
bytes (their flags still raised), and whose receivers then also skip the
count flag: the differences to the kernel are what the receivers' piece
waits, the copies and the count's round trips cost; what is left is the
launch, the tickets and the signals.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("a2a_loopback.cu", "notify_wait.cu")
ENTRIES = ("tdt_a2a_loopback", "tdt_notify_wait")
WORLD, CAP, HIDDEN, SCALE_COLS, LOW = 8, 128, 7168, 128, 13   # phase 6
RINGS = {"tutorial": ((8, 16, 128), 4), "long": ((8, 256 * 64, 128), 64)}
REPS, B2B = 50, 200
# Patches of csrc/a2a_loopback.cu (its one-thread receiver or its warp
# receiver; each text found exactly once in the sources that have it): the receivers' piece
# waits cut, and then also the pieces' copies (their flags still raised).
NO_PIECE_WAITS = [
    ("for (int k = 0; k < live; ++k) lang::wait(flags + base + k, epoch);",
     ""),
    ("wait_all(base, live, epoch);", "")]
NO_COPIES = NO_PIECE_WAITS + [
    ("      lang::putmem_signal(pay.recv[p] + off, pay.send[p] + off,\n"
     "                          (size_t)(r1 - r0) * rb, flags + t, epoch);",
     "      lang::notify(flags + t, epoch);"),
    ("      lang::copy_rounds<kUnroll>(pay.recv[p] + off, pay.send[p] + off,\n"
     "                                 (size_t)(r1 - r0) * rb, threadIdx.x,\n"
     "                                 kThreads);", "")]
NO_WAITS = NO_COPIES + [
    ("      lang::wait(flags + i, epoch);\n", ""),
    ("      lang::wait(flags + i, epoch, 0);\n", "")]
BREAKDOWN = {"kernel": [], "no piece waits": NO_PIECE_WAITS,
             "no piece waits, no copies": NO_COPIES,
             "no waits, no copies": NO_WAITS}
# The probes: one translation unit with the checkout's source, timing the
# parts of its C entry with the host clock.
PROBE = r"""
#include <chrono>
#include "{src}"

namespace {{
__global__ void probe_empty_kernel() {{}}
double now_us() {{
  return std::chrono::duration<double, std::micro>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}}
}}

// out[0]: persistent_blocks (a2a only); out[1]: a 4-byte cudaMemsetAsync;
// out[2]: an empty kernel's <<<>>> launch; out[3]: its cooperative launch
// over `coop` blocks. Microseconds per call, over reps calls each.
extern "C" int tdt_probe_{name}(long long work, long long coop, int reps,
                                void* scratch, void* stream, double* out) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < 4; ++i) out[i] = 0;
  double t0;
#if {a2a}
  unsigned blocks = 0;
  t0 = now_us();
  for (int i = 0; i < reps; ++i)
    if (tdt::gemm::persistent_blocks(a2a_loopback_kernel, kThreads, 0, work,
                                     &blocks) != cudaSuccess) return 1;
  out[0] = (now_us() - t0) / reps;
#endif
  t0 = now_us();
  for (int i = 0; i < reps; ++i)
    if (cudaMemsetAsync(scratch, 0, 4, s) != cudaSuccess) return 2;
  out[1] = (now_us() - t0) / reps;
  t0 = now_us();
  for (int i = 0; i < reps; ++i) probe_empty_kernel<<<1, 256, 0, s>>>();
  out[2] = (now_us() - t0) / reps;
  void* args[] = {{nullptr}};
  t0 = now_us();
  for (int i = 0; i < reps; ++i)
    if (cudaLaunchCooperativeKernel(
            reinterpret_cast<const void*>(probe_empty_kernel),
            dim3((unsigned)coop), dim3(256), args, 0, s) != cudaSuccess)
      return 3;
  out[3] = (now_us() - t0) / reps;
  return cudaGetLastError();
}}
"""


def load_smoke():
    """This checkout's chip_smoke.py, for its timers (it imports only torch
    at its top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched_csrc(_build, out_dir: str, patches) -> Path:
    """The package's csrc/, or a copy under out_dir with a2a_loopback.cu
    patched (each patch that the source holds, applied once; at least
    one)."""
    if not patches:
        return _build.CSRC
    csrc = Path(out_dir) / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    cu = csrc / "a2a_loopback.cu"
    text = cu.read_text()
    hits = [(old, new) for old, new in patches if text.count(old) == 1]
    if not hits:
        raise RuntimeError("a2a_loopback.cu holds none of the patches' texts")
    for old, new in hits:
        text = text.replace(old, new)
    cu.write_text(text)
    return csrc


def build(_build, out_dir: str, patches=(), probes=False) -> ctypes.CDLL:
    """The two sources of the package whose ``_build`` is given (patched;
    with ``probes``, each inside its probe's translation unit), compiled
    with its flags and linked into one library kept under a hash of its
    sources and flags; the entry points get the package's own argtypes."""
    os.makedirs(out_dir, exist_ok=True)
    csrc = patched_csrc(_build, out_dir, patches)
    units = []
    for src in SOURCES:
        if probes:
            name = src.split(".")[0]
            unit = Path(out_dir) / f"probe_{name}.cu"
            unit.write_text(PROBE.format(src=csrc / src, name=name,
                                         a2a=int(name == "a2a_loopback")))
            units.append(unit)
        else:
            units.append(csrc / src)
    h = hashlib.sha256(" ".join(_build.ARCH_FLAGS
                                + _build.NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")) + units:
        h.update(p.name.encode() + p.read_bytes())
    so = os.path.join(out_dir, f"libcoll_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        nvcc = _build.nvcc_path()
        procs = []
        for unit in units:
            obj = os.path.join(out_dir, unit.stem + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
                 str(csrc), "-c", str(unit), "-o", obj],
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
    if probes:
        for name in ("tdt_probe_a2a_loopback", "tdt_probe_notify_wait"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_double)]
            fn.restype = ctypes.c_int
    return lib


def events_median_ms(timer, fn, reps: int = REPS) -> float:
    """(a) as ``chip_smoke.Timer`` measures it (CUDA events around each
    call after its L2 flush), the median call instead of the mean: a call
    that the shared host delays past the flush lifts the mean alone."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        timer.flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def a2a_inputs(smoke, gen, count):
    toks = smoke.randn(gen, WORLD, CAP, HIDDEN, dtype=torch.float32).to(
        torch.float8_e4m3fn)
    scales = torch.rand(WORLD, CAP, SCALE_COLS, generator=gen, device="cuda")
    counts = torch.full((WORLD,), count, dtype=torch.int32, device="cuda")
    return toks, scales, counts


def a2a_same(tea, ctx, toks, scales, counts, got) -> bool:
    (gt, gs), rc = got
    (wt, ws), _ = tea.a2a_loopback_ref((toks, scales), counts, ctx=ctx,
                                       world=WORLD)
    live = (torch.arange(CAP, device="cuda")[None]
            < counts.clamp(0, CAP)[:, None])[..., None]
    return (torch.equal(rc, counts)
            and torch.equal(gt.view(torch.uint8) * live,
                            wt.view(torch.uint8) * live)
            and torch.equal(gs.view(torch.int32) * live,
                            ws.view(torch.int32) * live))


def cases(smoke, tea, tnw, gen):
    """(name, kernel call, library call, check, device kernel name)."""
    ctx = tea.AllToAllContext(capacity=CAP, hidden=HIDDEN, chunk_rows=CAP)
    out = []
    for name, count in (("a2a full", CAP), ("a2a 13 rows", LOW)):
        toks, scales, counts = a2a_inputs(smoke, gen, count)
        dt, ds = torch.empty_like(toks), torch.empty_like(scales)

        def run(toks=toks, scales=scales, counts=counts):
            return tea.a2a_loopback_cuda((toks, scales), counts, ctx=ctx,
                                         world=WORLD)

        def lib(toks=toks, scales=scales, dt=dt, ds=ds):
            dt.copy_(toks)
            ds.copy_(scales)

        def check(run=run, toks=toks, scales=scales, counts=counts):
            return a2a_same(tea, ctx, toks, scales, counts, run())

        out.append((name, run, lib, check, "a2a_loopback_kernel"))
    for name, (shape, ch) in RINGS.items():
        x = smoke.randn(gen, *shape, dtype=torch.float32)

        def run(x=x, ch=ch):
            return tnw.producer_consumer_cuda(x, chunk_rows=ch)

        def check(run=run, x=x):
            return torch.equal(run(), torch.roll(x, 1, 0))

        out.append((f"ring {name}", run,
                    lambda x=x: torch.roll(x, 1, 0), check,
                    "notify_wait_kernel"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding triton_distributed_tpu_torch")
    ap.add_argument("--label", default=None)
    ap.add_argument("--split", action="store_true",
                    help="cut each call's host path into its parts")
    ap.add_argument("--breakdown", action="store_true",
                    help="time the dispatch loopback without piece waits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    label = args.label or os.path.basename(root)
    sys.path.insert(0, root)
    smoke = load_smoke()
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import ep_all_to_all as tea
    from triton_distributed_tpu_torch.kernels import notify_wait as tnw
    if not str(_build.CSRC).startswith(root):
        raise RuntimeError(f"imported {_build.CSRC}, not {root}'s package")
    t0 = time.perf_counter()
    out_dir = os.path.join(root, "build", "collectives_before_after")
    _build._LIBRARY._lib = build(_build, out_dir, probes=args.split)
    built = time.perf_counter() - t0
    card = smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    todo = cases(smoke, tea, tnw, gen)
    if args.split:
        return split(_build, tea, tnw, smoke, todo, label, card)
    if args.breakdown:
        return breakdown(_build, tea, smoke, todo, root, label, card)
    timer = smoke.Timer("cuda")
    profiled = []
    for name, run, lib, check, kernel in todo:
        if not check():
            raise AssertionError(f"{label}: {name}: the kernel's result "
                                 f"differs from its plain version")
        # The back-to-back loops first, before the process runs a
        # torch.profiler session; the same loops after (b) are kept apart.
        rec = {"root": label, "case": name,
               "b2b_ms": smoke.b2b_ms(run, B2B),
               "library_b2b_ms": smoke.b2b_ms(lib, B2B)}
        rec.update({"ms": timer(run, reps=REPS),
                    "ms_median": events_median_ms(timer, run),
                    "library_ms": timer(lib, reps=REPS),
                    "library_ms_median": events_median_ms(timer, lib)})
        profiled.append((rec, run, lib, kernel))
    for rec, run, lib, kernel in profiled:
        rec["device_ms"] = smoke.kernel_device_ms(run, kernel)
        rec["library_device_ms"] = smoke.call_device_ms(lib)
    for rec, run, lib, kernel in profiled:
        rec["b2b_after_profiler_ms"] = smoke.b2b_ms(run, B2B)
        rec["library_b2b_after_profiler_ms"] = smoke.b2b_ms(lib, B2B)
        rec["ms_over_library"] = rec["ms"] / rec["library_ms"]
        rec["b2b_over_library"] = rec["b2b_ms"] / rec["library_b2b_ms"]
        rec["card"] = card
        print(json.dumps(rec), flush=True)
    print(json.dumps({"root": label, "build_s": built, "card": card}),
          flush=True)
    return 0


class Clock:
    """Host-clock sums of named parts, in call order."""

    def __init__(self):
        self.parts: dict[str, float] = {}
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        t = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + t - self.t
        self.t = t


def split_a2a(_build, tea, toks, scales, counts, ctx, clock):
    """The dispatch wrapper's steps of a checkout whose signals the host
    resets (``a2a_loopback_cuda`` with a scratch ticket and cells and a
    memset in the C entry), one by one, at one call's cost each."""
    world, payloads = WORLD, (toks, scales)
    single, payloads = tea._as_tuple(payloads)
    tea._check_layout(payloads, ctx, world)
    dev = payloads[0].device
    for pay in payloads:
        if not pay.is_cuda or pay.device != dev or not pay.is_contiguous():
            raise ValueError("payloads")
    cn = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    if cn.shape != (world,):
        raise ValueError("counts")
    cn = cn.contiguous()
    cap, ch = ctx.capacity, ctx.chunk_rows
    clock.lap("checks and torch.as_tensor")
    recvs = [torch.empty_like(pay) for pay in payloads]
    clock.lap("torch.empty_like x 2 (the receive payloads)")
    row_bytes = [pay.numel() // (world * cap) * pay.element_size()
                 for pay in payloads]
    piece_rows = [min(ch, max(1, tea.PIECE_BYTES // rb)) for rb in row_bytes]
    items = sum(world * (cap // ch) * -(-ch // pr) for pr in piece_rows)
    clock.lap("row bytes, pieces and items")
    flags = tea._signal.flags(dev, "a2a_loopback", items + 2 * world)
    clock.lap("_signal.flags")
    cells = torch.empty(world, dtype=torch.int32, device=dev)
    clock.lap("torch.empty (cells)")
    recv_counts = torch.empty(world, dtype=torch.int32, device=dev)
    clock.lap("torch.empty (recv_counts)")
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    clock.lap("torch.empty (ticket)")
    n = len(payloads)
    arrays = ((ctypes.c_void_p * n)(*[p.data_ptr() for p in payloads]),
              (ctypes.c_void_p * n)(*[r.data_ptr() for r in recvs]),
              (ctypes.c_longlong * n)(*row_bytes),
              (ctypes.c_longlong * n)(*piece_rows))
    clock.lap("ctypes arrays")
    epoch, stream = tea._signal.next_epoch(dev), _build.stream_ptr(toks)
    lib = _build.lib()
    clock.lap("epoch, stream and library")
    err = lib.tdt_a2a_loopback(*arrays, n, cn.data_ptr(), cells.data_ptr(),
                               recv_counts.data_ptr(), flags.data_ptr(),
                               ticket.data_ptr(), epoch, world, cap, ch,
                               stream)
    clock.lap("C entry (occupancy query, ticket memset, launch)")
    _build.check(err, "tdt_a2a_loopback")
    tea.A2A_LOOPBACK.launches += 1
    clock.lap("check and count")
    return items + 2 * world


def split_ring(_build, tnw, x, ch, clock):
    """The ring wrapper's steps of a checkout whose signals the host
    resets (``_signal.counters``), one by one."""
    n_chunks = tnw._n_chunks(x, ch)
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("x")
    world = x.shape[0]
    chunk_bytes = x[0, :ch].numel() * x.element_size()
    shape = (world, 2, ch, *x.shape[2:])
    clock.lap("checks")
    queue = torch.empty(shape, dtype=x.dtype, device=x.device)
    clock.lap("torch.empty (queue)")
    out = torch.empty_like(x)
    clock.lap("torch.empty_like (out)")
    signals = tnw._signal.counters(x.device, "notify_wait", 3 * world + 1)
    clock.lap("_signal.counters (lookup and zero_: a memset launch)")
    lib, stream = _build.lib(), _build.stream_ptr(x)
    clock.lap("stream and library")
    err = lib.tdt_notify_wait(x.data_ptr(), queue.data_ptr(), out.data_ptr(),
                              signals.data_ptr(), world, n_chunks,
                              chunk_bytes, 0, stream)
    clock.lap("C entry (cudaLaunchCooperativeKernel)")
    _build.check(err, "tdt_notify_wait")
    tnw.NOTIFY_WAIT.launches += 1
    clock.lap("check and count")
    return world


def split_a2a_plan(_build, tea, toks, scales, counts, ctx, clock):
    """The dispatch wrapper's steps where the kernel resets its ticket (a
    cached plan, a persistent ticket and count cells), one by one."""
    world, payloads = WORLD, (toks, scales)
    single, payloads = tea._as_tuple(payloads)
    tea._check_layout(payloads, ctx, world)
    dev = payloads[0].device
    for pay in payloads:
        if not pay.is_cuda or pay.device != dev or not pay.is_contiguous():
            raise ValueError("payloads")
    cn = counts
    if not (isinstance(cn, torch.Tensor) and cn.dtype == torch.int32
            and cn.device == dev):
        cn = torch.as_tensor(cn, dtype=torch.int32, device=dev)
    if cn.shape != (world,):
        raise ValueError("counts")
    cn = cn.contiguous()
    cap, ch = ctx.capacity, ctx.chunk_rows
    clock.lap("checks (torch.as_tensor only for counts not yet int32 "
              "there)")
    plan = tea._a2a_plan(payloads, cap, ch, world, tea.PIECE_BYTES)
    clock.lap("the cached plan")
    recvs = [torch.empty_like(pay) for pay in payloads]
    clock.lap("torch.empty_like x 2 (the receive payloads)")
    recv_counts = torch.empty(world, dtype=torch.int32, device=dev)
    clock.lap("torch.empty (recv_counts)")
    stream = _build.stream_ptr(toks)
    clock.lap("stream")
    flags = tea._signal.flags(dev, "a2a_loopback", plan.items + 2 * world,
                              stream)
    scratch = tea._signal.arrivals(dev, "a2a_loopback", 32 + world,
                                   stream).data_ptr()
    clock.lap("_signal.flags and .arrivals (ticket, cells)")
    n = len(payloads)
    sends = plan.c_pointers(*[p.data_ptr() for p in payloads])
    recv_ptrs = plan.c_pointers(*[r.data_ptr() for r in recvs])
    clock.lap("ctypes arrays")
    epoch, lib = tea._signal.next_epoch(dev), _build.lib()
    clock.lap("epoch and library")
    err = lib.tdt_a2a_loopback(sends, recv_ptrs, plan.c_row_bytes,
                               plan.c_piece_rows, n, cn.data_ptr(),
                               scratch + 128, recv_counts.data_ptr(),
                               flags.data_ptr(), scratch, epoch, world, cap,
                               ch, stream)
    clock.lap("C entry (cached occupancy, launch)")
    _build.check(err, "tdt_a2a_loopback")
    tea.A2A_LOOPBACK.launches += 1
    clock.lap("check and count")
    return plan.items + 2 * world


def split_ring_arrivals(_build, tnw, x, ch, clock):
    """The ring wrapper's steps where the kernel resets its signals (a
    persistent queue, ``_signal.arrivals``), one by one."""
    n_chunks = tnw._n_chunks(x, ch)
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("x")
    world = x.shape[0]
    chunk_bytes = x.numel() // (world * n_chunks) * x.element_size()
    shape = (world, 2, ch, *x.shape[2:])
    clock.lap("checks")
    stream = _build.stream_ptr(x)
    clock.lap("stream")
    queue = tnw._QUEUES.get((x.device, stream, shape, x.dtype))
    if queue is None:
        queue = tnw._QUEUES[(x.device, stream, shape, x.dtype)] = (
            torch.empty(shape, dtype=x.dtype, device=x.device))
    clock.lap("the persistent queue")
    out = torch.empty_like(x)
    clock.lap("torch.empty_like (out)")
    stripes = min(tnw.MAX_STRIPES, -(-chunk_bytes // tnw.MIN_STRIPE))
    signals = tnw._signal.arrivals(x.device, "notify_wait",
                                   3 * world * stripes + 1, stream)
    clock.lap("_signal.arrivals")
    lib = _build.lib()
    err = lib.tdt_notify_wait(x.data_ptr(), queue.data_ptr(), out.data_ptr(),
                              signals.data_ptr(), world, n_chunks,
                              chunk_bytes, 0, stream)
    clock.lap("C entry (cudaLaunchCooperativeKernel)")
    _build.check(err, "tdt_notify_wait")
    tnw.NOTIFY_WAIT.launches += 1
    clock.lap("check and count")
    return world


def split(_build, tea, tnw, smoke, todo, label, card) -> int:
    """Each call's host path in parts (mean microseconds over B2B calls;
    each part also holds one lap of the clock), then the C entries' parts
    from the probes. The steps replayed are those of the checkout's
    wrappers: with host-reset counters (``_signal.counters``) or
    without."""
    legacy = hasattr(tea._signal, "counters")
    split_a, split_r = ((split_a2a, split_ring) if legacy
                        else (split_a2a_plan, split_ring_arrivals))
    ctx = tea.AllToAllContext(capacity=CAP, hidden=HIDDEN, chunk_rows=CAP)
    lib = _build.lib()
    scratch = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, run, _, check, _ in todo:
        if not check():
            raise AssertionError(f"{label}: {name}: wrong result")
        if name.startswith("a2a"):
            inputs = a2a_inputs(smoke, gen, CAP if "full" in name else LOW)
            step = (lambda clock: split_a(_build, tea, *inputs, ctx,
                                          clock))
        else:
            shape, ch = RINGS[name.split()[1]]
            x = smoke.randn(gen, *shape, dtype=torch.float32)
            step = (lambda clock: split_r(_build, tnw, x, ch, clock))
        for _ in range(3):
            step(Clock())
        torch.cuda.synchronize()
        clock = Clock()
        t0 = time.perf_counter()
        for _ in range(B2B):
            clock.t = time.perf_counter()
            work = step(clock)
        host = (time.perf_counter() - t0) / B2B * 1e6
        torch.cuda.synchronize()
        parts = {k: v / B2B * 1e6 for k, v in clock.parts.items()}
        rec = {"root": label, "case": name, "split_us": parts,
               "host_us_per_call": host, "card": card}
        probe = (ctypes.c_double * 4)()
        is_a2a = name.startswith("a2a")
        fn = (lib.tdt_probe_a2a_loopback if is_a2a
              else lib.tdt_probe_notify_wait)
        err = fn(work,
                 WORLD, B2B, scratch.data_ptr(), stream, probe)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"probe failed: {err}")
        rec["c_entry_parts_us"] = {
            "persistent_blocks": probe[0] if is_a2a else None,
            "cudaMemsetAsync 4 B": probe[1],
            "empty kernel <<<1, 256>>>": probe[2],
            f"empty kernel cooperative <<<{WORLD}, 256>>>": probe[3]}
        print(json.dumps(rec), flush=True)
    return 0


def breakdown(_build, tea, smoke, todo, root, label, card) -> int:
    """The dispatch loopback on the kernel and on each patched variant of
    BREAKDOWN, in turns (the order reversed in the second round). The
    variants without piece waits still give the kernel's result (every
    piece item runs before the launch ends); the one without copies does
    not, and is not checked."""
    libs = {name: build(_build, os.path.join(
        root, "build", "collectives_breakdown", str(i)), patches)
        if patches else _build.lib()
        for i, (name, patches) in enumerate(BREAKDOWN.items())}
    for rnd in range(2):
        for variant in (list(libs) if rnd == 0 else list(libs)[::-1]):
            _build._LIBRARY._lib = libs[variant]
            for name, run, _, check, kernel in todo:
                if not name.startswith("a2a"):
                    continue
                if "no copies" not in variant and not check():
                    raise AssertionError(f"{label} {variant}: {name}: "
                                         f"wrong result")
                print(json.dumps({
                    "root": label, "variant": variant, "case": name,
                    "device_ms": smoke.kernel_device_ms(run, kernel),
                    "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
