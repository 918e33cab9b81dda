"""The ring and direct-push allgathers and the one-shot all-reduce loopback
of one checkout, timed at the shapes chip_smoke.py phases 6 and 10 give
them, so that two commits can be compared on one card.

    python3 scripts/torch_ag_ar_loopback_before_after.py               # this
    python3 scripts/torch_ag_ar_loopback_before_after.py --root DIR    # another

DIR holds a ``triton_distributed_tpu_torch`` package (for example an
earlier commit unpacked with ``git archive``). The script builds that
package's ``csrc/ring_ag.cu``, ``a2a_ag.cu`` and ``oneshot_ar_loopback.cu``
alone (one nvcc each, started together; with ``--shared`` also
``oneshot_ar.cu`` and ``matmul.cu``) into one library, and calls them
through that package's own wrappers:

- ``ring decode`` / ``ring prefill``: ``ring_all_gather_cuda`` at phase
  10's (8, 16, 5,120) and (8, 1,024, 5,120) bf16;
- ``a2a decode`` / ``a2a prefill``: ``a2a_all_gather_cuda`` at the same;
- ``loopback``: ``oneshot_ar_loopback(x, world=8)`` at bench.py's (128,
  5,120) bf16 (phase 6).

For each it prints one JSON object with ``ms``, CUDA events around each
call after an L2 flush (``chip_smoke.Timer``, the mean), ``device_ms``,
the kernel's device time alone (``chip_smoke.kernel_device_ms``), ``b2b_ms``,
the host clock per call over 200 calls back to back
(``chip_smoke.b2b_ms``), ``ops``, the device operations one call enqueues
(``chip_smoke.captured_ops``), and the library call that computes the same
function (``x.reshape(1, -1, n).expand(8, -1, -1).contiguous()``;
``x.mul(8)``) with the same figures (``library_*``) and ``ms_over_library``.
The result is checked first against the plain version, bit for bit.

    --shared    also row 14's multi-rank one-shot all-reduce through its
                serving path at phase 7's (8, 128, 5,120) and (8, 8, 5,120)
                bf16 beside ``x.float().sum(0)``, and phase 6's M = 128 ar
                and no-communication arms timed in turns (the median of
                chip_smoke.DECOMPOSITION_ROUNDS rounds):
                ``mlp_m128_ar_machinery_ms`` is their difference.
    --pieces    the ring at both shapes with each piece size in PIECES
                (this checkout's ``allgather.ring_piece`` replaced), and
                the loopback with each chunk unit in CHUNKS (its
                ``allreduce.LOOPBACK_CHUNK_BYTES`` replaced), in turns:
                device time and events.

    --breakdown the ring at the decode shard (163,840 B) at worlds 2, 3,
                4, 6 and 8 (its time against its world - 1 hops) and the
                loopback at worlds 1, 2, 4 and 8; then both on copies of
                csrc/ patched one way each, in turns (every patch text
                found exactly once): ``no release fence`` (the ring's flag
                stored relaxed, no fence before it: a measurement only),
                ``signals only`` (the ring's steps after the first copy
                nothing, their flags still chained: a measurement only),
                ``ticket a block`` (one ticket a block, then a stride of
                the grid), ``fold unroll 2`` (the one-shot fold two vectors
                a thread at once) and ``ring sleep 32`` (the ring's spin
                sleeps 32 ns between polls); only the last three are
                checked, the first two are wrong by design.

Inputs are made on the card from seed 0, the same for every checkout;
every line carries the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``). To compare commits A
and B, run A, B, B, A on one card, one after another. Needs one CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
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
SOURCES = ("ring_ag.cu", "a2a_ag.cu", "oneshot_ar_loopback.cu")
SHARED_SOURCES = ("oneshot_ar.cu", "matmul.cu")
WORLD, HIDDEN = 8, 5120
AG_ROWS = {"decode": 16, "prefill": 1024}        # phase 10
AR_ROWS, AR_FF = 128, 3200                       # phase 6
ONESHOT_ROWS = {"bench": 128, "decode": 8}       # phase 7
PIECES = (8192, 16384, 32768, 65536)
CHUNKS = (4096, 8192, 16384)
# --breakdown's patches: (file, text, replacement).
RING_WAIT = "      if (threadIdx.x == 0) lang::wait(flag, 1u, 0);\n"
RING_NOTIFY = ("      if (threadIdx.x == 0) lang::notify(flag_at(right, step, "
               "q), 1u);\n")
RING_FORWARD = ("    forward(out + (size_t)right * row + (size_t)c * seg + "
                "p0, own, src, len);\n")
TICKET = """  for (;;) {
    const int t = tdt::gemm::take_ticket(ticket, total + (int)gridDim.x - 1);
    if (t >= total) return;
"""
TICKET_A_BLOCK = """  const int first = tdt::gemm::take_ticket(ticket, (int)gridDim.x - 1);
  for (int t = first; t < total; t += gridDim.x) {
"""
FOLD_LOOP = ("    for (long long i = threadIdx.x; i < len / P; i += kThreads) {"
             "\n      float acc[P];\n")
BREAKDOWN = {
    "kernel": ([], True),
    "no release fence": ([("ring_ag.cu", RING_NOTIFY, (
        "      if (threadIdx.x == 0)\n        asm volatile(\"st.relaxed.gpu."
        "global.u32 [%0], %1;\" :: \"l\"(flag_at(right, step, q)), "
        "\"r\"(1u) : \"memory\");\n"))], False),
    "signals only": ([("ring_ag.cu", RING_FORWARD,
                       "    if (step == 0)\n  " + RING_FORWARD)], False),
    "ticket a block": ([("ring_ag.cu", TICKET, TICKET_A_BLOCK),
                        ("oneshot_ar_loopback.cu", TICKET, TICKET_A_BLOCK)],
                       True),
    "fold unroll 2": ([("oneshot_ar.cuh", FOLD_LOOP,
                        "#pragma unroll 2\n" + FOLD_LOOP)], True),
    "ring sleep 32": ([("ring_ag.cu", RING_WAIT,
                        RING_WAIT.replace("1u, 0)", "1u, 32)"))], True),
}
REPS = 50


def load_smoke():
    """This checkout's chip_smoke.py, for its timers (it imports only torch
    at its top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(_build, out_dir: str, sources, csrc=None) -> ctypes.CDLL:
    """The sources of the package whose ``_build`` is given (from ``csrc``,
    by default its own), compiled with its flags and linked into one
    library kept under a hash of its sources and flags; every entry point
    of its ``SIGNATURES`` that the library holds gets the package's own
    argtypes."""
    csrc = csrc or _build.CSRC
    os.makedirs(out_dir, exist_ok=True)
    h = hashlib.sha256(" ".join(_build.ARCH_FLAGS + _build.NVCC_FLAGS
                                + list(sources)).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode() + p.read_bytes())
    so = os.path.join(out_dir, f"libagar_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        nvcc = _build.nvcc_path()
        procs = []
        for src in sources:
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
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def gather_lib(x):
    return lambda: x.reshape(1, -1, x.shape[2]).expand(
        x.shape[0], -1, -1).contiguous()


def cases(smoke, tag, tar, gen, shared: bool):
    """(name, kernel call, library call, check, kernel name, reps)."""
    out = []
    for label, rows in AG_ROWS.items():
        x = smoke.randn(gen, WORLD, rows, HIDDEN)
        reps = REPS if rows < 1024 else 10
        for method, run, kern in (
                ("ring", tag.ring_all_gather_cuda, "ring_ag_kernel"),
                ("a2a", tag.a2a_all_gather_cuda, "a2a_ag_kernel")):
            out.append((
                f"{method} {label}", lambda x=x, run=run: run(x),
                gather_lib(x),
                lambda x=x, run=run: torch.equal(run(x),
                                                 tag.all_gather_ref(x)),
                kern, reps))
    x = smoke.randn(gen, AR_ROWS, HIDDEN)
    out.append(("loopback", lambda: tar.oneshot_ar_loopback(x, world=WORLD),
                lambda: x.mul(WORLD),
                lambda: torch.equal(tar.oneshot_ar_loopback(x, world=WORLD),
                                    tar.oneshot_ar_loopback_ref(x,
                                                                world=WORLD))
                and torch.equal(tar.oneshot_ar_loopback(x, world=WORLD),
                                x.mul(WORLD)),
                "ar_loopback_kernel", REPS))
    if shared:
        for label, rows in ONESHOT_ROWS.items():
            xs = smoke.randn(gen, WORLD, rows, HIDDEN)
            out.append((
                f"oneshot {label} serving",
                lambda xs=xs: tar.oneshot_all_reduce(xs, world=WORLD),
                lambda xs=xs: xs.float().sum(0),
                lambda xs=xs: torch.equal(
                    tar.oneshot_all_reduce(xs, world=WORLD),
                    tar.oneshot_all_reduce_ref(xs)),
                "oneshot_ar_kernel", REPS))
    return out


def record(smoke, timer, name, run, lib, kernel, reps, label, card):
    # The host clock first: the profiler can slow a process's host path.
    rec = {"root": label, "case": name,
           "b2b_ms": smoke.b2b_ms(run), "library_b2b_ms": smoke.b2b_ms(lib),
           "ms": timer(run, reps=reps, warmup=2),
           "library_ms": timer(lib, reps=reps, warmup=2),
           "device_ms": smoke.kernel_device_ms(run, kernel, n=min(reps, 20)),
           "library_device_ms": smoke.call_device_ms(lib, n=min(reps, 20)),
           "ops": smoke.captured_ops(run)}
    rec["ms_over_library"] = rec["ms"] / rec["library_ms"]
    rec["device_over_library"] = (rec["device_ms"]
                                  / rec["library_device_ms"])
    rec["card"] = card
    return rec


def machinery(smoke, tg, tar, gen, timer, label, card):
    """Phase 6's M = 128 ar and no-communication arms in turns: their
    medians and difference."""
    from triton_distributed_tpu_torch.layers import TPMLP

    x = smoke.randn(gen, AR_ROWS, HIDDEN)
    w_gate_up = smoke.randn(gen, HIDDEN, 2 * AR_FF, scale=HIDDEN ** -0.5)
    w_down = smoke.randn(gen, AR_FF, HIDDEN, scale=AR_FF ** -0.5)
    arms = {"ar": lambda: smoke.mlp_arm(tg, tar, TPMLP, x, w_gate_up, w_down,
                                        comm=True),
            "nocomm": lambda: smoke.mlp_arm(tg, tar, TPMLP, x, w_gate_up,
                                            w_down, comm=False)}
    if not torch.equal(arms["ar"](), 8 * arms["nocomm"]()):
        raise AssertionError(f"{label}: the ar arm != 8 x the "
                             f"no-communication arm")
    rounds = {name: [] for name in arms}
    order = list(arms)
    for rnd in range(smoke.DECOMPOSITION_ROUNDS):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            rounds[name].append(timer(arms[name], reps=10))
    t = {name: statistics.median(v) for name, v in rounds.items()}
    return {"root": label, "case": "mlp m128 arms",
            "mlp_m128_ar_loopback_ms": t["ar"],
            "mlp_m128_pallas_nocomm_ms": t["nocomm"],
            "mlp_m128_ar_machinery_ms": t["ar"] - t["nocomm"], "card": card}


def variant_rows(smoke, timer, label, card, variants, runs, kernel):
    """Each (name, set) of ``variants`` in turns, the order reversed in the
    second round: set() installs the variant, then every (case, run,
    check, reps) of ``runs`` is checked and timed (events and device)."""
    for rnd in range(2):
        for name, install in (variants if rnd == 0 else variants[::-1]):
            install()
            for case, run, check, reps in runs:
                if not check():
                    raise AssertionError(f"{label}: {case} at {name} is "
                                         f"wrong")
                print(json.dumps({
                    "root": label, "case": case, "variant": name,
                    "round": rnd, "ms": timer(run, reps=reps),
                    "device_ms": smoke.kernel_device_ms(run, kernel,
                                                        n=min(reps, 20)),
                    "card": card}), flush=True)


def pieces(smoke, tag, tar, gen, timer, label, card):
    """The ring at both shapes with each piece size of PIECES and the
    loopback with each chunk unit of CHUNKS."""
    rule, unit = tag.ring_piece, tar.LOOPBACK_CHUNK_BYTES

    def ring_piece(piece):
        def install():
            tag.ring_piece = lambda seg: piece
            tag._AG_PLANS.clear()
        return f"{piece} B pieces", install

    def loopback_chunk(chunk):
        def install():
            tar.LOOPBACK_CHUNK_BYTES = chunk
            tar._LOOPBACK_PLANS.clear()
        return f"{chunk} B chunks", install

    runs = []
    for lab, rows in AG_ROWS.items():
        x = smoke.randn(gen, WORLD, rows, HIDDEN)
        want = tag.all_gather_ref(x)
        runs.append((f"ring {lab}", lambda x=x: tag.ring_all_gather_cuda(x),
                     lambda x=x, want=want: torch.equal(
                         tag.ring_all_gather_cuda(x), want),
                     REPS if lab == "decode" else 10))
    x = smoke.randn(gen, AR_ROWS, HIDDEN)
    loop = [("loopback", lambda: tar.oneshot_ar_loopback(x, world=WORLD),
             lambda: torch.equal(tar.oneshot_ar_loopback(x, world=WORLD),
                                 x.mul(WORLD)), REPS)]
    try:
        variant_rows(smoke, timer, label, card,
                     [ring_piece(p) for p in PIECES], runs, "ring_ag_kernel")
        variant_rows(smoke, timer, label, card,
                     [loopback_chunk(c) for c in CHUNKS], loop,
                     "ar_loopback_kernel")
    finally:
        tag.ring_piece, tar.LOOPBACK_CHUNK_BYTES = rule, unit
        tag._AG_PLANS.clear()
        tar._LOOPBACK_PLANS.clear()


def breakdown(smoke, _build, tag, tar, gen, timer, root, label, card):
    """--breakdown: the worlds, then the patched copies in turns."""
    from triton_distributed_tpu_torch.kernels import _signal

    for world in (2, 3, 4, 6, 8):
        x = smoke.randn(gen, world, AG_ROWS["decode"], HIDDEN)
        run = lambda x=x: tag.ring_all_gather_cuda(x)
        if not torch.equal(run(), tag.all_gather_ref(x)):
            raise AssertionError(f"{label}: ring at world {world} is wrong")
        print(json.dumps({
            "root": label, "case": "ring decode shard", "world": world,
            "device_ms": smoke.kernel_device_ms(run, "ring_ag_kernel"),
            "card": card}), flush=True)
    x = smoke.randn(gen, AR_ROWS, HIDDEN)
    for world in (1, 2, 4, 8):
        run = lambda world=world: tar.oneshot_ar_loopback(x, world=world)
        if not torch.equal(run(), tar.oneshot_ar_loopback_ref(x,
                                                              world=world)):
            raise AssertionError(f"{label}: loopback at world {world} is "
                                 f"wrong")
        print(json.dumps({
            "root": label, "case": "loopback", "world": world,
            "device_ms": smoke.kernel_device_ms(run, "ar_loopback_kernel"),
            "card": card}), flush=True)
    libs = {}
    for i, (name, (patches, _)) in enumerate(BREAKDOWN.items()):
        csrc = Path(root) / "build" / "ag_ar_breakdown" / str(i) / "csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC, csrc)
        for f, old, new in patches:
            text = (csrc / f).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{f} holds the patch text "
                                   f"{text.count(old)} times, not once")
            (csrc / f).write_text(text.replace(old, new))
        libs[name] = build(_build, str(csrc.parent / "lib"), SOURCES, csrc)
    xd = smoke.randn(gen, WORLD, AG_ROWS["decode"], HIDDEN)
    want = tag.all_gather_ref(xd)
    cases = [("ring decode", lambda: tag.ring_all_gather_cuda(xd),
              lambda g: torch.equal(g, want), "ring_ag_kernel", "ring_ag"),
             ("loopback", lambda: tar.oneshot_ar_loopback(x, world=WORLD),
              lambda g: torch.equal(g, x.mul(WORLD)), "ar_loopback_kernel",
              "oneshot_ar_loopback")]
    dev = xd.device
    stream = torch.cuda.current_stream().cuda_stream
    names = list(BREAKDOWN)
    for rnd in range(2):
        for name in (names if rnd == 0 else names[::-1]):
            _build._LIBRARY._lib = libs[name]
            checked = BREAKDOWN[name][1]
            for case, run, check, kernel, cells in cases:
                if not check(run()) and checked:
                    raise AssertionError(f"{label}: {case} under {name} is "
                                         f"wrong")
                rec = {"root": label, "case": case, "variant": name,
                       "checked": checked, "round": rnd,
                       "device_ms": smoke.kernel_device_ms(run, kernel),
                       "ms": timer(run, reps=REPS), "card": card}
                torch.cuda.synchronize()
                # An unchecked variant may leave a flag raised: clear them.
                _signal.arrivals(dev, cells, 1, stream).zero_()
                print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding triton_distributed_tpu_torch")
    ap.add_argument("--label", default=None)
    ap.add_argument("--shared", action="store_true",
                    help="also row 14's one-shot and the M = 128 ar arm")
    ap.add_argument("--pieces", action="store_true",
                    help="the ring's piece sizes and the loopback's chunks")
    ap.add_argument("--breakdown", action="store_true",
                    help="worlds and patched copies of this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    label = args.label or os.path.basename(root)
    sys.path.insert(0, root)
    smoke = load_smoke()
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import allreduce as tar
    tag = importlib.import_module(
        "triton_distributed_tpu_torch.kernels.allgather")
    if not str(_build.CSRC).startswith(root):
        raise RuntimeError(f"imported {_build.CSRC}, not {root}'s package")
    card = smoke.card_line()
    t0 = time.perf_counter()
    sources = SOURCES + (SHARED_SOURCES if args.shared else ())
    _build._LIBRARY._lib = build(_build, os.path.join(
        root, "build", "ag_ar_before_after"), sources)
    built = time.perf_counter() - t0
    timer = smoke.Timer("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, run, lib, check, kernel, reps in cases(smoke, tag, tar, gen,
                                                      args.shared):
        if not check():
            raise AssertionError(f"{label}: {name}: the kernel's result "
                                 f"differs from its plain version")
        print(json.dumps(record(smoke, timer, name, run, lib, kernel, reps,
                                label, card)), flush=True)
    if args.shared:
        print(json.dumps(machinery(smoke, tg, tar, gen, timer, label, card)),
              flush=True)
    if args.pieces:
        pieces(smoke, tag, tar, gen, timer, label, card)
    if args.breakdown:
        breakdown(smoke, _build, tag, tar, gen, timer, root, label, card)
    print(json.dumps({"root": label, "build_s": built, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
