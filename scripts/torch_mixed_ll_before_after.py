"""The paged-attention mixed step and the LL allgather of one checkout,
timed at the shapes chip_smoke.py phases 1, 4 and 10 give them, with the
serving path over int8/fp8 pools beside them, so that two commits can be
compared on one card.

    python3 scripts/torch_mixed_ll_before_after.py               # this one
    python3 scripts/torch_mixed_ll_before_after.py --root DIR    # another

DIR holds a ``triton_distributed_tpu_torch`` package (for example an
earlier commit unpacked with ``git archive``). The script builds that
package's kernels with its own ``kernels/_build.py`` (into ``DIR/build/``)
and calls them through that package's wrappers:

- ``mixed <pool>``: ``paged_attention(**case)`` at phase 1's "mixed" case
  (Qwen3-1.7B geometry: 8 slots, 16 / 8 heads, head_dim 128, tables of 256
  blocks of 16, a 512-row chunk with ragged q_lens, slot 6 dead, NaN in
  every unreached block), for the bf16, int8 and fp8 pools;
- ``ll``: ``ll_all_gather_cuda`` at phase 10's SP decode partial exchange,
  world 8 x (256, 256) f32, the epoch a 0-d tensor on the card.

For each it prints one JSON object: ``ms``, CUDA events around each call
after an L2 flush (``chip_smoke.Timer``, the mean); ``device_ms``, the
kernel's device time alone (``chip_smoke.kernel_device_ms``); the library
call that computes the same function (SDPA over the gathered, dequantized
view; the allgather's copy) with the same two figures, and
``ms_over_library``. The LL line adds ``b2b_ms`` (host clock over 200
back-to-back calls, ``chip_smoke.b2b_ms``) beside the library's and
``device_ops_of_10_calls``, the device operations ten calls make
(``chip_smoke.device_ops``: the profiler may drop some).
Each result is checked first: the mixed step per live slot against
``paged_attention_ref`` (``chip_smoke.check_paged``: 2e-2 of the slot's
max, finite, padding rows zero), the LL allgather bit for bit against
``ll_all_gather_ref`` over five epochs.

Then (unless ``--no-serve``) Qwen3-1.7B at full width with random weights
from seed 0 serves phase 3b's 16 requests through ``BatchEngine`` over an
int8 and an fp8 pool; one line per pool gives the mean mixed-step ms, the
prompt tokens/s over mixed-step time and the generated tokens/s over all
steps (host clock around each step, which ends in a synchronize). These
are informational.

Inputs come from seed 0, the same for every checkout; every line carries
the card's name and power limit. To compare commits A and B, run A, B, B,
A on one card, one after another. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOLS = (None, "int8", "fp8")


def load_smoke():
    """This checkout's chip_smoke.py, for its cases and timers (it imports
    only torch at its top; what it imports later comes from --root)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mixed_rows(smoke, label, card):
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import paged_attention as tpa
    from triton_distributed_tpu_torch.kernels.sp_attention import (
        paged_gather_kv)
    from triton_distributed_tpu_torch.layers.nn import quantize_kv_rows

    timer = smoke.Timer("cuda")
    geo = smoke.PAGED_CASES["mixed"]
    for kv in POOLS:
        gen = torch.Generator(device="cuda").manual_seed(0)
        c = smoke.paged_case(gen, quantize_kv_rows, kv=kv, **geo)
        _, worst = smoke.check_paged(f"{label} mixed {kv}", tpa, c, "mixed",
                                     geo)
        tables = torch.where(c["slot_mask"][:, None], c["block_tables"], 0)
        views = []
        for pool, sc in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
            x = paged_gather_kv(c[pool], tables)
            if sc in c:
                x = x.float() * paged_gather_kv(c[sc], tables)[..., None]
            views.append(torch.nan_to_num(x.bfloat16()).transpose(1, 2)
                         .contiguous())
        L = c["q"].shape[1]
        S = views[0].shape[2]
        j = torch.arange(L, device="cuda")
        qpos = (c["kv_lens"] - c["q_lens"])[:, None] + j
        mask = ((torch.arange(S, device="cuda")[None, None] <= qpos[..., None])
                & (j[None, :, None] < c["q_lens"][:, None, None]))[:, None]
        qt = c["q"].transpose(1, 2).contiguous()
        run = lambda: tpa.paged_attention(**c)
        lib = lambda: F.scaled_dot_product_attention(
            qt, views[0], views[1], attn_mask=mask, enable_gqa=True)
        rec = {"root": label, "case": f"mixed {kv or 'bf16'}",
               "ms": timer(run, reps=20), "library_ms": timer(lib, reps=20),
               "device_ms": smoke.kernel_device_ms(run, "flash_prefill"),
               "library_device_ms": smoke.call_device_ms(lib),
               "worst_slot_err": worst}
        rec["ms_over_library"] = rec["ms"] / rec["library_ms"]
        rec["device_over_library"] = (rec["device_ms"]
                                      / rec["library_device_ms"])
        rec["card"] = card
        print(json.dumps(rec), flush=True)


def ll_row(smoke, label, card):
    from triton_distributed_tpu_torch.kernels import ll_allgather as tll
    from triton_distributed_tpu_torch.kernels.sp_attention import (
        decode_partial_feat)

    w, rows = smoke.SP_WORLD, smoke.SP_B * smoke.SP_HQ
    feat = decode_partial_feat(smoke.SP_DH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    staging = torch.zeros((w, 2, w - 1, rows, feat), device="cuda")
    mirror = staging.clone()
    for epoch in range(5):
        x = smoke.randn(gen, w, rows, feat, dtype=torch.float32)
        got, _ = tll.ll_all_gather_cuda(x, staging, epoch)
        want, mirror = tll.ll_all_gather_ref(x, mirror, epoch)
        if not (torch.equal(got, want) and torch.equal(staging, mirror)):
            raise AssertionError(f"{label}: ll epoch {epoch}: not the plain "
                                 f"version's bits")
    timer = smoke.Timer("cuda")
    epoch = torch.zeros((), dtype=torch.int32, device="cuda")
    run = lambda: tll.ll_all_gather_cuda(x, staging, epoch)
    lib = lambda: x.reshape(1, -1, feat).expand(w, -1, -1).contiguous()
    ops = smoke.device_ops(run)
    rec = {"root": label, "case": "ll", "ms": timer(run, reps=20),
           "library_ms": timer(lib, reps=20),
           "device_ms": smoke.kernel_device_ms(run, "ll_allgather_kernel"),
           "library_device_ms": smoke.call_device_ms(lib),
           "b2b_ms": smoke.b2b_ms(run), "library_b2b_ms": smoke.b2b_ms(lib),
           "device_ops_of_10_calls": len(ops),
           "every_op_the_kernel": all("ll_allgather_kernel" in op
                                      for op in ops)}
    rec["ms_over_library"] = rec["ms"] / rec["library_ms"]
    rec["card"] = card
    print(json.dumps(rec), flush=True)


def serve_rows(smoke, label, card):
    from triton_distributed_tpu_torch import BatchEngine, Engine, ModelConfig

    cfg = ModelConfig.from_name("qwen3-1.7b")
    eng = Engine(cfg, mode="dist", device="cuda", seed=0)
    prompts = smoke.serving_prompts(cfg.vocab_size)
    for kv in ("int8", "fp8"):
        be = BatchEngine(eng, kv_dtype=kv, **smoke.SERVE)
        for p in prompts:
            be.submit(p, smoke.SERVE_GEN)
        times = {"decode": [], "mixed": []}
        torch.cuda.synchronize()
        while True:
            dec0 = be.metrics["decode_steps"]
            t0 = time.perf_counter()
            if not be.step():
                break
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            times["decode" if be.metrics["decode_steps"] > dec0
                  else "mixed"].append(dt)
        m = be.metrics
        mixed = sum(times["mixed"])
        print(json.dumps({
            "root": label, "case": f"serve {kv}",
            "mixed_steps": len(times["mixed"]),
            "mean_mixed_step_ms": 1e3 * mixed / max(len(times["mixed"]), 1),
            "prompt_tokens_per_s": m["prefill_tokens"] / max(mixed, 1e-9),
            "generated_tokens_per_s": m["tokens_generated"] / max(
                mixed + sum(times["decode"]), 1e-9),
            "card": card}), flush=True)
        del be
        smoke.free_card()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="directory holding triton_distributed_tpu_torch")
    ap.add_argument("--label", default=None)
    ap.add_argument("--no-serve", action="store_true",
                    help="time the two kernels only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    label = args.label or os.path.basename(root)
    sys.path.insert(0, root)
    smoke = load_smoke()
    from triton_distributed_tpu_torch.kernels import _build
    if not str(_build.CSRC).startswith(root):
        raise RuntimeError(f"imported {_build.CSRC}, not {root}'s package")
    card = smoke.card_line()
    t0 = time.perf_counter()
    _build.lib()
    print(json.dumps({"root": label, "build_s": time.perf_counter() - t0,
                      "card": card}), flush=True)
    mixed_rows(smoke, label, card)
    ll_row(smoke, label, card)
    if not args.no_serve:
        serve_rows(smoke, label, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
