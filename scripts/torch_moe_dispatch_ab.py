"""Qwen3-30B-A3B prefill: the one-stage MoE dispatch against the two-stage one.

    python3 scripts/torch_moe_dispatch_ab.py     # on a machine with one H100

``MoEMLP.dist_fwd`` at world 1 packs the (token, expert) pairs straight into
the per-expert grid (``route_to_experts``) and combines from it
(``combine_from_experts``). The JAX layer goes through the expert exchange in
two stages: pairs into a per-rank send layout (``route_to_ranks``,
``scatter_to_capacity``), the exchange (the identity at world 1), then
regrouped by local expert (``tokens_by_local_expert``), and the same way
back. Both give the same slots and drops at world 1.

This script builds Qwen3-30B-A3B at full width (48 layers, bf16, random
weights from seed 0, capacity factor 16) and times the 4 x 2,048 prefill
(prefill plus argmax: the time to the first token) through each, in the
order one, two, two, one, ``--reps`` times, on the same weights and tokens.
It checks that the logits are bit-identical and that ``Engine.serve``
gives the same tokens. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from triton_distributed_tpu_torch import Engine, ModelConfig  # noqa: E402
from triton_distributed_tpu_torch.kernels import moe_utils  # noqa: E402
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP  # noqa: E402

B, L0 = 4, 2048


def two_stage_dist_fwd(self, params, x, *, return_stats=False,
                       skip_gemm=True, layer_idx=None):
    """``MoEMLP.dist_fwd`` through the JAX layer's exchange at world 1."""
    cap, ecap = self._capacities(x.shape[0])
    w, ids = self.route(params["router"], x)
    plan = moe_utils.route_to_ranks(ids, w, n_experts=self.n_experts,
                                    world=1, capacity=cap)
    send, send_ids = moe_utils.scatter_to_capacity(x, plan, world=1,
                                                   capacity=cap)
    grouped, counts, src_idx, n_drop_e = moe_utils.tokens_by_local_expert(
        send, send_ids[:, :, 0], plan.counts, n_local_experts=self.n_experts,
        expert_base=0, expert_capacity=ecap)
    out = self._expert_ffn(grouped, params["w_gate_up"], params["w_down"],
                           counts=counts if skip_gemm else None,
                           layer_idx=layer_idx)
    back = moe_utils.scatter_back_from_experts(out, src_idx, world=1,
                                               capacity=cap)
    y = moe_utils.gather_from_capacity(back, plan,
                                       n_tokens=x.shape[0]).to(x.dtype)
    if return_stats:
        return y, {"n_dropped_dispatch": plan.n_dropped,
                   "n_dropped_expert": n_drop_e}
    return y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gen", type=int, default=8,
                    help="new tokens of the serve comparison")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_moe_dispatch_ab: no CUDA device is visible",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(ModelConfig.from_name("qwen3-30b-a3b"),
                              moe_capacity_factor=16.0)
    eng = Engine(cfg, mode="dist", device="cuda", seed=0,
                 max_length=L0 + args.gen)
    ids = torch.randint(0, cfg.vocab_size, (B, L0), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7), dtype=torch.int32)
    one_stage = MoEMLP.dist_fwd
    paths = {"one-stage": one_stage, "two-stage": two_stage_dist_fwd}

    def ttft():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng.prefill(ids, eng.new_cache(B))
        torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, logits

    times = {name: [] for name in paths}
    logits, tokens = {}, {}
    try:
        for name, fwd in paths.items():      # warm-up and the outputs
            MoEMLP.dist_fwd = fwd
            _, logits[name] = ttft()
            tokens[name] = eng.serve(ids, args.gen)
        for _ in range(args.reps):
            for name in ("one-stage", "two-stage", "two-stage", "one-stage"):
                MoEMLP.dist_fwd = paths[name]
                times[name].append(ttft()[0])
    finally:
        MoEMLP.dist_fwd = one_stage
    for name, ts in times.items():
        print(f"{name}: TTFT median {statistics.median(ts):.2f} ms, min "
              f"{min(ts):.2f} ms over {len(ts)} prefills of {B}x{L0} "
              f"({', '.join(f'{t:.2f}' for t in ts)})")
    same_logits = torch.equal(logits["one-stage"], logits["two-stage"])
    same_tokens = torch.equal(tokens["one-stage"], tokens["two-stage"])
    print(f"logits bit-identical: {same_logits}; serve tokens ({B}x"
          f"{args.gen}) identical: {same_tokens}")
    return 0 if same_logits and same_tokens else 1


if __name__ == "__main__":
    sys.exit(main())
