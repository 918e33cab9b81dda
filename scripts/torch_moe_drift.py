"""Where Qwen3-30B-A3B's prefill logits leave the xla golden.

    python3 scripts/torch_moe_drift.py          # on a machine with one H100

Builds Qwen3-30B-A3B at full width (48 layers, bf16, random weights from
seed 0, the dropless capacity factor 16) and runs the dist prefill of 4 x
2,048 tokens with the attention swapped, one variant at a time, for:

  kernels      the shipped path (the flash-prefill kernel: P rounded to
               bf16 before the P V product);
  golden       the golden's own dense attention (f32 scores and P,
               ``nn.dense_attn_with_cache``);
  bf16 P       dense attention with P rounded to bf16 (the kernel's
               rounding, the golden's sums: ``chip_smoke.py``'s witness);
  float64      dense attention with sums in float64 and P rounded to f32
               (differs from the golden only at f32 rounding level).

For each it prints the logits' min cosine and max |diff| (in % of max
|logit|) against the xla golden, and how many of the 8,192 tokens pick
another top-8 expert set at layer 24 than the golden does. The matmul and
grouped-GEMM kernels stay in every variant. Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import dense_attention  # noqa: E402
from triton_distributed_tpu_torch import Engine, ModelConfig  # noqa: E402
from triton_distributed_tpu_torch.layers import nn  # noqa: E402
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP  # noqa: E402

B, L0, LAYER = 4, 2048, 24


def moe_input(eng, ids):
    """The hidden states entering layer LAYER's MoE block in one prefill."""
    method = "dist_fwd" if eng.mode == "dist" else "xla_fwd"
    real, seen, calls = getattr(MoEMLP, method), {}, [0]

    def spy(self, params, x, **kw):
        if calls[0] == LAYER:
            seen["x"] = x.clone()
        calls[0] += 1
        return real(self, params, x, **kw)

    setattr(MoEMLP, method, spy)
    try:
        logits, _ = eng.prefill(ids, eng.new_cache(B))
    finally:
        setattr(MoEMLP, method, real)
    return logits, seen["x"]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_moe_drift: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(ModelConfig.from_name("qwen3-30b-a3b"),
                              moe_capacity_factor=16.0)
    eng = Engine(cfg, mode="dist", device="cuda", seed=0,
                 max_length=L0 + 32)
    xla = Engine(cfg, mode="xla", device="cuda", params=eng.params,
                 max_length=L0 + 32)
    ids = torch.randint(0, cfg.vocab_size, (B, L0), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7), dtype=torch.int32)
    want, x_want = moe_input(xla, ids)
    router = eng.params["layers"]["mlp"]["router"][LAYER]
    want_sets = eng.model.mlp.route(router, x_want)[1].sort(-1).values
    shipped = nn.flash_prefill
    variants = {
        "kernels": shipped,
        "golden": lambda q, k, v, *, offset, scale, seq_lens=None, **_:
            nn.dense_attn_with_cache(q, k, v, offset, scale=scale,
                                     seq_lens=seq_lens),
        "bf16 P": dense_attention,
        "float64": lambda q, k, v, **kw: dense_attention(
            q, k, v, p_dtype=torch.float32, acc=torch.float64, **kw),
    }
    for name, attn in variants.items():
        nn.flash_prefill = attn
        try:
            got, x_got = moe_input(eng, ids)
        finally:
            nn.flash_prefill = shipped
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min()
        diff = (got - want).abs().max() / want.abs().max()
        sets = eng.model.mlp.route(router, x_got)[1].sort(-1).values
        flips = int((sets != want_sets).any(-1).sum())
        print(f"{name}: min cosine {cos.item():.6f}, max |diff| "
              f"{100 * diff.item():.3f}% of max |logit|; top-8 sets differing "
              f"at layer {LAYER}: {flips} of {B * L0}", flush=True)
        del got, x_got
    return 0


if __name__ == "__main__":
    sys.exit(main())
