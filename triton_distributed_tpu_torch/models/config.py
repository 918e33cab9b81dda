"""Model configuration.

Counterpart of ``triton_distributed_tpu/models/config.py``: the same
``ModelConfig`` fields and the same presets (public HF ``config.json``
values), with torch dtypes. Kept as a copy so the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_name: str = "Qwen/Qwen3-32B"
    vocab_size: int = 151_936
    d_model: int = 5120
    n_layers: int = 64
    n_heads: int = 64
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 25_600
    rope_theta: float = 1e6
    # Llama-3.1/3.2 "llama3" RoPE scaling: (factor, low_freq_factor,
    # high_freq_factor, original_max_position); None = plain RoPE.
    rope_scaling: tuple | None = None
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    qk_norm: bool = True
    max_length: int = 4096
    dtype: torch.dtype = torch.bfloat16
    # Mixture-of-Experts (Qwen3-MoE family): n_experts == 0 means dense.
    n_experts: int = 0
    n_experts_per_tok: int = 8
    moe_d_ff: int | None = None
    norm_topk_prob: bool = True
    moe_capacity_factor: float = 2.0

    @classmethod
    def from_name(cls, name: str, **overrides) -> "ModelConfig":
        key = name.lower().removeprefix("qwen/").removeprefix("meta-llama/")
        if key not in _PRESETS:
            raise ValueError(
                f"unknown model {name!r}; known: {sorted(_PRESETS)}")
        return cls(model_name=name, **{**_PRESETS[key], **overrides})


# Public Qwen3 / Llama-3 architecture hyper-parameters (HF config.json).
_PRESETS: dict[str, dict] = {
    "qwen3-0.6b": dict(d_model=1024, n_layers=28, n_heads=16, n_kv_heads=8,
                       head_dim=128, d_ff=3072, tie_embeddings=True),
    "qwen3-1.7b": dict(d_model=2048, n_layers=28, n_heads=16, n_kv_heads=8,
                       head_dim=128, d_ff=6144, tie_embeddings=True),
    "qwen3-4b": dict(d_model=2560, n_layers=36, n_heads=32, n_kv_heads=8,
                     head_dim=128, d_ff=9728, tie_embeddings=True),
    "qwen3-8b": dict(d_model=4096, n_layers=36, n_heads=32, n_kv_heads=8,
                     head_dim=128, d_ff=12_288),
    "qwen3-14b": dict(d_model=5120, n_layers=40, n_heads=40, n_kv_heads=8,
                      head_dim=128, d_ff=17_408),
    "qwen3-32b": dict(d_model=5120, n_layers=64, n_heads=64, n_kv_heads=8,
                      head_dim=128, d_ff=25_600),
    "meta-llama-3-8b": dict(vocab_size=128_256, d_model=4096, n_layers=32,
                            n_heads=32, n_kv_heads=8, head_dim=128,
                            d_ff=14_336, rope_theta=5e5, qk_norm=False,
                            max_length=8192),
    "meta-llama-3-70b": dict(vocab_size=128_256, d_model=8192, n_layers=80,
                             n_heads=64, n_kv_heads=8, head_dim=128,
                             d_ff=28_672, rope_theta=5e5, qk_norm=False,
                             max_length=8192),
    "llama-3.1-8b": dict(vocab_size=128_256, d_model=4096, n_layers=32,
                         n_heads=32, n_kv_heads=8, head_dim=128,
                         d_ff=14_336, rope_theta=5e5, qk_norm=False,
                         rope_scaling=(8.0, 1.0, 4.0, 8192),
                         max_length=16_384),
    "llama-3.2-1b": dict(vocab_size=128_256, d_model=2048, n_layers=16,
                         n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192,
                         rope_theta=5e5, qk_norm=False,
                         rope_scaling=(32.0, 1.0, 4.0, 8192),
                         tie_embeddings=True, max_length=16_384),
    "qwen3-30b-a3b": dict(d_model=2048, n_layers=48, n_heads=32,
                          n_kv_heads=4, head_dim=128, d_ff=6144,
                          n_experts=128, n_experts_per_tok=8,
                          moe_d_ff=768),
    "qwen3-235b-a22b": dict(d_model=4096, n_layers=94, n_heads=64,
                            n_kv_heads=4, head_dim=128, d_ff=12_288,
                            n_experts=128, n_experts_per_tok=8,
                            moe_d_ff=1536),
    "qwen3-30b-a3b-d6": dict(d_model=2048, n_layers=6, n_heads=32,
                             n_kv_heads=4, head_dim=128, d_ff=6144,
                             n_experts=128, n_experts_per_tok=8,
                             moe_d_ff=768),
    # Tiny configs for tests (not real checkpoints).
    "tiny": dict(vocab_size=128, d_model=64, n_layers=2, n_heads=8,
                 n_kv_heads=8, head_dim=8, d_ff=128, rope_theta=1e4,
                 max_length=32, dtype=torch.float32),
    "tiny-moe": dict(vocab_size=128, d_model=64, n_layers=2, n_heads=8,
                     n_kv_heads=8, head_dim=8, d_ff=128, rope_theta=1e4,
                     max_length=32, dtype=torch.float32, n_experts=8,
                     n_experts_per_tok=2, moe_d_ff=32),
}
