"""Inference engine: prefill, then sample, then decode token by token.

Counterpart of ``triton_distributed_tpu/models/engine.py`` (``Engine``), for
dense and MoE Qwen3 configs. Modes:

  ``dist`` - the kernel path: every prefill projection (M >= 64) through
             ``csrc/matmul.cu``, prefill attention through
             ``csrc/flash_prefill.cu``, each decode step's attention through
             ``csrc/flash_decode.cu``, an MoE FFN's expert GEMMs through
             ``csrc/grouped_gemm.cu`` (above world 1 between the two
             halves of ``csrc/ep_a2a.cu``'s exchange).
  ``ar``   - the all-reduce mode (dense only): ``torch.matmul``
             projections, the flash and paged attention kernels, and the
             one-shot all-reduce of each block's partial, the identity at
             world 1 (``kernels/allreduce.py``).
  ``xla``  - the golden the JAX package also keeps: ``torch.matmul``
             products and dense attention with f32 probabilities. An
             explicit mode, never a fallback.

``world`` > 1 serves with that many tensor-parallel ranks simulated on one
card (the JAX engine's ``mesh``): ``dist`` through the multi-rank AG-GEMM
and GEMM-RS kernels and, for an MoE config, the expert-parallel exchange
(``csrc/ep_a2a.cu``, dispatch and combine) around the grouped GEMM; ``ar``
(dense only) through the multi-rank one-shot all-reduce
(``models/qwen.py``). ``make_paged_step`` (and so ``BatchEngine``) stays at
world 1 for now.

PyTorch runs eagerly, so there is no step to compile; the KV cache is
written in place where the JAX engine donates its buffers to a jitted step.
``make_paged_step`` builds the two fixed-shape serving steps that
``serving.BatchEngine`` calls (the JAX ``Engine._make_sm(paged=...)``).
Not ported yet (see ROADMAP.md): ``serve_scanned`` (a CUDA graph of the
decode loop), ``aot_cache`` and ``hf_path``.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.kv_cache import KVCache
from triton_distributed_tpu_torch.models.qwen import (
    MODES,
    Qwen3,
    check_ar,
    check_world,
)
from triton_distributed_tpu_torch.models.sampling import sample_token
from triton_distributed_tpu_torch.runtime.device import resolve_device


class Engine:
    def __init__(self, config: ModelConfig, *, mode: str = "dist",
                 device=None, params=None, seed: int = 0,
                 max_length: int | None = None, temperature: float = 0.0,
                 top_p: float = 1.0, world: int = 1):
        """``device`` defaults to the card (no card raises); pass "cpu" for
        the plain versions of the kernels. ``params`` is a dict in the JAX
        layout (``Qwen3.init`` or ``params_from_jax``, with the same
        ``world``), moved to ``device``; without it the weights are random
        from ``seed``. ``world`` simulated tensor-parallel ranks (an MoE config's
        experts split over them: ``n_experts`` divisible by ``world``)."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
        check_ar(config, mode)
        check_world(config, world)
        self.config = config
        self.device = resolve_device(device)
        self.mode = mode
        self.world = world
        self.model = Qwen3(config, world=world)
        self.temperature = temperature
        self.top_p = top_p
        self.max_length = max_length or config.max_length
        if params is None:
            self.params = self.model.init(seed, self.device)
        else:
            self.params = _to_device(params, self.device)

    @torch.inference_mode()
    def moe_drop_stats(self, input_ids) -> dict:
        """Capacity audit of an MoE config (the JAX ``Engine.moe_drop_stats``
        :205): one dist-mode forward over ``input_ids`` (B, L) on a fresh
        cache, returning ``{"n_dropped_dispatch": int, "n_dropped_expert":
        int}``, the (token, expert) pairs the static capacities dropped,
        summed over layers and ranks. A deployment should see zeros;
        otherwise raise ``moe_capacity_factor``."""
        if not self.config.n_experts:
            raise ValueError("moe_drop_stats is only meaningful for MoE "
                             "configs (n_experts > 0)")
        ids = torch.as_tensor(input_ids, device=self.device).to(torch.int32)
        kv = self.new_cache(ids.shape[0])
        _, stats = self.model.forward(self.params, ids, kv.k, kv.v,
                                      kv.offset, mode="dist",
                                      return_moe_stats=True)
        return {k: int(v) for k, v in stats.items()}

    def new_cache(self, batch_size: int) -> KVCache:
        return KVCache.create(self.config, batch_size, device=self.device,
                              max_length=self.max_length, world=self.world)

    def _step(self, ids: torch.Tensor, kv: KVCache):
        logits = self.model.forward(self.params, ids, kv.k, kv.v, kv.offset,
                                    mode=self.mode)
        kv.offset += ids.shape[1]
        return logits, kv

    def make_paged_step(self, paged: str, *, paged_attn: str = "fused",
                        kv_quant: bool = False):
        """One serving step over the block-paged pool, the counterpart of
        the JAX ``Engine._make_sm(paged=..., paged_attn=...,
        kv_quant=...)`` (:72-171).

        ``paged="decode"``: ``step(ids, pool, offsets, block_tables,
        slot_mask)`` with ids (n_slots, 1). ``paged="prefill"`` (the mixed
        step): ``step(ids, pool, offsets, block_tables, slot_mask,
        seq_lens)`` with ids (n_slots, prefill_chunk) and ``seq_lens``
        (n_slots,) the live tokens of each row. ``pool`` is a
        ``serving.kv_pool.PagedKVState`` (or anything with ``k``, ``v``,
        ``k_scale``, ``v_scale``), written in place. Returns the logits
        (n_slots, vocab) f32 at each row's last live token. Every operand is
        data: slot churn changes values, never a shape."""
        if paged not in ("decode", "prefill"):
            raise ValueError(f"unknown paged variant {paged!r}")
        if self.world > 1:
            raise NotImplementedError(
                "the block-paged serving step at world > 1 (BatchEngine over "
                "simulated ranks) is not ported yet: see ROADMAP.md")
        model, mode = self.model, self.mode

        @torch.inference_mode()
        def step(ids, pool, offsets, block_tables, slot_mask, seq_lens=None):
            if (paged == "prefill") != (seq_lens is not None):
                raise ValueError("the mixed (prefill) step takes seq_lens; "
                                 "the decode step does not")
            if kv_quant != (pool.k_scale is not None):
                raise ValueError(f"step built with kv_quant={kv_quant} got a "
                                 f"pool {'without' if kv_quant else 'with'} "
                                 f"scale arenas")
            scales = (pool.k_scale, pool.v_scale) if kv_quant else None
            return model.forward(self.params, ids, pool.k, pool.v, offsets,
                                 mode=mode, seq_lens=seq_lens,
                                 block_tables=block_tables,
                                 slot_mask=slot_mask, paged_attn=paged_attn,
                                 kv_scales=scales)

        return step

    @torch.inference_mode()
    def prefill(self, input_ids, kv: KVCache):
        """input_ids: (B, L) -> (logits (B, V) f32, kv); kv is written in
        place and its offset advances by L."""
        ids = torch.as_tensor(input_ids, device=self.device)
        return self._step(ids, kv)

    @torch.inference_mode()
    def decode_step(self, token, kv: KVCache):
        """token: (B,) -> (logits (B, V) f32, kv)."""
        tok = torch.as_tensor(token, device=self.device)
        return self._step(tok[:, None], kv)

    @torch.inference_mode()
    def serve(self, input_ids, gen_len: int,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Generate ``gen_len`` tokens after the prompt: (B, L0) ->
        (B, gen_len) int32. Sampling with ``temperature > 0`` draws from
        ``generator`` (default: one seeded 0 on the engine's device)."""
        ids = torch.as_tensor(input_ids, device=self.device).to(torch.int32)
        B, L0 = ids.shape
        if gen_len <= 0:
            return torch.zeros((B, 0), dtype=torch.int32, device=self.device)
        if L0 + gen_len > self.max_length:
            raise ValueError(
                f"prompt ({L0}) + gen_len ({gen_len}) exceeds the KV cache "
                f"max_length ({self.max_length})")
        if generator is None and self.temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        kv = self.new_cache(B)
        logits, kv = self.prefill(ids, kv)
        tok = sample_token(logits, generator, temperature=self.temperature,
                           top_p=self.top_p)
        out = [tok]
        for _ in range(gen_len - 1):
            logits, kv = self.decode_step(tok, kv)
            tok = sample_token(logits, generator,
                               temperature=self.temperature, top_p=self.top_p)
            out.append(tok)
        return torch.stack(out, dim=1)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
