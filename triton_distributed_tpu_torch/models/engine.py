"""Inference engine: prefill, then sample, then decode token by token.

Counterpart of ``triton_distributed_tpu/models/engine.py`` (``Engine``).
Modes:

  ``dist`` - the kernel path: every prefill projection (M >= 64) through
             ``csrc/matmul.cu``, prefill attention through
             ``csrc/flash_prefill.cu``, each decode step's attention through
             ``csrc/flash_decode.cu``.
  ``xla``  - the golden the JAX package also keeps: ``torch.matmul``
             products and dense attention with f32 probabilities. An
             explicit mode, never a fallback.

PyTorch runs eagerly, so there is no step to compile; the KV cache is
written in place where the JAX engine donates its buffers to a jitted step.
Not ported yet (see ROADMAP.md): ``mode="ar"``, ``serve_scanned`` (a CUDA
graph of the decode loop), ``aot_cache`` and ``hf_path``.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.kv_cache import KVCache
from triton_distributed_tpu_torch.models.qwen import Qwen3
from triton_distributed_tpu_torch.models.sampling import sample_token
from triton_distributed_tpu_torch.runtime.device import resolve_device

MODES = ("dist", "xla")


class Engine:
    def __init__(self, config: ModelConfig, *, mode: str = "dist",
                 device=None, params=None, seed: int = 0,
                 max_length: int | None = None, temperature: float = 0.0,
                 top_p: float = 1.0):
        """``device`` defaults to the card (no card raises); pass "cpu" for
        the plain versions of the kernels. ``params`` is a dict in the JAX
        layout (``Qwen3.init`` or ``params_from_jax``), moved to ``device``;
        without it the weights are random from ``seed``."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; ported modes: {MODES} "
                             f"('ar' waits for the allreduce kernel)")
        self.config = config
        self.device = resolve_device(device)
        self.mode = mode
        self.model = Qwen3(config)
        self.temperature = temperature
        self.top_p = top_p
        self.max_length = max_length or config.max_length
        if params is None:
            self.params = self.model.init(seed, self.device)
        else:
            self.params = _to_device(params, self.device)

    def new_cache(self, batch_size: int) -> KVCache:
        return KVCache.create(self.config, batch_size, device=self.device,
                              max_length=self.max_length)

    def _step(self, ids: torch.Tensor, kv: KVCache):
        logits = self.model.forward(self.params, ids, kv.k, kv.v, kv.offset,
                                    mode=self.mode)
        kv.offset += ids.shape[1]
        return logits, kv

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
