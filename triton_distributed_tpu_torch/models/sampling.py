"""Token sampling.

Counterpart of ``triton_distributed_tpu/models/sampling.py``: greedy,
temperature and nucleus (top-p) sampling. Randomness comes from an explicit
``torch.Generator`` where the JAX package threads a PRNG key; the two give
different draws from the same seed, so only the greedy path and the top-p
kept set are comparable across the frameworks.
"""

from __future__ import annotations

import torch


def finite_logits_mask(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) -> (B,) bool, True where every logit is finite."""
    return torch.isfinite(logits).all(dim=-1)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Set to -inf every logit outside the nucleus: tokens are kept in
    descending order until the cumulative probability reaches ``top_p``
    (always at least one), and ties with the cutoff logit stay in."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(logits >= cutoff, logits,
                       torch.full_like(logits, float("-inf")))


def sample_token(logits: torch.Tensor, generator: torch.Generator | None = None,
                 *, temperature: float = 0.0, top_p: float = 1.0
                 ) -> torch.Tensor:
    """logits: (B, V) fp32 -> (B,) int32 token ids.

    Greedy when ``temperature == 0`` or no generator is given (as the JAX
    version is greedy without a key)."""
    if temperature == 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
