"""Gated MLP (SwiGLU) at world 1.

Counterpart of ``triton_distributed_tpu/layers/tp_mlp.py`` (``TPMLP``):

  ``dist_fwd`` - AG-GEMM(x, w_gate_up) -> SwiGLU -> GEMM-RS(h, w_down); at
                 world 1 both products are the single-card matmul, so every
                 prefill projection (M >= 64) runs ``csrc/matmul.cu``.
  ``ar_fwd``   - the all-reduce mode: ``torch.matmul`` products (the JAX
                 ``@`` there is plain XLA, :128-133), then the one-shot
                 all-reduce of the partial, the identity at world 1.
  ``xla_fwd``  - the golden: plain ``torch.matmul`` products.

The fused ``w_gate_up`` keeps the JAX layout: (d_model, 2 * d_ff) with
[gate | up] inside each rank's shard, which at world 1 is the plain
concatenation.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from triton_distributed_tpu_torch.kernels.allgather_gemm import ag_gemm_device
from triton_distributed_tpu_torch.kernels.allreduce import oneshot_all_reduce
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    gemm_rs_device,
)


@dataclasses.dataclass(frozen=True)
class TPMLP:
    d_model: int
    d_ff: int

    @staticmethod
    def interleave_gate_up(w_gate: torch.Tensor, w_up: torch.Tensor):
        """Pack (..., d, d_ff) gate and up matrices into the fused
        (..., d, 2*d_ff) [gate | up] layout."""
        return torch.cat([w_gate, w_up], dim=-1)

    @staticmethod
    def _glu(h: torch.Tensor) -> torch.Tensor:
        """SiLU(gate) * up in f32, cast back to h's dtype."""
        ff_local = h.shape[-1] // 2
        gate, up = h[:, :ff_local], h[:, ff_local:]
        return (F.silu(gate.float()) * up.float()).to(h.dtype)

    def dist_fwd(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: (m, d_model) -> (m, d_model) through the matmul kernel."""
        h = ag_gemm_device(x, params["w_gate_up"])
        return gemm_rs_device(self._glu(h), params["w_down"])

    def ar_fwd(self, params, x_full: torch.Tensor) -> torch.Tensor:
        """x_full: (M, d_model) replicated -> (M, d_model) replicated:
        local products, then the one-shot all-reduce of the partial."""
        h = self._glu(torch.matmul(x_full, params["w_gate_up"]))
        partial = torch.matmul(h, params["w_down"])
        return oneshot_all_reduce(partial)

    def xla_fwd(self, params, x: torch.Tensor) -> torch.Tensor:
        """Golden: the same math with ``torch.matmul``."""
        h = self._glu(torch.matmul(x, params["w_gate_up"]))
        return torch.matmul(h, params["w_down"])
