"""Tensor-parallel gated MLP (SwiGLU).

Counterpart of ``triton_distributed_tpu/layers/tp_mlp.py`` (``TPMLP``):

  ``dist_fwd`` - AG-GEMM(x, w_gate_up) -> SwiGLU -> GEMM-RS(h, w_down); at
                 world 1 both products are the single-card matmul, so every
                 prefill projection (M >= 64) runs ``csrc/matmul.cu``.
  ``ar_fwd``   - the all-reduce mode: ``torch.matmul`` products (the JAX
                 ``@`` there is plain XLA, :128-133), then the one-shot
                 all-reduce of the partial, the identity at world 1.
  ``xla_fwd``  - the golden: plain ``torch.matmul`` products.

The fused ``w_gate_up`` keeps the JAX layout: (d_model, 2 * d_ff) with
[gate | up] inside each rank's shard (``interleave_gate_up``), which at
world 1 is the plain concatenation.

At ``world`` > 1 the ranks are simulated on one card (``runtime/mesh.py``):
``w_gate_up`` is held as its rank stack (world, d_model, 2 ff_l) and
``w_down`` as (world, ff_l, d_model). ``dist_fwd`` takes the M-sharded rows
(M, d), rank r's rows ``[r M / world, (r + 1) M / world)``, and returns
them so (JAX :116); ``ar_fwd`` and ``xla_fwd`` take and return the
replicated (M, d), held once.
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
    world: int = 1

    @staticmethod
    def interleave_gate_up(w_gate: torch.Tensor, w_up: torch.Tensor,
                           world: int = 1):
        """Pack (..., d, d_ff) gate and up matrices into the fused
        (..., d, 2*d_ff) layout whose ``world`` column shards are each
        [gate_r | up_r] (JAX :64)."""
        g = w_gate.reshape(*w_gate.shape[:-1], world, -1)
        u = w_up.reshape(*w_up.shape[:-1], world, -1)
        out = torch.cat([g, u], dim=-1)
        return out.reshape(*out.shape[:-2], -1)

    @staticmethod
    def deinterleave_gate_up(w_gate_up: torch.Tensor, world: int = 1):
        """Inverse of ``interleave_gate_up`` -> (w_gate, w_up) (JAX :75)."""
        w = w_gate_up.reshape(*w_gate_up.shape[:-1], world, 2, -1)
        lead = w_gate_up.shape[:-1]
        return (w[..., 0, :].reshape(*lead, -1),
                w[..., 1, :].reshape(*lead, -1))

    @staticmethod
    def _glu(h: torch.Tensor) -> torch.Tensor:
        """SiLU(gate) * up in f32, cast back to h's dtype."""
        ff_local = h.shape[-1] // 2
        gate, up = h[..., :ff_local], h[..., ff_local:]
        return (F.silu(gate.float()) * up.float()).to(h.dtype)

    def _partials(self, params, x_full: torch.Tensor) -> torch.Tensor:
        """``torch.matmul`` products of the replicated x: (M, d) at world 1,
        every rank's partial (world, M, d) above."""
        h = self._glu(torch.matmul(x_full, params["w_gate_up"]))
        return torch.matmul(h, params["w_down"])

    def dist_fwd(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: (m, d_model) -> (m, d_model): AG-GEMM -> SwiGLU -> GEMM-RS,
        through the matmul kernel at world 1 and the multi-rank kernels
        above (x then the M-sharded rows, (M, d))."""
        w = self.world
        if w == 1:
            h = ag_gemm_device(x, params["w_gate_up"])
            return gemm_rs_device(self._glu(h), params["w_down"])
        M, d = x.shape
        h = ag_gemm_device(x.reshape(w, M // w, d), params["w_gate_up"],
                           world=w)
        return gemm_rs_device(self._glu(h), params["w_down"],
                              world=w).reshape(M, d)

    def ar_fwd(self, params, x_full: torch.Tensor) -> torch.Tensor:
        """x_full: (M, d_model) replicated -> (M, d_model) replicated:
        local products, then the one-shot all-reduce of the partials (JAX
        :128); at world > 1 rank 0's copy (every copy is the same bits)."""
        out = oneshot_all_reduce(self._partials(params, x_full),
                                 world=self.world)
        return out[0] if self.world > 1 else out

    def xla_fwd(self, params, x: torch.Tensor) -> torch.Tensor:
        """Golden: the same math with ``torch.matmul``; at world > 1 the
        ranks' partials summed in f32 (JAX's ``psum_scatter``)."""
        out = self._partials(params, x)
        if self.world > 1:
            out = out.float().sum(0).to(x.dtype)
        return out
