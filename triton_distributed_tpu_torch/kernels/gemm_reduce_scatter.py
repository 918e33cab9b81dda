"""GEMM + reduce-scatter at world 1.

Counterpart of ``triton_distributed_tpu/kernels/gemm_reduce_scatter.py``:
at world 1 ``gemm_rs_device`` (:190) is the single-card matmul. The
overlapped multi-rank kernel is not ported yet.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels.allgather_gemm import (
    ag_gemm_single_chip,
)


def gemm_rs_device(a_local: torch.Tensor, b_local: torch.Tensor, *,
                   world: int = 1) -> torch.Tensor:
    """GEMM-RS ``(M, k_local) x (k_local, N) -> (M/world, N)``. Only world 1
    is ported: it is ``ag_gemm_single_chip``."""
    if world != 1:
        raise NotImplementedError(
            "gemm_rs_device at world > 1 (the overlapped reduce-scatter "
            "kernel) is not ported yet: ROADMAP.md Queue 1 item 11 / Queue 2 "
            "row 13")
    return ag_gemm_single_chip(a_local, b_local)
