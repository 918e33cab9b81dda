"""Single-card matmul: the world-1 path of AG-GEMM.

Counterpart of ``triton_distributed_tpu/kernels/allgather_gemm.py``. At
world 1 its ``ag_gemm_device`` is ``ag_gemm_single_chip`` (:399), whose
Pallas ``_matmul_kernel`` (:733) carries every projection with M >= 64;
below that the JAX package hands the product to XLA (:826-828) and the port
hands it to ``torch.matmul``. The JAX package's other XLA delegations
(ragged blocks, the VMEM budget, :833-848) follow from Mosaic's tiling and
do not carry over: ``csrc/matmul.cu`` masks ragged edges itself.

The overlapped multi-rank kernel (world > 1) is not ported yet.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels import _build

MATMUL = _build.register(
    "matmul", "triton_distributed_tpu_torch/csrc/matmul.cu",
    "triton_distributed_tpu/kernels/allgather_gemm.py:733")

# Below this many rows the product is a weight-streaming GEMV, left to the
# library as the JAX package leaves it to XLA.
SMALL_M = 64


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(M, K) x (K, N)`` in f32, cast to the promoted
    input dtype."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/matmul.cu`` on CUDA tensors: f32 accumulation, output
    in the inputs' dtype (bf16 or fp32; both operands the same dtype)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("matmul_cuda takes two tensors on one CUDA device")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul operands differ in dtype: {a.dtype} vs "
                        f"{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda takes row-major contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    err = _build.lib().tdt_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
        _build.dtype_code(a), _build.stream_ptr(a))
    _build.check(err, "tdt_matmul")
    MATMUL.launches += 1
    return c


def ag_gemm_single_chip(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) x (K, N) -> (M, N)`` with f32 accumulation.

    M < 64 goes to ``torch.matmul`` (as the JAX package gives it to XLA).
    Otherwise a CUDA tensor goes to the matmul kernel and a CPU tensor to
    ``matmul_ref``."""
    if a.shape[0] < SMALL_M:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
        return torch.matmul(a.to(out_dtype), b.to(out_dtype))
    if a.is_cuda:
        return matmul_cuda(a, b)
    return matmul_ref(a, b)


def ag_gemm_device(a_local: torch.Tensor, b_local: torch.Tensor, *,
                   world: int = 1) -> torch.Tensor:
    """AG-GEMM ``(m, K) x (K, n_local) -> (world*m, n_local)``. Only world 1
    is ported: it is ``ag_gemm_single_chip``."""
    if world != 1:
        raise NotImplementedError(
            "ag_gemm_device at world > 1 (the overlapped allgather kernel) is "
            "not ported yet: ROADMAP.md Queue 1 item 11 / Queue 2 row 12")
    if a_local.shape[1] != b_local.shape[0]:
        raise ValueError(f"K mismatch: A has {a_local.shape[1]}, B has "
                         f"{b_local.shape[0]}")
    return ag_gemm_single_chip(a_local, b_local)
