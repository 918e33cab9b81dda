"""Kernel wrappers of the port (counterpart of ``triton_distributed_tpu.kernels``).

Each module holds a hand-written CUDA kernel's wrapper (sources in
``csrc/``), its plain PyTorch version, and the entry point that picks one by
the device of its tensors. ``KERNELS`` lists every kernel with its source,
the TPU kernel it replaces and its launch count.
"""

from triton_distributed_tpu_torch.kernels import (  # noqa: F401
    allgather_gemm,
    allreduce,
    ep_all_to_all,
    gemm_reduce_scatter,
    moe_utils,
    notify_wait,
    paged_attention,
    sp_attention,
)
from triton_distributed_tpu_torch.kernels._build import (  # noqa: F401
    KERNELS,
    reset_counts,
)
