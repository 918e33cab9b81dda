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
    moe_overlap,
    moe_utils,
    notify_wait,
    paged_attention,
    reduce_scatter,
    sp_attention,
)
from triton_distributed_tpu_torch.kernels.moe_overlap import (  # noqa: F401
    MoEOverlapConfig,
    ag_group_gemm_2d_device,
    ag_group_gemm_device,
    ag_moe_mlp_2d_device,
    ag_moe_mlp_device,
    group_gemm_rs_2d_device,
    group_gemm_rs_device,
)
# JAX also exports its host ``reduce_scatter`` here (:10-13); in the port
# that name stays the module (the host function is
# ``reduce_scatter.reduce_scatter``).
from triton_distributed_tpu_torch.kernels.reduce_scatter import (  # noqa: F401
    oneshot_reduce_scatter,
    ring_reduce_scatter,
)
from triton_distributed_tpu_torch.kernels._build import (  # noqa: F401
    KERNELS,
    reset_counts,
)
