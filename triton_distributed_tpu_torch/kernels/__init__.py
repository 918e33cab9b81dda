"""Kernel wrappers of the port (counterpart of ``triton_distributed_tpu.kernels``).

Each module holds a hand-written CUDA kernel's wrapper (sources in
``csrc/``), its plain PyTorch version, and the entry point that picks one by
the device of its tensors. ``KERNELS`` lists every kernel with its source,
the TPU kernel it replaces and its launch count.
"""

from triton_distributed_tpu_torch.kernels import (  # noqa: F401
    allgather,
    allgather_gemm,
    allreduce,
    ep_all_to_all,
    gemm_reduce_scatter,
    ll_allgather,
    moe_overlap,
    moe_utils,
    notify_wait,
    paged_attention,
    reduce_scatter,
    sp_attention,
)
from triton_distributed_tpu_torch.kernels.allgather import (  # noqa: F401
    AllGatherMethod,
    a2a_all_gather,
    all_gather,
    choose_all_gather_method,
    ring_all_gather,
)
from triton_distributed_tpu_torch.kernels.ll_allgather import (  # noqa: F401
    ll_all_gather,
    ll_all_gather_device,
    make_ll_staging,
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
from triton_distributed_tpu_torch.kernels.sp_attention import (  # noqa: F401
    decode_partial_feat,
    flash_decode_device,
    sp_ag_attention_device,
)
from triton_distributed_tpu_torch.kernels._build import (  # noqa: F401
    KERNELS,
    reset_counts,
)
