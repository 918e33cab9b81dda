"""Model layers of the port (counterpart of ``triton_distributed_tpu.layers``)."""

from triton_distributed_tpu_torch.layers import nn  # noqa: F401
from triton_distributed_tpu_torch.layers.allgather_layer import (  # noqa: F401
    AllGatherLayer,
)
from triton_distributed_tpu_torch.layers.ep_a2a_layer import (  # noqa: F401
    EPAll2AllLayer,
)
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP  # noqa: F401
from triton_distributed_tpu_torch.layers.sp_flash_decode_layer import (  # noqa: E501,F401
    SpGQAFlashDecodeAttention,
)
from triton_distributed_tpu_torch.layers.tp_attn import TPAttn  # noqa: F401
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP  # noqa: F401
