"""Models and inference engine of the port (counterpart of
``triton_distributed_tpu.models``)."""

from triton_distributed_tpu_torch.models.config import ModelConfig  # noqa: F401
from triton_distributed_tpu_torch.models.kv_cache import KVCache  # noqa: F401
from triton_distributed_tpu_torch.models.qwen import (  # noqa: F401
    Qwen3,
    params_from_jax,
)
from triton_distributed_tpu_torch.models.engine import Engine  # noqa: F401
from triton_distributed_tpu_torch.models.sampling import (  # noqa: F401
    finite_logits_mask,
    sample_token,
)
