"""Runtime helpers of the port (counterpart of ``triton_distributed_tpu.runtime``)."""

from triton_distributed_tpu_torch.runtime.device import resolve_device  # noqa: F401
