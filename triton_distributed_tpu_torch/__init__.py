"""triton_distributed_tpu_torch — the PyTorch/CUDA port of
``triton_distributed_tpu`` for one NVIDIA Hopper card (sm_90a).

The module tree mirrors the JAX package so each file's counterpart is easy
to find:

  runtime/device.py       device resolution (cuda unless the caller asks
                          for the CPU; no card raises)
  models/                 ModelConfig presets, sampling, KVCache, Qwen3
                          (dense and MoE), Engine (prefill -> sample ->
                          decode loop, and the two paged serving steps)
  serving/                BatchEngine (continuous batching), KVPool,
                          Scheduler, RadixPrefixCache
  runtime/mesh.py         the simulated world: rank stacks of sharded
                          arrays
  layers/                 nn ops (incl. KV quantization and the paged pool
                          write/read), TPAttn, TPMLP, MoEMLP and
                          EPAll2AllLayer (the expert-parallel exchange)
  kernels/                wrappers of the hand-written CUDA kernels in
                          ``csrc/`` (matmuls, attention, the grouped GEMM,
                          the collectives and the multi-rank kernels: the
                          reduce-scatter, and the MoE-TP AG-GroupGEMM and
                          GroupGEMM-RS of ``moe_overlap``), each beside its
                          plain PyTorch version; MoE routing
                          (``moe_utils``)
  kernels/_build.py       nvcc -> one shared library with a C interface,
                          loaded with ctypes at first use

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package. On a CUDA tensor a kernel wrapper launches its kernel (or raises);
on a CPU tensor it runs the plain version, which is what the CPU tests
compare against the JAX reference.
"""

__version__ = "0.1.0"

from triton_distributed_tpu_torch.models import (  # noqa: F401
    Engine,
    KVCache,
    ModelConfig,
    Qwen3,
    params_from_jax,
    sample_token,
)
from triton_distributed_tpu_torch.runtime.device import (  # noqa: F401
    resolve_device,
)
from triton_distributed_tpu_torch.serving import (  # noqa: F401
    BatchEngine,
    KVPool,
    PagedKVState,
    RadixPrefixCache,
    Request,
    Scheduler,
)
