"""Continuous-batching serving (counterpart of ``triton_distributed_tpu.serving``).

  kv_pool.py       the block-paged KV pool (bf16/f32 or int8/fp8 rows with
                   per-row scales) and its host-side allocator
  scheduler.py     ``Request`` and the priority-FIFO ``Scheduler``
  prefix_cache.py  the radix-tree prefix cache over pool blocks
  batch_engine.py  ``BatchEngine``: two fixed-shape steps over the pool

The router, fleet, controller, speculative decoding and metrics modules
are not ported yet (ROADMAP.md Queue 1 items 6-8).
"""

from triton_distributed_tpu_torch.serving.batch_engine import (  # noqa: F401
    BatchEngine,
)
from triton_distributed_tpu_torch.serving.kv_pool import (  # noqa: F401
    KVPool,
    PagedKVState,
)
from triton_distributed_tpu_torch.serving.prefix_cache import (  # noqa: F401
    RadixPrefixCache,
)
from triton_distributed_tpu_torch.serving.scheduler import (  # noqa: F401
    Request,
    Scheduler,
)
