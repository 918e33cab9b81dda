"""Device resolution.

Counterpart of ``triton_distributed_tpu/runtime/platform.py``
(``resolve_interpret``): there the question is whether a Pallas kernel runs
compiled or in the interpreter; here it is which device the port's entry
points place their tensors on. The answer is the card unless the caller
names another device. A missing card raises: nothing quietly runs on the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else -> ``torch.device(device)``.

    Raises ``RuntimeError`` when the resolved device is CUDA and no card is
    visible. Pass ``device="cpu"`` to run the plain PyTorch versions of the
    kernels (what the CPU tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev
