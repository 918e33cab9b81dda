"""Host side of ``csrc/signal.cuh``: flag buffers and epochs of the
one-chip overlap kernels.

A flag buffer is a persistent zeroed ``uint32`` array per (stream, name),
grown on demand and never reset: each call takes a new epoch (a per-device
counter) and its producers raise flags to that epoch, so the flags of an
earlier call read as "not yet" to a later one. Calls on one stream run in
order, and calls on two streams use two buffers, so no call's flags are
raised while another's are awaited.
"""

from __future__ import annotations

import torch

_FLAGS: dict[tuple[torch.device, int, str], torch.Tensor] = {}
_EPOCH: dict[torch.device, int] = {}


def flags(device: torch.device, name: str, n: int) -> torch.Tensor:
    """At least ``n`` flags of ``name`` for the current stream of
    ``device`` (int32 storage that the kernels read as uint32)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream, name)
    buf = _FLAGS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _FLAGS[key] = buf
    return buf


def next_epoch(device: torch.device) -> int:
    """A new epoch in ``[1, 2**31)`` for one call on ``device``. The
    kernels compare wrap-safely, so only its difference from the flags'
    values matters."""
    e = _EPOCH.get(device, 0) % (2 ** 31 - 1) + 1
    _EPOCH[device] = e
    return e
