"""Host side of ``csrc/language.cuh``'s signals: flag buffers with
epochs, and arrival buffers that their kernels leave at 0.

A flag buffer is a persistent zeroed ``uint32`` array per (stream, name),
grown on demand and never reset: each call takes a new epoch (a per-device
counter) and its producers raise flags to that epoch, so the flags of an
earlier call read as "not yet" to a later one; when the counter wraps, the
device's flag buffers are zeroed first (``next_epoch``). An arrival buffer
(``arrivals``: counters that a kernel ADDs to, flags raised to a use number,
tickets) is zeroed once, when it is made, and every launch that uses it
leaves it at 0 (the last block to arrive or to leave resets what it
counted, as the split-KV decode's merge, the all-to-all loopback's ticket
and the notify/wait ring do), so the host never resets it and a call makes
no memset. Calls on one stream run in order, and calls on two streams use
two buffers, so no call's signals are raised while another's are awaited.
The stream is the current one of ``device`` unless the caller passes its
handle (``cuda_stream``), which saves a query on a short call's host path.
"""

from __future__ import annotations

import torch

_FLAGS: dict[tuple[torch.device, int, str], torch.Tensor] = {}
_ARRIVALS: dict[tuple[torch.device, int, str], torch.Tensor] = {}
_EPOCH: dict[torch.device, int] = {}


def _buffer(store: dict, device: torch.device, name: str, n: int,
            stream: int | None) -> torch.Tensor:
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream, name)
    buf = store.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        store[key] = buf
    return buf


def flags(device: torch.device, name: str, n: int,
          stream: int | None = None) -> torch.Tensor:
    """At least ``n`` flags of ``name`` for the current stream of
    ``device`` (int32 storage that the kernels read as uint32)."""
    return _buffer(_FLAGS, device, name, n, stream)


def arrivals(device: torch.device, name: str, n: int,
             stream: int | None = None) -> torch.Tensor:
    """At least ``n`` arrival cells of ``name`` for the current stream of
    ``device``: zeroed when made, and left at 0 by every launch of the
    kernel that uses them, never reset by the host."""
    return _buffer(_ARRIVALS, device, name, n, stream)


def next_epoch(device: torch.device) -> int:
    """A new epoch in ``[1, 2**31)`` for one call on ``device``. The
    kernels compare wrap-safely (``int32(flag - epoch) >= 0`` reads as
    raised), so only its difference from the flags' values matters. When
    the counter wraps from ``2**31 - 1`` back to 1, every flag buffer of
    ``device`` is zeroed first, each on its own stream (after every call
    that used it): a flag left at an old epoch near ``2**31`` would
    otherwise read as already raised to the small new ones."""
    e = _EPOCH.get(device, 0) + 1
    if e >= 2 ** 31:
        for (dev, stream, _), buf in _FLAGS.items():
            if dev != device:
                continue
            if buf.is_cuda:
                with torch.cuda.stream(torch.cuda.ExternalStream(
                        stream, device=dev)):
                    buf.zero_()
            else:
                buf.zero_()
        e = 1
    _EPOCH[device] = e
    return e
