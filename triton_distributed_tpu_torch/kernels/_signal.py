"""Host side of ``csrc/language.cuh``'s signals: flag buffers with
epochs, counters zeroed on the stream, and arrival counters that their
kernel resets.

A flag buffer is a persistent zeroed ``uint32`` array per (stream, name),
grown on demand and never reset: each call takes a new epoch (a per-device
counter) and its producers raise flags to that epoch, so the flags of an
earlier call read as "not yet" to a later one; when the counter wraps, the
device's flag buffers are zeroed first (``next_epoch``). A counter buffer
(cells that kernels ADD to, ``SIGNAL_ADD``) is zeroed on the stream right
before each call's launch, so nothing an earlier call added can satisfy a
wait of this one. An arrival counter buffer (``arrivals``: cells that a
kernel ADDs to and that the last block to arrive resets to 0, as the
split-KV decode's merge does) is zeroed once, when it is made, and every
launch that uses it leaves it at 0, so the host never resets it. Calls on
one stream run in order, and calls on two streams use two buffers, so no
call's signals are raised while another's are awaited.
"""

from __future__ import annotations

import torch

_FLAGS: dict[tuple[torch.device, int, str], torch.Tensor] = {}
_COUNTERS: dict[tuple[torch.device, int, str], torch.Tensor] = {}
_ARRIVALS: dict[tuple[torch.device, int, str], torch.Tensor] = {}
_EPOCH: dict[torch.device, int] = {}


def _buffer(store: dict, device: torch.device, name: str,
            n: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream, name)
    buf = store.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        store[key] = buf
    return buf


def flags(device: torch.device, name: str, n: int) -> torch.Tensor:
    """At least ``n`` flags of ``name`` for the current stream of
    ``device`` (int32 storage that the kernels read as uint32)."""
    return _buffer(_FLAGS, device, name, n)


def counters(device: torch.device, name: str, n: int) -> torch.Tensor:
    """``n`` counters of ``name`` for the current stream of ``device``,
    zeroed on that stream now: the launch that follows starts from 0."""
    buf = _buffer(_COUNTERS, device, name, n)[:n]
    buf.zero_()
    return buf


def arrivals(device: torch.device, name: str, n: int) -> torch.Tensor:
    """At least ``n`` arrival counters of ``name`` for the current stream
    of ``device``: zeroed when made, and reset to 0 by the kernel that
    counts on them (its last arriving block), never by the host."""
    return _buffer(_ARRIVALS, device, name, n)


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
