"""EP all-to-all at world 1, and the one-chip all-to-all loopback.

Counterpart of ``triton_distributed_tpu/kernels/ep_all_to_all.py``. Each
rank owns a ``(world, capacity, ...)`` send layout per payload (slot p =
the rows bound for rank p) and receives into the same layout (slot p = the
rows from rank p), with a ``(world,)`` int32 count per slot. At world 1
``fast_all_to_all`` (:186) is the identity plus the send counts
(:207-211); the multi-rank ``_a2a_kernel`` (:102) is not ported yet.
``a2a_loopback`` (:378) runs on ``csrc/a2a_loopback.cu``: the whole
dispatch protocol (count cells, occupancy-predicated chunked pushes, the
receiver's re-derived waits) with every peer simulated on this card. Its
counts stay on the device: no wrapper reads them back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal

A2A_LOOPBACK = _build.register(
    "a2a_loopback", "triton_distributed_tpu_torch/csrc/a2a_loopback.cu",
    "triton_distributed_tpu/kernels/ep_all_to_all.py:336")

# Bytes of one payload piece, the kernel's unit of work inside a chunk: a
# full-occupancy chunk of 128 fp8 tokens of 7,168 is 32 pieces of 4 rows.
PIECE_BYTES = 32768
MAX_PAYLOADS = 4  # csrc/a2a_loopback.cu kMaxPayloads


@dataclasses.dataclass(frozen=True)
class AllToAllContext:
    """Static exchange geometry (JAX ``AllToAllContext`` :58): at most
    ``capacity`` tokens per (source, destination) pair, ``hidden`` wide;
    ``chunk_rows`` is the push granularity: a slot sends ``ceil(count /
    chunk_rows)`` chunks, not its whole capacity. The same fields and
    ``ValueError``s as JAX. JAX's ``_check_payload_alignment`` is not
    carried over: it is Mosaic's rule that a DMA slice along the token dim
    needs a minor dim of a multiple of 128 lanes, and the CUDA kernel moves
    bytes (16 at a time where the rows allow, else one by one)."""

    capacity: int
    hidden: int
    axis: str = "ep"
    chunk_rows: int = 8

    def __post_init__(self):
        if self.capacity % 8:
            raise ValueError(f"capacity {self.capacity} must be a multiple of 8 "
                             "(TPU sublane tiling)")
        if self.chunk_rows % 8 or self.capacity % self.chunk_rows:
            raise ValueError(
                f"chunk_rows {self.chunk_rows} must be a multiple of 8 and "
                f"divide capacity {self.capacity}")


def _as_tuple(payloads):
    single = not isinstance(payloads, (tuple, list))
    return single, ((payloads,) if single else tuple(payloads))


def fast_all_to_all(payloads, send_counts, *, ctx: AllToAllContext,
                    direction: str = "dispatch", world: int = 1):
    """Per-rank EP exchange (JAX :186): ``payloads`` one tensor or a tuple,
    each ``(world, capacity, ...)``; ``send_counts`` (world,) int32. Returns
    ``(recv_payloads, recv_counts)`` in the same layout. At world 1 it is
    the identity plus the send counts (JAX :207-211)."""
    if direction not in ("dispatch", "combine"):
        raise ValueError(f"direction must be 'dispatch' or 'combine', got "
                         f"{direction!r}")
    single, payloads = _as_tuple(payloads)
    if world == 1:
        return (payloads[0] if single else payloads), send_counts
    raise NotImplementedError(
        "fast_all_to_all at world > 1 (the multi-rank _a2a_kernel) is not "
        "ported yet: ROADMAP.md Queue 1 item 11 / Queue 2 row 18")


def _check_layout(payloads, ctx: AllToAllContext, world: int) -> None:
    for pay in payloads:
        if pay.shape[0] != world or pay.shape[1] != ctx.capacity:
            raise ValueError(f"payload {tuple(pay.shape)} != (world={world}, "
                             f"capacity={ctx.capacity}, ...)")


def a2a_loopback_ref(payloads, send_counts, *, ctx: AllToAllContext,
                     world: int = 8):
    """Plain version: each slot's rows below min(count, capacity) copied
    byte for byte (the rows past it are zeros here, unspecified in the
    kernel), and the counts returned unchanged. Masks, no host read, so it
    runs on the card as well."""
    single, payloads = _as_tuple(payloads)
    _check_layout(payloads, ctx, world)
    dev = payloads[0].device
    counts = torch.as_tensor(send_counts, dtype=torch.int32, device=dev)
    live = (torch.arange(ctx.capacity, device=dev)[None]
            < counts.clamp(min=0)[:, None])                 # (world, cap)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    out = []
    for pay in payloads:
        b = pay.contiguous().view(torch.uint8).reshape(world, ctx.capacity,
                                                       -1)
        got = torch.where(live[..., None], b, zero)
        out.append(got.view(pay.dtype).reshape(pay.shape))
    return (out[0] if single else tuple(out)), counts.clone()


def a2a_loopback_cuda(payloads, send_counts, *, ctx: AllToAllContext,
                      world: int = 8, piece_bytes: int = PIECE_BYTES):
    """Launch ``csrc/a2a_loopback.cu`` on the current stream. Payloads of
    any dtype (fp8 included, never converted), contiguous, on one card;
    ``send_counts`` (world,) int32, read on the device only. Returns
    ``(recv_payloads, recv_counts)``; received rows past a count are
    unspecified. ``piece_bytes`` is the work item's size inside a chunk
    (one item per chunk when it holds a whole chunk: the timing of the
    pieces against that)."""
    single, payloads = _as_tuple(payloads)
    _check_layout(payloads, ctx, world)
    if not 1 <= len(payloads) <= MAX_PAYLOADS:
        raise ValueError(f"1 to {MAX_PAYLOADS} payloads, got {len(payloads)}")
    dev = payloads[0].device
    for pay in payloads:
        if not pay.is_cuda or pay.device != dev:
            raise ValueError("a2a_loopback_cuda takes payloads on one CUDA "
                             "device")
        if not pay.is_contiguous():
            raise ValueError("a2a_loopback_cuda takes contiguous payloads")
    counts = torch.as_tensor(send_counts, dtype=torch.int32, device=dev)
    if counts.shape != (world,):
        raise ValueError(f"send_counts {tuple(counts.shape)} != ({world},)")
    counts = counts.contiguous()
    cap, ch = ctx.capacity, ctx.chunk_rows
    recvs = [torch.empty_like(pay) for pay in payloads]
    row_bytes = [pay.numel() // (world * cap) * pay.element_size()
                 for pay in payloads]
    if min(row_bytes) < 1:
        raise ValueError("a2a_loopback_cuda takes non-empty rows")
    piece_rows = [min(ch, max(1, piece_bytes // rb)) for rb in row_bytes]
    items = sum(world * (cap // ch) * -(-ch // pr) for pr in piece_rows)
    n = len(payloads)
    flags = _signal.flags(dev, "a2a_loopback", items + 2 * world)
    cells = torch.empty(world, dtype=torch.int32, device=dev)
    recv_counts = torch.empty(world, dtype=torch.int32, device=dev)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    err = _build.lib().tdt_a2a_loopback(
        (ctypes.c_void_p * n)(*[p.data_ptr() for p in payloads]),
        (ctypes.c_void_p * n)(*[r.data_ptr() for r in recvs]),
        (ctypes.c_longlong * n)(*row_bytes),
        (ctypes.c_longlong * n)(*piece_rows), n, counts.data_ptr(),
        cells.data_ptr(), recv_counts.data_ptr(), flags.data_ptr(),
        ticket.data_ptr(), _signal.next_epoch(dev), world, cap, ch,
        _build.stream_ptr(payloads[0]))
    _build.check(err, "tdt_a2a_loopback")
    A2A_LOOPBACK.launches += 1
    return (recvs[0] if single else tuple(recvs)), recv_counts


def a2a_loopback(payloads, send_counts, *, ctx: AllToAllContext,
                 world: int = 8):
    """One-chip SELF-LOOPBACK all-to-all (JAX :378): the dispatch machinery
    of ``fast_all_to_all`` (per-slot count cells, occupancy-scaled chunked
    pushes, the receiver's count read-back and predicated waits) with every
    peer simulated on this card. ``payloads`` one tensor or a tuple, each
    ``(world, capacity, ...)``; ``send_counts`` (world,) int32. Returns
    ``(recv_payloads, recv_counts)``: each slot's rows below its count
    round-tripped, the counts unchanged. CUDA tensors run the kernel, CPU
    tensors the plain version."""
    single, pays = _as_tuple(payloads)
    _check_layout(pays, ctx, world)
    fn = a2a_loopback_cuda if pays[0].is_cuda else a2a_loopback_ref
    return fn(payloads, send_counts, ctx=ctx, world=world)
