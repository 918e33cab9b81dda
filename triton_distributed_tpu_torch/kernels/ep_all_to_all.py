"""EP all-to-all: the multi-rank exchange and the one-chip loopback.

Counterpart of ``triton_distributed_tpu/kernels/ep_all_to_all.py``. Each
rank owns a ``(world, capacity, ...)`` send layout per payload (slot p =
the rows bound for rank p) and receives into the same layout (slot p = the
rows from rank p), with a ``(world,)`` int32 count per slot.

``fast_all_to_all`` (:186) is the exchange. At world 1 it is the identity
plus the send counts (:207-211). Above it the ranks are simulated on one
card (``runtime/mesh.py``), so the per-rank layouts are held as their rank
stack: each payload ``(world, world, capacity, ...)`` with rank r's send
slot p at ``[r, p]``, the counts ``(world, world)``; the result follows
the JAX host wrapper ``all_to_all`` (:293): ``out[r][p] = in[p][r]`` below
``rcounts[r][p] = counts[p][r]``. A CUDA tensor runs ``csrc/ep_a2a.cu``
(replaces ``_a2a_kernel`` :102) or raises, a CPU tensor the plain version
``fast_all_to_all_ref``. ``a2a_loopback`` (:378) runs on
``csrc/a2a_loopback.cu``: the dispatch protocol with every peer simulated
on this card. No wrapper reads a count back to the host.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal

A2A_LOOPBACK = _build.register(
    "a2a_loopback", "triton_distributed_tpu_torch/csrc/a2a_loopback.cu",
    "triton_distributed_tpu/kernels/ep_all_to_all.py:336")
EP_A2A = _build.register(
    "ep_a2a", "triton_distributed_tpu_torch/csrc/ep_a2a.cu",
    "triton_distributed_tpu/kernels/ep_all_to_all.py:102")

# Bytes of one payload piece, the kernels' unit of work: a full-occupancy
# chunk of 128 fp8 tokens of 7,168 is 32 pieces of 4 rows; a chunk of 8
# bf16 rows of 2,048 is one piece; 8,192 rows of 4-byte expert ids are one.
PIECE_BYTES = 32768
MAX_PAYLOADS = 4  # csrc/a2a_loopback.cu and csrc/ep_a2a.cu kMaxPayloads


@dataclasses.dataclass(frozen=True)
class AllToAllContext:
    """Static exchange geometry (JAX ``AllToAllContext`` :58): at most
    ``capacity`` tokens per (source, destination) pair, ``hidden`` wide;
    ``chunk_rows`` is the push granularity: a slot sends ``ceil(count /
    chunk_rows)`` chunks, not its whole capacity. The same fields and
    ``ValueError``s as JAX. JAX's ``_check_payload_alignment`` is not
    carried over: it is Mosaic's rule that a DMA slice along the token dim
    needs a minor dim of a multiple of 128 lanes, and the CUDA kernels move
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


def _check_direction(direction: str) -> None:
    if direction not in ("dispatch", "combine"):
        raise ValueError(f"direction must be 'dispatch' or 'combine', got "
                         f"{direction!r}")


def fast_all_to_all(payloads, send_counts, *, ctx: AllToAllContext,
                    direction: str = "dispatch", world: int = 1):
    """The EP exchange (JAX :186). ``payloads`` one tensor or a tuple. At
    world 1 each is one rank's ``(1, capacity, ...)`` and ``send_counts``
    its (1,) counts: returned as they are. Above it each payload is the
    rank stack ``(world, world, capacity, ...)`` (rank r's send slot p at
    ``[r, p]``) and ``send_counts`` (world, world) int32; returns
    ``(recv_payloads, recv_counts)`` with ``recv[r][p] = payload[p][r]``
    below ``recv_counts[r][p] = send_counts[p][r]`` (received rows past a
    count are unspecified). ``direction`` "dispatch" or "combine" keeps the
    two directions' signals apart, as JAX keeps their collective ids."""
    _check_direction(direction)
    single, pays = _as_tuple(payloads)
    if world == 1:
        return (pays[0] if single else pays), send_counts
    _check_stacked(pays, ctx, world)
    fn = fast_all_to_all_cuda if pays[0].is_cuda else fast_all_to_all_ref
    return fn(payloads, send_counts, ctx=ctx, world=world,
              direction=direction)


def all_to_all(payloads, send_counts, *, ctx: AllToAllContext):
    """Host-level wrapper over stacked arrays (JAX :293): each payload
    ``(world, world, capacity, ...)`` (rank r owns slice [r]), counts
    (world, world); returns the routed arrays, ``out[r][p] = in[p][r]``,
    and the received counts. The world is the payloads' first dimension."""
    _, pays = _as_tuple(payloads)
    return fast_all_to_all(payloads, send_counts, ctx=ctx,
                           world=pays[0].shape[0])


def _check_stacked(payloads, ctx: AllToAllContext, world: int) -> None:
    for pay in payloads:
        if (pay.dim() < 3 or pay.shape[0] != world or pay.shape[1] != world
                or pay.shape[2] != ctx.capacity):
            raise ValueError(f"payload {tuple(pay.shape)} != (world={world}, "
                             f"world={world}, capacity={ctx.capacity}, ...)")


def _stack_counts(send_counts, world: int, device) -> torch.Tensor:
    counts = torch.as_tensor(send_counts, dtype=torch.int32, device=device)
    if counts.shape != (world, world):
        raise ValueError(f"send_counts {tuple(counts.shape)} != ({world}, "
                         f"{world})")
    return counts.contiguous()


def fast_all_to_all_ref(payloads, send_counts, *, ctx: AllToAllContext,
                        world: int, direction: str = "dispatch"):
    """Plain version of the multi-rank exchange: ``recv[r][p]`` = the rows
    of ``payload[p][r]`` below min(count, capacity), byte for byte (the
    rows past it are zeros here), and the transposed counts. Masks, no host
    read, so it runs on the card as well."""
    _check_direction(direction)
    single, payloads = _as_tuple(payloads)
    _check_stacked(payloads, ctx, world)
    dev = payloads[0].device
    rcounts = _stack_counts(send_counts, world, dev).T.contiguous()
    live = (torch.arange(ctx.capacity, device=dev)[None, None]
            < rcounts.clamp(min=0)[..., None])        # (world, world, cap)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    out = []
    for pay in payloads:
        b = pay.contiguous().view(torch.uint8).reshape(
            world, world, ctx.capacity, -1).transpose(0, 1)
        got = torch.where(live[..., None], b, zero)
        out.append(got.view(pay.dtype).reshape(pay.shape))
    return (out[0] if single else tuple(out)), rcounts


def _piece_rows(row_bytes: int, chunk_rows: int, capacity: int) -> int:
    """Rows of one piece of ``csrc/ep_a2a.cu``: about ``PIECE_BYTES``, cut
    from one chunk, or whole chunks when a chunk is smaller."""
    rows = max(1, PIECE_BYTES // row_bytes)
    if rows < chunk_rows:
        return rows
    return min(rows // chunk_rows * chunk_rows, capacity)


def _pieces_per_pair(piece_rows: int, chunk_rows: int, capacity: int) -> int:
    span = max(piece_rows, chunk_rows)
    return -(-capacity // span) * -(-span // piece_rows)


def fast_all_to_all_cuda(payloads, send_counts, *, ctx: AllToAllContext,
                         world: int, direction: str = "dispatch", recv=None,
                         producer_delay_ns: int = 0):
    """Launch ``csrc/ep_a2a.cu`` on the current stream: every rank's
    exchange in one launch. Payloads ``(world, world, capacity, ...)`` of
    any dtype (never converted), contiguous, on one card, at most
    ``MAX_PAYLOADS``; ``send_counts`` (world, world) int32, read on the
    device only. Returns ``(recv_payloads, recv_counts)``. ``recv`` (one
    contiguous buffer per payload, like it; default new ``torch.empty``
    ones) and ``producer_delay_ns`` (every producer item sleeps that long
    before its copy) let a test poison the receive buffers and hold the
    pushes back. The call draws its signal epoch here, once."""
    _check_direction(direction)
    single, payloads = _as_tuple(payloads)
    _check_stacked(payloads, ctx, world)
    if not 1 <= len(payloads) <= MAX_PAYLOADS:
        raise ValueError(f"1 to {MAX_PAYLOADS} payloads, got {len(payloads)}")
    dev = payloads[0].device
    for pay in payloads:
        if not pay.is_cuda or pay.device != dev:
            raise ValueError("fast_all_to_all_cuda takes payloads on one CUDA "
                             "device")
        if not pay.is_contiguous():
            raise ValueError("fast_all_to_all_cuda takes contiguous payloads")
    counts = _stack_counts(send_counts, world, dev)
    cap, ch = ctx.capacity, ctx.chunk_rows
    if recv is None:
        recvs = [torch.empty_like(pay) for pay in payloads]
    else:
        _, recvs = _as_tuple(recv)
        if len(recvs) != len(payloads) or any(
                r.shape != p.shape or r.dtype != p.dtype or r.device != dev
                or not r.is_contiguous() for r, p in zip(recvs, payloads)):
            raise ValueError("recv must hold one contiguous buffer like each "
                             "payload")
    row_bytes = [pay.numel() // (world * world * cap) * pay.element_size()
                 for pay in payloads]
    if min(row_bytes) < 1:
        raise ValueError("fast_all_to_all_cuda takes non-empty rows")
    piece_rows = [_piece_rows(rb, ch, cap) for rb in row_bytes]
    pieces = world * world * sum(_pieces_per_pair(pr, ch, cap)
                                 for pr in piece_rows)
    n = len(payloads)
    flags = _signal.flags(dev, f"ep_a2a_{direction}", world * world + pieces)
    cells = torch.empty((world, world), dtype=torch.int32, device=dev)
    recv_counts = torch.empty((world, world), dtype=torch.int32, device=dev)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    err = _build.lib().tdt_ep_a2a(
        (ctypes.c_void_p * n)(*[p.data_ptr() for p in payloads]),
        (ctypes.c_void_p * n)(*[r.data_ptr() for r in recvs]),
        (ctypes.c_longlong * n)(*row_bytes),
        (ctypes.c_longlong * n)(*piece_rows), n, counts.data_ptr(),
        cells.data_ptr(), recv_counts.data_ptr(), flags.data_ptr(),
        ticket.data_ptr(), _signal.next_epoch(dev), world, cap, ch,
        producer_delay_ns, _build.stream_ptr(payloads[0]))
    _build.check(err, "tdt_ep_a2a")
    EP_A2A.launches += 1
    return (recvs[0] if single else tuple(recvs)), recv_counts


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


@dataclasses.dataclass(frozen=True)
class A2APlan:
    """The launch geometry of ``a2a_loopback_cuda`` for one set of payload
    shapes and dtypes, ``capacity``, ``chunk_rows``, ``world`` and
    ``piece_bytes``: each payload's bytes per row and rows per piece, the
    piece items over every payload, and the two size arrays in the C
    entry's ``ctypes`` form (read-only, so one plan serves every call)."""

    row_bytes: tuple[int, ...]
    piece_rows: tuple[int, ...]
    items: int
    c_row_bytes: ctypes.Array
    c_piece_rows: ctypes.Array
    c_pointers: type  # ctypes.c_void_p * n_payloads


_A2A_PLANS: dict[tuple, A2APlan] = {}


def _a2a_plan(payloads, capacity: int, chunk_rows: int, world: int,
              piece_bytes: int) -> A2APlan:
    """The cached plan of these payloads' shapes and dtypes (made on first
    use; raises on empty rows, as the launch did)."""
    key = (*[(p.shape, p.dtype) for p in payloads], capacity, chunk_rows,
           world, piece_bytes)
    plan = _A2A_PLANS.get(key)
    if plan is None:
        row_bytes = tuple(p.numel() // (world * capacity) * p.element_size()
                          for p in payloads)
        if min(row_bytes) < 1:
            raise ValueError("a2a_loopback_cuda takes non-empty rows")
        piece_rows = tuple(min(chunk_rows, max(1, piece_bytes // rb))
                           for rb in row_bytes)
        n = len(payloads)
        plan = A2APlan(
            row_bytes, piece_rows,
            sum(world * (capacity // chunk_rows) * -(-chunk_rows // pr)
                for pr in piece_rows),
            (ctypes.c_longlong * n)(*row_bytes),
            (ctypes.c_longlong * n)(*piece_rows), ctypes.c_void_p * n)
        _A2A_PLANS[key] = plan
    return plan


def a2a_loopback_cuda(payloads, send_counts, *, ctx: AllToAllContext,
                      world: int = 8, piece_bytes: int = PIECE_BYTES,
                      recv=None):
    """Launch ``csrc/a2a_loopback.cu`` on the current stream. Payloads of
    any dtype (fp8 included, never converted), contiguous, on one card;
    ``send_counts`` (world,) int32, read on the device only. Returns
    ``(recv_payloads, recv_counts)``; received rows past a count are
    unspecified (the kernel neither reads nor writes them). ``piece_bytes``
    is the work item's size inside a chunk (one item per chunk when it
    holds a whole chunk: the timing of the pieces against that); ``recv``
    (one contiguous buffer per payload, like it; default new
    ``torch.empty_like`` ones) lets a test poison the receive buffers. The
    launch geometry is a cached plan (``_a2a_plan``); the count cells and
    the ticket are a persistent per-stream buffer (``_signal.arrivals``)
    that the kernel leaves at 0, so the call allocates only what it
    returns and makes one device operation, the launch."""
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
    counts = send_counts
    if not (isinstance(counts, torch.Tensor) and counts.dtype == torch.int32
            and counts.device == dev):
        counts = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    if counts.shape != (world,):
        raise ValueError(f"send_counts {tuple(counts.shape)} != ({world},)")
    counts = counts.contiguous()
    cap, ch = ctx.capacity, ctx.chunk_rows
    plan = _a2a_plan(payloads, cap, ch, world, piece_bytes)
    if recv is None:
        recvs = [torch.empty_like(pay) for pay in payloads]
    else:
        _, recvs = _as_tuple(recv)
        if len(recvs) != len(payloads) or any(
                r.shape != p.shape or r.dtype != p.dtype or r.device != dev
                or not r.is_contiguous() for r, p in zip(recvs, payloads)):
            raise ValueError("recv must hold one contiguous buffer like each "
                             "payload")
    recv_counts = torch.empty(world, dtype=torch.int32, device=dev)
    stream = _build.stream_ptr(payloads[0])
    flags = _signal.flags(dev, "a2a_loopback", plan.items + 2 * world,
                          stream)
    # [0] the ticket; from [32] on, a cache line further, the count cells
    scratch = _signal.arrivals(dev, "a2a_loopback", 32 + world,
                               stream).data_ptr()
    err = _build.lib().tdt_a2a_loopback(
        plan.c_pointers(*[p.data_ptr() for p in payloads]),
        plan.c_pointers(*[r.data_ptr() for r in recvs]),
        plan.c_row_bytes, plan.c_piece_rows, len(payloads),
        counts.data_ptr(), scratch + 128, recv_counts.data_ptr(),
        flags.data_ptr(), scratch, _signal.next_epoch(dev), world, cap, ch,
        stream)
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
