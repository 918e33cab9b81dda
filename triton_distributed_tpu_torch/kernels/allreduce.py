"""All-reduce: one-shot and two-shot over simulated ranks, and the one-chip
one-shot all-reduce loopback.

Counterpart of ``triton_distributed_tpu/kernels/allreduce.py``. At world 1
``oneshot_all_reduce`` (:109) and ``twoshot_all_reduce`` (:253) are the
identity (:115-116, :257-258). At world > 1 the ranks are simulated on one
card: they take every rank's contribution stacked, ``(world, m, ...)``,
and return every rank's copy of the sum, ``(world, m, ...)``, each copy the
same bits, on ``csrc/oneshot_ar.cu`` (``_oneshot_ar_kernel`` :74: every
rank pushes its buffer into a staging slot of every peer, then folds the
world terms in rank order) and ``csrc/twoshot_ar.cu``
(``_twoshot_ar_kernel`` :209: ring reduce-scatter, then ring allgather).
The host wrapper ``all_reduce`` (:297) takes the stacked contributions and
returns the reduced ``(m, ...)``, by the method ``choose_all_reduce_method``
(:53) picks from the perf model. One card stands in for the group: the
pushes go through device memory, not NVLink.

``oneshot_ar_loopback`` (:174) runs on ``csrc/oneshot_ar_loopback.cu``,
the multi-rank one-shot's items with one owner whose every source is x:
world - 1 simulated peers push this card's buffer into staging slots, each
chunk flagged when it lands, and a fixed-order f32 fold returns ``world *
x``. It prices the all-reduce machinery beside the small-M GEMMs of the ar
mode (``bench.py``'s M = 128 arm).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal
from triton_distributed_tpu_torch.runtime import symm

ONESHOT_AR_LOOPBACK = _build.register(
    "oneshot_ar_loopback",
    "triton_distributed_tpu_torch/csrc/oneshot_ar_loopback.cu",
    "triton_distributed_tpu/kernels/allreduce.py:158")

# Bytes of one piece of the two-shot all-reduce's and the reduce-scatters'
# rings (whole rows, at least one: ``_chunk``).
CHUNK_BYTES = 16384


class AllReduceMethod(enum.Enum):
    """The JAX method enum (:44): one-shot (push to every peer, reduce
    locally) and two-shot (ring reduce-scatter + all-gather)."""

    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"


ONESHOT_AR = _build.register(
    "oneshot_ar", "triton_distributed_tpu_torch/csrc/oneshot_ar.cu",
    "triton_distributed_tpu/kernels/allreduce.py:74")
TWOSHOT_AR = _build.register(
    "twoshot_ar", "triton_distributed_tpu_torch/csrc/twoshot_ar.cu",
    "triton_distributed_tpu/kernels/allreduce.py:209")

# At most this many chunks (flags) per rank in the multi-rank kernels: at
# bench.py's (128, 5,120) bf16 a chunk is one 10 KB row; at an ar-mode
# prefill of 8,192 rows a chunk grows to 8 rows.
MAX_CHUNKS = 1024


def choose_all_reduce_method(world: int, nbytes: int, leading_dim: int, *,
                             hw=None) -> AllReduceMethod:
    """The JAX rule (:53): one-shot at world <= 2 or when the leading dim
    does not split into world chunks; otherwise the method the perf model
    (``runtime/perf_model.py``, this card's figures unless ``hw`` is given)
    estimates faster, one-shot on a tie."""
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    if world <= 2 or leading_dim % world:
        return AllReduceMethod.ONE_SHOT
    one = pm.est_oneshot_all_reduce(nbytes, world, hw)
    two = pm.est_twoshot_all_reduce(nbytes, world, hw)
    return AllReduceMethod.ONE_SHOT if one <= two else AllReduceMethod.TWO_SHOT


def _stacked(name: str, x: torch.Tensor, world: int) -> None:
    if x.dim() < 2 or x.shape[0] != world or x.shape[1] == 0:
        raise ValueError(f"{name} at world {world} takes every rank's "
                         f"contribution stacked, (world, m, ...), got "
                         f"{tuple(x.shape)}")


def _chunk(n: int, row: int, itemsize: int) -> int:
    """Elements of one chunk: whole rows of CHUNK_BYTES or more, and no
    more than MAX_CHUNKS chunks of ``n`` elements."""
    rows = max(1, CHUNK_BYTES // (row * itemsize))
    rows = max(rows, -(-(n // row) // MAX_CHUNKS))
    return rows * row


def oneshot_all_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the multi-rank one-shot all-reduce, in the kernel's
    order and rounding (``common.reduce_slots_tiled``): the f32 sum of the
    world contributions ``x[0] + x[1] + ...`` in rank order, cast once;
    every rank's copy is that sum."""
    acc = x[0].float()
    for src in range(1, x.shape[0]):
        acc = acc + x[src].float()
    return acc.to(x.dtype).expand(x.shape).clone()


# The one-shot kernel's chunks: whole rounds of its block (256 threads x
# four 16-byte vectors), one round a chunk until there would be more than
# MAX_CHUNKS of them, then as many rounds a chunk as keep them at MAX_CHUNKS.
ONESHOT_ROUND_BYTES = 16384
# The loopback's chunks: whole units of this many bytes (two 16-byte vectors
# a thread of its 256), by the same rule. Its one owner has one push and
# one fold a chunk, so a chunk smaller than a round spreads a decode-sized
# buffer over more blocks; 8 KB beat 4 and 16 KB at bench.py's shape.
LOOPBACK_CHUNK_BYTES = 8192


def oneshot_ar_plan(n: int, itemsize: int,
                    unit: int = ONESHOT_ROUND_BYTES) -> tuple[int, int]:
    """``(chunk, n_chunks)`` of ``csrc/oneshot_ar.cu`` over n elements a
    rank: a chunk is a whole number of ``unit`` bytes (16 KB rounds; a
    multiple of every vector width), one unit unless that gives more than
    MAX_CHUNKS chunks; the chunks cover [0, n) once, the last one
    ragged."""
    units = max(1, -(-n * itemsize // (unit * MAX_CHUNKS)))
    chunk = units * unit // itemsize
    return chunk, -(-n // chunk)


def oneshot_ar_items(world: int, n_chunks: int,
                     lag: int = 1) -> list[tuple[str, int, int]]:
    """The kernel's work items in ticket order (``item_of`` in
    ``csrc/oneshot_ar.cu``): ``("push", c, src)`` copies chunk c of
    x[src] into every peer's slot and raises flag (c, src); ``("fold", c,
    d)`` waits on the flags (c, src != d) and folds rank d's chunk c. The
    pushes of chunks 0 .. lag - 1 first, then for each chunk c the pushes
    of c + lag (while there is one) and the folds of c."""
    lag = min(lag, n_chunks)
    items = [("push", c, s) for c in range(lag) for s in range(world)]
    for c in range(n_chunks):
        if c + lag < n_chunks:
            items += [("push", c + lag, s) for s in range(world)]
        items += [("fold", c, d) for d in range(world)]
    return items


_ONESHOT_PLANS: dict[tuple, tuple[int, int, int]] = {}


def _oneshot_launch(x: torch.Tensor, staging: torch.Tensor, out: torch.Tensor,
                    stream: int, delay_ns: int) -> None:
    """One launch of ``csrc/oneshot_ar.cu``: the plan of this shape (chunk,
    chunks, flags) cached, the flags and the self-resetting ticket from
    the stream's persistent signal buffers, no memset."""
    key = (x.shape, x.dtype)
    plan = _ONESHOT_PLANS.get(key)
    if plan is None:
        n = x[0].numel()
        chunk, n_chunks = oneshot_ar_plan(n, x.element_size())
        plan = _ONESHOT_PLANS[key] = (n, chunk, x.shape[0] * n_chunks)
    n, chunk, n_flags = plan
    dev = x.device
    err = _build.lib().tdt_oneshot_ar(
        x.data_ptr(), staging.data_ptr(), out.data_ptr(),
        _signal.flags(dev, "oneshot_ar", n_flags, stream).data_ptr(),
        _signal.arrivals(dev, "oneshot_ar", 1, stream).data_ptr(),
        _signal.next_epoch(dev), x.shape[0], n, chunk,
        _build.dtype_code(x), delay_ns, stream)
    _build.check(err, "tdt_oneshot_ar")
    ONESHOT_AR.launches += 1


def _check_oneshot(x: torch.Tensor) -> None:
    world = x.shape[0]
    _stacked("oneshot_all_reduce_cuda", x, world)
    if world < 2 or not x.is_cuda:
        raise ValueError("oneshot_all_reduce_cuda takes a CUDA tensor of "
                         "world >= 2 contributions")
    _build.dtype_code(x)
    if not x.is_contiguous():
        raise ValueError("oneshot_all_reduce_cuda takes a contiguous x")


def oneshot_all_reduce_cuda(x: torch.Tensor, *, staging=None,
                            producer_delay_ns: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/oneshot_ar.cu`` on the current stream: ``x`` (world,
    m, ...) f32 or bf16, contiguous. Returns ``(out, staging)``, staging
    (world, world - 1, m, ...) holding every pushed buffer
    (``staging[d][peer_slot(src, d)] = x[src]``). ``staging`` (default: a
    new buffer) and ``producer_delay_ns`` (every push item sleeps that
    long before its copy) let a test poison the slots and hold the pushes
    back; the result must not change."""
    _check_oneshot(x)
    world = x.shape[0]
    shape = (world, world - 1, *x.shape[1:])
    if staging is None:
        staging = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif (tuple(staging.shape) != shape or staging.dtype != x.dtype
          or staging.device != x.device or not staging.is_contiguous()):
        raise ValueError(f"staging must be a contiguous {shape} {x.dtype} "
                         f"tensor on {x.device}")
    out = torch.empty_like(x)
    _oneshot_launch(x, staging, out, _build.stream_ptr(x), producer_delay_ns)
    return out, staging


def serving_staging(x: torch.Tensor, stream: int) -> torch.Tensor:
    """The serving path's staging for ``x`` (world, m, ...): a view of the
    stream's persistent scratch (``runtime/symm.py`` ``get_scratch``, grown
    to the largest call), so a call allocates none; its contents are the
    last call's pushes. The view is kept per shape on the scratch itself
    (``views``), so it dies with it."""
    world = x.shape[0]
    per = (world - 1) * x[0].numel()
    ws = symm.get_scratch("oneshot_ar.staging", per, x.dtype, world=world,
                          device=x.device, stream=stream)
    view = ws.views.get(x.shape)
    if view is None:
        view = ws.views[x.shape] = ws.array.view(-1)[:world * per].view(
            world, world - 1, *x.shape[1:])
    return view


def oneshot_all_reduce(x_local: torch.Tensor, *,
                       world: int = 1) -> torch.Tensor:
    """Latency-optimal all-reduce over ``world`` ranks (JAX :109). At world
    1 ``x_local`` (m, ...) is returned as is (JAX :115). At world > 1
    ``x_local`` is every rank's contribution stacked, (world, m, ...), and
    the result every rank's copy of the sum, (world, m, ...): the kernel on
    a CUDA tensor (its pushes into the persistent ``serving_staging``, so
    the call's one device operation is the launch), the plain version on a
    CPU one."""
    _check_world(world)
    if world == 1:
        return x_local
    _stacked("oneshot_all_reduce", x_local, world)
    if not x_local.is_cuda:
        return oneshot_all_reduce_ref(x_local)
    _check_oneshot(x_local)
    stream = _build.stream_ptr(x_local)
    out = torch.empty_like(x_local)
    _oneshot_launch(x_local, serving_staging(x_local, stream), out, stream, 0)
    return out


def _twoshot_rows(x: torch.Tensor, world: int) -> int:
    """Rows of one ring chunk; JAX's ``ValueError`` when the leading dim
    does not split into ``world`` chunks (:259-262)."""
    if x.shape[1] % world:
        raise ValueError(
            f"two-shot allreduce needs leading dim {x.shape[1]} divisible "
            f"by world {world}; use one-shot or pad")
    return x.shape[1] // world


def twoshot_all_reduce_ref(x: torch.Tensor, *, return_staging: bool = False):
    """Plain version of the multi-rank two-shot all-reduce, step by step in
    the kernel's order and rounding: ring step s = 0 .. world - 2, rank r
    adds its chunk c = (r - s - 1) mod world to what its left neighbour
    pushed at step s - 1, in f32, rounds to x's dtype and pushes it right
    (``common.reduce_rows_tiled``); rank r's own chunk is x[r][r] plus the
    last push, rounded; the ring allgather copies each finished chunk to
    every rank. ``return_staging`` also returns the (world, world - 1, m,
    ...) pushes: ``staging[r][s]`` what rank r received at step s."""
    world = x.shape[0]
    m = _twoshot_rows(x, world)
    chunks = x.reshape(world, world, m, *x.shape[2:])
    staging = torch.empty((world, max(world - 1, 1), m, *x.shape[2:]),
                          dtype=x.dtype, device=x.device)
    for s in range(world - 1):
        for r in range(world):
            acc = chunks[r, (r - s - 1) % world].float()
            if s > 0:
                acc = acc + staging[r, s - 1].float()
            staging[(r + 1) % world, s] = acc.to(x.dtype)
    out = torch.empty_like(chunks[0])
    for r in range(world):
        out[r] = (chunks[r, r].float() + staging[r, world - 2].float()
                  ).to(x.dtype)
    out = out.reshape(x.shape[1:]).expand(x.shape).clone()
    return (out, staging) if return_staging else out


def twoshot_all_reduce_cuda(x: torch.Tensor, *, staging=None,
                            producer_delay_ns: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/twoshot_ar.cu`` on the current stream: ``x`` (world,
    M, ...) f32 or bf16, contiguous, M divisible by world. Returns ``(out,
    staging)``, staging (world, world - 1, M / world, ...) the ring's
    pushes as ``twoshot_all_reduce_ref`` gives them. ``staging`` and
    ``producer_delay_ns`` (the ring's first pushes sleep that long) let a
    test poison the slots and hold the ring back."""
    world = x.shape[0]
    _stacked("twoshot_all_reduce_cuda", x, world)
    if world < 2 or not x.is_cuda:
        raise ValueError("twoshot_all_reduce_cuda takes a CUDA tensor of "
                         "world >= 2 contributions")
    code = _build.dtype_code(x)
    if not x.is_contiguous():
        raise ValueError("twoshot_all_reduce_cuda takes a contiguous x")
    m = _twoshot_rows(x, world)
    shape = (world, world - 1, m, *x.shape[2:])
    if staging is None:
        staging = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif (tuple(staging.shape) != shape or staging.dtype != x.dtype
          or staging.device != x.device or not staging.is_contiguous()):
        raise ValueError(f"staging must be a contiguous {shape} {x.dtype} "
                         f"tensor on {x.device}")
    cn = x[0].numel() // world
    piece = _chunk(cn, cn // m, x.element_size())
    n_pieces = -(-cn // piece)
    rs_flags = _signal.flags(x.device, "twoshot_ar.rs",
                             world * (world - 1) * n_pieces)
    ag_flags = _signal.flags(x.device, "twoshot_ar.ag",
                             world * world * n_pieces)
    ticket = torch.empty(1, dtype=torch.int32, device=x.device)
    out = torch.empty_like(x)
    err = _build.lib().tdt_twoshot_ar(
        x.data_ptr(), staging.data_ptr(), out.data_ptr(),
        rs_flags.data_ptr(), ag_flags.data_ptr(), ticket.data_ptr(),
        _signal.next_epoch(x.device), world, cn, piece, code,
        producer_delay_ns, _build.stream_ptr(x))
    _build.check(err, "tdt_twoshot_ar")
    TWOSHOT_AR.launches += 1
    return out, staging


def twoshot_all_reduce(x_local: torch.Tensor, *,
                       world: int = 1) -> torch.Tensor:
    """Bandwidth-optimal all-reduce (ring reduce-scatter + ring allgather,
    JAX :253). At world 1 the identity (JAX :257); at world > 1 stacked in
    and out as ``oneshot_all_reduce``, with m divisible by world (JAX's
    ``ValueError`` otherwise)."""
    _check_world(world)
    if world == 1:
        return x_local
    _stacked("twoshot_all_reduce", x_local, world)
    _twoshot_rows(x_local, world)
    if x_local.is_cuda:
        return twoshot_all_reduce_cuda(x_local)[0]
    return twoshot_all_reduce_ref(x_local)


def all_reduce(x_stacked: torch.Tensor, *,
               method: AllReduceMethod | str = AllReduceMethod.AUTO
               ) -> torch.Tensor:
    """Standalone all-reduce (JAX :297): ``x_stacked`` (world, m, ...),
    rank r's contribution at index r; returns the reduced (m, ...). AUTO
    asks ``choose_all_reduce_method`` with one rank's bytes and m, by the
    figures of the card the tensor is on (a CPU tensor, which runs the
    plain versions, by the H100 SXM's, the card the kernels are built
    for)."""
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    world = x_stacked.shape[0]
    if isinstance(method, str):
        method = AllReduceMethod(method)
    if method is AllReduceMethod.AUTO:
        method = choose_all_reduce_method(
            world, x_stacked[0].numel() * x_stacked.element_size(),
            x_stacked.shape[1],
            hw=None if x_stacked.is_cuda else pm.H100_SXM)
    if world == 1:
        return x_stacked[0]
    run = (oneshot_all_reduce if method is AllReduceMethod.ONE_SHOT
           else twoshot_all_reduce)
    return run(x_stacked, world=world)[0]


def _check_world(world: int) -> None:
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")


def oneshot_ar_loopback_ref(x: torch.Tensor, *,
                            world: int = 8) -> torch.Tensor:
    """Plain version, in the kernel's order and rounding: the own buffer in
    f32, then ``+=`` each of the world - 1 staged copies in rank order, then
    one cast (``common.reduce_slots_tiled`` with me = 0)."""
    _check_world(world)
    own = x.float()
    acc = own.clone()
    for _ in range(world - 1):
        acc += own
    return acc.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LoopbackPlan:
    """The launch geometry of ``oneshot_ar_loopback_cuda`` for one shape,
    dtype, device and world: the elements, the chunk and chunks
    (``oneshot_ar_plan`` in units of LOOPBACK_CHUNK_BYTES), the staging's
    shape, the persistent grid (one occupancy query) and the flags (world
    - 1 a chunk)."""

    n: int
    chunk: int
    n_chunks: int
    staging_shape: tuple
    blocks: int
    n_flags: int


_LOOPBACK_PLANS: dict[tuple, LoopbackPlan] = {}


def loopback_plan(x: torch.Tensor, world: int) -> LoopbackPlan:
    """The cached plan of a call on ``x`` at ``world``, made on first use:
    the checks of the shape and dtype and one occupancy query."""
    key = (x.shape, x.dtype, x.device, world)
    plan = _LOOPBACK_PLANS.get(key)
    if plan is None:
        _check_world(world)
        code = _build.dtype_code(x)
        if x.dim() < 1 or x.numel() == 0:
            raise ValueError("oneshot_ar_loopback_cuda takes a non-empty "
                             f"(m, ...) tensor, got {tuple(x.shape)}")
        n = x.numel()
        chunk, n_chunks = oneshot_ar_plan(n, x.element_size(),
                                          LOOPBACK_CHUNK_BYTES)
        blocks = _build.persistent_blocks("tdt_oneshot_ar_loopback_blocks",
                                          x.device, n_chunks, world, code)
        plan = _LOOPBACK_PLANS[key] = LoopbackPlan(
            n, chunk, n_chunks, (world - 1, *x.shape), blocks,
            n_chunks * (world - 1))
    return plan


def loopback_staging(x: torch.Tensor, world: int,
                     stream: int) -> torch.Tensor:
    """The loopback's default staging for ``x``: a (world - 1, *x.shape)
    view of the stream's persistent scratch (``runtime/symm.py``
    ``get_scratch``, grown to the largest call), so a call allocates none;
    its contents are the last call's pushes. The view is kept per shape on
    the scratch itself (``views``)."""
    ws = symm.get_scratch("oneshot_ar_loopback.staging", x.numel(), x.dtype,
                          world=world - 1, device=x.device, stream=stream)
    view = ws.views.get(x.shape)
    if view is None:
        view = ws.views[x.shape] = ws.array.view(-1)[
            :(world - 1) * x.numel()].view(world - 1, *x.shape)
    return view


def oneshot_ar_loopback_cuda(x: torch.Tensor, *, world: int = 8,
                             staging: torch.Tensor | None = None,
                             producer_delay_ns: int = 0) -> torch.Tensor:
    """Launch ``csrc/oneshot_ar_loopback.cu`` on the current stream (f32 or
    bf16, any trailing shape). ``staging`` (default: the stream's
    persistent scratch, ``loopback_staging``) and ``producer_delay_ns``
    (every push sleeps that long before its copy) let a test poison the
    slots and hold the pushes back; the result must not change. A call
    allocates only its output and makes one device operation: the plan is
    cached (``loopback_plan``), and the ticket and flags are arrival cells
    the kernel leaves at 0."""
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("oneshot_ar_loopback_cuda takes a contiguous CUDA "
                         "tensor")
    plan = loopback_plan(x, world)
    stream = _build.stream_ptr(x)
    if world == 1:
        st = None
    elif staging is None:
        st = loopback_staging(x, world, stream).data_ptr()
    elif (staging.shape != plan.staging_shape or staging.dtype != x.dtype
          or staging.device != x.device or not staging.is_contiguous()):
        raise ValueError(f"staging must be a contiguous "
                         f"{plan.staging_shape} {x.dtype} tensor on "
                         f"{x.device}")
    else:
        st = staging.data_ptr()
    out = torch.empty_like(x)
    # Cell 0 the ticket, cells 1 .. the flags.
    cells = _signal.arrivals(x.device, ONESHOT_AR_LOOPBACK.name,
                             1 + plan.n_flags, stream).data_ptr()
    err = _build.lib().tdt_oneshot_ar_loopback(
        x.data_ptr(), st, out.data_ptr(), cells + 4, cells, plan.n,
        plan.chunk, plan.n_chunks, world, plan.blocks,
        _build.DTYPE_CODES[x.dtype], producer_delay_ns, stream)
    _build.check(err, "tdt_oneshot_ar_loopback")
    ONESHOT_AR_LOOPBACK.launches += 1
    return out


def oneshot_ar_loopback(x: torch.Tensor, *, world: int = 8) -> torch.Tensor:
    """One-chip SELF-LOOPBACK one-shot all-reduce (JAX :174): the staging
    pushes, per-source arrival waits and fixed-order f32 fold of
    ``oneshot_all_reduce``, with every slot carrying this card's own buffer,
    so the result is ``world * x``. A CUDA tensor runs the kernel, a CPU
    tensor the plain version."""
    if x.is_cuda:
        return oneshot_ar_loopback_cuda(x, world=world)
    return oneshot_ar_loopback_ref(x, world=world)
