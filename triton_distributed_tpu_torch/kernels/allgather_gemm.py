"""Single-card matmul (the world-1 path of AG-GEMM) and the one-chip
AG-GEMM overlap path.

Counterpart of ``triton_distributed_tpu/kernels/allgather_gemm.py``. At
world 1 its ``ag_gemm_device`` is ``ag_gemm_single_chip`` (:399), whose
Pallas ``_matmul_kernel`` (:733) carries every projection with M >= 64;
below that the JAX package hands the product to XLA (:826-828) and the port
hands it to ``torch.matmul``. The JAX package's other XLA delegations
(ragged blocks, the VMEM budget, :833-848) follow from Mosaic's tiling and
do not carry over: ``csrc/matmul.cu`` masks ragged edges itself.

The one-chip overlap entry points (``ag_gemm_loopback`` :543,
``ag_gemm_segmented_bare`` :631, their tail ``matmul_tail_into`` :232 and
``fused_matmul_step`` :892) run on ``csrc/ag_gemm_loopback.cu``,
``csrc/matmul_tail_into.cu`` and ``csrc/fused_step.cu``: in the loopback
the first work items of one persistent kernel stage A chunk by chunk (bulk
copies) and raise a flag per chunk, and its consumer tiles (``wgmma``, fed
by TMA, where TMA can read the rows) wait on the flags
(``ag_loopback_items`` lists them in ticket order). Those kernels take
bf16 operands; on the CPU each entry point runs the plain versions.
Mosaic's VMEM arithmetic (``_split_blocks`` :151, ``_overlap_vmem``,
``_OVERLAP_VMEM_CAP``) does not carry over: the CUDA tiles are fixed and
mask ragged edges.

At world > 1 the ranks are simulated on one card (``runtime/mesh.py``):
``ag_gemm_device`` takes every rank's A shard and B shard stacked, a
(world, m, K) and b (world, K, n_local), and returns every rank's product
(world, world * m, n_local) on ``csrc/ag_gemm.cu`` (``_ag_gemm_kernel``
:304): the shards bulk-copied into each rank's staging, flagged chunk by
chunk, and each rank's ``wgmma`` tiles (TMA from the staging) waiting on
the rows they read, in the rank's segment order; a bf16 call needs
16-byte aligned operands and K and n in multiples of 8 (TMA), f32 takes
any shape. The columns past ``overlap_cols`` run in
``matmul_tail_into`` over each rank's gathered A (:478-480). One card
stands in for the group: the gather goes through device memory, not
NVLink. The host wrapper ``ag_gemm`` (:979) takes JAX's global shapes.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal
from triton_distributed_tpu_torch.runtime.mesh import World

MATMUL = _build.register(
    "matmul", "triton_distributed_tpu_torch/csrc/matmul.cu",
    "triton_distributed_tpu/kernels/allgather_gemm.py:733")
FUSED_STEP = _build.register(
    "fused_step", "triton_distributed_tpu_torch/csrc/fused_step.cu",
    "triton_distributed_tpu/kernels/allgather_gemm.py:875")
TAIL_INTO = _build.register(
    "matmul_tail_into",
    "triton_distributed_tpu_torch/csrc/matmul_tail_into.cu",
    "triton_distributed_tpu/kernels/allgather_gemm.py:206")
# One kernel for both loopback arms: staged (:484) and bare (:600).
AG_LOOPBACK = _build.register(
    "ag_gemm_loopback",
    "triton_distributed_tpu_torch/csrc/ag_gemm_loopback.cu",
    "triton_distributed_tpu/kernels/allgather_gemm.py:484")
AG_GEMM = _build.register(
    "ag_gemm", "triton_distributed_tpu_torch/csrc/ag_gemm.cu",
    "triton_distributed_tpu/kernels/allgather_gemm.py:304")

# Output tile width of the CUDA GEMM tiles (csrc/gemm_tile.cuh BN).
TILE_N = 128
# Rows of A one producer item of the loopback copies (fewer where a segment
# has fewer): 16 rows of 5,120 bf16 are 160 KB, so at bench.py's shape 256
# items copy in parallel on the first wave of blocks.
STAGE_CHUNK_ROWS = 16

# Below this many rows the product is a weight-streaming GEMV, left to the
# library as the JAX package leaves it to XLA.
SMALL_M = 64

# The warp-specialised GEMM's tile rows (csrc/gemm_ws.cuh BM).
WS_TILE_M = 128


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(M, K) x (K, N)`` in f32, cast to the promoted
    input dtype."""
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/matmul.cu`` on CUDA tensors: f32 accumulation, output
    in the inputs' dtype (bf16 or fp32; both operands the same dtype). bf16
    whose operands TMA can read (``_build.tma_rows``, K > 0) runs the
    warp-specialised ``wgmma`` GEMM (``csrc/gemm_ws.cuh``, its tile from
    ``matmul_tile``), other bf16 the ``mma.sync`` tile, f32 the SIMT tile:
    one launch, chosen before it."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("matmul_cuda takes two tensors on one CUDA device")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul operands differ in dtype: {a.dtype} vs "
                        f"{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda takes row-major contiguous operands")
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return c
    code = _build.dtype_code(a)
    tma = (_build.tma_rows((K, N), a, b, c)
           if a.dtype == torch.bfloat16 and K > 0 else 0)
    err = _build.lib().tdt_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, code, tma,
        _build.stream_ptr(a))
    _build.check(err, "tdt_matmul")
    MATMUL.launches += 1
    return c


def matmul_tile(M: int, N: int, sms: int) -> tuple[int, int]:
    """The warp-specialised GEMM's tile for an (M, N) output on a card of
    ``sms`` SMs (``csrc/gemm_ws.cuh`` ``tile_n``): 128 x 256 where those
    tiles give every SM one at least, else 128 x 128."""
    wide = -(-M // WS_TILE_M) * -(-N // 256)
    return WS_TILE_M, (256 if wide >= sms else 128)


def ag_gemm_single_chip(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) x (K, N) -> (M, N)`` with f32 accumulation.

    M < 64 goes to ``torch.matmul`` (as the JAX package gives it to XLA).
    Otherwise a CUDA tensor goes to the matmul kernel and a CPU tensor to
    ``matmul_ref``."""
    if a.shape[0] < SMALL_M:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
        return torch.matmul(a.to(out_dtype), b.to(out_dtype))
    if a.is_cuda:
        return matmul_cuda(a, b)
    return matmul_ref(a, b)


def ag_gemm_device(a_local: torch.Tensor, b_local: torch.Tensor, *,
                   world: int = 1,
                   config: "AGGEMMConfig | None" = None) -> torch.Tensor:
    """AG-GEMM: the allgather of A overlapped into the matmul (JAX :368).

    At world 1 ``(m, K) x (K, n_local) -> (m, n_local)``: the single-card
    matmul, ``config`` unused (as in JAX). At world > 1 every rank's shards
    stacked: a (world, m, K), b (world, K, n_local) -> (world, world * m,
    n_local), rank d's product of the gathered A (rows in absolute rank
    order) against b[d]. The kernel on CUDA tensors (f32 or bf16, one
    dtype), the plain version on CPU ones; columns past ``overlap_cols``
    (``_resolve_overlap_cols``) in ``matmul_tail_into`` per rank."""
    if world == 1:
        if a_local.shape[1] != b_local.shape[0]:
            raise ValueError(f"K mismatch: A has {a_local.shape[1]}, B has "
                             f"{b_local.shape[0]}")
        return ag_gemm_single_chip(a_local, b_local)
    if (a_local.dim() != 3 or b_local.dim() != 3
            or a_local.shape[0] != world or b_local.shape[0] != world):
        raise ValueError(f"ag_gemm_device at world {world} takes stacked "
                         f"a (world, m, K) and b (world, K, n_local), got "
                         f"{tuple(a_local.shape)} and {tuple(b_local.shape)}")
    _, m, k = a_local.shape
    _, k2, n = b_local.shape
    if k != k2:
        raise ValueError(f"K mismatch: A has {k}, B has {k2}")
    config, _ = _split_blocks(config or AGGEMMConfig(), n)
    config.n_tiles(n)  # divisibility check
    cols = _resolve_overlap_cols(config, n)
    if a_local.is_cuda:
        out1, staged = ag_gemm_cuda(a_local, b_local, cols=cols)
    else:
        out1, staged = ag_gemm_ref(a_local, b_local, cols=cols)
    if cols == n:
        return out1
    return torch.stack([
        matmul_tail_into(out1[r], staged[r].reshape(world * m, k),
                         b_local[r], cols) for r in range(world)])


def ag_gemm_ref(a: torch.Tensor, b: torch.Tensor, *,
                cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the multi-rank kernel: ``(out1, staged)``, staged
    (world, world, m, K) every rank's gathered A (``staged[d][src] =
    a[src]``) and out1[d] = staged[d] @ b[d][:, :cols] in f32, cast to the
    promoted dtype."""
    world, m, k = a.shape
    staged = a.reshape(1, world * m, k).expand(world, -1, -1)
    out1 = matmul_ref(staged, b[:, :, :cols])
    return out1, staged.reshape(world, world, m, k).clone()


def ag_gemm_cuda(a: torch.Tensor, b: torch.Tensor, *, cols: int,
                 staging: torch.Tensor | None = None,
                 producer_delay_ns: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ag_gemm.cu`` on the current stream: a (world, m, K),
    b (world, K, n), one dtype (f32 or bf16), contiguous. Returns ``(out1,
    staging)``: out1 (world, world m, cols), staging (world, world, m, K)
    every rank's gathered A. ``staging`` (default: a new buffer) and
    ``producer_delay_ns`` (every producer item sleeps that long before its
    copy) let a test poison the buffer and hold the gather back. bf16 runs
    the ``wgmma`` tile where TMA can read every operand (``_build.tma_rows``)
    and the ``mma.sync`` tile otherwise, in the same one launch."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("ag_gemm_cuda takes two tensors on one CUDA device")
    if a.dtype != b.dtype:
        raise TypeError(f"ag_gemm operands differ in dtype: {a.dtype} vs "
                        f"{b.dtype}")
    code = _build.dtype_code(a)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ag_gemm_cuda takes row-major contiguous operands")
    world, m, k = a.shape
    n = b.shape[2]
    if world < 2 or tuple(b.shape[:2]) != (world, k) or not 0 < cols <= n:
        raise ValueError(f"ag_gemm_cuda shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}, cols {cols}")
    shape = (world, world, m, k)
    if staging is None:
        staging = torch.empty(shape, dtype=a.dtype, device=a.device)
    elif (tuple(staging.shape) != shape or staging.dtype != a.dtype
          or staging.device != a.device or not staging.is_contiguous()):
        raise ValueError(f"staging must be a contiguous {shape} {a.dtype} "
                         f"tensor on {a.device}")
    tma = (_build.tma_rows((k, n), a, b, staging)
           if a.dtype == torch.bfloat16 else 0)
    chunk_rows = min(m, STAGE_CHUNK_ROWS)
    flags = _signal.flags(a.device, "ag_gemm",
                          world * world * -(-m // chunk_rows))
    ticket = torch.empty(1, dtype=torch.int32, device=a.device)
    out = torch.empty((world, world * m, cols), dtype=a.dtype,
                      device=a.device)
    err = _build.lib().tdt_ag_gemm(
        a.data_ptr(), staging.data_ptr(), b.data_ptr(), out.data_ptr(),
        flags.data_ptr(), ticket.data_ptr(), _signal.next_epoch(a.device),
        world, m, k, n, cols, chunk_rows, code, tma, producer_delay_ns,
        _build.stream_ptr(a))
    _build.check(err, "tdt_ag_gemm")
    AG_GEMM.launches += 1
    return out, staging


def ag_gemm(a: torch.Tensor, b: torch.Tensor, *, world: int,
            config: "AGGEMMConfig | None" = None) -> torch.Tensor:
    """Standalone AG-GEMM over ``world`` simulated ranks (JAX :979): a
    global (M, K) sharded on M, b global (K, N) sharded on N; returns the
    global (M, N) = a @ b, sharded on N."""
    w = World(world)
    if world == 1:
        return ag_gemm_device(a, b)
    out = ag_gemm_device(w.split(a, 0), w.split(b, 1), world=world,
                         config=config)
    return w.join(out, 1)


# ---------------------------------------------------------------------------
# The one-chip AG-GEMM overlap path.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AGGEMMConfig:
    """Column split of AG-GEMM, the one-chip loopback and the multi-rank
    kernel alike (JAX ``AGGEMMConfig`` :57).

    ``block_n`` is the column granularity of the split: ``n`` and
    ``overlap_cols`` must be multiples of it. ``None`` resolves to the CUDA
    tile's width (``TILE_N``) when it divides ``n``, else to ``n``.
    ``overlap_cols`` is the width the segment-ordered consumer computes
    while the copies land; the remaining columns run in ``matmul_tail_into``
    over the staged A. ``None`` sizes it automatically
    (``_auto_overlap_cols``)."""

    block_n: int | None = None
    overlap_cols: int | None = None

    def n_tiles(self, n_local: int) -> int:
        if self.block_n is None or n_local % self.block_n:
            raise ValueError(
                f"n_local {n_local} not divisible by block_n {self.block_n}")
        return n_local // self.block_n

    def resolve(self, n_local: int) -> "AGGEMMConfig":
        if self.block_n is not None:
            return self
        bn = TILE_N if n_local % TILE_N == 0 else n_local
        return AGGEMMConfig(block_n=bn, overlap_cols=self.overlap_cols)


def _auto_overlap_cols(n_local: int) -> int:
    """Consumer width when the config leaves it open (JAX :103): all of
    ``n_local``, no tail. The TPU rule sizes the overlap kernel just wide
    enough to hide the gather, because its sequential grid runs the tail at
    a better block; on the card a narrow consumer is a fraction of a wave
    (128 columns at M = 4,096 are 32 tiles on 132 SMs) and the tail cannot
    start before it ends. Measured at bench.py's shape on an H100 (PERF.md,
    ``chip_smoke.py`` phase 5's sweep): 3,200 columns 0.697 ms, 1,280 0.705,
    640 0.719, 128 0.749. The multi-rank kernel keeps the rule: its
    consumer is the same tile grid, and on one card its gather is a copy
    through device memory, as the loopback's is."""
    return n_local


def _split_blocks(config: AGGEMMConfig, n: int
                  ) -> tuple[AGGEMMConfig, int]:
    """The overlap kernel's and the tail's column blocks (JAX :151). An
    explicit ``block_n`` serves both, as in JAX; otherwise both are the
    CUDA tile's width when it divides ``n``, else ``n``. Mosaic's VMEM
    arithmetic, which made JAX's two differ, does not carry over."""
    config = config.resolve(n)
    return config, config.block_n


def _resolve_overlap_cols(config: AGGEMMConfig, n: int) -> int:
    """``config.overlap_cols`` when given, else ``_auto_overlap_cols``;
    validated against the resolved ``block_n`` (JAX :183)."""
    bn = config.block_n
    cols = config.overlap_cols
    if cols is None:
        cols = _auto_overlap_cols(n)
    if cols <= 0 or cols % bn or cols > n:
        raise ValueError(f"overlap_cols {cols} must be a positive multiple "
                         f"of block_n {bn} and <= {n}")
    return cols


def _split(a: torch.Tensor, b: torch.Tensor, segments: int,
           config: AGGEMMConfig | None) -> int:
    """Validate a loopback call and return its ``overlap_cols``."""
    M, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"K mismatch: A has {k}, B has {k2}")
    if segments < 1 or M % segments:
        raise ValueError(f"M {M} not divisible by segments {segments}")
    config = (config or AGGEMMConfig()).resolve(n)
    config.n_tiles(n)  # divisibility check
    return _resolve_overlap_cols(config, n)


def _check_bf16_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} takes tensors on one CUDA device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16 operands, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes row-major contiguous operands")


def ag_gemm_loopback_ref(a: torch.Tensor, b: torch.Tensor, *,
                         cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the staged consumer: the staged A (a copy of ``a``,
    segments in order) and ``staged @ b[:, :cols]`` in f32, cast to the
    promoted dtype."""
    staged = a.clone()
    return matmul_ref(staged, b[:, :cols]), staged


def segmented_bare_ref(a: torch.Tensor, b: torch.Tensor, *,
                       cols: int) -> torch.Tensor:
    """Plain version of the bare consumer: ``a @ b[:, :cols]``."""
    return matmul_ref(a, b[:, :cols])


def loopback_chunk_rows(M: int, segments: int) -> int:
    """Rows of one producer item of the loopback: gcd(M / segments,
    STAGE_CHUNK_ROWS), so that no chunk straddles a segment."""
    return math.gcd(M // segments, STAGE_CHUNK_ROWS)


def loopback_tile(M: int, cols: int) -> tuple[int, int]:
    """The loopback's ``wgmma`` tile (rows, columns) for an (M, cols)
    output (``csrc/ag_gemm.cuh`` ``tile_m``, ``tile_n``): 96 columns where
    they cover cols with fewer masked columns than 128, then 256 rows over
    more than 128; else 128 x 128. Rows TMA cannot read take the
    ``mma.sync`` tile's 128 x 128."""
    bn = 96 if cols % 96 == 0 and cols % 128 else 128
    return (256 if bn == 96 and M > 128 else 128), bn


def ag_loopback_items(M: int, cols: int, segments: int, *,
                      staged: bool = True) -> list[tuple]:
    """The loopback kernel's work items in ticket order (``csrc/ag_gemm.cuh``
    ``run_items`` at world 1 with one expert): ``("produce", c, r0, r1)``
    copies rows [r0, r1) of A into the staging and then raises flag c;
    ``("tile", m0, n0, waits)`` is the output tile at rows m0 and columns
    n0 (``loopback_tile``'s shape; masked at M and cols), whose thread 0
    first acquires the flags ``waits`` (the chunks its rows touch; none
    when bare). Every producer first, in segment order, then the tiles row
    tile by row tile (segment order), each row tile's column tiles in a
    row. The bare variant has no producers."""
    chunk = loopback_chunk_rows(M, segments)
    bm, bn = loopback_tile(M, cols)
    items = [("produce", c, c * chunk, (c + 1) * chunk)
             for c in range(M // chunk)] if staged else []
    for m0 in range(0, M, bm):
        waits = (tuple(range(m0 // chunk, (min(m0 + bm, M) - 1) // chunk + 1))
                 if staged else ())
        items += [("tile", m0, n0, waits) for n0 in range(0, cols, bn)]
    return items


def _ag_launch(a: torch.Tensor, b: torch.Tensor, *, segments: int,
               cols: int, staging: torch.Tensor | None,
               producer_delay_ns: int = 0) -> torch.Tensor:
    """Launch ``csrc/ag_gemm_loopback.cu`` on the current stream, staged
    (``staging`` given) or bare: one device operation, the kernel (its
    ticket is the stream's persistent one, left at 0 by the kernel). bf16
    runs the ``wgmma`` tile where TMA can read every operand
    (``_build.tma_rows``) and the ``mma.sync`` tile otherwise, in the same
    one launch."""
    _check_bf16_cuda("ag_gemm_loopback_cuda", a, b)
    M, K = a.shape
    n = b.shape[1]
    if b.shape[0] != K or not 0 < cols <= n or segments < 1 \
            or M % segments or K == 0:
        raise ValueError(f"loopback shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}, cols {cols}, segments "
                         f"{segments}")
    out = torch.empty((M, cols), dtype=a.dtype, device=a.device)
    chunk_rows = loopback_chunk_rows(M, segments)
    stream = _build.stream_ptr(a)
    flags = _signal.flags(a.device, AG_LOOPBACK.name, M // chunk_rows,
                          stream)
    ticket = _signal.arrivals(a.device, AG_LOOPBACK.name, 1, stream)
    read = (a, b) if staging is None else (a, b, staging)
    err = _build.lib().tdt_ag_gemm_loopback(
        a.data_ptr(), None if staging is None else staging.data_ptr(),
        b.data_ptr(), out.data_ptr(), flags.data_ptr(), ticket.data_ptr(),
        _signal.next_epoch(a.device), M, cols, n, K, chunk_rows,
        _build.tma_rows((K, n), *read), producer_delay_ns, stream)
    _build.check(err, "tdt_ag_gemm_loopback")
    AG_LOOPBACK.launches += 1
    return out


def ag_gemm_loopback_cuda(a: torch.Tensor, b: torch.Tensor, *, segments: int,
                          cols: int, staging: torch.Tensor | None = None,
                          producer_delay_ns: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The staged loopback on the card, one launch: returns ``(a @ b[:,
    :cols], staged A)``. The kernel's first work items copy A into the
    staging buffer chunk by chunk and raise a flag per chunk; its consumer
    tiles wait on the flags of the rows they read. ``staging`` (default: a
    new buffer) and ``producer_delay_ns`` (every producer item sleeps that
    long before its copy) let a test poison the buffer and hold the
    producers back; a delay past the waits' bound (about a second) makes
    the launch trap."""
    if staging is None:
        staging = torch.empty_like(a)
    elif (staging.shape != a.shape or staging.dtype != a.dtype
          or staging.device != a.device or not staging.is_contiguous()):
        raise ValueError("staging must be a contiguous twin of A")
    out1 = _ag_launch(a, b, segments=segments, cols=cols, staging=staging,
                      producer_delay_ns=producer_delay_ns)
    return out1, staging


def ag_gemm_segmented_bare_cuda(a: torch.Tensor, b: torch.Tensor, *,
                                segments: int, cols: int) -> torch.Tensor:
    """The bare variant on the card: the same persistent grid, ticket order
    and tiles over A itself, with no staging, producer items or waits."""
    return _ag_launch(a, b, segments=segments, cols=cols, staging=None)


def ag_gemm_loopback(a: torch.Tensor, b: torch.Tensor, *, segments: int = 8,
                     config: AGGEMMConfig | None = None) -> torch.Tensor:
    """One-chip self-loopback AG-GEMM ``(M, K) x (K, n) -> (M, n)`` (JAX
    :543): A staged chunk by chunk, in segment order, into a buffer that
    stands in for the gathered A, a consumer that waits on the arrival
    flags of the rows it reads on first touch and computes the first
    ``overlap_cols`` columns in segment order, and ``matmul_tail_into`` for
    the rest over the staged A. Against the bare matmul it measures what
    the staging machinery costs."""
    cols = _split(a, b, segments, config)
    if a.is_cuda:
        out1, staged = ag_gemm_loopback_cuda(a, b, segments=segments,
                                             cols=cols)
    else:
        out1, staged = ag_gemm_loopback_ref(a, b, cols=cols)
    if cols == b.shape[1]:
        return out1
    return matmul_tail_into(out1, staged, b, cols)


def ag_gemm_segmented_bare(a: torch.Tensor, b: torch.Tensor, *,
                           segments: int = 8,
                           config: AGGEMMConfig | None = None
                           ) -> torch.Tensor:
    """The loopback's consumer structure without the staging (JAX :631):
    the same segment-ordered grid and tiles over ``overlap_cols`` and the
    same tail, reading A straight from the input. bare -> segmented bare is
    the grid-structure cost; segmented bare -> loopback the staging
    machinery's."""
    cols = _split(a, b, segments, config)
    if a.is_cuda:
        out1 = ag_gemm_segmented_bare_cuda(a, b, segments=segments,
                                           cols=cols)
    else:
        out1 = segmented_bare_ref(a, b, cols=cols)
    if cols == b.shape[1]:
        return out1
    return matmul_tail_into(out1, a, b, cols)


def matmul_tail_into_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         col_start: int) -> torch.Tensor:
    """Plain version: ``[c | a @ b[:, col_start:]]``, the product in f32
    cast to ``c``'s dtype."""
    tail = torch.matmul(a.float(), b[:, col_start:].float()).to(c.dtype)
    return torch.cat([c, tail], dim=1)


def matmul_tail_into_cuda(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          col_start: int) -> torch.Tensor:
    """Launch ``csrc/matmul_tail_into.cu`` (bf16) on the current stream."""
    _check_bf16_cuda("matmul_tail_into_cuda", c, a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=c.dtype, device=c.device)
    if m == 0:
        return out
    err = _build.lib().tdt_matmul_tail_into(
        c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        col_start, _build.stream_ptr(a))
    _build.check(err, "tdt_matmul_tail_into")
    TAIL_INTO.launches += 1
    return out


def matmul_tail_into(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     col_start: int) -> torch.Tensor:
    """The split's assembly in one pass (JAX :232): the full ``(m, n)``
    product whose columns ``[0, col_start)`` are ``c`` and whose rest is
    ``a @ b[:, col_start:]``, in ``c``'s dtype."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"K mismatch: A has {k}, B has {k2}")
    if not 0 <= col_start <= n or tuple(c.shape) != (m, col_start):
        raise ValueError(f"c {tuple(c.shape)} != ({m}, {col_start}) with "
                         f"col_start in [0, {n}]")
    if a.is_cuda:
        return matmul_tail_into_cuda(c, a, b, col_start)
    return matmul_tail_into_ref(c, a, b, col_start)


def _scalar_bf16(s, dtype: torch.dtype) -> torch.Tensor:
    """``s`` (None = 0) as an f32 scalar cast to ``dtype``, as the TPU
    kernel's ``s_ref[0].astype(b_ref.dtype)``."""
    if s is None:
        s = 0.0
    return torch.as_tensor(s, dtype=torch.float32).reshape(()).to(dtype)


def fused_matmul_step_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          s=None) -> torch.Tensor:
    """Plain version: ``c + a @ (b + s)`` in f32, ``b + s`` rounded in b's
    dtype. Returns a new tensor."""
    bb = b + _scalar_bf16(s, b.dtype).to(b.device)
    return c.float() + torch.matmul(a.float(), bb.float())


def fused_step_cuda(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    s=None) -> torch.Tensor:
    """Launch ``csrc/fused_step.cu`` on the current stream: ``out += a @
    (b + s)`` with ``out`` a contiguous f32 CUDA tensor, ``a``, ``b`` bf16.
    ``s`` may be None, a number, or a one-element CUDA tensor (read on the
    card: no host synchronisation)."""
    _check_bf16_cuda("fused_step_cuda", a, b)
    if (out.dtype != torch.float32 or not out.is_contiguous()
            or out.device != a.device):
        raise ValueError("fused_step_cuda: the accumulator must be a "
                         "contiguous f32 tensor on the operands' device")
    m, k = a.shape
    n = b.shape[1]
    s_ptr, s_val = None, 0.0
    if isinstance(s, torch.Tensor):
        if s.device != a.device or s.numel() != 1:
            raise ValueError("fused_step_cuda: s must be a one-element "
                             "tensor on the operands' device")
        s = s.reshape(1).float().contiguous()
        s_ptr = s.data_ptr()
    elif s is not None:
        s_val = float(s)
    if m == 0 or n == 0:
        return out
    err = _build.lib().tdt_fused_step(
        out.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), s_ptr,
        s_val, m, n, k, _build.stream_ptr(a))
    _build.check(err, "tdt_fused_step")
    FUSED_STEP.launches += 1
    return out


def fused_matmul_step(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      s=None) -> torch.Tensor:
    """One fused accumulate step ``c + a @ (b + s)`` in f32 (JAX :892),
    ``s`` a scalar (None = 0) cast to b's dtype before the add. ``c`` is
    updated in place and returned when it is a contiguous f32 tensor (the
    TPU call's ``input_output_aliases={1: 0}``); otherwise the result is a
    converted copy, as JAX's ``c.astype(f32)`` is. The JAX version's block
    sizes are Mosaic's; the CUDA tiles are fixed."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"K mismatch: A has {k}, B has {k2}")
    if tuple(c.shape) != (m, n):
        raise ValueError(f"c {tuple(c.shape)} != ({m}, {n})")
    out = c if c.dtype == torch.float32 and c.is_contiguous() else \
        c.float().contiguous()
    if a.is_cuda:
        return fused_step_cuda(out, a, b, s)
    return out.copy_(fused_matmul_step_ref(out, a, b, s))
