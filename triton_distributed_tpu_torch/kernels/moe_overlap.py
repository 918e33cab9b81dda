"""MoE tensor parallelism with the communication fused into the expert
GEMMs: AG-GroupGEMM and GroupGEMM-RS over simulated ranks.

Counterpart of ``triton_distributed_tpu/kernels/moe_overlap.py``. Tokens
are sharded over the ranks, every expert's weights on f (column-parallel
up, row-parallel down). Each rank routes its tokens into an (E, capacity,
d) grid; ``ag_group_gemm_device`` (:144) gathers every rank's grid and
multiplies it by the rank's f shard of each expert, and
``group_gemm_rs_device`` (:346) multiplies the activations by the rank's
down shard and reduce-scatters the partials back to the rows' owners;
``ag_moe_mlp_device`` (:436) chains route -> up -> activation -> down ->
combine.

At world 1 the two GEMMs are the einsums of JAX :176-182 and :368-370
(torch ops, as the JAX package leaves them to XLA). At world > 1 the ranks
are simulated on one card and every argument is a rank stack (index r of
the leading dimension is rank r's shard): the routing of every rank runs in
one call (``moe_utils.route_rank_stack``), and the GEMMs run on
``csrc/ag_group_gemm.cu`` (``_ag_group_gemm_kernel`` :85) and
``csrc/group_gemm_rs.cu`` (``_group_gemm_rs_kernel`` :268), the
multi-rank AG-GEMM and GEMM-RS (``ag_gemm.cu``, ``gemm_rs.cu``) with an
expert dimension. One card stands in for the group: the gather and the
pushes go through device memory, not NVLink. The 2-D variants
(``*_2d_device``) raise: their inter-slice leg cannot be checked on one
card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from triton_distributed_tpu_torch.kernels import _build, _signal
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    F32_TILE,
    TILE_M,
    gemm_rs_fold,
    rs_plan,
)
from triton_distributed_tpu_torch.kernels.moe_utils import (
    combine_from_experts,
    route_rank_stack,
    route_to_experts,
)

AG_GROUP_GEMM = _build.register(
    "ag_group_gemm", "triton_distributed_tpu_torch/csrc/ag_group_gemm.cu",
    "triton_distributed_tpu/kernels/moe_overlap.py:85")
GROUP_GEMM_RS = _build.register(
    "group_gemm_rs", "triton_distributed_tpu_torch/csrc/group_gemm_rs.cu",
    "triton_distributed_tpu/kernels/moe_overlap.py:268")

# Bytes of grid one producer item of the AG-GroupGEMM copies
# (``producer_chunk``): whole experts while they fit, else rows of one
# expert. At Qwen3-30B-A3B's decode (cap 8, d 2,048, bf16) two experts, at
# its prefill (cap 128) 16 rows of one expert, so a tile's rows arrive
# from several items running at once (measured no slower than whole
# experts of 128 rows: scripts/torch_ag_group_gemm_breakdown.py).
CHUNK_BYTES = 65536


def producer_chunk(cap: int, d: int, itemsize: int) -> tuple[int, int]:
    """``(experts, rows)`` of one AG-GroupGEMM producer item: whole experts
    (at least one) when one expert's (cap, d) grid fits ``CHUNK_BYTES``,
    else ``CHUNK_BYTES`` of rows of one expert."""
    grid = cap * d * itemsize
    if grid <= CHUNK_BYTES:
        return CHUNK_BYTES // grid, cap
    return 1, max(1, CHUNK_BYTES // (d * itemsize))


@dataclasses.dataclass(frozen=True)
class MoEOverlapConfig:
    """Tile configuration of the JAX kernels (:61): ``block_f`` tiles
    f_local in the up GEMM, ``block_d`` d in the down GEMM, ``block_k`` the
    contraction. The CUDA tiles are fixed (AG-GroupGEMM: a 256 x 96, 128 x
    96 or 128 x 128 ``wgmma`` tile in bf16, 64 x 64 in f32; GroupGEMM-RS:
    128 x 128 bf16) and mask ragged edges, so the config only validates, as
    ``GEMMRSConfig`` does: a dim that its block does not divide raises
    JAX's ``ValueError``."""

    block_f: int = 256
    block_d: int = 256
    block_k: int = 512

    @staticmethod
    def tiles(dim: int, block: int) -> tuple[int, int]:
        b = min(block, dim)
        if dim % b:
            raise ValueError(f"dim {dim} not divisible by block {b}")
        return dim // b, b


def _cuda_operands(name: str, *ts: torch.Tensor) -> int:
    """The dtype code of CUDA operands of one dtype (f32 or bf16) on one
    device, contiguous; raises otherwise."""
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError(f"{name} takes tensors on one CUDA device")
    if len({t.dtype for t in ts}) != 1:
        raise TypeError(f"{name} operands differ in dtype: "
                        f"{[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous operands")
    return _build.dtype_code(ts[0])


def _staging(name: str, staging, shape, like: torch.Tensor) -> torch.Tensor:
    if staging is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if (tuple(staging.shape) != tuple(shape) or staging.dtype != like.dtype
            or staging.device != like.device
            or not staging.is_contiguous()):
        raise ValueError(f"{name}: staging must be a contiguous "
                         f"{tuple(shape)} {like.dtype} tensor on "
                         f"{like.device}")
    return staging


# -- AG-GroupGEMM -------------------------------------------------------------

def ag_group_gemm_ref(grids: torch.Tensor, w_up: torch.Tensor, *,
                      return_staging: bool = False):
    """Plain version of the multi-rank kernel: grids (world, E, cap, d),
    w_up (world, E, d, f) -> up (world, E, world cap, f), ``up[r][e][src
    cap + i] = grids[src][e][i] @ w_up[r][e]`` summed in f32, cast to the
    promoted dtype. ``return_staging`` also the (world, E, world, cap, d)
    gathered grids, ``staging[r][e][src] = grids[src][e]``."""
    world, E, cap, d = grids.shape
    gathered = grids.transpose(0, 1).reshape(E, world * cap, d)
    up = torch.matmul(gathered.float(), w_up.float()).to(
        torch.promote_types(grids.dtype, w_up.dtype))
    if not return_staging:
        return up
    staging = gathered.reshape(1, E, world, cap, d).expand(
        world, -1, -1, -1, -1).clone()
    return up, staging


def ag_group_gemm_cuda(grids: torch.Tensor, w_up: torch.Tensor, *,
                       staging: torch.Tensor | None = None,
                       producer_delay_ns: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ag_group_gemm.cu`` on the current stream: grids
    (world, E, cap, d), w_up (world, E, d, f), one dtype (f32 or bf16),
    contiguous. Returns ``(up, staging)``: up (world, E, world cap, f),
    staging (world, E, world, cap, d) every rank's gathered grids.
    ``staging`` (default: a new buffer) and ``producer_delay_ns`` (every
    producer item sleeps that long before its copy) let a test poison the
    buffer and hold the gather back. bf16 runs the ``wgmma`` tile where
    TMA can read every operand (``_build.tma_rows``) and the ``mma.sync``
    tile otherwise, in the same one launch."""
    code = _cuda_operands("ag_group_gemm_cuda", grids, w_up)
    world, E, cap, d = grids.shape
    f = w_up.shape[3]
    if world < 2 or w_up.dim() != 4 or tuple(w_up.shape[:3]) != (world, E,
                                                                 d):
        raise ValueError(f"ag_group_gemm_cuda shapes {tuple(grids.shape)} "
                         f"x {tuple(w_up.shape)}")
    staging = _staging("ag_group_gemm_cuda", staging,
                       (world, E, world, cap, d), grids)
    tma = (_build.tma_rows((d, f), grids, w_up, staging)
           if grids.dtype == torch.bfloat16 else 0)
    ec, rows = producer_chunk(cap, d, grids.element_size())
    flags = _signal.flags(grids.device, "ag_group_gemm",
                          world * world * -(-E // ec) * -(-cap // rows))
    ticket = torch.empty(1, dtype=torch.int32, device=grids.device)
    up = torch.empty((world, E, world * cap, f), dtype=grids.dtype,
                     device=grids.device)
    err = _build.lib().tdt_ag_group_gemm(
        grids.data_ptr(), staging.data_ptr(), w_up.data_ptr(), up.data_ptr(),
        flags.data_ptr(), ticket.data_ptr(), _signal.next_epoch(grids.device),
        world, E, cap, d, f, ec, rows, code, tma, producer_delay_ns,
        _build.stream_ptr(grids))
    _build.check(err, "tdt_ag_group_gemm")
    AG_GROUP_GEMM.launches += 1
    return up, staging


def _ag_group_gemm(x, topk_ids, w_up, *, world, n_experts, capacity, config,
                   plain):
    config = config or MoEOverlapConfig()
    if world == 1:
        E, d, f_local = w_up.shape
    else:
        if (x.dim() != 3 or topk_ids.dim() != 3 or w_up.dim() != 4
                or {x.shape[0], topk_ids.shape[0], w_up.shape[0]}
                != {world}):
            raise ValueError(
                f"ag_group_gemm_device at world {world} takes stacked x "
                f"(world, m, d), topk_ids (world, m, k) and w_up (world, E, "
                f"d, f_local), got {tuple(x.shape)}, "
                f"{tuple(topk_ids.shape)} and {tuple(w_up.shape)}")
        _, E, d, f_local = w_up.shape
    if E != n_experts:
        raise ValueError(f"w_up has {E} experts, expected {n_experts}")
    if world == 1:
        grid, slot, kept, n_dropped, _ = route_to_experts(
            x, topk_ids, n_experts=n_experts, capacity=capacity)
    else:
        grid, slot, kept, n_dropped, _ = route_rank_stack(
            x, topk_ids, n_experts=n_experts, capacity=capacity)
    state = {"slot": slot, "kept": kept, "n_dropped": n_dropped}
    MoEOverlapConfig.tiles(f_local, config.block_f)
    MoEOverlapConfig.tiles(d, config.block_k)
    if world == 1:
        up = torch.matmul(grid.float(), w_up.float()).to(
            torch.promote_types(x.dtype, w_up.dtype))
    elif plain:
        up = ag_group_gemm_ref(grid, w_up)
    else:
        up = ag_group_gemm_cuda(grid, w_up)[0]
    return up, state


def ag_group_gemm_device(x: torch.Tensor, topk_ids: torch.Tensor,
                         w_up: torch.Tensor, *, world: int = 1,
                         n_experts: int, capacity: int,
                         config: MoEOverlapConfig | None = None):
    """AG of per-expert capacity grids fused into the grouped up GEMM (JAX
    :144). At world 1 x (m, d), topk_ids (m, k), w_up (E, d, f_local) ->
    ``(up (E, cap, f_local), state)``. At world > 1 every rank's shards
    stacked: x (world, m, d), topk_ids (world, m, k), w_up (world, E, d,
    f_local) -> up (world, E, world cap, f_local), ``up[r][e][src cap + i]
    = grid[src][e][i] @ w_up[r][e]`` (f32 sums, the promoted dtype). ``state``
    holds each rank's routing: ``slot``, ``kept`` and ``n_dropped``
    (capacity overflow is counted, never silent). The kernel on CUDA
    tensors, the plain version on CPU ones."""
    return _ag_group_gemm(x, topk_ids, w_up, world=world,
                          n_experts=n_experts, capacity=capacity,
                          config=config, plain=not x.is_cuda)


# -- GroupGEMM-RS -------------------------------------------------------------

def group_gemm_rs_partials(act: torch.Tensor,
                           w_down: torch.Tensor) -> torch.Tensor:
    """Every rank's partial down product in f32, segment-major: act (world,
    E, world cap, f), w_down (world, E, f, d) -> (world, world E cap, d),
    rank r's rows of owner dst being its (E, cap, d) block dst, the layout
    ``gemm_rs_fold`` folds."""
    world, E, rows, f = act.shape
    cap = rows // world
    by_owner = act.float().reshape(world, E, world, cap, f).transpose(1, 2)
    part = torch.matmul(by_owner, w_down.float()[:, None])
    return part.reshape(world, world * E * cap, -1)


def group_gemm_rs_ref(act: torch.Tensor, w_down: torch.Tensor, *,
                      return_staging: bool = False):
    """Plain version of the multi-rank kernel, in its order and rounding:
    ``gemm_rs_fold`` of ``group_gemm_rs_partials`` (rank dst adds, for
    src = 0 .. world - 1, its own f32 partial or rank src's rounded to the
    output dtype, in f32, then casts once; JAX :323-336). Returns (world,
    E, cap, d); ``return_staging`` also the (world, world - 1, E, cap, d)
    pushes."""
    world, E, rows, _ = act.shape
    d = w_down.shape[3]
    shape = (world, E, rows // world, d)
    folded = gemm_rs_fold(group_gemm_rs_partials(act, w_down),
                          torch.promote_types(act.dtype, w_down.dtype),
                          return_staging=return_staging)
    if not return_staging:
        return folded.reshape(shape)
    out, staging = folded
    return out.reshape(shape), staging.reshape(world, world - 1, *shape[1:])


def group_gemm_rs_cuda(act: torch.Tensor, w_down: torch.Tensor, *,
                       staging: torch.Tensor | None = None,
                       producer_delay_ns: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/group_gemm_rs.cu`` on the current stream: act (world,
    E, world cap, f), w_down (world, E, f, d), one dtype (f32 or bf16),
    contiguous. Returns ``(out, staging)``: out (world, E, cap, d), staging
    (world, world - 1, E, cap, d) the pushed partials as
    ``group_gemm_rs_ref`` gives them. ``staging`` (default: a new buffer)
    and ``producer_delay_ns`` (every product tile sleeps that long before
    it releases its flag) let a test poison the slots and hold the partials
    back. bf16 runs the ``wgmma`` items where ``rs_plan`` says TMA can read
    every operand, the ``mma.sync`` tile otherwise, in the same one
    launch."""
    code = _cuda_operands("group_gemm_rs_cuda", act, w_down)
    world, E, rows, f = act.shape
    d = w_down.shape[3]
    if (world < 2 or rows % world or w_down.dim() != 4
            or tuple(w_down.shape[:3]) != (world, E, f)):
        raise ValueError(f"group_gemm_rs_cuda shapes {tuple(act.shape)} x "
                         f"{tuple(w_down.shape)}")
    cap = rows // world
    staging = _staging("group_gemm_rs_cuda", staging,
                       (world, world - 1, E, cap, d), act)
    tile = TILE_M if act.dtype == torch.bfloat16 else F32_TILE
    flags = _signal.flags(act.device, "group_gemm_rs",
                          world * E * -(-rows // tile) * -(-d // tile))
    ticket = torch.empty(1, dtype=torch.int32, device=act.device)
    out = torch.empty((world, E, cap, d), dtype=act.dtype, device=act.device)
    tma, own = rs_plan(act, w_down, out, staging, (world, E, cap, d))
    err = _build.lib().tdt_group_gemm_rs(
        act.data_ptr(), w_down.data_ptr(), out.data_ptr(), staging.data_ptr(),
        None if own is None else own.data_ptr(), flags.data_ptr(),
        ticket.data_ptr(), _signal.next_epoch(act.device), world, E, cap, f,
        d, code, tma, producer_delay_ns, _build.stream_ptr(act))
    _build.check(err, "tdt_group_gemm_rs")
    GROUP_GEMM_RS.launches += 1
    return out, staging


def _group_gemm_rs(act, w_down, *, world, capacity, config, plain):
    config = config or MoEOverlapConfig()
    if world > 1 and (act.dim() != 4 or w_down.dim() != 4
                      or act.shape[0] != world or w_down.shape[0] != world):
        raise ValueError(f"group_gemm_rs_device at world {world} takes "
                         f"stacked act (world, E, world * cap, f_local) and "
                         f"w_down (world, E, f_local, d), got "
                         f"{tuple(act.shape)} and {tuple(w_down.shape)}")
    _, rows, f_local = act.shape[-3:]
    d = w_down.shape[-1]
    if rows != world * capacity:
        raise ValueError(f"act rows {rows} != world*capacity "
                         f"{world * capacity}")
    MoEOverlapConfig.tiles(d, config.block_d)
    MoEOverlapConfig.tiles(f_local, config.block_k)
    if world == 1:
        return torch.matmul(act.float(), w_down.float()).to(
            torch.promote_types(act.dtype, w_down.dtype))
    if plain:
        return group_gemm_rs_ref(act, w_down)
    return group_gemm_rs_cuda(act, w_down)[0]


def group_gemm_rs_device(act: torch.Tensor, w_down: torch.Tensor, *,
                         world: int = 1, capacity: int,
                         config: MoEOverlapConfig | None = None
                         ) -> torch.Tensor:
    """Grouped down GEMM fused with the reduce-scatter over the f shards
    (JAX :346). At world 1 act (E, cap, f_local), w_down (E, f_local, d) ->
    (E, cap, d). At world > 1 stacked: act (world, E, world cap, f_local)
    (``ag_group_gemm_device``'s layout), w_down (world, E, f_local, d) ->
    (world, E, cap, d), rank r's own cap rows of every expert summed over
    every rank's partial. JAX's ``ValueError`` when the rows are not
    world x capacity. The kernel on CUDA tensors, the plain version on CPU
    ones."""
    return _group_gemm_rs(act, w_down, world=world, capacity=capacity,
                          config=config, plain=not act.is_cuda)


# -- the MoE-TP MLP -----------------------------------------------------------

def _combine_stack(down, topk_ids, topk_weights, slot, kept):
    """``combine_from_experts`` of every rank in one call: rank r's ids
    offset by r E into the (world E, cap, d) view of the down stack."""
    world, E, cap, d = down.shape
    m, k = topk_ids.shape[1:]
    base = torch.arange(world, device=topk_ids.device).reshape(world, 1, 1)
    ids = torch.where((topk_ids >= 0) & (topk_ids < E), topk_ids + base * E,
                      0)
    out = combine_from_experts(
        down.reshape(world * E, cap, d), ids.reshape(world * m, k),
        topk_weights.reshape(world * m, k), slot.reshape(world * m, k),
        kept.reshape(world * m, k))
    return out.reshape(world, m, d)


def _ag_moe_mlp(x, topk_ids, topk_weights, w_up, w_down, *, world,
                n_experts, capacity, activation, config, plain):
    up, state = _ag_group_gemm(x, topk_ids, w_up, world=world,
                               n_experts=n_experts, capacity=capacity,
                               config=config, plain=plain)
    act = activation(up.float()).to(up.dtype)
    down = _group_gemm_rs(act, w_down, world=world, capacity=capacity,
                          config=config, plain=plain)
    combine = combine_from_experts if world == 1 else _combine_stack
    out = combine(down, topk_ids, topk_weights, state["slot"],
                  state["kept"])
    return out, state["n_dropped"]


def ag_moe_mlp_device(x: torch.Tensor, topk_ids: torch.Tensor,
                      topk_weights: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor, *, world: int = 1,
                      n_experts: int, capacity: int, activation=F.silu,
                      config: MoEOverlapConfig | None = None):
    """The MoE-TP MLP (JAX :436): route -> AG-GroupGEMM (up) ->
    ``activation`` in f32, cast back -> GroupGEMM-RS (down) -> each rank's
    top-k combine. ``capacity`` bounds the tokens of one (source, expert).
    At world 1 x (m, d), topk_ids and topk_weights (m, k), w_up (E, d,
    f_local), w_down (E, f_local, d) -> ``(out (m, d), n_dropped ())``; at
    world > 1 each stacked over the ranks -> ``(out (world, m, d),
    n_dropped (world,))``. Dropped pairs add nothing, and are counted. The
    kernels on CUDA tensors, the plain versions on CPU ones."""
    return _ag_moe_mlp(x, topk_ids, topk_weights, w_up, w_down, world=world,
                       n_experts=n_experts, capacity=capacity,
                       activation=activation, config=config,
                       plain=not x.is_cuda)


def ag_moe_mlp_ref(x: torch.Tensor, topk_ids: torch.Tensor,
                   topk_weights: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, *, world: int = 1, n_experts: int,
                   capacity: int, activation=F.silu,
                   config: MoEOverlapConfig | None = None):
    """``ag_moe_mlp_device`` through the plain versions on any device: what
    a card's run of the kernels is held against."""
    return _ag_moe_mlp(x, topk_ids, topk_weights, w_up, w_down, world=world,
                       n_experts=n_experts, capacity=capacity,
                       activation=activation, config=config, plain=True)


# -- the 2-D variants ---------------------------------------------------------

def _no_2d(name: str):
    raise NotImplementedError(
        f"{name}: the inter-slice (dcn) leg is not ported; one card cannot "
        f"check it")


def ag_group_gemm_2d_device(*args, **kwargs):
    """JAX :466; not ported (raises ``NotImplementedError``)."""
    _no_2d("ag_group_gemm_2d_device")


def group_gemm_rs_2d_device(*args, **kwargs):
    """JAX :511; not ported (raises ``NotImplementedError``)."""
    _no_2d("group_gemm_rs_2d_device")


def ag_moe_mlp_2d_device(*args, **kwargs):
    """JAX :551; not ported (raises ``NotImplementedError``)."""
    _no_2d("ag_moe_mlp_2d_device")
