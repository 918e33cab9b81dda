"""MoE token routing and the count-aware grouped GEMM.

Counterpart of ``triton_distributed_tpu/kernels/moe_utils.py``. The routing
math is the JAX module's, written again in torch: the sort-free one-hot
exclusive prefix count of ``sort_to_capacity`` (:42) gives every flat
(token, k) pair its slot in its bucket's capacity block, in original order,
so slots, ``counts`` and ``n_dropped`` are the JAX values exactly.

PyTorch has no scatter with ``mode="drop"``: a scatter target gets one spare
row at index ``size``, every invalid write goes there, and the spare row is
sliced off. Nothing here uses ``nonzero``, boolean-mask indexing, tensor
repeats or ``.item()``, so the routing never reads a value back to the host
(the serving steps stay free of host reads, ready for a CUDA-graph capture).

``grouped_gemm_skip`` is the wrapper of ``csrc/grouped_gemm.cu``, which
replaces ``_grouped_gemm_skip_kernel`` (:237): a CUDA tensor always runs the
kernel, a CPU tensor its plain version ``grouped_gemm_skip_ref``.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.kernels import _build

GROUPED_GEMM = _build.register(
    "grouped_gemm", "triton_distributed_tpu_torch/csrc/grouped_gemm.cu",
    "triton_distributed_tpu/kernels/moe_utils.py:237")


@dataclasses.dataclass
class RoutingPlan:
    """Everything needed to route tokens out and un-route results back."""

    dest: torch.Tensor         # (n*k,) destination rank per flat (token, k)
    slot: torch.Tensor         # (n*k,) position within the dest capacity block
    counts: torch.Tensor       # (world,) tokens per destination rank
    kept: torch.Tensor         # (n*k,) bool: False where capacity overflowed
    expert: torch.Tensor       # (n*k,) global expert id per flat (token, k)
    topk_weight: torch.Tensor  # (n*k,) routing weight per flat (token, k)
    n_dropped: torch.Tensor    # () int32: (token, k) pairs lost to capacity


def sort_to_capacity(keys, n_buckets: int, capacity: int):
    """Assign each flat bucket key a slot within its bucket's capacity
    block, in original order: ``slot[i] = #{j < i : keys[j] == keys[i]}``,
    from a one-hot inclusive prefix count over (n_buckets, n). Keys >=
    ``n_buckets`` are never kept.

    Returns (keys, slot, kept, counts, n_dropped): ``counts`` clamped to
    capacity; ``n_dropped`` counts in-range keys lost to overflow."""
    in_range = keys < n_buckets
    k_safe = torch.where(in_range, keys, 0)
    buckets = torch.arange(n_buckets, device=keys.device)
    # (n_buckets, n): the prefix count runs along the inner dim, where
    # PyTorch's CUDA scan is fast (down the outer dim of an (n, n_buckets)
    # one-hot it took ~23 ms per layer of a 4 x 2,048 Qwen3-30B-A3B prefill).
    onehot = ((k_safe[None, :] == buckets[:, None])
              & in_range[None, :]).to(torch.int32)
    ends = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    slot = (ends * onehot).sum(dim=0, dtype=torch.int32) - 1
    if keys.shape[0]:
        counts = ends[:, -1]
    else:
        counts = torch.zeros(n_buckets, dtype=torch.int32, device=keys.device)
    kept = in_range & (slot < capacity)
    n_dropped = (in_range & ~kept).sum(dtype=torch.int32)
    return keys, slot, kept, torch.clamp(counts, max=capacity), n_dropped


def route_to_ranks(topk_ids, topk_weights, *, n_experts: int, world: int,
                   capacity: int) -> RoutingPlan:
    """The dispatch plan: flat (token, k) pairs keyed by destination rank
    (expert // experts_per_rank), assigned capacity slots; overflow is
    dropped through ``kept`` and counted in ``n_dropped``."""
    if n_experts % world:
        raise ValueError(f"n_experts {n_experts} not divisible by world "
                         f"{world}")
    epr = n_experts // world
    flat_expert = topk_ids.reshape(-1)
    flat_weight = topk_weights.reshape(-1)
    dest = torch.div(flat_expert, epr, rounding_mode="floor")
    _, slot, kept, counts, n_dropped = sort_to_capacity(dest, world, capacity)
    return RoutingPlan(dest=dest, slot=torch.where(kept, slot, 0),
                       counts=counts, kept=kept, expert=flat_expert,
                       topk_weight=flat_weight, n_dropped=n_dropped)


def inverse_index(dst_idx, valid, size: int, n: int):
    """``inv[j]`` = the i (< n) with ``dst_idx[i] == j`` and valid[i], or
    ``n`` for unfilled slots. Invalid writes land on a spare row at
    ``size``, which is cut off."""
    inv = torch.full((size + 1,), n, dtype=torch.int32, device=dst_idx.device)
    target = torch.where(valid, dst_idx.long(), size)
    inv.scatter_(0, target, torch.arange(n, dtype=torch.int32,
                                         device=dst_idx.device))
    return inv[:size]


def _take_rows(rows, idx, out=None):
    """``rows[idx]`` with index ``len(rows)`` reading a zero row (the JAX
    gather from ``rows`` with a zero row appended), without the copy of
    ``rows`` that appending would make. ``out``: a buffer of the result's
    shape to write it into (a rank's slice of a rank stack)."""
    n = rows.shape[0]
    out = torch.index_select(rows, 0, idx.clamp(max=max(n - 1, 0)), out=out)
    return out.masked_fill_((idx >= n).reshape(-1, *[1] * (rows.dim() - 1)),
                            0)


def fill_by_inverse(rows, dst_idx, valid, size: int, out=None):
    """``grid_flat[dst_idx[i]] = rows[i]`` for valid i (dst unique among
    valid), empty slots zero: an inverse scatter of indices plus a row
    gather (into ``out`` when given). Returns ``(grid_flat, inv)``,
    ``inv[j]`` the source row of slot j or ``len(rows)`` for an empty
    one."""
    inv = inverse_index(dst_idx, valid, size, rows.shape[0])
    return _take_rows(rows, inv, out), inv


def _repeat_rows(x, k: int):
    """Each row of x repeated k times, in place order (x[0] k times, ...)."""
    n = x.shape[0]
    return x[:, None].expand(n, k, *x.shape[1:]).reshape(n * k,
                                                         *x.shape[1:])


def _flat_out(out, rows: int):
    return None if out is None else out.view(rows, out.shape[-1])


def scatter_to_capacity(x, plan: RoutingPlan, *, world: int, capacity: int,
                        out=None):
    """Pack per-token rows into the (world, capacity, hidden) send layout
    (written into ``out``, a contiguous buffer of that shape, when given)
    plus per-slot expert ids (world, capacity, 1) int32; empty slots hold
    expert id -1."""
    k_dup = plan.dest.shape[0] // x.shape[0]
    send_flat, inv = fill_by_inverse(
        _repeat_rows(x, k_dup), plan.dest * capacity + plan.slot, plan.kept,
        world * capacity, _flat_out(out, world * capacity))
    send = send_flat.reshape(world, capacity, x.shape[-1])
    ids = _take_rows(plan.expert.to(torch.int32) + 1, inv) - 1  # empty: -1
    ids = ids.reshape(world, capacity, 1)
    return send, ids


def gather_from_capacity(recv, plan: RoutingPlan, *, n_tokens: int):
    """Un-route combined results: each flat pair's row out of the (world,
    capacity, hidden) layout, weighted by its topk probability (cast to the
    rows' dtype first), the k duplicates summed in k order."""
    rows = recv[plan.dest.long(), plan.slot.long()]          # (n*k, hidden)
    rows = torch.where(plan.kept[:, None], rows, 0)
    rows = rows * plan.topk_weight[:, None].to(rows.dtype)
    k_dup = plan.dest.shape[0] // n_tokens
    return rows.reshape(n_tokens, k_dup, -1).sum(dim=1)


def tokens_by_local_expert(recv_tokens, recv_ids, recv_counts, *,
                           n_local_experts: int, expert_base,
                           expert_capacity: int, out=None):
    """Regroup received (world, capacity, hidden) tokens by local expert into
    (n_local_experts, expert_capacity, hidden) for the grouped GEMM (written
    into ``out``, a contiguous buffer of that shape, when given). Only rows
    below each slot's count are read.

    Returns (grouped, counts, src_flat_idx, n_dropped): ``counts`` the rows
    each expert holds (filled from slot 0, the rest zero: the grouped-GEMM
    contract), ``src_flat_idx`` each grid slot's flat position in the recv
    layout (-1 = empty), ``n_dropped`` the valid arrivals lost to
    ``expert_capacity``."""
    world, cap, hidden = recv_tokens.shape
    flat = recv_tokens.reshape(world * cap, hidden)
    ids = recv_ids.reshape(world * cap)
    pos = torch.arange(cap, device=ids.device)
    valid = (pos[None, :] < recv_counts[:, None]).reshape(world * cap)
    local = torch.where(valid & (ids >= 0), ids - expert_base,
                        n_local_experts)
    _, slot, kept, counts, n_dropped = sort_to_capacity(
        local, n_local_experts, expert_capacity)
    n_flat = world * cap
    src = inverse_index(local * expert_capacity + slot, kept,
                        n_local_experts * expert_capacity, n_flat)
    grouped = _take_rows(flat, src, _flat_out(
        out, n_local_experts * expert_capacity)).reshape(
            n_local_experts, expert_capacity, hidden)
    src_flat_idx = torch.where(src == n_flat, -1, src).reshape(
        n_local_experts, expert_capacity)
    return grouped, counts, src_flat_idx, n_dropped


def scatter_back_from_experts(expert_out, src_flat_idx, *, world: int,
                              capacity: int, out=None):
    """Inverse of ``tokens_by_local_expert``: per-expert results back into
    the (world, capacity, hidden) layout for the combine (written into
    ``out``, a contiguous buffer of that shape, when given)."""
    e, ec, hidden = expert_out.shape
    idx = src_flat_idx.reshape(-1)
    flat_out, _ = fill_by_inverse(expert_out.reshape(e * ec, hidden), idx,
                                  idx >= 0, world * capacity,
                                  _flat_out(out, world * capacity))
    return flat_out.reshape(world, capacity, hidden)


def route_to_experts(x, topk_ids, *, n_experts: int, capacity: int):
    """Pack (token, k) pairs into a per-expert capacity grid.

    x: (n, d); topk_ids: (n, k), ids >= ``n_experts`` never kept (and not
    counted as dropped). Returns (grid (E, capacity, d), empty slots zero;
    slot (n, k), each pair's slot in its expert's block (past ``capacity``
    where dropped); kept (n, k) bool; n_dropped () int32; counts (E,)
    int32, the rows each expert holds, filled from slot 0: the grouped
    GEMM's grid contract). The JAX function returns the first four."""
    n, k = topk_ids.shape
    flat_e = topk_ids.reshape(-1)
    _, slot, kept, counts, n_dropped = sort_to_capacity(flat_e, n_experts,
                                                        capacity)
    grid_flat, _ = fill_by_inverse(_repeat_rows(x, k),
                                   flat_e * capacity + slot, kept,
                                   n_experts * capacity)
    grid = grid_flat.reshape(n_experts, capacity, x.shape[-1])
    return grid, slot.reshape(n, k), kept.reshape(n, k), n_dropped, counts


def route_rank_stack(x, topk_ids, *, n_experts: int, capacity: int):
    """``route_to_experts`` of every rank of a stack in one call.

    x (world, m, d), topk_ids (world, m, k). Rank r's ids are offset by
    ``r * n_experts`` and all pairs sorted into ``world * n_experts``
    buckets, so the (world * E, capacity, d) grid is the (world, E,
    capacity, d) stack of every rank's grid, and each rank's slots are the
    rank-by-rank ones (an id outside [0, ``n_experts``) is never kept and
    not counted as dropped). Returns (grid (world, E, capacity, d); slot,
    kept (world, m, k); n_dropped (world,) int32; counts (world, E)
    int32)."""
    world, m, k = topk_ids.shape
    base = torch.arange(world, device=topk_ids.device).reshape(world, 1, 1)
    in_range = (topk_ids >= 0) & (topk_ids < n_experts)
    keys = torch.where(in_range, topk_ids + base * n_experts,
                       world * n_experts)
    grid, slot, kept, _, counts = route_to_experts(
        x.reshape(world * m, -1), keys.reshape(world * m, k),
        n_experts=world * n_experts, capacity=capacity)
    n_dropped = (in_range & ~kept.reshape(world, m, k)).reshape(
        world, -1).sum(dim=1, dtype=torch.int32)
    return (grid.reshape(world, n_experts, capacity, -1),
            slot.reshape(world, m, k), kept.reshape(world, m, k), n_dropped,
            counts.reshape(world, n_experts))


def combine_from_experts(out_grid, topk_ids, topk_weights, slot, kept):
    """Inverse of ``route_to_experts`` after expert compute: each pair's row
    of the (E, capacity, d) grid, weighted by its topk probability, the k
    duplicates summed. A dropped pair reads slot 0 and is zeroed."""
    slot = torch.where(kept, slot, 0)
    rows = out_grid[topk_ids.long(), slot.long()]              # (n, k, d)
    rows = torch.where(kept[..., None], rows, 0)
    w = topk_weights[..., None].to(rows.dtype)
    return (rows * w).sum(dim=1)


def grouped_gemm(grouped, weights):
    """Batched per-expert product (E, cap, d) x (E, d, f) -> (E, cap, f),
    f32 sums, cast to ``grouped``'s dtype (the JAX einsum)."""
    return torch.matmul(grouped.float(), weights.float()).to(grouped.dtype)


def _layer_weights(weights, layer_idx):
    if (weights.dim() == 4) != (layer_idx is not None):
        raise ValueError("layer_idx must be passed exactly when weights are "
                         "layer-stacked (L, E, d, f)")
    return weights if layer_idx is None else weights[int(layer_idx)]


def grouped_gemm_skip_ref(grouped, weights, counts, *, layer_idx=None):
    """Plain version of the count-aware grouped GEMM: every row of every
    expert with ``counts[e] > 0`` computed (f32 sums), empty experts
    zero."""
    w = _layer_weights(weights, layer_idx)
    out = grouped_gemm(grouped, w)
    live = (counts > 0).reshape(-1, 1, 1)
    return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def grouped_gemm_skip_cuda(grouped, weights, counts, *, layer_idx=None):
    """Launch ``csrc/grouped_gemm.cu`` on CUDA tensors: bf16 or fp32,
    ``grouped`` (E, cap, d), ``weights`` (E, d, f) or (L, E, d, f) with
    ``layer_idx`` (a host int: the layer is a pointer offset), ``counts``
    (E,) int32 on the card."""
    w = _layer_weights(weights, layer_idx)
    if grouped.dim() != 3 or w.dim() != 3 or w.shape[0] != grouped.shape[0] \
            or w.shape[1] != grouped.shape[2]:
        raise ValueError(f"grouped_gemm shapes {tuple(grouped.shape)} x "
                         f"{tuple(weights.shape)}")
    E, cap, d = grouped.shape
    f = w.shape[2]
    if counts.shape != (E,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be ({E},) int32, got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if not (grouped.is_cuda and w.is_cuda and counts.is_cuda) or len(
            {grouped.device, w.device, counts.device}) != 1:
        raise ValueError("grouped_gemm_skip_cuda takes tensors on one CUDA "
                         "device")
    if grouped.dtype != w.dtype:
        raise TypeError(f"grouped_gemm operands differ in dtype: "
                        f"{grouped.dtype} vs {w.dtype}")
    if not (grouped.is_contiguous() and w.is_contiguous()
            and counts.is_contiguous()):
        raise ValueError("grouped_gemm_skip_cuda takes contiguous operands")
    out = torch.empty((E, cap, f), dtype=grouped.dtype, device=grouped.device)
    if out.numel() == 0:
        return out
    err = _build.lib().tdt_grouped_gemm(
        grouped.data_ptr(), w.data_ptr(), out.data_ptr(), counts.data_ptr(),
        E, cap, d, f, _build.dtype_code(grouped), _build.stream_ptr(grouped))
    _build.check(err, "tdt_grouped_gemm")
    GROUPED_GEMM.launches += 1
    return out


def grouped_gemm_skip(grouped, weights, counts, *, layer_idx=None):
    """Count-aware grouped GEMM ``(E, cap, d) x (E, d, f) -> (E, cap, f)``:
    experts with ``counts[e] == 0`` give zeros and fetch no weights.

    Grid contract (what ``route_to_experts`` and ``tokens_by_local_expert``
    produce): expert e's rows sit in slots ``[0, counts[e])`` and every row
    past its count is zero, so its product row is zero. The kernel writes those zeros without
    reading the rows; the plain version computes every row, as the JAX
    kernel does. ``weights`` may be layer-stacked (L, E, d, f) with
    ``layer_idx`` selecting the layer (the JAX signature; in torch
    ``weights[layer_idx]`` is a free view).

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    ``grouped_gemm_skip_ref``."""
    if grouped.is_cuda:
        return grouped_gemm_skip_cuda(grouped, weights, counts,
                                      layer_idx=layer_idx)
    return grouped_gemm_skip_ref(grouped, weights, counts,
                                 layer_idx=layer_idx)
