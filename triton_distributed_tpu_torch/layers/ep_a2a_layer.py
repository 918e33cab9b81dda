"""Expert-parallel all-to-all layer.

Counterpart of ``triton_distributed_tpu/layers/ep_a2a_layer.py``
(``EPAll2AllLayer`` :36). Per rank, as in JAX:

  dispatch: route each (token, k) pair to the rank that owns its expert
            (``route_to_ranks``) -> the (world, capacity, hidden) send
            layout with the expert ids beside it (``scatter_to_capacity``)
            -> ``fast_all_to_all`` (tokens and ids ride together) -> the
            arrivals regrouped by local expert for the grouped GEMM
            (``tokens_by_local_expert``).
  combine:  expert outputs back into the arrival layout
            (``scatter_back_from_experts``) -> the reverse
            ``fast_all_to_all`` with the RECEIVED counts -> each pair's row,
            weighted by its top-k probability, the k summed
            (``gather_from_capacity``).

The ranks are simulated on one card (``runtime/mesh.py``), so every
per-rank tensor is held as its rank stack: tokens (world, n, hidden), the
send and receive layouts (world, world, capacity, hidden), the expert grid
(world, E_local, expert_capacity, hidden). The routing functions run rank
by rank on index tensors; the big layouts are written in place into their
stacks (no per-rank copy is stacked), and ONE exchange moves every rank's
slots. The state between the halves is a dict, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.kernels import ep_all_to_all, moe_utils
from triton_distributed_tpu_torch.kernels.ep_all_to_all import AllToAllContext


@dataclasses.dataclass(frozen=True)
class EPAll2AllLayer:
    """Static MoE exchange config (JAX :38): ``capacity`` tokens at most
    per (src, dst) rank pair, ``expert_capacity`` per local expert after
    arrival, over ``world`` simulated ranks. ``dcn_axis`` (the JAX 2-D
    exchange across slices, ``fast_all_to_all_2d``) is not ported."""

    n_experts: int
    topk: int
    hidden: int
    capacity: int
    expert_capacity: int
    axis: str = "ep"
    dcn_axis: str | None = None
    world: int = 1

    def __post_init__(self):
        if self.dcn_axis is not None:
            raise NotImplementedError(
                "the 2-D exchange over dcn_axis (fast_all_to_all_2d) is not "
                "ported yet: see ROADMAP.md")

    def ctx(self) -> AllToAllContext:
        return AllToAllContext(capacity=self.capacity, hidden=self.hidden,
                               axis=self.axis)

    def _a2a(self, payloads, counts, *, direction):
        return ep_all_to_all.fast_all_to_all(
            payloads, counts, ctx=self.ctx(), direction=direction,
            world=self.world)

    def dispatch(self, x, topk_ids, topk_weights):
        """x: (world, n, hidden), rank r's tokens at [r]; topk_ids/weights:
        (world, n, topk). Returns ``(grouped, expert_counts, state)``:
        grouped (world, E_local, expert_capacity, hidden), expert_counts
        (world, E_local) int32 (rank r's local expert j is global expert
        r * E_local + j), and the state ``combine`` takes.

        Drops (JAX :76-84): pairs past ``capacity`` per destination rank,
        or past ``expert_capacity`` per local expert after arrival,
        contribute zero; ``state["stats"]`` holds ``n_dropped_dispatch``
        and ``n_dropped_expert``, (world,) int32, one per rank."""
        W, cap, ecap = self.world, self.capacity, self.expert_capacity
        n_local = self.n_experts // W
        send = x.new_empty((W, W, cap, self.hidden))
        plans, ids = [], []
        for r in range(W):
            plan = moe_utils.route_to_ranks(
                topk_ids[r], topk_weights[r], n_experts=self.n_experts,
                world=W, capacity=cap)
            ids.append(moe_utils.scatter_to_capacity(
                x[r], plan, world=W, capacity=cap, out=send[r])[1])
            plans.append(plan)
        counts = torch.stack([p.counts for p in plans]).to(torch.int32)
        (recv, recv_ids), rcounts = self._a2a(
            (send, torch.stack(ids)), counts, direction="dispatch")
        del send
        grouped = x.new_empty((W, n_local, ecap, self.hidden))
        expert_counts, src_idx, n_drop_e = [], [], []
        for r in range(W):
            _, c, src, drop = moe_utils.tokens_by_local_expert(
                recv[r], recv_ids[r, :, :, 0], rcounts[r],
                n_local_experts=n_local, expert_base=r * n_local,
                expert_capacity=ecap, out=grouped[r])
            expert_counts.append(c)
            src_idx.append(src)
            n_drop_e.append(drop)
        state = {"plans": plans, "src_idx": torch.stack(src_idx),
                 "rcounts": rcounts, "n_tokens": x.shape[1],
                 "stats": {"n_dropped_dispatch": torch.stack(
                               [p.n_dropped for p in plans]),
                           "n_dropped_expert": torch.stack(n_drop_e)}}
        return grouped, torch.stack(expert_counts), state

    def combine(self, expert_out, state):
        """expert_out: (world, E_local, expert_capacity, hidden). Returns
        (world, n, hidden): each rank's top-k weighted sum per token."""
        W, cap = self.world, self.capacity
        back = expert_out.new_empty((W, W, cap, self.hidden))
        for r in range(W):
            moe_utils.scatter_back_from_experts(
                expert_out[r], state["src_idx"][r], world=W, capacity=cap,
                out=back[r])
        ret, _ = self._a2a(back, state["rcounts"], direction="combine")
        del back
        return torch.stack([
            moe_utils.gather_from_capacity(ret[r], plan,
                                           n_tokens=state["n_tokens"])
            for r, plan in enumerate(state["plans"])])

    def moe_mlp(self, x, topk_ids, topk_weights, expert_weights):
        """The whole EP-MoE forward (JAX :119): dispatch -> per-expert
        matmul -> combine; ``expert_weights`` (world, E_local, hidden,
        hidden)."""
        grouped, _, state = self.dispatch(x, topk_ids, topk_weights)
        return self.combine(moe_utils.grouped_gemm(grouped, expert_weights),
                            state)
