"""Mixture-of-Experts MLP (Qwen3-MoE sparse FFN).

Counterpart of ``triton_distributed_tpu/layers/moe_mlp.py`` (``MoEMLP``).
The router follows HF ``Qwen3MoeSparseMoeBlock``: an f32 softmax over all
expert logits, top-k, optional renormalization of the selected
probabilities (``norm_topk_prob``), then the weighted sum of gated-SwiGLU
expert outputs.

  ``dist_fwd`` - route -> ``route_to_experts`` into a per-expert
                 capacity grid -> the count-aware grouped GEMM
                 (``csrc/grouped_gemm.cu`` on the card) for gate_up and
                 down -> ``combine_from_experts``. Static capacities sized
                 as the JAX layer sizes them, so the same pairs are
                 dropped. At world 1 the JAX layer's two-stage exchange
                 (dispatch to ranks, regroup by local expert) gives the
                 same slots as this one stage: every pair goes to rank 0
                 in flat order, so its dispatch slot is its flat index.
                 Above world 1 it is JAX's two stages over the simulated
                 ranks (``layers/ep_a2a_layer.py``): route -> dispatch
                 (``csrc/ep_a2a.cu``) -> the grouped GEMM -> combine
                 (``csrc/ep_a2a.cu`` again).
  ``xla_fwd``  - the golden: the same function without a capacity grid,
                 over the global batch at every world.
                 The JAX golden builds a worst-case grid (capacity n * k per
                 expert: 34 GB at a 4 x 2,048 prefill of Qwen3-30B-A3B);
                 here each expert's rows (a stable sort of the flat expert
                 ids) go through one ``torch.matmul`` each. It reads the
                 per-expert counts back to the host: an explicit mode, not
                 the serving step.

Leaves (JAX layout): ``router`` (d, E) f32, ``w_gate_up`` (E, d, 2 * ff)
[gate | up], ``w_down`` (E, ff, d); ``Qwen3`` stacks them over layers.
At ``world`` > 1 JAX shards the experts over the ranks (``P(axis, None,
None)``, :94-97) and replicates the router: the expert leaves are held as
their rank stacks (world, E_local, ...), rank r's experts ``[r E_local,
(r + 1) E_local)``, which is a free view of the global (E, ...) leaf.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from triton_distributed_tpu_torch.kernels import moe_utils
from triton_distributed_tpu_torch.layers.ep_a2a_layer import EPAll2AllLayer


def _round8(x) -> int:
    return max(8, (int(x) + 7) // 8 * 8)


def _round16(x) -> int:
    """Expert-grid row granularity (the JAX layer's 16-row minimum; kept so
    capacities, and so drops, equal the JAX values)."""
    return max(16, (int(x) + 15) // 16 * 16)


def _glu(h: torch.Tensor) -> torch.Tensor:
    """SiLU(gate) * up in f32, cast back to h's dtype ([gate | up] on the
    last dim). In place on one f32 copy of the gate: at a prefill's
    capacity grid each f32 temporary is gigabytes."""
    ff = h.shape[-1] // 2
    g = torch.empty(h.shape[:-1] + (ff,), dtype=torch.float32,
                    device=h.device)
    F.silu(g.copy_(h[..., :ff]), inplace=True)
    return g.mul_(h[..., ff:]).to(h.dtype)


@dataclasses.dataclass(frozen=True)
class MoEMLP:
    """Sparse gated-SwiGLU FFN with top-k routing."""

    d_model: int
    d_ff: int                  # per-expert intermediate size
    n_experts: int
    topk: int
    norm_topk_prob: bool = True
    dtype: torch.dtype = torch.bfloat16
    # Capacities are this factor x the uniform-routing expectation.
    capacity_factor: float = 2.0
    world: int = 1

    # -- parameters ---------------------------------------------------------

    def init(self, generator: torch.Generator, device,
             n_layers: int) -> dict:
        """Random layer-stacked leaves on ``device`` from ``generator``
        (normal, scaled by fan_in ** -0.5; the router f32, the experts in
        ``dtype``). Sampled in the weights' dtype, in place: no f32 copy of
        the expert weights is ever made (they are ~57 GiB at 30B-A3B)."""
        d, ff, E = self.d_model, self.d_ff, self.n_experts

        def randw(shape, fan_in, dtype):
            w = torch.randn((n_layers,) + shape, generator=generator,
                            device=device, dtype=dtype)
            return w.mul_(fan_in ** -0.5)

        return {"router": randw((d, E), d, torch.float32),
                "w_gate_up": randw((E, d, 2 * ff), d, self.dtype),
                "w_down": randw((E, ff, d), ff, self.dtype)}

    @staticmethod
    def stack_experts(gates, ups, downs):
        """Pack per-expert (d, ff) / (ff, d) matrices (HF checkpoint layout)
        into the stacked (E, d, 2ff) / (E, ff, d) leaves."""
        return (torch.cat([torch.stack(gates), torch.stack(ups)], dim=-1),
                torch.stack(downs))

    # -- routing ------------------------------------------------------------

    def route(self, router: torch.Tensor, x: torch.Tensor):
        """x: (n, d) -> (topk_weights (n, k) f32, ids (n, k) int32)."""
        probs = torch.softmax(x.float() @ router.float(), dim=-1)
        w, ids = torch.topk(probs, self.topk, dim=-1)
        if self.norm_topk_prob:
            w = w / w.sum(dim=-1, keepdim=True)
        return w, ids.to(torch.int32)

    def _expert_ffn(self, grouped, w_gate_up, w_down, counts=None,
                    layer_idx=None):
        """Gated SwiGLU over an (E, cap, d) capacity grid (empty slots zero,
        and zero through the gate). With ``counts`` the two GEMMs run the
        count-aware grouped GEMM; without, the plain batched product.
        ``layer_idx`` selects the layer of layer-stacked weights."""
        if counts is None:
            if layer_idx is not None:
                w_gate_up, w_down = w_gate_up[layer_idx], w_down[layer_idx]
            return moe_utils.grouped_gemm(
                _glu(moe_utils.grouped_gemm(grouped, w_gate_up)), w_down)
        act = _glu(moe_utils.grouped_gemm_skip(grouped, w_gate_up, counts,
                                               layer_idx=layer_idx))
        return moe_utils.grouped_gemm_skip(act, w_down, counts,
                                           layer_idx=layer_idx)

    def _capacities(self, n_local_tokens: int) -> tuple[int, int]:
        """(dispatch capacity per rank pair, capacity per local expert) for
        ``n_local_tokens`` tokens a rank: the JAX ``_ep_layer`` sizing
        (:148-159)."""
        world = self.world
        pairs = n_local_tokens * self.topk
        cap = min(_round8(pairs * self.capacity_factor / world),
                  _round8(pairs))
        ecap = min(
            _round16(world * pairs * self.capacity_factor / self.n_experts),
            _round16(world * cap))
        return cap, ecap

    def _ep_layer(self, n_local_tokens: int) -> EPAll2AllLayer:
        cap, ecap = self._capacities(n_local_tokens)
        return EPAll2AllLayer(
            n_experts=self.n_experts, topk=self.topk, hidden=self.d_model,
            capacity=cap, expert_capacity=ecap, world=self.world)

    def _global_experts(self, w: torch.Tensor) -> torch.Tensor:
        """An expert leaf's rank stack (..., world, E_local, a, b) -> the
        global (..., E, a, b): a view, since rank r holds the contiguous
        block of experts [r E_local, (r + 1) E_local)."""
        return w.flatten(-4, -3) if self.world > 1 else w

    # -- forwards -----------------------------------------------------------

    def dist_fwd(self, params, x: torch.Tensor, *, return_stats: bool = False,
                 skip_gemm: bool = True, layer_idx=None):
        """x: (n, d) -> (n, d) through the expert grid, the grouped-GEMM
        kernel and the combine. ``params["w_gate_up"]``/``["w_down"]`` may
        be the layer-stacked (L, E, ...) leaves with ``layer_idx`` (the JAX
        signature). ``skip_gemm=False`` takes the plain batched product.
        ``return_stats=True`` also returns ``{"n_dropped_dispatch",
        "n_dropped_expert"}`` as () int32 device tensors, at world > 1 as
        (world,) ones, rank by rank.

        At world > 1, x is the M-sharded (M, d): rank r's tokens are the
        rows ``[r M / world, (r + 1) M / world)`` (JAX's ``P(axis,
        None)``), and the expert leaves are rank stacks."""
        if self.world > 1:
            return self._ep_fwd(params, x, return_stats=return_stats,
                                skip_gemm=skip_gemm, layer_idx=layer_idx)
        n = x.shape[0]
        pairs = n * self.topk
        w, ids = self.route(params["router"], x)
        cap, ecap = self._capacities(n)
        routed = ids
        if cap < pairs:
            # A dispatch capacity below n * k (a factor under 1) drops the
            # pairs past it in flat order, as the JAX exchange does.
            flat = torch.arange(pairs, device=x.device).reshape(ids.shape)
            routed = torch.where(flat < cap, ids, self.n_experts)
        grid, slot, kept, n_drop_e, counts = moe_utils.route_to_experts(
            x, routed, n_experts=self.n_experts, capacity=ecap)
        out = self._expert_ffn(grid, params["w_gate_up"], params["w_down"],
                               counts=counts if skip_gemm else None,
                               layer_idx=layer_idx)
        y = moe_utils.combine_from_experts(out, ids, w, slot, kept).to(
            x.dtype)
        if return_stats:
            return y, {"n_dropped_dispatch": torch.full(
                           (), max(pairs - cap, 0), dtype=torch.int32,
                           device=x.device),
                       "n_dropped_expert": n_drop_e}
        return y

    def _ep_fwd(self, params, x: torch.Tensor, *, return_stats: bool,
                skip_gemm: bool, layer_idx):
        """``dist_fwd`` over ``world`` simulated ranks (JAX :161-196). The
        router is row-wise, so it runs once over every rank's rows. Rank
        r's local expert j is global expert r E_local + j, so the stacked
        grids, viewed as one (E, expert_capacity, d), go through ONE
        grouped-GEMM launch per projection against the global weights."""
        W, E = self.world, self.n_experts
        M, d = x.shape
        if M % W:
            raise ValueError(f"{M} rows not divisible by world {W}")
        n = M // W
        w, ids = self.route(params["router"], x)
        ep = self._ep_layer(n)
        grouped, counts, state = ep.dispatch(
            x.reshape(W, n, d), ids.reshape(W, n, -1), w.reshape(W, n, -1))
        ecap = ep.expert_capacity
        out = self._expert_ffn(grouped.reshape(E, ecap, d),
                               self._global_experts(params["w_gate_up"]),
                               self._global_experts(params["w_down"]),
                               counts=counts.reshape(E) if skip_gemm else None,
                               layer_idx=layer_idx)
        del grouped
        y = ep.combine(out.reshape(W, E // W, ecap, d), state).reshape(
            M, d).to(x.dtype)
        if return_stats:
            return y, state["stats"]
        return y

    def xla_fwd(self, params, x: torch.Tensor) -> torch.Tensor:
        """Golden: every (token, k) pair through its expert, no capacity, no
        drops; the k results summed in k order as ``dist_fwd`` sums them.
        At world > 1 x is the global (M, d), held once (JAX computes the
        same function over the gathered batch, :198-219)."""
        n, d = x.shape
        k = self.topk
        w_gate_up = self._global_experts(params["w_gate_up"])
        w_down = self._global_experts(params["w_down"])
        w, ids = self.route(params["router"], x)
        flat = ids.reshape(-1).long()
        order = torch.sort(flat, stable=True).indices
        counts = torch.bincount(flat, minlength=self.n_experts).tolist()
        out = x.new_zeros((n * k, d))
        start = 0
        for e, c in enumerate(counts):
            if c == 0:
                continue
            pairs = order[start:start + c]
            rows = x.index_select(0, torch.div(pairs, k,
                                               rounding_mode="floor"))
            h = _glu(torch.matmul(rows, w_gate_up[e]))
            out.index_copy_(0, pairs, torch.matmul(h, w_down[e]))
            start += c
        rows = out.reshape(n, k, d)
        return (rows * w[..., None].to(rows.dtype)).sum(dim=1).to(x.dtype)
