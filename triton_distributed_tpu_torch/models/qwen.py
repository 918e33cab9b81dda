"""Qwen3 decoder stack (dense and MoE families).

Counterpart of ``triton_distributed_tpu/models/qwen.py`` (``Qwen3``). The
parameters keep the JAX package's layout: a dict whose per-layer leaves are
stacked along a leading ``n_layers`` dim, matrices stored (in, out),
``w_qkv`` packed [q | k | v], ``w_gate_up`` packed [gate | up], f32 norms,
and no ``lm_head`` when embeddings are tied. An MoE config (``n_experts >
0``) has ``router`` (L, d, E) f32, ``w_gate_up`` (L, E, d, 2 * moe_d_ff)
and ``w_down`` (L, E, moe_d_ff, d) as its MLP leaves. ``params_from_jax``
carries a JAX parameter tree (as numpy arrays) over unchanged, so both
frameworks can run the same weights.

The JAX stack walks the layers with ``lax.scan``; here a Python loop walks
them, and each layer writes its slice of the KV cache (or of the serving
path's block pool) in place.

At ``world`` > 1 (``Engine``) the tensor-parallel ranks are simulated on
one card (``runtime/mesh.py``): every leaf JAX shards is held as its rank
stack, the rank dimension right after the layer dimension (``w_qkv`` (L,
world, d, q_l + 2 kv_l), ``w_o`` (L, world, q_l, d); a dense MLP's
``w_gate_up`` (L, world, d, 2 ff_l) and ``w_down`` (L, world, ff_l, d); an
MoE config's experts (L, world, E_local, ...), a free view of the global
leaf); what JAX replicates (embeddings, norms, the router, ``lm_head``)
is held once. The hidden state is (B, L, d) in every mode: in dist mode
rank r's rows are the batch rows ``[r B / world, (r + 1) B / world)`` (JAX
:327-334), so gathering the last positions across ranks in rank order is
the identity.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.layers import nn
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP
from triton_distributed_tpu_torch.layers.tp_attn import TPAttn
from triton_distributed_tpu_torch.layers.tp_mlp import TPMLP
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.runtime.device import resolve_device
from triton_distributed_tpu_torch.runtime.mesh import World

def sharded_leaves(config: ModelConfig) -> dict:
    """The leaves JAX shards over the ranks (``Qwen3.param_specs``), and
    the dimension (behind the layer dimension) it shards: P(None, axis) for
    the column-parallel products, P(axis, None) for the row-parallel ones;
    an MoE config's experts on E (``MoEMLP.param_specs``), the router
    replicated. An expert leaf's [gate | up] stays whole per expert: it is
    not the dense MLP's per-rank interleave."""
    if config.n_experts:
        mlp = {("mlp", "w_gate_up"): 0, ("mlp", "w_down"): 0}
    else:
        mlp = {("mlp", "w_gate_up"): 1, ("mlp", "w_down"): 0}
    return {("attn", "w_qkv"): 1, ("attn", "w_o"): 0, **mlp}


def check_world(config: ModelConfig, world: int) -> None:
    """What runs at ``world`` > 1: configs whose heads split over the ranks
    (JAX's ``TPAttn.sizes`` error otherwise) and, for MoE, whose experts
    do (the error of JAX's ``route_to_ranks``)."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if world > 1 and config.n_experts % world:
        raise ValueError(f"n_experts {config.n_experts} not divisible by "
                         f"world {world}")
    if world > 1:
        Qwen3(config, world=world).attn.sizes(world)


def shard_layers(params: dict, config: ModelConfig, world: int) -> dict:
    """The JAX-global parameter dict -> the rank-stacked one: each leaf of
    ``sharded_leaves(config)`` (L, ...) becomes (L, world, ...); the rest
    is kept."""
    if world == 1:
        return params
    w = World(world)
    layers = {k: dict(v) if isinstance(v, dict) else v
              for k, v in params["layers"].items()}
    for (block, name), dim in sharded_leaves(config).items():
        layers[block][name] = w.split(layers[block][name], dim + 1, at=1)
    return {**params, "layers": layers}


def params_from_jax(tree, config: ModelConfig, device=None, *,
                    world: int = 1) -> dict:
    """The weight carrier: turn a JAX ``Qwen3.init``/``load_hf`` parameter
    tree (nested dicts of numpy arrays, or of anything ``numpy.asarray``
    takes; global arrays, as ``numpy.asarray`` gathers them) into the
    port's parameter dict on ``device`` (default: the card; pass "cpu" for
    the CPU). Matrices take ``config.dtype``; norms and the MoE router stay
    f32. At ``world`` > 1 the leaves JAX shards are split into their rank
    stacks (``shard_layers``)."""
    import numpy as np

    check_world(config, world)
    device = resolve_device(device)

    def conv(x, dtype):
        arr = np.asarray(x)
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            # numpy has no bfloat16: ml_dtypes arrays go through float32
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.array(arr)).to(device=device,
                                                  dtype=dtype)

    mat, vec = config.dtype, torch.float32
    layers = tree["layers"]
    attn = {"w_qkv": conv(layers["attn"]["w_qkv"], mat),
            "w_o": conv(layers["attn"]["w_o"], mat)}
    if config.qk_norm:
        attn["q_norm"] = conv(layers["attn"]["q_norm"], vec)
        attn["k_norm"] = conv(layers["attn"]["k_norm"], vec)
    mlp = {"w_gate_up": conv(layers["mlp"]["w_gate_up"], mat),
           "w_down": conv(layers["mlp"]["w_down"], mat)}
    if config.n_experts:
        mlp["router"] = conv(layers["mlp"]["router"], vec)
    params = {
        "embed": conv(tree["embed"], mat),
        "final_norm": conv(tree["final_norm"], vec),
        "layers": {
            "input_norm": conv(layers["input_norm"], vec),
            "post_norm": conv(layers["post_norm"], vec),
            "attn": attn,
            "mlp": mlp,
        },
    }
    if not config.tie_embeddings:
        params["lm_head"] = conv(tree["lm_head"], mat)
    return shard_layers(params, config, world)


MODES = ("dist", "xla", "ar")


def check_ar(config: ModelConfig, mode: str) -> None:
    """The all-reduce mode is dense only, as in the JAX stack (qwen.py
    :340-344): raises its ``ValueError`` for an MoE config in ``mode="ar"``."""
    if mode == "ar" and config.n_experts:
        raise ValueError(
            "mode='ar' is a dense-TP latency path (GEMM + fused "
            "AllReduce); an MoE FFN's comm IS the expert dispatch — "
            "use mode='dist' (a2a kernels) or 'xla'")


@dataclasses.dataclass(frozen=True)
class Qwen3:
    config: ModelConfig
    world: int = 1

    @property
    def attn(self) -> TPAttn:
        c = self.config
        return TPAttn(d_model=c.d_model, n_heads=c.n_heads,
                      n_kv_heads=c.n_kv_heads, head_dim=c.head_dim,
                      rope_theta=c.rope_theta, rope_scaling=c.rope_scaling,
                      qk_norm=c.qk_norm, rms_eps=c.rms_eps, world=self.world)

    @property
    def mlp(self) -> TPMLP | MoEMLP:
        """The FFN block: dense ``TPMLP`` or sparse ``MoEMLP``; both take
        ``{dist,xla}_fwd(params, (n, d)) -> (n, d)``."""
        c = self.config
        if c.n_experts:
            return MoEMLP(d_model=c.d_model, d_ff=c.moe_d_ff,
                          n_experts=c.n_experts, topk=c.n_experts_per_tok,
                          norm_topk_prob=c.norm_topk_prob, dtype=c.dtype,
                          capacity_factor=c.moe_capacity_factor,
                          world=self.world)
        return TPMLP(d_model=c.d_model, d_ff=c.d_ff, world=self.world)

    def init(self, seed: int, device) -> dict:
        """Random parameters made on ``device`` from ``seed`` with a
        ``torch.Generator`` (normal, scaled by fan_in ** -0.5, in the
        config's dtype; norms are ones), in the JAX layout. The draws differ
        from JAX's ``Qwen3.init``; tests carry JAX weights over with
        ``params_from_jax`` instead. At ``world`` > 1 the sharded leaves are
        drawn straight into their rank stacks (no global copy is made: at
        Qwen3-32B one would not fit beside the stacks)."""
        c = self.config
        check_world(c, self.world)
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        L, d, dh = c.n_layers, c.d_model, c.head_dim

        def randw(shape, fan_in):
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=c.dtype)
            return w.mul_(fan_in ** -0.5)

        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=device)

        if self.world > 1:
            return self._init_stacked(randw, ones, gen, device)
        w_qkv = TPAttn.pack_qkv(randw((L, d, c.n_heads * dh), d),
                                randw((L, d, c.n_kv_heads * dh), d),
                                randw((L, d, c.n_kv_heads * dh), d))
        if c.n_experts:
            mlp = self.mlp.init(gen, device, L)
        else:
            w_gate_up = TPMLP.interleave_gate_up(randw((L, d, c.d_ff), d),
                                                 randw((L, d, c.d_ff), d))
        layer_attn = {"w_qkv": w_qkv,
                      "w_o": randw((L, c.n_heads * dh, d), c.n_heads * dh)}
        if c.qk_norm:
            layer_attn["q_norm"] = ones(L, dh)
            layer_attn["k_norm"] = ones(L, dh)
        params = {
            "embed": randw((c.vocab_size, d), d),
            "final_norm": ones(d),
            "layers": {
                "input_norm": ones(L, d),
                "post_norm": ones(L, d),
                "attn": layer_attn,
                "mlp": mlp if c.n_experts else {
                    "w_gate_up": w_gate_up,
                    "w_down": randw((L, c.d_ff, d), c.d_ff)},
            },
        }
        if not c.tie_embeddings:
            params["lm_head"] = randw((d, c.vocab_size), d)
        return params

    def _init_stacked(self, randw, ones, gen, device) -> dict:
        """``init`` at world > 1: the sharded leaves drawn in their rank
        stacks, the replicated ones once. An MoE config's expert leaves are
        drawn global and viewed as their stacks (rank r's experts are a
        contiguous block)."""
        c, w = self.config, self.world
        L, d, dh = c.n_layers, c.d_model, c.head_dim
        qs, kvs = self.attn.sizes(w)
        layer_attn = {"w_qkv": randw((L, w, d, qs + 2 * kvs), d),
                      "w_o": randw((L, w, qs, d), c.n_heads * dh)}
        if c.qk_norm:
            layer_attn["q_norm"] = ones(L, dh)
            layer_attn["k_norm"] = ones(L, dh)
        params = {
            "embed": randw((c.vocab_size, d), d),
            "final_norm": ones(d),
            "layers": {
                "input_norm": ones(L, d),
                "post_norm": ones(L, d),
                "attn": layer_attn,
                "mlp": self._init_stacked_mlp(randw, gen, device),
            },
        }
        if not c.tie_embeddings:
            params["lm_head"] = randw((d, c.vocab_size), d)
        return params

    def _init_stacked_mlp(self, randw, gen, device) -> dict:
        c, w = self.config, self.world
        L, d = c.n_layers, c.d_model
        if not c.n_experts:
            return {"w_gate_up": randw((L, w, d, 2 * c.d_ff // w), d),
                    "w_down": randw((L, w, c.d_ff // w, d), c.d_ff)}
        mlp = self.mlp.init(gen, device, L)
        for (block, name), dim in sharded_leaves(c).items():
            if block == "mlp":
                mlp[name] = World(w).split(mlp[name], dim + 1, at=1)
        return mlp

    def forward(self, params, ids, k_cache, v_cache, offset, *,
                mode: str = "dist", seq_lens=None, block_tables=None,
                slot_mask=None, paged_attn: str = "fused",
                kv_scales=None, return_moe_stats: bool = False):
        """One forward step. ids: (B, L) int. Returns the logits (B, vocab)
        f32 at each row's last position.

        Contiguous cache (``Engine``): k/v_cache (n_layers, B, S, Hkv, dh),
        written in place at ``[offset, offset + L)``.

        Serving (``BatchEngine``, the keywords of the JAX
        ``forward_device`` :271): ``offset`` a (B,) per-slot depth;
        ``seq_lens`` (B,) live tokens per row, and the logits of row b come
        from its last valid position ``seq_lens[b] - 1`` (0 when the row is
        empty: garbage the caller discards); ``block_tables`` (B,
        max_blocks) int32 and ``slot_mask`` (B,) bool switch the caches to
        the block pool (n_layers, n_blocks, block_size, Hkv, dh), written
        in place; ``paged_attn`` "fused" (the kernel) or "gather" (the
        oracle); ``kv_scales`` (k_scale, v_scale) the per-layer scale
        arenas (n_layers, n_blocks, block_size, Hkv) f32 of an int8/fp8
        pool. ``spec_verify`` waits for the speculative slice.

        ``return_moe_stats=True`` (MoE, ``mode="dist"``) returns ``(logits,
        stats)``: ``stats`` the (token, expert) pairs the static capacities
        dropped, ``{"n_dropped_dispatch", "n_dropped_expert"}`` () int32
        device tensors summed over layers and ranks (the JAX :315-347,
        :446-447).

        An MoE config routes every row of the step, padding rows included,
        as the JAX stack does (``hn.reshape(-1, d)``).

        At ``world`` > 1 (contiguous cache): the parameters in their rank
        stacks, the cache in the global layout, and in dist and xla mode B
        divisible by world (JAX's ``ValueError`` otherwise)."""
        c = self.config
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
        check_ar(c, mode)
        if self.world > 1:
            check_world(c, self.world)
            B = ids.shape[0]
            if mode in ("dist", "xla") and B % self.world:
                raise ValueError(f"batch {B} not divisible by world "
                                 f"{self.world} (required in {mode} mode)")
            if block_tables is not None:
                raise NotImplementedError(
                    "the block-paged serving step at world > 1 (BatchEngine "
                    "over simulated ranks) is not ported yet: see "
                    "ROADMAP.md")
        if return_moe_stats and (not c.n_experts or mode != "dist"):
            raise ValueError("return_moe_stats requires an MoE config in "
                             "mode='dist' (drops exist only on the dispatch "
                             "path)")
        if kv_scales is not None and block_tables is None:
            raise ValueError("kv_scales requires the paged cache layout "
                             "(block_tables)")
        attn_kw = dict(seq_lens=seq_lens)
        if block_tables is not None:
            # The pool addressing depends on the step alone: built once here,
            # shared by every layer's writes and reads.
            step = nn.paged_step(block_tables, offset, ids.shape[1],
                                 *k_cache.shape[1:3], slot_mask=slot_mask,
                                 seq_lens=seq_lens)
            attn_kw.update(block_tables=block_tables, slot_mask=slot_mask,
                           paged_attn=paged_attn, paged_step=step)
        attn, mlp = self.attn, self.mlp
        lp = params["layers"]
        moe_dist = bool(c.n_experts) and mode == "dist"
        stats = None
        h = params["embed"][ids.long()]                       # (B, L, d)
        for i in range(c.n_layers):
            la = {k: v[i] for k, v in lp["attn"].items()}
            lm = {k: v[i] for k, v in lp["mlp"].items()}
            if kv_scales is not None:
                attn_kw["kv_scales"] = (kv_scales[0][i], kv_scales[1][i])
            resid = h
            hn = nn.rms_norm(h, lp["input_norm"][i], c.rms_eps)
            fwd = {"dist": attn.dist_fwd, "xla": attn.xla_fwd,
                   "ar": attn.ar_fwd}[mode]
            h = resid + fwd(la, hn, k_cache[i], v_cache[i], offset, **attn_kw)
            resid = h
            flat = nn.rms_norm(h, lp["post_norm"][i],
                               c.rms_eps).reshape(-1, c.d_model)
            if moe_dist:
                # The JAX signature: stacked expert weights + the layer.
                lm.update(w_gate_up=lp["mlp"]["w_gate_up"],
                          w_down=lp["mlp"]["w_down"])
                m = mlp.dist_fwd(lm, flat, return_stats=return_moe_stats,
                                 layer_idx=i)
                if return_moe_stats:
                    m, layer = m
                    layer = {k: v.sum(dtype=torch.int32)
                             for k, v in layer.items()}
                    stats = (layer if stats is None else
                             {k: stats[k] + layer[k] for k in stats})
            elif mode == "dist":
                m = mlp.dist_fwd(lm, flat)
            elif mode == "ar":
                m = mlp.ar_fwd(lm, flat)
            else:
                m = mlp.xla_fwd(lm, flat)
            h = resid + m.reshape(h.shape)
        if seq_lens is None:
            last = h[:, -1]
        else:
            idx = torch.clamp(seq_lens.long() - 1, min=0)
            last = h[torch.arange(h.shape[0], device=h.device), idx]
        last = nn.rms_norm(last, params["final_norm"], c.rms_eps)
        lm_head = (params["embed"].T if c.tie_embeddings
                   else params["lm_head"])
        # Operands in their stored dtype, products summed in f32: the JAX
        # dot with preferred_element_type=f32.
        logits = torch.matmul(last.float(), lm_head.float())
        if return_moe_stats:
            return logits, stats
        return logits
