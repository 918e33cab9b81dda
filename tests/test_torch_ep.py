"""The port's expert-parallel path at world 4 against the JAX package's, on
the CPU: the plain version of the multi-rank all-to-all against the JAX
``all_to_all`` (its ``_a2a_kernel`` interpreted on the conftest ``mesh8``,
at ``tests/test_ep_a2a.py``'s sizes: every buffer <= 12 KB per device),
``EPAll2AllLayer`` dispatch/combine and ``MoEMLP.dist_fwd`` against the JAX
layers on a 4-device mesh (drop-free and tight capacities, the drop
counters of every rank equal), the placement of the expert leaves, the
perf model's all-to-all terms, and the slice, ``Engine(tiny-moe,
world=4)`` in dist and xla mode against the JAX xla engine on the mesh
(JAX's own ``tests/test_moe_model.py:151`` holds its dist engine to that
golden), with ``moe_drop_stats`` against the JAX dist engine's at a
roomy and a tight capacity factor. Plus the refusals.

Bars: the exchange moves bytes, so the rows below each count and the
counts are held exactly; the layers and engines fp32 ``rtol=atol=1e-5``
(the routing and the data movement are exact; sums run in other orders),
the engines' tokens identical. Inputs come from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from triton_distributed_tpu.kernels import ep_all_to_all as jea
from triton_distributed_tpu.kernels import moe_utils as jmu
from triton_distributed_tpu.layers.ep_a2a_layer import (
    EPAll2AllLayer as JaxEPLayer,
)
from triton_distributed_tpu.layers.moe_mlp import MoEMLP as JaxMoEMLP
from triton_distributed_tpu.layers.tp_attn import TPAttn as JaxAttn
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.runtime import perf_model as jpm
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu.runtime.mesh import make_mesh
from triton_distributed_tpu_torch import (
    BatchEngine,
    Engine,
    ModelConfig,
    params_from_jax,
)
from triton_distributed_tpu_torch.kernels import KERNELS, _build
from triton_distributed_tpu_torch.kernels import ep_all_to_all as tea
from triton_distributed_tpu_torch.layers import EPAll2AllLayer, MoEMLP
from triton_distributed_tpu_torch.runtime import perf_model as pm
from triton_distributed_tpu_torch.runtime.mesh import World

W = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh({"tp": W}, devices=jax.devices()[:W],
                     set_default=False)


def _no_launches():
    return all(k.launches == 0 for k in KERNELS.values())


def _bytes(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8).reshape(*a.shape[:3], -1)


def _tbytes(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return t.view(torch.uint8).reshape(*t.shape[:3], -1).numpy()


# -- 1. the exchange against the JAX kernel (mesh8) ---------------------------

CAP, CH = 16, 8
# Per (src, dst): zero, partial chunks, chunk edges, full, past capacity and
# below zero; no two rows alike, so a transposed pair would show.
COUNTS = np.array([[(3 * r + 5 * p) % 21 - 2 for p in range(8)]
                   for r in range(8)], np.int32)


def _payloads(rng):
    """(8, 8, 16, ...) payloads (<= 8 KB per device each): f32 tokens, fp8
    tokens, f32 scales, int32 expert ids."""
    return (rng.standard_normal((8, 8, CAP, 16)).astype(np.float32),
            rng.standard_normal((8, 8, CAP, 32)).astype(
                np.float32).astype(ml_dtypes.float8_e4m3fn),
            rng.random((8, 8, CAP, 1), dtype=np.float32),
            rng.integers(-1, 100, (8, 8, CAP, 1)).astype(np.int32))


# The port's calls: one payload, fp8 tokens with their scales, several.
CASES = {"one": (0,), "fp8": (1, 2), "several": (0, 3, 2, 1)}


@pytest.fixture(scope="module")
def jax_a2a(mesh8):
    """The JAX host wrapper's output for all four payloads in one call (a
    payload's rows do not depend on the others riding with it)."""
    pays = _payloads(np.random.default_rng(0))
    ctx = jea.AllToAllContext(capacity=CAP, hidden=16, axis="tp",
                              chunk_rows=CH)
    out, rc = jea.all_to_all(tuple(jnp.asarray(p) for p in pays),
                             jnp.asarray(COUNTS), ctx=ctx, mesh=mesh8)
    return pays, tuple(np.asarray(o) for o in out), np.asarray(rc)


@pytest.mark.parametrize("case", ["one", "fp8", "several"])
def test_fast_all_to_all_ref_matches_jax_below_every_count(jax_a2a, case):
    arrays, jall, jrc = jax_a2a
    pick = CASES[case]
    pays = tuple(torch.from_numpy(p.view(np.uint8)).view(torch.float8_e4m3fn)
                 if p.dtype == ml_dtypes.float8_e4m3fn
                 else torch.from_numpy(p) for p in (arrays[i] for i in pick))
    ctx = tea.AllToAllContext(capacity=CAP, hidden=16, chunk_rows=CH)
    out, rc = tea.all_to_all(pays if len(pays) > 1 else pays[0],
                             torch.from_numpy(COUNTS), ctx=ctx)
    out = out if len(pays) > 1 else (out,)
    jout = [jall[i] for i in pick]
    np.testing.assert_array_equal(rc.numpy(), jrc)
    np.testing.assert_array_equal(jrc, COUNTS.T)
    live = np.clip(jrc, 0, CAP)
    for t, j, pay in zip(out, jout, pays):
        assert t.dtype == pay.dtype and t.shape == pay.shape
        tb, jb = _tbytes(t), _bytes(j)
        for r in range(8):
            for p in range(8):
                n = live[r, p]
                np.testing.assert_array_equal(tb[r, p, :n], jb[r, p, :n],
                                              err_msg=f"{case} r={r} p={p}")
                # Past the count the plain version holds zeros.
                assert not tb[r, p, n:].any()
    assert _no_launches()


def test_fast_all_to_all_shapes_and_refusals():
    ctx = tea.AllToAllContext(capacity=8, hidden=4)
    pay = torch.randn(4, 4, 8, 4)
    counts = torch.full((4, 4), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="world=4"):
        tea.fast_all_to_all(pay[:, :3], counts, ctx=ctx, world=4)
    with pytest.raises(ValueError, match=r"send_counts \(4,\) != \(4, 4\)"):
        tea.fast_all_to_all(pay, counts[0], ctx=ctx, world=4)
    with pytest.raises(ValueError) as want:
        jea.fast_all_to_all(None, None, ctx=None, direction="both")
    with pytest.raises(ValueError) as got:
        tea.fast_all_to_all(pay, counts, ctx=ctx, world=4, direction="both")
    assert str(got.value) == str(want.value)
    # A full exchange is its own inverse: combine of dispatch returns it.
    back, rc = tea.fast_all_to_all(pay, counts, ctx=ctx, world=4)
    again, rc2 = tea.fast_all_to_all(back, rc, ctx=ctx, world=4,
                                     direction="combine")
    assert torch.equal(again, pay) and torch.equal(rc2, counts)


# -- 2. the layers on a 4-device mesh ----------------------------------------

D, FF, E, K = 32, 16, 8, 2
N = 8                         # tokens per rank
# The exchange layer's capacities, and MoEMLP's factors that size the
# same ones there (MoEMLP._capacities at 8 tokens a rank: 16 / 64, 8 / 16).
ROOMY = dict(capacity=16, expert_capacity=32)
TIGHT = dict(capacity=8, expert_capacity=16)
FACTORS = {"roomy": 64.0, "tight": 0.5}


def _tokens(rng, n):
    """Tokens with a skew: three in four equal to one token, so their
    expert pair overflows a tight capacity."""
    x = rng.standard_normal((n, D)).astype(np.float32)
    x[np.arange(n) % 4 != 0] = x[0]
    return x


@pytest.fixture(scope="module")
def layer_case(mesh4):
    """Seeded MoE weights, tokens and top-k routing, and the JAX layers'
    outputs in one program: the exchange layer (dispatch -> grouped GEMM
    -> combine) and ``MoEMLP.fwd(mode="dist")``, at roomy and tight
    capacities, every rank's drop counters."""
    rng = np.random.default_rng(1)
    params = {"router": rng.standard_normal((D, E)).astype(np.float32),
              "w_gate_up": (rng.standard_normal((E, D, 2 * FF))
                            * D ** -0.5).astype(np.float32),
              "w_down": (rng.standard_normal((E, FF, D))
                         * FF ** -0.5).astype(np.float32)}
    x = _tokens(rng, W * N)
    wts = rng.random((W * N, K)).astype(np.float32)
    ids = np.stack([rng.permutation(E)[:K] for _ in range(W * N)]).astype(
        np.int32)
    ids[np.arange(W * N) % 4 != 0] = ids[0]
    ew = (rng.standard_normal((E, D, D)) * D ** -0.5).astype(np.float32)
    kinds = {"roomy": ROOMY, "tight": TIGHT}
    layers = {k: JaxEPLayer(n_experts=E, topk=K, hidden=D, axis="tp", **c)
              for k, c in kinds.items()}
    mlps = {k: JaxMoEMLP(d_model=D, d_ff=FF, n_experts=E, topk=K,
                         axis="tp", dtype=jnp.float32,
                         capacity_factor=FACTORS[k]) for k in kinds}

    def f(p, xl, il, wl, ewl):
        out = {}
        for k in kinds:
            grouped, counts, st = layers[k].dispatch(xl, il, wl)
            y = layers[k].combine(jmu.grouped_gemm(grouped, ewl), st)
            m, ms = mlps[k].dist_fwd(p, xl, return_stats=True)
            out[k] = (grouped, counts, st["rcounts"][None], y,
                      {s: v[None] for s, v in st["stats"].items()}, m,
                      {s: v[None] for s, v in ms.items()})
        return out

    row = P("tp", None)
    spec = (P("tp", None, None), P("tp"), P("tp", None), row,
            {s: P("tp") for s in ("n_dropped_dispatch", "n_dropped_expert")},
            row, {s: P("tp") for s in ("n_dropped_dispatch",
                                       "n_dropped_expert")})
    got = jax.jit(shard_map(
        f, mesh=mesh4, in_specs=(mlps["roomy"].param_specs(), row, row, row,
                                 P("tp", None, None)),
        out_specs={k: spec for k in kinds}, check_vma=False))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(ids), jnp.asarray(wts), jnp.asarray(ew))
    return dict(params=params, x=x, ids=ids, wts=wts, ew=ew, kinds=kinds,
                got=jax.tree.map(np.asarray, got))


def _stats(st):
    return {k: v.numpy().tolist() for k, v in st.items()}


@pytest.mark.parametrize("kind", ["roomy", "tight"])
def test_ep_layer_dispatch_and_combine_match_jax(layer_case, kind):
    c = layer_case
    grouped_j, counts_j, rcounts_j, y_j, stats_j, _, _ = c["got"][kind]
    layer = EPAll2AllLayer(n_experts=E, topk=K, hidden=D, world=W,
                           **c["kinds"][kind])
    x = torch.from_numpy(c["x"]).reshape(W, N, D)
    ids = torch.from_numpy(c["ids"]).reshape(W, N, K)
    wts = torch.from_numpy(c["wts"]).reshape(W, N, K)
    grouped, counts, state = layer.dispatch(x, ids, wts)
    el = E // W
    # Data movement only: the grids bit for bit.
    np.testing.assert_array_equal(grouped.numpy(),
                                  grouped_j.reshape(W, el, -1, D))
    np.testing.assert_array_equal(counts.numpy(), counts_j.reshape(W, el))
    np.testing.assert_array_equal(state["rcounts"].numpy(), rcounts_j)
    assert _stats(state["stats"]) == {k: v.tolist()
                                      for k, v in stats_j.items()}
    assert (sum(map(sum, _stats(state["stats"]).values())) > 0) == (
        kind == "tight")
    ew = torch.from_numpy(c["ew"]).reshape(W, el, D, D)
    y = layer.moe_mlp(x, ids, wts, ew)
    np.testing.assert_allclose(y.reshape(W * N, D).numpy(), y_j, **TOL)
    assert _no_launches()


@pytest.mark.parametrize("kind", ["roomy", "tight"])
def test_moe_mlp_dist_fwd_world4_matches_jax(layer_case, kind):
    c = layer_case
    _, _, _, _, _, m_j, ms_j = c["got"][kind]
    mlp = MoEMLP(d_model=D, d_ff=FF, n_experts=E, topk=K,
                 dtype=torch.float32, capacity_factor=FACTORS[kind], world=W)
    assert mlp._capacities(N) == {"roomy": (16, 64), "tight": (8, 16)}[kind]
    w = World(W)
    params = {"router": torch.from_numpy(c["params"]["router"])}
    for name in ("w_gate_up", "w_down"):
        params[name] = w.split(torch.from_numpy(c["params"][name]), 0)
    x = torch.from_numpy(c["x"])
    y, stats = mlp.dist_fwd(params, x, return_stats=True)
    np.testing.assert_allclose(y.numpy(), m_j, **TOL)
    assert _stats(stats) == {k: v.tolist() for k, v in ms_j.items()}
    assert (sum(map(sum, _stats(stats).values())) > 0) == (kind == "tight")
    if kind == "roomy":
        # Drop-free: the golden (every pair through its expert) agrees,
        # and so does the plain batched product.
        np.testing.assert_allclose(mlp.xla_fwd(params, x).numpy(), m_j,
                                   **TOL)
        np.testing.assert_allclose(
            mlp.dist_fwd(params, x, skip_gemm=False).numpy(), y.numpy(),
            **TOL)
    assert _no_launches()


def test_ep_layer_refuses_the_2d_exchange():
    with pytest.raises(NotImplementedError, match="dcn_axis"):
        EPAll2AllLayer(n_experts=E, topk=K, hidden=D, capacity=8,
                       expert_capacity=16, world=W, dcn_axis="dcn")


# -- 3. the perf model's all-to-all terms ------------------------------------

def test_perf_model_all_to_all_terms_match_jax():
    v5e = jpm.detect_hardware()
    hw = pm.Hardware("v5e", v5e.peak_bf16_flops, v5e.hbm_bw,
                     link_bw=v5e.ici_link_bw, links=v5e.ici_links,
                     hop_lat=v5e.ici_hop_lat, ring_bisection=True)
    for world in (2, 4, 8):
        for nbytes in (1 << 10, 1 << 20, 1 << 26):
            assert pm.wire_bytes_all_to_all(nbytes, world) == \
                jpm.wire_bytes_all_to_all(nbytes, world)
            assert pm.est_push_all_gather(nbytes, world, hw) == \
                pytest.approx(jpm.est_push_all_gather(nbytes, world, v5e),
                              rel=1e-12)
    # Qwen3-30B-A3B's world-4 dispatch at full occupancy: bf16 tokens of
    # 2,048 and int32 ids, 16,384 live rows a pair (past 20,000: capped).
    counts = [[16384, 16384, 20000, 0]] * 4
    assert pm.ep_a2a_bytes(counts, 16384, (4096, 4)) == \
        2 * 12 * 16384 * 4100 + 2 * 4 * 16


# -- 4. the slice: Engine(tiny-moe, world=4) ---------------------------------

B, L0, GEN = 8, 4, 4            # tests/test_moe_model.py:151-168


def _numpy_tree(jcfg, mesh, seed):
    """A JAX parameter tree for ``jcfg`` on ``mesh`` from a numpy seed:
    norms one, every other leaf normal / sqrt(fan_in)."""
    model = JaxQwen3(jcfg, block_n=8)
    shapes = jax.eval_shape(lambda key: model.init(key, mesh),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if "norm" in jax.tree_util.keystr(path):
            return np.ones(s.shape, np.float32)
        return (rng.standard_normal(s.shape)
                * s.shape[-2] ** -0.5).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    placed = jax.tree.map(lambda x, sp: jax.device_put(
        x, NamedSharding(mesh, sp)), tree, model.param_specs())
    return tree, placed


@pytest.fixture(scope="module")
def moe4(mesh4):
    """JAX tiny-moe weights on the 4-device mesh, a prompt (rows 0 and 1
    equal: skewed routing), the JAX xla engine's prefill logits and greedy
    tokens, and the JAX dist engine's drop audit at factors 64 and 0.25."""
    jcfg = JaxConfig.from_name("tiny-moe", moe_capacity_factor=64.0)
    tree, placed = _numpy_tree(jcfg, mesh4, seed=7)
    ids = np.random.default_rng(3).integers(0, 128, (B, L0)).astype(np.int32)
    ids[1] = ids[0]
    jeng = JaxEngine(jcfg, mesh=mesh4, mode="xla", params=placed, block_n=8)
    logits, _ = jeng.prefill(jnp.asarray(ids), jeng.new_cache(B))
    drops = {}
    for factor in (64.0, 0.25):
        dist = JaxEngine(JaxConfig.from_name("tiny-moe",
                                             moe_capacity_factor=factor),
                         mesh=mesh4, mode="dist", params=placed, block_n=8)
        drops[factor] = dist.moe_drop_stats(jnp.asarray(ids))
    return dict(tree=tree, placed=placed, ids=ids, logits=np.asarray(logits),
                tokens=np.asarray(jeng.serve(jnp.asarray(ids), GEN)),
                drops=drops)


def test_params_from_jax_world4_places_as_jax(moe4):
    """Every sharded leaf's rank r is what JAX's NamedSharding puts on
    device r (the experts on E, [gate | up] whole per expert); the router
    is held once, as JAX replicates it."""
    cfg = ModelConfig.from_name("tiny-moe")
    params = params_from_jax(moe4["tree"], cfg, device="cpu", world=W)
    placed = moe4["placed"]["layers"]
    for block, name in (("attn", "w_qkv"), ("attn", "w_o"),
                        ("mlp", "w_gate_up"), ("mlp", "w_down")):
        stack = params["layers"][block][name]
        assert stack.shape[:2] == (cfg.n_layers, W)
        by_dev = {s.device: np.asarray(s.data)
                  for s in placed[block][name].addressable_shards}
        for r, dev in enumerate(placed[block][name].sharding.mesh.devices
                                .flat):
            np.testing.assert_array_equal(stack[:, r].reshape(
                by_dev[dev].shape).numpy(), by_dev[dev])
    router = params["layers"]["mlp"]["router"]
    assert router.shape == (cfg.n_layers, cfg.d_model, cfg.n_experts)
    np.testing.assert_array_equal(router.numpy(),
                                  moe4["tree"]["layers"]["mlp"]["router"])
    # The expert stack is a view of the global leaf: no copy was made.
    gu = params["layers"]["mlp"]["w_gate_up"]
    assert gu.is_contiguous() and torch.equal(
        gu.flatten(1, 2), torch.from_numpy(
            moe4["tree"]["layers"]["mlp"]["w_gate_up"]))


@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_engine_world4_moe_matches_the_jax_engine(moe4, mode):
    cfg = ModelConfig.from_name("tiny-moe", moe_capacity_factor=64.0)
    params = params_from_jax(moe4["tree"], cfg, device="cpu", world=W)
    eng = Engine(cfg, mode=mode, device="cpu", params=params, world=W)
    _build.reset_counts()
    logits, _ = eng.prefill(moe4["ids"], eng.new_cache(B))
    np.testing.assert_allclose(logits.numpy(), moe4["logits"], atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_array_equal(eng.serve(moe4["ids"], GEN).numpy(),
                                  moe4["tokens"])
    assert _no_launches()


@pytest.mark.parametrize("factor", [64.0, 0.25])
def test_moe_drop_stats_world4_match_jax(moe4, factor):
    cfg = ModelConfig.from_name("tiny-moe", moe_capacity_factor=factor)
    params = params_from_jax(moe4["tree"], cfg, device="cpu", world=W)
    got = Engine(cfg, device="cpu", params=params, world=W).moe_drop_stats(
        moe4["ids"])
    assert got == moe4["drops"][factor]
    assert (sum(got.values()) > 0) == (factor < 1)


def test_world4_moe_refusals_match_jax(moe4):
    """ar mode with an MoE config (JAX :340-344), experts or heads that do
    not split over the world (JAX's errors), and the paged serving step
    at world > 1 (not ported)."""
    cfg = ModelConfig.from_name("tiny-moe")
    with pytest.raises(ValueError, match="MoE"):
        Engine(cfg, mode="ar", device="cpu", seed=0, world=W)
    with pytest.raises(ValueError) as want:
        jmu.route_to_ranks(jnp.zeros((1, 2), jnp.int32), jnp.zeros((1, 2)),
                           n_experts=6, world=W, capacity=8)
    with pytest.raises(ValueError) as got:
        Engine(dataclasses.replace(cfg, n_experts=6), device="cpu", world=W)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JaxAttn(d_model=64, n_heads=8, n_kv_heads=2, head_dim=8).sizes(W)
    with pytest.raises(ValueError) as got:
        Engine(dataclasses.replace(cfg, n_kv_heads=2), device="cpu",
               world=W)
    assert str(got.value) == str(want.value)
    params = params_from_jax(moe4["tree"], cfg, device="cpu", world=W)
    eng = Engine(cfg, device="cpu", params=params, world=W)
    with pytest.raises(NotImplementedError, match="world > 1"):
        eng.make_paged_step("decode")
    with pytest.raises(NotImplementedError, match="world > 1"):
        BatchEngine(eng, n_slots=2, block_size=4)
