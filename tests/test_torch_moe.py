"""The MoE slice on the CPU against the JAX package at world 1.

1. ``MoEMLP.dist_fwd`` and ``xla_fwd`` against the JAX layer on the same
   weights and tokens: at the default ``capacity_factor`` with skewed
   tokens (pairs are dropped: the drop counters must be equal), at one
   under 1 (the dispatch drops pairs too) and at a roomy one (no drops;
   both of the port's paths agree with the JAX ones).
   Bar 1e-5 (fp32; the golden sums each expert's rows in another order).
2. ``Engine`` on ``tiny-moe`` against the JAX dist ``Engine``: prefill
   logits within 2e-4, greedy tokens identical; ``moe_drop_stats`` equal
   at a capacity factor under 1 (both counters non-zero).
3. ``BatchEngine`` on ``tiny-moe`` (capacities roomy enough for no drops:
   padding rows are routed too) against the JAX ``BatchEngine`` and
   against the port's per-request ``Engine``: tokens identical, in both of
   the port's modes. The JAX side reads its pool through the gather oracle
   (a fused JAX engine is slow in the Pallas interpreter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.layers.moe_mlp import MoEMLP as JaxMoEMLP
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu.runtime.mesh import make_mesh
from triton_distributed_tpu.serving import BatchEngine as JaxBatchEngine
from triton_distributed_tpu_torch import (
    BatchEngine,
    Engine,
    ModelConfig,
    params_from_jax,
)
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP

ROOMY = 64.0   # capacity factor with no drops at these sizes


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh({"tp": 1}, devices=jax.devices()[:1], set_default=False)


# -- 1. the MoE block ---------------------------------------------------------

MLP_KW = dict(d_model=32, d_ff=16, n_experts=8, topk=2)


def _jax_mlp_fwd(mesh, jlayer, mode, jparams, x):
    def f(p, xl):
        if mode == "xla":
            return jlayer.xla_fwd(p, xl)
        return jlayer.dist_fwd(p, xl, return_stats=True)
    out_specs = P("tp", None) if mode == "xla" else (P("tp", None), P())
    return jax.jit(shard_map(f, mesh=mesh,
                             in_specs=(jlayer.param_specs(), P("tp", None)),
                             out_specs=out_specs, check_vma=False))(
        jparams, jnp.asarray(x))


@pytest.fixture(scope="module")
def mlp_case(mesh1):
    """Seeded weights and tokens of the MoE block, and the JAX golden's
    output (its worst-case grid does not depend on the capacity factor)."""
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy((rng.standard_normal(shape)
                                   * shape[-2] ** -0.5).astype(np.float32))
              for k, shape in (("router", (32, 8)),
                               ("w_gate_up", (8, 32, 32)),
                               ("w_down", (8, 16, 32)))}
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    x = rng.standard_normal((40, 32)).astype(np.float32)
    x[4:] = x[0]   # 36 of 40 tokens identical: their expert pair overflows
    jlayer = JaxMoEMLP(axis="tp", dtype=jnp.float32, **MLP_KW)
    return dict(params=params, jparams=jparams, x=x,
                golden=np.asarray(_jax_mlp_fwd(mesh1, jlayer, "xla",
                                               jparams, x)))


@pytest.mark.parametrize("factor", [0.5, 2.0, ROOMY])
def test_moe_mlp_matches_jax(mesh1, mlp_case, factor):
    jlayer = JaxMoEMLP(axis="tp", dtype=jnp.float32, capacity_factor=factor,
                       **MLP_KW)
    layer = MoEMLP(dtype=torch.float32, capacity_factor=factor, **MLP_KW)
    params, x = mlp_case["params"], mlp_case["x"]
    jy, jstats = _jax_mlp_fwd(mesh1, jlayer, "dist", mlp_case["jparams"], x)
    y, stats = layer.dist_fwd(params, torch.from_numpy(x), return_stats=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in jstats.items()}
    assert (sum(int(v) for v in stats.values()) > 0) == (factor != ROOMY)
    # Under a factor of 1 the dispatch capacity drops pairs too.
    assert (int(stats["n_dropped_dispatch"]) > 0) == (factor < 1)
    # The golden: no capacity, so the JAX worst-case grid's answer.
    np.testing.assert_allclose(layer.xla_fwd(params, torch.from_numpy(x))
                               .numpy(), mlp_case["golden"], atol=1e-5,
                               rtol=1e-5)
    # The plain batched product gives dist_fwd's answer too.
    np.testing.assert_allclose(
        layer.dist_fwd(params, torch.from_numpy(x), skip_gemm=False).numpy(),
        y.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_path_hands_the_kernel_contiguous_operands(monkeypatch, dtype):
    """The grouped-GEMM kernel takes contiguous operands (its wrapper raises
    otherwise); on the CPU the plain version does not care, so the operands
    of the MoE path are checked here."""
    from triton_distributed_tpu_torch.kernels import moe_utils

    seen = []
    real = moe_utils.grouped_gemm_skip

    def checked(grouped, weights, counts, **kw):
        seen.append(grouped.is_contiguous() and weights.is_contiguous()
                    and counts.dtype == torch.int32)
        return real(grouped, weights, counts, **kw)

    monkeypatch.setattr(moe_utils, "grouped_gemm_skip", checked)
    cfg = ModelConfig.from_name("tiny-moe", dtype=dtype)
    eng = Engine(cfg, device="cpu", seed=0)
    eng.serve(np.arange(12, dtype=np.int32).reshape(2, 6), 2)
    assert seen and all(seen)


def test_route_and_stack_experts_match_jax(mesh1):
    kw = dict(d_model=16, d_ff=8, n_experts=8, topk=3, norm_topk_prob=False)
    rng = np.random.default_rng(4)
    router = rng.standard_normal((16, 8)).astype(np.float32)
    x = rng.standard_normal((10, 16)).astype(np.float32)
    jw, jids = JaxMoEMLP(**kw).route(jnp.asarray(router), jnp.asarray(x))
    w, ids = MoEMLP(**kw).route(torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    mats = [rng.standard_normal((3, 16, 8)).astype(np.float32)
            for _ in range(2)] + [rng.standard_normal((3, 8, 16))
                                  .astype(np.float32)]
    got = MoEMLP.stack_experts(*[[torch.from_numpy(m) for m in ms]
                                 for ms in mats])
    want = JaxMoEMLP.stack_experts(*[[jnp.asarray(m) for m in ms]
                                     for ms in mats])
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


# -- 2. Engine ----------------------------------------------------------------

def _numpy_tree(jcfg, mesh, seed):
    """A JAX parameter tree for ``jcfg`` from a numpy seed: norms one (as
    the JAX init makes them), every other leaf normal / sqrt(fan_in)."""
    shapes = jax.eval_shape(
        lambda key: JaxQwen3(jcfg, block_n=8).init(key, mesh),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if "norm" in jax.tree_util.keystr(path):
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray((rng.standard_normal(s.shape)
                            * s.shape[-2] ** -0.5).astype(s.dtype))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def moe_case(mesh1):
    """The JAX tiny-moe dist engine (capacities roomy enough for no drops),
    the port's copy of its weights, a prompt, and the JAX logits and
    tokens. The BatchEngine cases share the engine."""
    jcfg = JaxConfig.from_name("tiny-moe", moe_capacity_factor=ROOMY)
    jeng = JaxEngine(jcfg, mesh=mesh1, mode="dist", block_n=8,
                     params=_numpy_tree(jcfg, mesh1, seed=7))
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                             ModelConfig.from_name("tiny-moe"), device="cpu")
    ids = np.random.default_rng(1).integers(0, 128, (4, 6)).astype(np.int32)
    ids[1] = ids[0]     # two identical prompts: skewed routing
    jlogits, _ = jeng.prefill(jnp.asarray(ids), jeng.new_cache(4))
    return dict(jeng=jeng, params=params, ids=ids,
                jlogits=np.asarray(jlogits),
                jtokens=np.asarray(jeng.serve(jnp.asarray(ids), 5)))


@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_moe_engine_matches_jax(moe_case, mode):
    eng = Engine(ModelConfig.from_name("tiny-moe", moe_capacity_factor=ROOMY),
                 mode=mode, device="cpu", params=moe_case["params"])
    ids = moe_case["ids"]
    logits, _ = eng.prefill(ids, eng.new_cache(ids.shape[0]))
    np.testing.assert_allclose(logits.numpy(), moe_case["jlogits"],
                               atol=2e-4, rtol=2e-4)
    _build.reset_counts()
    np.testing.assert_array_equal(eng.serve(ids, 5).numpy(),
                                  moe_case["jtokens"])
    assert all(k.launches == 0 for k in _build.KERNELS.values())


def test_moe_drop_stats_match_jax(moe_case):
    """A capacity factor under 1: the dispatch capacity drops pairs too."""
    tight = 0.5
    eng = Engine(ModelConfig.from_name("tiny-moe", moe_capacity_factor=tight),
                 device="cpu", params=moe_case["params"])
    jeng = JaxEngine(JaxConfig.from_name("tiny-moe",
                                         moe_capacity_factor=tight),
                     mesh=moe_case["jeng"].mesh, mode="dist",
                     params=moe_case["jeng"].params, block_n=8)
    # Three tokens in four one id: at layer 0 they pick the same experts.
    long_ids = np.arange(64, dtype=np.int32).reshape(4, 16)
    long_ids[:, np.arange(16) % 4 != 0] = 5
    got = eng.moe_drop_stats(long_ids)
    assert got == jeng.moe_drop_stats(jnp.asarray(long_ids))
    assert got["n_dropped_dispatch"] > 0 and got["n_dropped_expert"] > 0
    roomy = Engine(ModelConfig.from_name("tiny-moe",
                                         moe_capacity_factor=ROOMY),
                   device="cpu", params=moe_case["params"])
    assert roomy.moe_drop_stats(long_ids) == {"n_dropped_dispatch": 0,
                                              "n_dropped_expert": 0}
    with pytest.raises(ValueError, match="MoE"):
        Engine(ModelConfig.from_name("tiny"), device="cpu").moe_drop_stats(
            long_ids)


# -- 3. BatchEngine -----------------------------------------------------------

def _stream(be, prompts, gens):
    """Staggered arrivals: two requests, two steps, then the rest."""
    rids = [be.submit(p, g) for p, g in zip(prompts[:2], gens[:2])]
    be.step()
    be.step()
    rids += [be.submit(p, g) for p, g in zip(prompts[2:], gens[2:])]
    out = be.run(max_steps=1000)
    return [list(map(int, out[r])) for r in rids]


@pytest.fixture(scope="module")
def moe_serving(moe_case):
    """The JAX BatchEngine's tokens on the roomy tiny-moe engine."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (9, 5, 12, 7)]
    gens = [4, 5, 3, 4]
    kw = dict(n_slots=3, n_blocks=9, block_size=4, prefill_chunk=8)
    jbe = JaxBatchEngine(moe_case["jeng"], paged_attn="gather",
                         windowed_metrics=False, blackbox=False,
                         tail_sampling=False, journey=False,
                         efficiency=False, incidents=False, **kw)
    return dict(prompts=prompts, gens=gens, kw=kw,
                want=_stream(jbe, prompts, gens))


@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_moe_batch_engine_matches_jax_and_engine(moe_case, moe_serving,
                                                 mode):
    cfg = ModelConfig.from_name("tiny-moe", moe_capacity_factor=ROOMY)
    eng = Engine(cfg, mode=mode, device="cpu", params=moe_case["params"])
    be = BatchEngine(eng, **moe_serving["kw"])
    got = _stream(be, moe_serving["prompts"], moe_serving["gens"])
    assert got == moe_serving["want"]
    for out, p, g in zip(got, moe_serving["prompts"], moe_serving["gens"]):
        assert out == eng.serve(torch.tensor([p]), g)[0].tolist()
    assert be.trace_counts == {"decode": 1, "prefill": 1}
