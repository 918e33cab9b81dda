"""The slice end to end: the port's ``Engine`` on the CPU against the JAX
``Engine`` on a world-1 mesh, both running the same weights (JAX
``Qwen3.init`` carried over by ``params_from_jax``). The JAX dist mode runs
its Pallas kernels in interpret mode where the shapes reach them; the port
runs the kernels' plain versions.

Bars: prefill logits ``atol=rtol=2e-4`` (fp32, different sum orders);
greedy ``serve`` tokens identical, on ``tiny`` and on a small head_dim-128
config, in both of the port's modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.models.sampling import sample_token as jax_sample
from triton_distributed_tpu.runtime.mesh import make_mesh
from triton_distributed_tpu_torch import Engine, ModelConfig, params_from_jax
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.models.sampling import (
    finite_logits_mask,
    sample_token,
    top_p_filter,
)

# name -> (preset overrides, batch, prompt length, tokens to generate)
CONFIGS = {
    "tiny": ({}, 8, 4, 6),
    # head_dim 128, so the JAX dist prefill reaches its Pallas flash-prefill
    # and (M = 64) matmul kernels.
    "dh128": (dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=128,
                   d_ff=512, vocab_size=512, max_length=64,
                   tie_embeddings=True), 4, 16, 6),
}


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh({"tp": 1}, devices=jax.devices()[:1], set_default=False)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request, mesh1):
    """JAX engine, its params, the port's params and the prompt, plus the
    JAX dist-mode tokens and prefill logits (computed once per config)."""
    overrides, B, L0, gen = CONFIGS[request.param]
    jcfg = JaxConfig.from_name("tiny", **overrides)
    tcfg = ModelConfig.from_name("tiny", **overrides)
    jparams = JaxQwen3(jcfg).init(jax.random.PRNGKey(0), mesh1)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    ids = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, L0)
                                            ).astype(np.int32)
    jeng = JaxEngine(jcfg, mesh=mesh1, mode="dist", params=jparams)
    jlogits, _ = jeng.prefill(jnp.asarray(ids), jeng.new_cache(B))
    jtokens = np.asarray(jeng.serve(jnp.asarray(ids), gen))
    return dict(cfg=tcfg, params=tparams, ids=ids, gen=gen,
                jlogits=np.asarray(jlogits), jtokens=jtokens)


@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_prefill_logits_match_jax(case, mode):
    eng = Engine(case["cfg"], mode=mode, device="cpu", params=case["params"])
    B = case["ids"].shape[0]
    logits, kv = eng.prefill(case["ids"], eng.new_cache(B))
    assert logits.dtype == torch.float32
    assert logits.shape == (B, case["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), case["jlogits"], atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("mode", ["dist", "xla"])
def test_greedy_serve_tokens_identical_to_jax(case, mode):
    eng = Engine(case["cfg"], mode=mode, device="cpu", params=case["params"])
    _build.reset_counts()
    tokens = eng.serve(case["ids"], case["gen"])
    assert tokens.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), case["jtokens"])
    # On the CPU the wrappers run the plain versions, never a launch.
    assert all(k.launches == 0 for k in _build.KERNELS.values())


def test_offset_advances_and_cache_is_written(case):
    eng = Engine(case["cfg"], mode="dist", device="cpu",
                 params=case["params"])
    ids = case["ids"]
    B, L0 = ids.shape
    kv = eng.new_cache(B)
    logits, kv = eng.prefill(ids, kv)
    assert kv.offset == L0
    assert kv.k[:, :, :L0].abs().sum() > 0 and kv.k[:, :, L0:].abs().sum() == 0
    tok = torch.argmax(logits, dim=-1)
    _, kv = eng.decode_step(tok, kv)
    assert kv.offset == L0 + 1
    assert kv.v[:, :, L0].abs().sum() > 0


def test_serve_rejects_overlong_requests():
    cfg = ModelConfig.from_name("tiny")
    eng = Engine(cfg, device="cpu", seed=0)
    ids = np.zeros((1, cfg.max_length - 2), np.int32)
    with pytest.raises(ValueError, match="max_length"):
        eng.serve(ids, 3)
    assert eng.serve(ids, 0).shape == (1, 0)
    assert eng.serve(ids, 2).shape == (1, 2)


def test_modes_and_families_not_ported_raise():
    cfg = ModelConfig.from_name("tiny")
    with pytest.raises(ValueError, match="mode"):
        Engine(cfg, mode="sp", device="cpu")
    assert Engine(cfg, mode="ar", device="cpu").mode == "ar"
    # An MoE FFN has no all-reduce mode, as in the JAX stack (qwen.py:340).
    moe = ModelConfig.from_name("tiny-moe")
    with pytest.raises(ValueError, match="ar"):
        Engine(moe, mode="ar", device="cpu")
    eng = Engine(moe, device="cpu")
    kv = eng.new_cache(1)
    with pytest.raises(ValueError, match="MoE"):
        eng.model.forward(eng.params, torch.zeros((1, 2), dtype=torch.int32),
                          kv.k, kv.v, 0, mode="ar")


def test_top_p_keeps_the_same_token_set_as_jax():
    probs = np.array([[0.3, 0.25, 0.2, 0.1, 0.05, 0.04, 0.03, 0.03],
                      [0.05, 0.6, 0.05, 0.1, 0.05, 0.05, 0.05, 0.05]])
    logits = np.log(probs).astype(np.float32)
    top_p = 0.8
    keys = jax.random.split(jax.random.PRNGKey(0), 3000)
    draws = np.asarray(jax.vmap(lambda k: jax_sample(
        jnp.asarray(logits), k, temperature=1.0, top_p=top_p))(keys))
    kept = torch.isfinite(top_p_filter(torch.from_numpy(logits), top_p))
    gen = torch.Generator().manual_seed(0)
    port_draws = torch.stack([
        sample_token(torch.from_numpy(logits), gen, temperature=1.0,
                     top_p=top_p) for _ in range(3000)]).numpy()
    for b in range(2):
        want = set(np.flatnonzero(kept[b].numpy()).tolist())
        assert set(draws[:, b].tolist()) == want
        assert set(port_draws[:, b].tolist()) == want


def test_sampling_greedy_and_seeded():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32)).astype(np.float32))
    torch.testing.assert_close(sample_token(logits),
                               torch.argmax(logits, -1).to(torch.int32))
    a = sample_token(logits, torch.Generator().manual_seed(3),
                     temperature=0.7, top_p=0.9)
    b = sample_token(logits, torch.Generator().manual_seed(3),
                     temperature=0.7, top_p=0.9)
    torch.testing.assert_close(a, b)
    logits[1, 5] = float("nan")
    assert finite_logits_mask(logits).tolist() == [True, False, True, True]
    cfg = ModelConfig.from_name("tiny")
    eng = Engine(cfg, device="cpu", seed=1, temperature=0.8, top_p=0.9)
    ids = np.arange(8, dtype=np.int32).reshape(2, 4)
    torch.testing.assert_close(eng.serve(ids, 4), eng.serve(ids, 4))


def test_weight_packing_matches_jax_layout():
    """The fused [q|k|v] and [gate|up] matrices are laid out as the JAX
    package lays them out at world 1, and unpack inverts pack."""
    from triton_distributed_tpu.layers.tp_attn import TPAttn as JaxAttn
    from triton_distributed_tpu.layers.tp_mlp import TPMLP as JaxMLP
    from triton_distributed_tpu_torch.layers import TPAttn, TPMLP

    rng = np.random.default_rng(5)
    d, dh, hq, hkv, ff = 16, 4, 4, 2, 24
    wq, wk, wv = (rng.standard_normal((d, h * dh)).astype(np.float32)
                  for h in (hq, hkv, hkv))
    wg, wu = (rng.standard_normal((d, ff)).astype(np.float32)
              for _ in range(2))
    jattn = JaxAttn(d_model=d, n_heads=hq, n_kv_heads=hkv, head_dim=dh)
    tattn = TPAttn(d_model=d, n_heads=hq, n_kv_heads=hkv, head_dim=dh)
    packed = tattn.pack_qkv(*map(torch.from_numpy, (wq, wk, wv)))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jattn.pack_qkv(jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv), 1)))
    for got, want in zip(tattn.unpack_qkv(packed), (wq, wk, wv)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TPMLP.interleave_gate_up(torch.from_numpy(wg),
                                 torch.from_numpy(wu)).numpy(),
        np.asarray(JaxMLP(d_model=d, d_ff=ff).interleave_gate_up(
            jnp.asarray(wg), jnp.asarray(wu), 1)))


def test_params_from_jax_carries_bf16_trees(mesh1):
    jcfg = JaxConfig.from_name("tiny", dtype=jnp.bfloat16,
                               tie_embeddings=True)
    tcfg = ModelConfig.from_name("tiny", dtype=torch.bfloat16,
                                 tie_embeddings=True)
    tree = jax.tree.map(np.asarray,
                        JaxQwen3(jcfg).init(jax.random.PRNGKey(2), mesh1))
    params = params_from_jax(tree, tcfg, device="cpu")
    assert "lm_head" not in params
    assert params["embed"].dtype == torch.bfloat16
    assert params["layers"]["attn"]["q_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        params["layers"]["mlp"]["w_down"].float().numpy(),
        tree["layers"]["mlp"]["w_down"].astype(np.float32))
    eng = Engine(tcfg, device="cpu", params=params)
    tokens = eng.serve(np.arange(16, dtype=np.int32).reshape(2, 8), 3)
    assert tokens.shape == (2, 3)
