"""The port's tensor-parallel path at world 8 against the JAX package's, on
the CPU: the plain versions of the multi-rank kernels (AG-GEMM, GEMM-RS,
one-shot and two-shot all-reduce) against the JAX kernels, run on the
conftest 8-device mesh in interpret mode as the JAX tests run them; the
all-reduce method rule; the rank-stack helpers and packings; ``TPMLP`` and
``TPAttn`` in dist and ar mode; ``params_from_jax(world=8)``; and the slice,
``Engine(tiny, world=8)`` in dist, ar and xla mode against the JAX xla
engine on the mesh (JAX's own tests hold its dist and ar engines to the
same golden: ``tests/test_qwen_e2e.py:59``). Plus the epoch wrap of the
signal layer.

Bars: the all-reduces are pure adds in fixed orders, so bit for bit in f32
and bf16; AG-GEMM and GEMM-RS in f32 ``rtol=atol=1e-5`` (XLA and torch sum
the products in other orders), and in bf16 bit for bit on operands whose
products are exact (one nonzero per row of A: every partial sum is then the
same bits in any order, which leaves the rounding of the fold); the layers
fp32 ``rtol=atol=1e-5``; the engines' tokens identical and prefill logits
within 2e-3 (``tests/test_qwen_e2e.py:35-56``). Inputs come from numpy
seeds; every JAX kernel call uses the shapes of the JAX package's own tests
(``tests/test_ag_gemm.py:34-47``, ``tests/test_gemm_rs.py:25-48``,
``tests/test_collectives.py:64-77``)."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from triton_distributed_tpu.kernels import allgather_gemm as jag
from triton_distributed_tpu.kernels import allreduce as jar
from triton_distributed_tpu.kernels import gemm_reduce_scatter as jrs
from triton_distributed_tpu.kernels import moe_utils as jmoe_utils
from triton_distributed_tpu.layers.tp_attn import TPAttn as JaxAttn
from triton_distributed_tpu.layers.tp_mlp import TPMLP as JaxMLP
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import KVCache as JaxKVCache
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.runtime import perf_model as jpm
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu_torch import (
    BatchEngine,
    Engine,
    ModelConfig,
    params_from_jax,
)
from triton_distributed_tpu_torch.kernels import KERNELS, _build, _signal
from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
from triton_distributed_tpu_torch.kernels import allreduce as tar
from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs
from triton_distributed_tpu_torch.layers import TPAttn, TPMLP
from triton_distributed_tpu_torch.models.kv_cache import KVCache
from triton_distributed_tpu_torch.runtime import perf_model as pm
from triton_distributed_tpu_torch.runtime.mesh import World

W = 8
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = ml_dtypes.bfloat16


def _no_launches():
    return all(k.launches == 0 for k in KERNELS.values())


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.itemsize == 2 else np.int32)


def _exact(rng, world, M, k, n):
    """A (world, M, k) with one small integer per row and B (world, k, n)
    of bf16 values: every product is exact in f32."""
    a = np.zeros((world, M, k), np.float32)
    rows = np.arange(M)
    for r in range(world):
        a[r, rows, rng.integers(0, k, M)] = rng.integers(1, 4, M)
    b = rng.standard_normal((world, k, n)).astype(BF16).astype(np.float32)
    return a, b


# -- 1. the all-reduces, bit for bit -----------------------------------------

@pytest.fixture(scope="module")
def jax_all_reduce(mesh8):
    """Every rank's output of the JAX one-shot and two-shot kernels on the
    8-device mesh, f32 (8, 16, 128) and bf16 (8, 8, 256) in one program."""
    rng = np.random.default_rng(0)
    x32 = rng.standard_normal((W, 16, 128)).astype(np.float32)
    x16 = rng.standard_normal((W, 8, 256)).astype(np.float32).astype(BF16)

    def f(a, b):
        return tuple(fn(x[0], axis="tp")[None] for x in (a, b)
                     for fn in (jar.oneshot_all_reduce,
                                jar.twoshot_all_reduce))

    spec = P("tp", None, None)
    outs = jax.jit(shard_map(f, mesh=mesh8, in_specs=(spec, spec),
                             out_specs=(spec,) * 4, check_vma=False))(
        jnp.asarray(x32), jnp.asarray(x16))
    got = dict(zip([("one_shot", "f32"), ("two_shot", "f32"),
                    ("one_shot", "bf16"), ("two_shot", "bf16")],
                   map(np.asarray, outs)))
    return {"f32": x32, "bf16": x16}, got


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", ["one_shot", "two_shot"])
def test_all_reduce_plain_matches_jax_bit_for_bit(jax_all_reduce, method,
                                                  dtype):
    xs, want = jax_all_reduce
    x = _t(xs[dtype], torch.float32 if dtype == "f32" else torch.bfloat16)
    _build.reset_counts()
    fn = (tar.oneshot_all_reduce if method == "one_shot"
          else tar.twoshot_all_reduce)
    got = fn(x, world=W)
    assert _no_launches()
    assert got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), _jbits(want[method, dtype]))
    assert torch.equal(tar.all_reduce(x, method=method), got[0])


def test_two_shot_staging_is_the_ring_and_refuses_ragged_m(mesh8):
    """Each hop's push is the running sum rounded to x's dtype: rank r's
    staging[s] is the sum of x[r - 1 - j][c] for j = 0 .. s of chunk
    c = r - s - 2, and the last push completes rank r's own chunk. A
    leading dim that does not split raises JAX's error."""
    x = torch.randint(-4, 5, (4, 8, 3)).float()
    out, staging = tar.twoshot_all_reduce_ref(x, return_staging=True)
    chunks = x.reshape(4, 4, 2, 3)
    for r in range(4):
        for s in range(3):
            c = (r - s - 2) % 4
            want = sum(chunks[(r - 1 - j) % 4, c] for j in range(s + 1))
            assert torch.equal(staging[r, s], want)
    assert torch.equal(out, x.sum(0).expand_as(x))
    with pytest.raises(ValueError) as want:
        _jax_layer(mesh8, lambda x: jar.twoshot_all_reduce(
            x[0], axis="tp")[None], P("tp"), P("tp"), jnp.zeros((W, 6, 4)))
    with pytest.raises(ValueError) as got:
        tar.twoshot_all_reduce(torch.zeros(W, 6, 4), world=W)
    assert str(got.value) == str(want.value)


# -- 2. AG-GEMM and GEMM-RS ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_ag_gemm(mesh8):
    """The JAX AG-GEMM (block_n 128, its test shapes) on f32 operands and on
    exact bf16 ones, one program; global (M, N) results."""
    rng = np.random.default_rng(1)
    a32 = rng.standard_normal((8 * W, 32)).astype(np.float32)
    b32 = rng.standard_normal((32, 128 * W)).astype(np.float32)
    a16, b16 = _exact(rng, 1, 4 * W, 64, 128 * W)
    a16, b16 = a16[0].astype(BF16), b16[0].astype(BF16)
    cfg = jag.AGGEMMConfig(block_n=128)

    def f(a, b, c, d):
        return (jag.ag_gemm_device(a, b, config=cfg),
                jag.ag_gemm_device(c, d, config=cfg))

    outs = jax.jit(shard_map(
        f, mesh=mesh8, in_specs=(P("tp", None), P(None, "tp")) * 2,
        out_specs=(P(None, "tp"),) * 2, check_vma=False))(a32, b32, a16, b16)
    return (a32, b32, np.asarray(outs[0])), (a16, b16, np.asarray(outs[1]))


def test_ag_gemm_plain_matches_jax_f32(jax_ag_gemm):
    a, b, want = jax_ag_gemm[0]
    _build.reset_counts()
    got = tg.ag_gemm(_t(a), _t(b), world=W,
                     config=tg.AGGEMMConfig(block_n=128))
    assert _no_launches()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ag_gemm_plain_matches_jax_bf16_exact(jax_ag_gemm):
    a, b, want = jax_ag_gemm[1]
    got = tg.ag_gemm(_t(a, torch.bfloat16), _t(b, torch.bfloat16), world=W)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _jbits(want))


def test_ag_gemm_device_stacks_ranks_and_splits_columns():
    """Per-rank shapes: (world, m, K) x (world, K, n) -> (world, world m,
    n), rank d's rows in absolute rank order; the staged A is every rank's
    gather; an explicit overlap_cols leaves a tail that matmul_tail_into
    fills; m = 1 works."""
    rng = np.random.default_rng(2)
    for m, cols in ((1, None), (3, 128)):
        a = _t(rng.standard_normal((W, m, 16)))
        b = _t(rng.standard_normal((W, 16, 256)))
        got = tg.ag_gemm_device(a, b, world=W, config=tg.AGGEMMConfig(
            block_n=128, overlap_cols=cols))
        full = a.reshape(W * m, 16)
        for d in range(W):
            torch.testing.assert_close(got[d], full @ b[d], **TOL)
    out1, staged = tg.ag_gemm_ref(a, b, cols=128)
    assert torch.equal(staged, a.expand(W, -1, -1, -1))
    assert out1.shape == (W, 3 * W, 128)
    with pytest.raises(ValueError, match="overlap_cols"):
        tg.ag_gemm_device(a, b, world=W, config=tg.AGGEMMConfig(
            block_n=128, overlap_cols=64))
    with pytest.raises(ValueError, match="stacked"):
        tg.ag_gemm_device(a[0], b[0], world=W)


@pytest.fixture(scope="module")
def jax_gemm_rs(mesh8):
    rng = np.random.default_rng(3)
    a32 = rng.standard_normal((4 * W, 16 * W)).astype(np.float32)
    b32 = rng.standard_normal((16 * W, 128)).astype(np.float32)
    a16, b16 = _exact(rng, W, 2 * W, 8, 128)
    cfg = jrs.GEMMRSConfig(block_n=128)

    def f(a, b, c, d):
        return (jrs.gemm_rs_device(a, b, config=cfg),
                jrs.gemm_rs_device(c, d, config=cfg))

    # The exact operands' rank shards side by side: A (M, W k), B (W k, N).
    ga16 = np.concatenate(list(a16), axis=1).astype(BF16)
    gb16 = np.concatenate(list(b16), axis=0).astype(BF16)
    outs = jax.jit(shard_map(
        f, mesh=mesh8, in_specs=(P(None, "tp"), P("tp", None)) * 2,
        out_specs=(P("tp", None),) * 2, check_vma=False))(
        a32, b32, ga16, gb16)
    return (a32, b32, np.asarray(outs[0])), (a16, b16, np.asarray(outs[1]))


def test_gemm_rs_plain_matches_jax_f32(jax_gemm_rs):
    a, b, want = jax_gemm_rs[0]
    _build.reset_counts()
    got = trs.gemm_rs(_t(a), _t(b), world=W,
                      config=trs.GEMMRSConfig(block_n=128))
    assert _no_launches()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gemm_rs_fold_matches_jax_bit_for_bit(jax_gemm_rs):
    """Identical partials (exact products): the plain fold (remote partials
    rounded to bf16, own f32, src = 0 .. world - 1, one cast) is JAX's fold
    bit for bit, and its staging holds each pushed partial."""
    a, b, want = jax_gemm_rs[1]
    ta, tb = _t(a, torch.bfloat16), _t(b, torch.bfloat16)
    got = trs.gemm_rs_device(ta, tb, world=W)
    np.testing.assert_array_equal(_bits(got.reshape(-1, 128)), _jbits(want))
    partials = trs.gemm_rs_partials(ta, tb)
    out, staging = trs.gemm_rs_fold(partials, torch.bfloat16,
                                    return_staging=True)
    assert torch.equal(out, got)
    m = 2
    assert torch.equal(staging[0, 0], partials[1, :m].to(torch.bfloat16))
    assert torch.equal(staging[3, 5], partials[6, 3 * m:4 * m].to(
        torch.bfloat16))


def test_gemm_rs_errors_match_jax():
    with pytest.raises(ValueError) as got:
        trs.gemm_rs_device(torch.zeros(W, 12, 4), torch.zeros(W, 4, 8),
                           world=W)
    assert str(got.value) == "M 12 not divisible by world 8"
    with pytest.raises(ValueError, match="block_n"):
        trs.gemm_rs_device(torch.zeros(W, 16, 4), torch.zeros(W, 4, 8),
                           world=W, config=trs.GEMMRSConfig(block_n=3))


# -- 3. the method rule and the perf model ------------------------------------

def test_choose_all_reduce_method_matches_jax():
    """With the JAX model's own link figures (its CPU fallback, the v5e
    row) the port's rule and estimates give JAX's answers over a grid; on
    the H100's figures the rule still picks one-shot where JAX must (world
    <= 2, a leading dim that does not split)."""
    v5e = jpm.detect_hardware()
    hw = pm.Hardware("v5e", v5e.peak_bf16_flops, v5e.hbm_bw,
                     link_bw=v5e.ici_link_bw, links=v5e.ici_links,
                     hop_lat=v5e.ici_hop_lat, ring_bisection=True)
    for world in (1, 2, 3, 4, 8, 16):
        for nbytes in (1 << 10, 1 << 16, 1 << 20, 1 << 24, 1 << 28):
            for lead in (8, 12, 128, 4096):
                want = jar.choose_all_reduce_method(world, nbytes, lead)
                got = tar.choose_all_reduce_method(world, nbytes, lead, hw=hw)
                assert got.value == want.value, (world, nbytes, lead)
            if world > 1:
                for name in ("est_oneshot_all_reduce",
                             "est_twoshot_all_reduce"):
                    assert getattr(pm, name)(nbytes, world, hw) == \
                        pytest.approx(getattr(jpm, name)(nbytes, world,
                                                         v5e), rel=1e-12)
            for method in ("one_shot", "two_shot"):
                assert pm.wire_bytes_all_reduce(nbytes, world, method) == \
                    jpm.wire_bytes_all_reduce(nbytes, world, method)
    for world, lead in ((2, 128), (8, 12)):
        assert tar.choose_all_reduce_method(
            world, 1 << 30, lead, hw=pm.H100_SXM) is \
            tar.AllReduceMethod.ONE_SHOT


def test_perf_model_work_of_the_multi_rank_kernels():
    """bench.py's Qwen3-32B TP = 8 shapes: AG-GEMM (8 x 512, 5,120) x
    (5,120, 3,200) per rank, GEMM-RS (4,096, 3,200) x (3,200, 5,120) per
    rank, the all-reduce (128, 5,120) bf16 per rank."""
    assert pm.ag_gemm_flops(8, 512, 5120, 3200) == 2 * 8 * 4096 * 5120 * 3200
    assert pm.ag_gemm_bytes(8, 512, 5120, 3200, 2) == \
        2 * (8 * 512 * 5120 + 8 * 5120 * 3200 + 8 * 4096 * 3200)
    assert pm.gemm_rs_flops(8, 4096, 3200, 5120) == \
        2 * 8 * 4096 * 3200 * 5120
    assert pm.gemm_rs_bytes(8, 4096, 3200, 5120, 2) == \
        2 * (8 * 4096 * 3200 + 8 * 3200 * 5120 + 4096 * 5120)
    assert pm.all_reduce_bytes(8, 128 * 5120 * 2) == 2 * 8 * 1_310_720


# -- 4. the rank stacks -------------------------------------------------------

def test_world_split_places_shards_as_jax(mesh8):
    """World.split puts at index r what JAX's placement puts on device r,
    for P(axis, None), P(None, axis) and the KV cache's kv-head spec."""
    rng = np.random.default_rng(4)
    w = World(W)
    for shape, spec, dim in (((16, 24), P("tp", None), 0),
                             ((6, 32), P(None, "tp"), 1),
                             ((2, 3, 4, 8, 5), JaxKVCache.spec()[0], 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        placed = jax.device_put(x, NamedSharding(mesh8, spec))
        by_dev = {s.device: np.asarray(s.data)
                  for s in placed.addressable_shards}
        stack = w.split(torch.from_numpy(x), dim)
        for r, dev in enumerate(mesh8.devices.flat):
            np.testing.assert_array_equal(stack[r].numpy(), by_dev[dev])
        assert torch.equal(w.join(stack, dim), torch.from_numpy(x))
    with pytest.raises(ValueError, match="divisible"):
        w.split(torch.zeros(4, 12), 1)


def test_packings_match_jax():
    rng = np.random.default_rng(5)
    d, dh, hq, hkv, ff = 16, 4, 8, 8, 32
    wq, wk, wv = (rng.standard_normal((d, h * dh)).astype(np.float32)
                  for h in (hq, hkv, hkv))
    tattn = TPAttn(d_model=d, n_heads=hq, n_kv_heads=hkv, head_dim=dh)
    jattn = JaxAttn(d_model=d, n_heads=hq, n_kv_heads=hkv, head_dim=dh)
    packed = tattn.pack_qkv(*map(torch.from_numpy, (wq, wk, wv)), W)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jattn.pack_qkv(
        jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv), W)))
    for got, want in zip(tattn.unpack_qkv(packed, W), (wq, wk, wv)):
        np.testing.assert_array_equal(got.numpy(), want)
    wg, wu = (rng.standard_normal((d, ff)).astype(np.float32)
              for _ in range(2))
    fused = TPMLP.interleave_gate_up(torch.from_numpy(wg),
                                     torch.from_numpy(wu), W)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(
        JaxMLP(d_model=d, d_ff=ff).interleave_gate_up(
            jnp.asarray(wg), jnp.asarray(wu), W)))
    for got, want in zip(TPMLP.deinterleave_gate_up(fused, W), (wg, wu)):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError) as got:
        TPAttn(d_model=d, n_heads=12, n_kv_heads=4, head_dim=dh).sizes(W)
    with pytest.raises(ValueError) as want:
        JaxAttn(d_model=d, n_heads=12, n_kv_heads=4, head_dim=dh).sizes(W)
    assert str(got.value) == str(want.value)


# -- 5. the layers at world 8 -------------------------------------------------

D, DH, HQ, HKV, FF = 64, 8, 8, 8, 128     # tests/test_tp_attn.py:20


def _jax_layer(mesh, fn, in_specs, out_specs, *args):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))(*args)


def test_tp_mlp_dist_and_ar_match_jax_golden(mesh8):
    """The port's dist and ar forwards (kernels' plain versions) against
    the JAX layer's xla forward at world 8; JAX's own tests hold its dist
    and ar forwards to the same golden (``tests/test_tp_mlp.py:43-60``),
    whose interpreted kernels would take this file over its time budget."""
    rng = np.random.default_rng(6)
    wg, wu = (rng.standard_normal((D, FF)).astype(np.float32) * D ** -0.5
              for _ in range(2))
    wd = rng.standard_normal((FF, D)).astype(np.float32) * FF ** -0.5
    x = rng.standard_normal((16, D)).astype(np.float32)
    jmlp = JaxMLP(d_model=D, d_ff=FF, dtype=jnp.float32, block_n=8)
    jp = {"w_gate_up": jmlp.interleave_gate_up(jnp.asarray(wg),
                                               jnp.asarray(wu), W),
          "w_down": jnp.asarray(wd)}
    specs = jmlp.param_specs()
    want = np.asarray(jmlp.fwd(jp, jnp.asarray(x), mesh=mesh8, mode="xla"))
    w = World(W)
    tp = {"w_gate_up": w.split(torch.from_numpy(np.asarray(
              jp["w_gate_up"])), 1),
          "w_down": w.split(torch.from_numpy(wd), 0)}
    tmlp = TPMLP(d_model=D, d_ff=FF, world=W)
    _build.reset_counts()
    dist = tmlp.dist_fwd(tp, torch.from_numpy(x))
    ar = tmlp.ar_fwd(tp, torch.from_numpy(x))
    assert _no_launches()
    np.testing.assert_allclose(dist.numpy(), want, **TOL)
    np.testing.assert_allclose(ar.numpy(), want, **TOL)
    np.testing.assert_allclose(tmlp.xla_fwd(tp, torch.from_numpy(x)).numpy(),
                               want, **TOL)
    assert specs == {"w_gate_up": P(None, "tp"), "w_down": P("tp", None)}


def test_tp_attn_dist_and_ar_match_jax_golden(mesh8):
    """A prefill of 4 tokens then a decode step into a contiguous cache, in
    dist and ar mode: outputs and the (global-layout) caches against the
    JAX layer's xla forward at world 8 (JAX's tests hold its dist and ar
    forwards to the same golden: ``tests/test_tp_attn.py:108-131``)."""
    rng = np.random.default_rng(7)
    jattn = JaxAttn(d_model=D, n_heads=HQ, n_kv_heads=HKV, head_dim=DH,
                    dtype=jnp.float32, block_n=8, rope_theta=1e4)
    tattn = TPAttn(d_model=D, n_heads=HQ, n_kv_heads=HKV, head_dim=DH,
                   rope_theta=1e4, world=W)
    wq, wk, wv = (rng.standard_normal((D, h * DH)).astype(np.float32)
                  * D ** -0.5 for h in (HQ, HKV, HKV))
    wo = rng.standard_normal((HQ * DH, D)).astype(np.float32) * 0.1
    norms = [(1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)
             for _ in range(2)]
    w_qkv = np.asarray(jattn.pack_qkv(jnp.asarray(wq), jnp.asarray(wk),
                                      jnp.asarray(wv), W))
    jp = {"w_qkv": jnp.asarray(w_qkv), "w_o": jnp.asarray(wo),
          "q_norm": jnp.asarray(norms[0]), "k_norm": jnp.asarray(norms[1])}
    w = World(W)
    tp = {"w_qkv": w.split(torch.from_numpy(w_qkv), 1),
          "w_o": w.split(torch.from_numpy(wo), 0),
          "q_norm": torch.from_numpy(norms[0]),
          "k_norm": torch.from_numpy(norms[1])}
    B, S = 8, 16
    kv_spec = P(None, None, "tp", None)
    xspec = P("tp", None, None)
    jk = jv = jnp.zeros((B, S, HKV, DH), jnp.float32)
    golden, offset = [], 0
    xs = [rng.standard_normal((B, L, D)).astype(np.float32) * 0.3
          for L in (4, 1)]
    for x in xs:
        out, jk, jv = _jax_layer(
            mesh8, lambda p, x, k, v, o=offset: jattn.xla_fwd(p, x, k, v, o),
            (jattn.param_specs(), xspec, kv_spec, kv_spec),
            (xspec, kv_spec, kv_spec), jp, jnp.asarray(x), jk, jv)
        golden.append((out, jk, jv))
        offset += x.shape[1]
    for mode in ("dist", "ar"):
        tk, tv = torch.zeros(B, S, HKV, DH), torch.zeros(B, S, HKV, DH)
        offset = 0
        for x, (out, jk, jv) in zip(xs, golden):
            fwd = tattn.dist_fwd if mode == "dist" else tattn.ar_fwd
            got = fwd(tp, torch.from_numpy(x), tk, tv, offset)
            np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
            offset += x.shape[1]


# -- 6. the slice: Engine(tiny, world=8) --------------------------------------

B, L0, GEN = 8, 4, 3        # tests/test_qwen_e2e.py:14


@pytest.fixture(scope="module")
def tiny8(mesh8):
    """JAX ``tiny`` weights on the 8-device mesh, a prompt, and the JAX xla
    engine's prefill logits and greedy tokens."""
    jcfg = JaxConfig.from_name("tiny")
    jparams = JaxQwen3(jcfg, block_n=8).init(jax.random.PRNGKey(0), mesh8)
    ids = np.random.default_rng(8).integers(0, jcfg.vocab_size, (B, L0)
                                            ).astype(np.int32)
    jeng = JaxEngine(jcfg, mesh=mesh8, mode="xla", params=jparams, block_n=8)
    logits, _ = jeng.prefill(jnp.asarray(ids), jeng.new_cache(B))
    return dict(tree=jax.tree.map(np.asarray, jparams), ids=ids,
                logits=np.asarray(logits),
                tokens=np.asarray(jeng.serve(jnp.asarray(ids), GEN)))


def test_params_from_jax_world8_round_trips_the_tree(tiny8):
    cfg = ModelConfig.from_name("tiny")
    params = params_from_jax(tiny8["tree"], cfg, device="cpu", world=W)
    w = World(W)
    for block, name, dim in (("attn", "w_qkv", 1), ("attn", "w_o", 0),
                             ("mlp", "w_gate_up", 1), ("mlp", "w_down", 0)):
        stack = params["layers"][block][name]
        want = tiny8["tree"]["layers"][block][name]
        assert stack.shape[:2] == (cfg.n_layers, W)
        np.testing.assert_array_equal(w.join(stack, dim + 1, at=1).numpy(),
                                      want)
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  tiny8["tree"]["embed"])
    assert params["layers"]["attn"]["q_norm"].shape == (cfg.n_layers,
                                                        cfg.head_dim)


@pytest.mark.parametrize("mode", ["dist", "ar", "xla"])
def test_engine_world8_matches_the_jax_xla_engine(tiny8, mode):
    cfg = ModelConfig.from_name("tiny")
    params = params_from_jax(tiny8["tree"], cfg, device="cpu", world=W)
    eng = Engine(cfg, mode=mode, device="cpu", params=params, world=W)
    _build.reset_counts()
    logits, kv = eng.prefill(tiny8["ids"], eng.new_cache(B))
    np.testing.assert_allclose(logits.numpy(), tiny8["logits"], atol=2e-3,
                               rtol=2e-3)
    assert kv.k.shape == (cfg.n_layers, B, cfg.max_length, cfg.n_kv_heads,
                          cfg.head_dim)
    np.testing.assert_array_equal(eng.serve(tiny8["ids"], GEN).numpy(),
                                  tiny8["tokens"])
    assert _no_launches()


def test_world8_refusals_match_jax(tiny8, mesh8):
    """JAX's errors for a batch that does not split (dist and xla mode), a
    cache whose kv heads do not and an MoE config whose experts do not (row
    18 is ported: an MoE config whose experts split runs); what is not
    ported at world > 1 raises: the paged serving step."""
    cfg = ModelConfig.from_name("tiny")
    params = params_from_jax(tiny8["tree"], cfg, device="cpu", world=W)
    jcfg = JaxConfig.from_name("tiny")
    jmodel = JaxQwen3(jcfg, block_n=8)
    ids = np.zeros((4, 2), np.int32)
    for mode in ("dist", "xla"):
        with pytest.raises(ValueError) as want:
            _jax_layer(mesh8, lambda e, i, mode=mode: jmodel.forward_device(
                {"embed": e}, i, None, None, 0, mode=mode)[0], (P(), P()),
                P(), jnp.zeros((jcfg.vocab_size, jcfg.d_model)),
                jnp.asarray(ids))
        eng = Engine(cfg, mode=mode, device="cpu", params=params, world=W)
        with pytest.raises(ValueError) as got:
            eng.prefill(ids, eng.new_cache(4))
        assert str(got.value) == str(want.value)
    kv4 = dataclasses.replace(cfg, n_kv_heads=4)
    with pytest.raises(ValueError) as want:
        JaxKVCache.create(dataclasses.replace(jcfg, n_kv_heads=4), 8,
                          mesh=mesh8)
    with pytest.raises(ValueError) as got:
        KVCache.create(kv4, 8, device="cpu", world=W)
    tail = "divisible by 8, but it is equal to 4 (full shape: (2, 8, 32, 4, 8))"
    assert str(want.value).endswith(tail) and str(got.value).endswith(tail)
    with pytest.raises(ValueError) as want:
        jmoe_utils.route_to_ranks(jnp.zeros((1, 2), jnp.int32),
                                  jnp.zeros((1, 2)), n_experts=12, world=W,
                                  capacity=8)
    with pytest.raises(ValueError) as got:
        Engine(dataclasses.replace(ModelConfig.from_name("tiny-moe"),
                                   n_experts=12), device="cpu", world=W)
    assert str(got.value) == str(want.value)
    eng = Engine(cfg, device="cpu", params=params, world=W)
    with pytest.raises(NotImplementedError, match="world > 1"):
        BatchEngine(eng, n_slots=2, block_size=4)


# -- 7. the signal layer's epoch wrap -----------------------------------------

def test_epoch_wrap_zeroes_the_devices_flags_first():
    """Across the wrap (2**31 - 1 -> 1) no flag raised at an old epoch
    satisfies a wait of a new one, by the kernels' own compare
    (int32(flag - value) >= 0); flags of another device are untouched."""
    dev = torch.device("cpu")
    saved = dict(_signal._FLAGS), dict(_signal._EPOCH)
    try:
        _signal._FLAGS.clear()
        flags = _signal._FLAGS[(dev, 0, "t")] = torch.zeros(4,
                                                            dtype=torch.int32)
        # Another device's buffer (a CPU tensor standing in for it).
        kept = _signal._FLAGS[(torch.device("cuda", 0), 0, "t")] = \
            torch.full((4,), 7, dtype=torch.int32)
        _signal._EPOCH[dev] = 2 ** 31 - 3

        def raised(v, value):
            return np.int32(np.uint32(v) - np.uint32(value)) >= 0

        seen = []
        for _ in range(4):
            e = _signal.next_epoch(dev)
            seen.append(e)
            for f in flags.tolist():
                # A flag is raised in this call only after this check.
                assert not raised(f, e), (f, e)
            flags[len(seen) % 4] = e     # a producer raises its flag
        assert seen == [2 ** 31 - 2, 2 ** 31 - 1, 1, 2]
        assert kept.tolist() == [7] * 4
        # Without the zeroing, the flag left at 2**31 - 1 would read as
        # raised to the new epoch 1:
        assert raised(2 ** 31 - 1, 1)
    finally:
        _signal._FLAGS.clear()
        _signal._FLAGS.update(saved[0])
        _signal._EPOCH.clear()
        _signal._EPOCH.update(saved[1])
