"""Parity of the port's one-chip overlap entry points with the JAX
package's: ``ag_gemm_loopback``, ``ag_gemm_segmented_bare``,
``matmul_tail_into``, ``gemm_rs_loopback`` and ``fused_matmul_step``. The
JAX side runs its Pallas kernels in interpret mode, as its own tests run
them, at their shapes (``tests/test_ag_gemm.py:139-230``,
``tests/test_gemm_rs.py:87-119``); the port runs its plain versions on CPU
tensors. Inputs come from a numpy seed. fp32, ``rtol=atol=1e-5`` (the two
sum the products in different orders). Plus the config errors, the perf
model's H100 arithmetic, and the GEMM-RS fold's bf16 rounding and order
against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import allgather_gemm as jag
from triton_distributed_tpu.kernels import gemm_reduce_scatter as jrs
from triton_distributed_tpu.runtime import perf_model as jpm
from triton_distributed_tpu_torch.kernels import KERNELS, _build
from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs
from triton_distributed_tpu_torch.runtime import perf_model as pm

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _no_launches():
    return all(k.launches == 0 for k in KERNELS.values())


@pytest.mark.parametrize("cols", [384, 128])
@pytest.mark.parametrize("arm", ["loopback", "segmented_bare"])
def test_ag_gemm_arms_match_jax(arm, cols):
    """overlap_cols = n (the consumer alone) and 128 (consumer + tail) at
    n = 384, 8 segments of 8 rows."""
    a, b = _inputs(cols, (64, 32), (32, 384))
    jfn, tfn = getattr(jag, f"ag_gemm_{arm}"), getattr(tg, f"ag_gemm_{arm}")
    jcfg = jag.AGGEMMConfig(block_n=128, overlap_cols=cols)
    want = jax.jit(lambda a, b: jfn(a, b, segments=8, config=jcfg))(a, b)
    _build.reset_counts()
    got = tfn(torch.from_numpy(a), torch.from_numpy(b), segments=8,
              config=tg.AGGEMMConfig(block_n=128, overlap_cols=cols))
    assert _no_launches()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_matmul_tail_into_matches_jax():
    a, b, c = _inputs(1, (64, 128), (128, 384), (64, 128))
    want = jax.jit(lambda c, a, b: jag.matmul_tail_into(
        c, a, b, 128, block_n=128))(c, a, b)
    got = tg.matmul_tail_into(torch.from_numpy(c), torch.from_numpy(a),
                              torch.from_numpy(b), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[:, :128].numpy(), c)


@pytest.mark.parametrize("segments,shape", [(8, (64, 32, 256)),
                                            (2, (16, 32, 128))])
def test_gemm_rs_loopback_matches_jax(segments, shape):
    """8 segments over two N tiles, and 2 segments with one N tile."""
    M, K, N = shape
    a, b = _inputs(segments, (M, K), (K, N))
    want = jax.jit(lambda a, b: jrs.gemm_rs_loopback(
        a, b, segments=segments,
        config=jrs.GEMMRSConfig(block_n=128)))(a, b)
    _build.reset_counts()
    got = trs.gemm_rs_loopback(torch.from_numpy(a), torch.from_numpy(b),
                               segments=segments,
                               config=trs.GEMMRSConfig(block_n=128))
    assert _no_launches()
    assert got.shape == (M // segments, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("block_k", [None, 128])
def test_fused_matmul_step_matches_jax(block_k):
    """c + a @ (b + 0.75), c updated in place (the JAX call donates it).
    a is scaled by K ** -0.5 = 1/16 (exact), so the outputs are O(1) and
    the f32 tolerance measures the algorithm, not the rounding of K-term
    sums of O(10) that cancel."""
    a, b, c = _inputs(2, (16, 256), (256, 128), (16, 128))
    a = a / 16
    want = jax.jit(lambda c, a, b: jag.fused_matmul_step(
        c, a, b, 0.75, block_m=8, block_n=128, block_k=block_k))(c, a, b)
    tc = torch.from_numpy(c.copy())
    got = tg.fused_matmul_step(tc, torch.from_numpy(a), torch.from_numpy(b),
                               0.75)
    assert got.data_ptr() == tc.data_ptr() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_step_converts_a_non_f32_c_and_rounds_b_plus_s_in_b_dtype():
    a = torch.ones((8, 16), dtype=torch.bfloat16)
    b = torch.full((16, 8), 1.0 / 512, dtype=torch.bfloat16)
    c = torch.zeros((8, 8), dtype=torch.bfloat16)
    got = tg.fused_matmul_step(c, a, b, 1.0)
    assert got.dtype == torch.float32 and got.data_ptr() != c.data_ptr()
    # 1 + 1/512 rounds to 1 in bf16 (8 bits of mantissa): 16 * 1.
    torch.testing.assert_close(got, torch.full((8, 8), 16.0))


def test_config_errors_match_jax():
    a, b = _inputs(3, (60, 32), (32, 384))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    msg = "not divisible by segments 8"
    for fn in (jag.ag_gemm_loopback, jag.ag_gemm_segmented_bare):
        with pytest.raises(ValueError, match=msg):
            fn(ja, jb, segments=8, config=jag.AGGEMMConfig(block_n=128))
    for fn in (tg.ag_gemm_loopback, tg.ag_gemm_segmented_bare):
        with pytest.raises(ValueError, match=msg):
            fn(ta, tb, segments=8, config=tg.AGGEMMConfig(block_n=128))
    ja, ta = ja[:32], ta[:32]
    for jcfg, tcfg, msg in (
            (jag.AGGEMMConfig(block_n=128, overlap_cols=192),
             tg.AGGEMMConfig(block_n=128, overlap_cols=192),
             "overlap_cols 192 must be a"),
            (jag.AGGEMMConfig(block_n=256), tg.AGGEMMConfig(block_n=256),
             "n_local 384 not divisible by block_n 256")):
        with pytest.raises(ValueError, match=msg):
            jag.ag_gemm_loopback(ja, jb, segments=8, config=jcfg)
        with pytest.raises(ValueError, match=msg):
            tg.ag_gemm_loopback(ta, tb, segments=8, config=tcfg)
    with pytest.raises(ValueError, match="not divisible by segments 3"):
        jrs.gemm_rs_loopback(ja, jb, segments=3)
    with pytest.raises(ValueError, match="not divisible by segments 3"):
        trs.gemm_rs_loopback(ta, tb, segments=3)
    with pytest.raises(ValueError, match="N 384 not divisible by block_n"):
        jrs.gemm_rs_loopback(ja, jb, segments=8,
                             config=jrs.GEMMRSConfig(block_n=256))
    with pytest.raises(ValueError, match="N 384 not divisible by block_n"):
        trs.gemm_rs_loopback(ta, tb, segments=8,
                             config=trs.GEMMRSConfig(block_n=256))
    # The auto split is a whole number of resolved blocks.
    assert tg._split(ta, tb, 8, None) % 128 == 0


def test_perf_model_h100_at_the_bench_shape():
    """The port's H100 SXM row and est_matmul against the JAX model's
    formula with the same figures, at bench.py's AG-GEMM shape."""
    hw = pm.detect_hardware("NVIDIA H100 80GB HBM3")
    assert hw is pm.H100_SXM
    assert pm.peak_bf16_tflops(hw) == pytest.approx(989.0)
    assert pm.hbm_gbps(hw) == pytest.approx(3350.0)
    jhw = jpm.Hardware("h100", 989e12, 3.35e12, 0.0, 0, 0.0, 0.0, 0.0)
    for n in (128, 640, 3200):
        assert pm.est_matmul(4096, 5120, n, 2, hw) == pytest.approx(
            jpm.est_matmul(4096, 5120, n, 2, jhw))
    # The gather of 8 x 512 rows over HBM against one 128-column strip:
    # 12.5 us vs 13.5 us (bytes-bound); a 640 strip is operations-bound.
    assert 8 * 512 * 5120 * 2 / hw.hbm_bw == pytest.approx(12.52e-6,
                                                           rel=1e-3)
    assert pm.est_matmul(4096, 5120, 128, 2, hw) == pytest.approx(
        13.54e-6, rel=1e-3)
    assert pm.est_matmul(4096, 5120, 640, 2, hw) == pytest.approx(
        2 * 4096 * 5120 * 640 / (989e12 * 0.85))
    t, by = pm.bound_seconds(2 * 4096 * 5120 * 3200,
                             2 * (4096 * 5120 + 5120 * 3200 + 4096 * 3200),
                             hw=hw)
    assert by == "operations" and t == pytest.approx(0.13571e-3, rel=1e-4)
    t, by = pm.bound_seconds(0, 2 * 7 * 512 * 5120 * 2, hw=hw)
    assert by == "bytes" and t == pytest.approx(0.0219e-3, rel=1e-2)
    for name in ("NVIDIA H100 PCIe", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(KeyError):
            pm.detect_hardware(name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.detect_hardware()


def _bf16_round(x):
    """f32 -> nearest-even bf16, returned as f32 (numpy has no bf16)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def test_gemm_rs_loopback_bf16_fold_order_and_rounding():
    """Integer inputs make every f32 product and sum exact, so only the
    bf16 roundings and the fold order decide the result: the own partial
    in f32, += each remote partial rounded to bf16 in order, one cast."""
    S, m, K, N = 8, 16, 32, 128
    rng = np.random.default_rng(4)
    a = rng.integers(-8, 9, (S * m, K)).astype(np.float32)
    b = rng.integers(-8, 9, (K, N)).astype(np.float32)
    acc = a[:m] @ b
    for dst in range(1, S):
        acc = acc + _bf16_round(a[dst * m:(dst + 1) * m] @ b)
    want = _bf16_round(acc)
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    got = trs.gemm_rs_loopback(ta, tb, segments=S)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # The JAX kernel (interpreted) folds the same way, bit for bit.
    jgot = jax.jit(lambda a, b: jrs.gemm_rs_loopback(
        a, b, segments=S, config=jrs.GEMMRSConfig(block_n=128)))(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(jgot, np.float32), want)
    # The rounding is visible: an unrounded fold gives another answer.
    assert not np.array_equal(_bf16_round(a.reshape(S, m, K).sum(0) @ b),
                              want)


def test_cuda_wrappers_refuse_cpu_tensors():
    a, b = torch.zeros((64, 32), dtype=torch.bfloat16), \
        torch.zeros((32, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tg.ag_gemm_segmented_bare_cuda(a, b, segments=8, cols=128)
    with pytest.raises(ValueError, match="CUDA"):
        tg.ag_gemm_loopback_cuda(a, b, segments=8, cols=128)
    with pytest.raises(ValueError, match="CUDA"):
        tg.matmul_tail_into_cuda(a[:, :0], a, b, 0)
    with pytest.raises(ValueError, match="CUDA"):
        trs.gemm_rs_loopback_cuda(a, b, segments=8)
    with pytest.raises(ValueError, match="CUDA"):
        tg.fused_step_cuda(torch.zeros((64, 128)), a, b, 0.5)
