"""The port's reduce-scatter at world 8 against the JAX package's, on the
CPU: the plain versions of the one-shot and ring kernels against the JAX
kernels, run on the conftest 8-device mesh in interpret mode, bit for bit
(pure adds in fixed orders: the one-shot fold in rank order, the ring
rounding at every hop): both in bf16, where the roundings show, and the
one-shot in f32 as well (each interpreted kernel costs 4-7 s here, so the
ring's f32 order is held exactly on integer inputs instead); the host
``reduce_scatter`` and its AUTO rule; the perf model's reduce-scatter
terms; JAX's errors and the 2-D refusal. One module-scoped JAX program runs
every interpreted kernel. No case launches a kernel: every tensor lies on
the CPU."""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.runtime import perf_model as jpm
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu_torch.kernels import KERNELS, _build
from triton_distributed_tpu_torch.runtime import perf_model as pm

# The packages export their host ``reduce_scatter`` under the module's name.
jrs = importlib.import_module("triton_distributed_tpu.kernels.reduce_scatter")
trs = importlib.import_module(
    "triton_distributed_tpu_torch.kernels.reduce_scatter")

W = 8
BF16 = ml_dtypes.bfloat16
METHODS = ("oneshot", "ring")


def _no_launches():
    return all(kern.launches == 0 for kern in KERNELS.values())


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.itemsize == 2 else np.int32)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def jax_rs(mesh8):
    """Every rank's segment from the JAX kernels on the 8-device mesh, in one
    program: the one-shot on an f32 (8, 16, 64) stack, both methods on a
    bf16 (8, 16, 96) one (<= 12 KB a device)."""
    rng = np.random.default_rng(0)
    xs = {"f32": rng.standard_normal((W, 2 * W, 64)).astype(np.float32),
          "bf16": rng.standard_normal((W, 2 * W, 96)).astype(BF16)}

    def f(a, b):
        return (jrs.oneshot_reduce_scatter(a[0], axis="tp")[None],
                jrs.oneshot_reduce_scatter(b[0], axis="tp")[None],
                jrs.ring_reduce_scatter(b[0], axis="tp")[None])

    spec = P("tp", None, None)
    outs = jax.jit(shard_map(f, mesh=mesh8, in_specs=(spec, spec),
                             out_specs=(spec,) * 3, check_vma=False))(
        jnp.asarray(xs["f32"]), jnp.asarray(xs["bf16"]))
    keys = [("f32", "oneshot"), ("bf16", "oneshot"), ("bf16", "ring")]
    return xs, dict(zip(keys, map(np.asarray, outs)))


@pytest.mark.parametrize("dtype,method", [("f32", "oneshot"),
                                          ("bf16", "oneshot"),
                                          ("bf16", "ring")])
def test_reduce_scatter_plain_matches_jax_bit_for_bit(jax_rs, method, dtype):
    """Stacked in (world, world m, ...), stacked out (world, m, ...): rank
    r's segment equals what JAX's kernel leaves on device r, bit for bit;
    the host wrapper returns the global (world m, ...) of them."""
    xs, want = jax_rs
    x = _torch(xs[dtype])
    _build.reset_counts()
    run = (trs.oneshot_reduce_scatter if method == "oneshot"
           else trs.ring_reduce_scatter)
    got = run(x, world=W)
    host = trs.reduce_scatter(x, world=W, method=method)
    assert _no_launches()
    assert got.shape == (W, 2, x.shape[2]) and got.dtype == x.dtype
    np.testing.assert_array_equal(_bits(got.view(
        torch.int16 if dtype == "bf16" else torch.int32)),
        _bits(want[dtype, method]))
    assert torch.equal(host, got.reshape(2 * W, -1))


def test_methods_round_differently_in_bf16(jax_rs):
    """The ring rounds at every hop and the one-shot once, so in bf16 the
    two differ (each is held against its own plain version above), while
    both stay within bf16 rounding of the f32 sum."""
    xs, _ = jax_rs
    x = _torch(xs["bf16"])
    one = trs.oneshot_reduce_scatter(x, world=W)
    ring = trs.ring_reduce_scatter(x, world=W)
    assert not torch.equal(one, ring)
    exact = x.float().sum(0).reshape(W, 2, -1)
    for got in (one, ring):
        torch.testing.assert_close(got.float(), exact, atol=0.1, rtol=0.05)
    assert _no_launches()


def test_staging_holds_the_pushes():
    """One-shot: owner d's slot for src holds segment d of x[src]. Ring:
    rank r's slot s holds the rounded running sum of chunk (r - s - 2) mod
    world over ranks r - 1, ..., r - 1 - s (integer inputs: exact)."""
    x = torch.randint(-4, 5, (4, 8, 3)).float()
    _, staging = trs.oneshot_reduce_scatter_ref(x, return_staging=True)
    seg = x.reshape(4, 4, 2, 3)
    for d in range(4):
        for src in range(4):
            if src != d:
                assert torch.equal(staging[d, src - (src > d)], seg[src, d])
    out, staging = trs.ring_reduce_scatter_ref(x, return_staging=True)
    for r in range(4):
        for s in range(3):
            c = (r - s - 2) % 4
            want = sum(seg[(r - 1 - j) % 4, c] for j in range(s + 1))
            assert torch.equal(staging[r, s], want)
    assert torch.equal(out, x.sum(0).reshape(4, 2, 3))


def test_auto_matches_the_jax_rule():
    """AUTO (JAX :243-247): with the JAX model's own figures (its CPU
    fallback, the v5e row) the port picks JAX's method over a grid of
    sizes, and the estimates agree; on the H100's (no ring bisection) the
    one-shot wins at both Qwen3-32B shapes, so the host wrapper on a CPU
    tensor runs the one-shot."""
    v5e = jpm.detect_hardware()
    hw = pm.Hardware("v5e", v5e.peak_bf16_flops, v5e.hbm_bw,
                     link_bw=v5e.ici_link_bw, links=v5e.ici_links,
                     hop_lat=v5e.ici_hop_lat, ring_bisection=True)
    for world in (2, 4, 8, 16):
        for nbytes in (1 << 10, 1 << 16, 1 << 20, 1 << 24, 1 << 28):
            one = jpm.est_oneshot_reduce_scatter(nbytes, world, v5e)
            ring = jpm.est_ring_reduce_scatter(nbytes, world, v5e)
            assert trs.choose_reduce_scatter_method(world, nbytes, hw=hw) \
                == ("oneshot" if one <= ring else "ring")
            assert pm.est_oneshot_reduce_scatter(nbytes, world, hw) == \
                pytest.approx(one, rel=1e-12)
            assert pm.wire_bytes_reduce_scatter(nbytes, world) == \
                jpm.wire_bytes_reduce_scatter(nbytes, world)
            assert pm.wire_bytes_all_gather(nbytes, world) == \
                jpm.wire_bytes_all_gather(nbytes, world)
    for m in (16, 1024):       # decode and prefill, (8, 8 m, 5,120) bf16
        assert trs.choose_reduce_scatter_method(
            W, W * m * 5120 * 2, hw=pm.H100_SXM) == "oneshot"
    x = torch.randn(W, 16, 4)
    _build.reset_counts()
    assert torch.equal(trs.reduce_scatter(x, world=W),
                       trs.oneshot_reduce_scatter_ref(x).reshape(16, 4))
    assert _no_launches()
    # Qwen3-32B TP = 8 prefill: every rank's 8,192 x 5,120 bf16 read once,
    # its 1,024-row segment written once.
    nb = 8192 * 5120 * 2
    assert pm.reduce_scatter_bytes(W, nb) == W * nb + nb


def test_world_one_and_errors_match_jax(mesh8):
    """World 1 returns the input (JAX :138-139); a leading dim that does not
    split raises JAX's ValueError; an unknown method JAX's; the 2-D
    exchange NotImplementedError."""
    x = torch.randn(1, 6, 4)
    assert trs.oneshot_reduce_scatter(x, world=1) is x
    assert trs.ring_reduce_scatter(x, world=1) is x
    assert torch.equal(trs.reduce_scatter(x, world=1), x[0])
    with pytest.raises(ValueError) as want:
        jax.jit(shard_map(lambda a: jrs.oneshot_reduce_scatter(
            a[0], axis="tp")[None], mesh=mesh8, in_specs=P("tp"),
            out_specs=P("tp"), check_vma=False))(jnp.zeros((W, 12, 4)))
    for run in (trs.oneshot_reduce_scatter, trs.ring_reduce_scatter):
        with pytest.raises(ValueError) as got:
            run(torch.zeros(W, 12, 4), world=W)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jrs.reduce_scatter(jnp.zeros((W, 16, 4)), mesh=mesh8,
                           method="tree")
    with pytest.raises(ValueError) as got:
        trs.reduce_scatter(torch.zeros(W, 16, 4), world=W, method="tree")
    assert str(got.value) == str(want.value)
    for kw in ({"method": "ring_2d"}, {"dcn_axis": "dcn"}):
        with pytest.raises(NotImplementedError, match="not ported"):
            trs.reduce_scatter(torch.zeros(W, 16, 4), world=W, **kw)
    assert _no_launches()
