"""The port's MoE tensor-parallel pipeline at world 8 against the JAX
package's, on the CPU: the plain versions of AG-GroupGEMM and GroupGEMM-RS
and ``ag_moe_mlp_device`` against the JAX kernels, run on the conftest
8-device mesh in interpret mode as ``tests/test_moe_overlap.py`` runs them,
at its shapes (m 2, k 2, d 8, f 64, E 2, cap 8, world 8); the rank-batched
routing against JAX's routing rank by rank; the weight shards against
JAX's per-device slices; JAX's errors; the 2-D variants' refusal.

Bars: bf16 bit for bit on operands whose products are exact (one small
integer per row of the left operand: every sum is then the same bits in any
order, which leaves the roundings of the fold); f32 ``rtol=atol=1e-5``
(XLA and torch sum the products in other orders); integer outputs exact.
One module-scoped JAX program runs every interpreted kernel the file
compares (each costs seconds in the interpreter). No case launches a
kernel: every tensor lies on the CPU."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.kernels import moe_overlap as jmo
from triton_distributed_tpu.kernels import moe_utils as jmu
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu_torch.kernels import KERNELS, _build
from triton_distributed_tpu_torch.kernels import moe_overlap as tmo
from triton_distributed_tpu_torch.kernels import moe_utils as tmu
from triton_distributed_tpu_torch.runtime import perf_model as pm
from triton_distributed_tpu_torch.runtime.mesh import World

W, m, k, d, f, E = 8, 2, 2, 8, 64, 2      # tests/test_moe_overlap.py:35-36
FL = f // W
CAP, TIGHT = 8, 2                         # roomy (>= m k) and dropping
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = ml_dtypes.bfloat16


def _no_launches():
    return all(kern.launches == 0 for kern in KERNELS.values())


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _one_hot_rows(rng, shape):
    """Rows with one small integer each (the rest zero): every product
    with bf16 values is exact in f32."""
    a = np.zeros(shape, np.float32)
    flat = a.reshape(-1, shape[-1])
    rows = np.arange(flat.shape[0])
    flat[rows, rng.integers(0, shape[-1], len(rows))] = rng.integers(
        1, 4, len(rows))
    return a


def _moe_golden(xs, ids, ws, w_up, w_down):
    """Dense per-token f32 golden (tests/test_moe_overlap.py:22)."""
    golden = np.zeros(xs.shape, np.float32)
    for t in range(xs.shape[0]):
        for j in range(ids.shape[1]):
            e = ids[t, j]
            h = xs[t] @ w_up[e]
            h = h / (1.0 + np.exp(-h))
            golden[t] += ws[t, j] * (h @ w_down[e])
    return golden


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    c = dict(
        xs=rng.standard_normal((W * m, d), dtype=np.float32),
        ids=rng.integers(0, E, (W * m, k)).astype(np.int32),
        ws=rng.random((W * m, k), dtype=np.float32),
        w_up=rng.standard_normal((E, d, f), dtype=np.float32) * 0.2,
        w_down=rng.standard_normal((E, f, d), dtype=np.float32) * 0.2,
        # bf16 exact products: one-hot integer tokens and activations.
        xe=_one_hot_rows(rng, (W * m, d)).astype(BF16),
        ide=rng.integers(0, E, (W * m, k)).astype(np.int32),
        wue=rng.standard_normal((E, d, f)).astype(BF16),
        acte=_one_hot_rows(rng, (W, E, W * CAP, FL)).astype(BF16),
        wde=rng.standard_normal((W, E, FL, d)).astype(BF16))
    return c


@pytest.fixture(scope="module")
def jax_moe(mesh8, case):
    """Every output the file compares, from ONE JAX program on the 8-device
    mesh: ``ag_moe_mlp_device`` in f32 at a capacity that drops, the
    AG-GroupGEMM and the GroupGEMM-RS on exact bf16 operands, and each
    device's weight slices (tests/test_moe_overlap.py:46-49)."""
    def per_device(x, ids, ws, wu, wd, xe, ide, wue, acte, wde):
        me = jax.lax.axis_index("tp")
        wu_l = jax.lax.dynamic_slice(wu, (0, 0, me * FL), (E, d, FL))
        wd_l = jax.lax.dynamic_slice(wd, (0, me * FL, 0), (E, FL, d))
        out, n_dropped = jmo.ag_moe_mlp_device(x, ids, ws, wu_l, wd_l,
                                               n_experts=E, capacity=TIGHT)
        wue_l = jax.lax.dynamic_slice(wue, (0, 0, me * FL), (E, d, FL))
        up, st = jmo.ag_group_gemm_device(xe, ide, wue_l, n_experts=E,
                                          capacity=CAP)
        down = jmo.group_gemm_rs_device(acte[0], wde[0], capacity=CAP)
        return (out, n_dropped[None], up[None], st["slot"], st["kept"],
                st["n_dropped"][None], down[None], wu_l[None], wd_l[None])

    rows, one, stack = P("tp", None), P("tp"), P("tp", None, None, None)
    outs = jax.jit(shard_map(
        per_device, mesh=mesh8,
        in_specs=(rows, rows, rows, P(), P(), rows, rows, P(), stack, stack),
        out_specs=(rows, one, stack, rows, rows, one, stack, stack, stack),
        check_vma=False))(
        *(jnp.asarray(case[n]) for n in ("xs", "ids", "ws", "w_up", "w_down",
                                         "xe", "ide", "wue", "acte", "wde")))
    names = ("out", "n_dropped", "up", "slot", "kept", "up_dropped", "down",
             "wu_l", "wd_l")
    return dict(zip(names, map(np.asarray, outs)))


def _stacks(case, x="xs", ids="ids"):
    return (_t(case[x]).reshape(W, m, d),
            torch.from_numpy(case[ids]).reshape(W, m, k))


def test_world_split_matches_jax_weight_slices(case, jax_moe):
    """JAX gives device r columns [r f_local, (r + 1) f_local) of w_up and
    those rows of w_down by dynamic_slice; the port's rank stacks are
    ``World.split(w_up, 2)`` and ``World.split(w_down, 1)``."""
    w = World(W)
    np.testing.assert_array_equal(
        w.split(_t(case["w_up"]), 2).numpy(), jax_moe["wu_l"])
    np.testing.assert_array_equal(
        w.split(_t(case["w_down"]), 1).numpy(), jax_moe["wd_l"])


def test_ag_moe_mlp_plain_matches_jax_with_drops(case, jax_moe):
    """The pipeline at a capacity that drops: outputs at 1e-5 and every
    rank's drop count equal (and some rank drops)."""
    w = World(W)
    x, ids = _stacks(case)
    _build.reset_counts()
    out, n_dropped = tmo.ag_moe_mlp_device(
        x, ids, _t(case["ws"]).reshape(W, m, k), w.split(_t(case["w_up"]), 2),
        w.split(_t(case["w_down"]), 1), world=W, n_experts=E,
        capacity=TIGHT)
    assert _no_launches()
    assert out.shape == (W, m, d) and n_dropped.dtype == torch.int32
    np.testing.assert_array_equal(n_dropped.numpy(), jax_moe["n_dropped"])
    assert n_dropped.sum() > 0
    np.testing.assert_allclose(out.reshape(W * m, d).numpy(), jax_moe["out"],
                               **TOL)


def test_ag_moe_mlp_matches_the_dense_golden(case):
    """At the roomy capacity nothing drops and the pipeline is the dense
    per-token MLP (JAX's own golden, tests/test_moe_overlap.py:22), in f32;
    at world 1 the same through the einsums."""
    w = World(W)
    x, ids = _stacks(case)
    ws = _t(case["ws"]).reshape(W, m, k)
    golden = _moe_golden(case["xs"], case["ids"], case["ws"], case["w_up"],
                         case["w_down"])
    _build.reset_counts()
    out, n_dropped = tmo.ag_moe_mlp_device(
        x, ids, ws, w.split(_t(case["w_up"]), 2),
        w.split(_t(case["w_down"]), 1), world=W, n_experts=E, capacity=CAP)
    assert not n_dropped.any()
    np.testing.assert_allclose(out.reshape(W * m, d).numpy(), golden, **TOL)
    out1, n1 = tmo.ag_moe_mlp_device(
        x.reshape(W * m, d), ids.reshape(W * m, k), ws.reshape(W * m, k),
        _t(case["w_up"]), _t(case["w_down"]), n_experts=E,
        capacity=W * CAP)
    assert _no_launches() and int(n1) == 0
    np.testing.assert_allclose(out1.numpy(), golden, **TOL)
    ref, _ = tmo.ag_moe_mlp_ref(x, ids, ws, w.split(_t(case["w_up"]), 2),
                                w.split(_t(case["w_down"]), 1), world=W,
                                n_experts=E, capacity=CAP)
    assert torch.equal(ref, out)


def test_ag_group_gemm_plain_matches_jax_bf16_exact(case, jax_moe):
    """Exact products: every rank's (E, world cap, f_local) output bit for
    bit, in JAX's layout (source src's rows at src cap), and the routing
    state equal."""
    x, ids = _stacks(case, "xe", "ide")
    x = x.to(torch.bfloat16)
    wue = World(W).split(_t(case["wue"], torch.bfloat16), 2)
    _build.reset_counts()
    up, state = tmo.ag_group_gemm_device(x, ids, wue, world=W, n_experts=E,
                                         capacity=CAP)
    assert _no_launches()
    assert up.shape == (W, E, W * CAP, FL) and up.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(up),
                                  jax_moe["up"].view(np.int16))
    np.testing.assert_array_equal(state["slot"].reshape(W * m, k).numpy(),
                                  jax_moe["slot"])
    np.testing.assert_array_equal(state["kept"].reshape(W * m, k).numpy(),
                                  jax_moe["kept"])
    np.testing.assert_array_equal(state["n_dropped"].numpy(),
                                  jax_moe["up_dropped"])
    # The gathered grids the kernel stages: every rank's, in source order.
    grids = tmu.route_rank_stack(x, ids, n_experts=E, capacity=CAP)[0]
    up2, staging = tmo.ag_group_gemm_ref(grids, wue, return_staging=True)
    assert torch.equal(up2, up)
    for r in range(W):
        for src in range(W):
            assert torch.equal(staging[r, :, src], grids[src])


def test_group_gemm_rs_plain_matches_jax_bf16_exact(case, jax_moe):
    """Exact partials: the fold (own partial f32, the others rounded to
    bf16, src = 0 .. world - 1, one cast) bit for bit; the staging holds
    each source's rounded partial of the owner's rows."""
    act = _t(case["acte"], torch.bfloat16)
    wde = _t(case["wde"], torch.bfloat16)
    _build.reset_counts()
    down = tmo.group_gemm_rs_device(act, wde, world=W, capacity=CAP)
    assert _no_launches()
    assert down.shape == (W, E, CAP, d) and down.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(down),
                                  jax_moe["down"].view(np.int16))
    out, staging = tmo.group_gemm_rs_ref(act, wde, return_staging=True)
    assert torch.equal(out, down)
    part = torch.matmul(act.float(), wde.float())    # (src, E, W cap, d)
    for dst in range(W):
        for src in range(W):
            if src != dst:
                rows = part[src, :, dst * CAP:(dst + 1) * CAP]
                assert torch.equal(staging[dst, src - (src > dst)],
                                   rows.to(torch.bfloat16))


@pytest.mark.parametrize("capacity", [CAP, 1])
def test_rank_batched_routing_matches_jax_rank_by_rank(capacity):
    """One call routes every rank (ids offset by r E into world E
    buckets); each rank's grid, slot, kept, drop count and counts equal
    JAX's ``route_to_experts`` on that rank alone, at a roomy and an
    overflowing capacity, an id of E (never kept) included."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((W, 5, d)).astype(np.float32)
    ids = rng.integers(0, E + 1, (W, 5, 3)).astype(np.int32)
    grid, slot, kept, n_dropped, counts = tmu.route_rank_stack(
        _t(x), torch.from_numpy(ids), n_experts=E, capacity=capacity)
    assert grid.shape == (W, E, capacity, d)
    route = jax.jit(lambda a, b: jmu.route_to_experts(
        a, b, n_experts=E, capacity=capacity))
    for r in range(W):
        g, s, kp, nd = map(np.asarray, route(x[r], ids[r]))
        np.testing.assert_array_equal(grid[r].numpy(), g)
        np.testing.assert_array_equal(slot[r].numpy(), s)
        np.testing.assert_array_equal(kept[r].numpy(), kp)
        assert int(n_dropped[r]) == int(nd)
        live = ids[r][ids[r] < E]
        np.testing.assert_array_equal(
            counts[r].numpy(),
            np.minimum(np.bincount(live, minlength=E), capacity))


def test_errors_match_jax(mesh8):
    """JAX's ValueErrors: a weight with another expert count, act rows that
    are not world x capacity, a block that does not divide its dim; the
    2-D variants raise NotImplementedError."""
    def jax_error(fn, *args):
        with pytest.raises(ValueError) as err:
            jax.jit(shard_map(fn, mesh=mesh8, in_specs=(P(),) * len(args),
                              out_specs=P(), check_vma=False))(*args)
        return str(err.value)

    want = jax_error(lambda x, i, w: jmo.ag_group_gemm_device(
        x, i, w, n_experts=3, capacity=4)[0], jnp.zeros((2, d)),
        jnp.zeros((2, k), jnp.int32), jnp.zeros((E, d, FL)))
    with pytest.raises(ValueError) as got:
        tmo.ag_group_gemm_device(torch.zeros(W, 2, d),
                                 torch.zeros(W, 2, k, dtype=torch.int64),
                                 torch.zeros(W, E, d, FL), world=W,
                                 n_experts=3, capacity=4)
    assert str(got.value) == want
    want = jax_error(lambda a, w: jmo.group_gemm_rs_device(
        a, w, capacity=4), jnp.zeros((E, 24, FL)), jnp.zeros((E, FL, d)))
    with pytest.raises(ValueError) as got:
        tmo.group_gemm_rs_device(torch.zeros(W, E, 24, FL),
                                 torch.zeros(W, E, FL, d), world=W,
                                 capacity=4)
    assert str(got.value) == want
    with pytest.raises(ValueError) as want:
        jmo.MoEOverlapConfig.tiles(96, 64)
    with pytest.raises(ValueError) as got:
        tmo.MoEOverlapConfig.tiles(96, 64)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not divisible by block"):
        tmo.group_gemm_rs_device(torch.zeros(W, E, W * 4, 6),
                                 torch.zeros(W, E, 6, d), world=W,
                                 capacity=4,
                                 config=tmo.MoEOverlapConfig(block_k=4))
    for fn in (tmo.ag_group_gemm_2d_device, tmo.group_gemm_rs_2d_device,
               tmo.ag_moe_mlp_2d_device):
        with pytest.raises(NotImplementedError, match="not ported"):
            fn(None, None, None, n_experts=E, capacity=4)
    assert _no_launches()


def test_perf_model_work_of_the_grouped_kernels():
    """Qwen3-30B-A3B's MoE layer at world 8 (d 2,048, 128 experts, f_local
    96), prefill capacity 128: 4.12e11 operations over every rank and
    ~1.14 GB of the function's own bytes each way; counting only filled
    rows scales the grid terms."""
    full = W * 128 * 128
    assert pm.group_gemm_flops(W, full, 2048, 96) == \
        2 * W * W * 128 * 128 * 2048 * 96
    assert abs(pm.group_gemm_flops(W, full, 2048, 96) - 4.12e11) < 1e9
    grids, weights, up = (full * 2048 * 2, W * 128 * 2048 * 96 * 2,
                          W * 128 * W * 128 * 96 * 2)
    assert pm.ag_group_gemm_bytes(W, 128, 128, 2048, 96, 2) == \
        grids + weights + up
    assert pm.group_gemm_rs_bytes(W, 128, 128, 2048, 96, 2) == \
        W * full * 96 * 2 + weights + grids
    assert abs(grids + weights + up - 1.14e9) < 1e7
    assert pm.ag_group_gemm_bytes(W, 128, 128, 2048, 96, 2, rows=100) == \
        100 * 2048 * 2 + weights + up
