"""The port's MoE routing and grouped GEMM (``kernels/moe_utils.py``) against
the JAX module on the same numpy inputs.

Integer outputs (slots, kept masks, counts, inverse indices, drop counts)
must be exactly equal; float outputs agree within 1e-6 (the routing moves
rows, it does not sum them, except the k-way combine). Each routing case
runs with roomy capacities and with capacities that overflow.
``grouped_gemm_skip_ref``, the kernel's plain version, is held against the
JAX Pallas kernel in interpret mode at 1e-5, with exact zeros for empty
experts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import moe_utils as jmu
from triton_distributed_tpu_torch.kernels import moe_utils as tmu

N, K, E, D = 24, 2, 8, 16
# capacity per destination rank / per expert: roomy, then overflowing
CASES = {"roomy": dict(world_cap=64, expert_cap=48),
         "overflow": dict(world_cap=8, expert_cap=3)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.cache
def _jit(fn, **static):
    """``fn`` of the JAX module jitted with its static arguments bound: one
    compile per case instead of one per eager primitive."""
    return jax.jit(functools.partial(fn, **static))


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def routing():
    """Seeded tokens, top-k ids (skewed: expert 3 takes a third of the
    pairs, so the tight capacities overflow) and weights."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    ids = np.stack([rng.permutation(E)[:K] for _ in range(N)]).astype(
        np.int32)
    ids[::3, 0] = 3
    ids[::3, 1] = np.where(ids[::3, 1] == 3, 5, ids[::3, 1])
    w = rng.random((N, K)).astype(np.float32)
    return x, ids, w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_to_capacity_matches_jax(case):
    rng = np.random.default_rng(1)
    # keys >= n_buckets are never kept
    keys = rng.integers(0, E + 2, size=40).astype(np.int32)
    cap = CASES[case]["expert_cap"]
    want = _jit(jmu.sort_to_capacity, n_buckets=E, capacity=cap)(
        jnp.asarray(keys))
    got = tmu.sort_to_capacity(_t(keys), E, cap)
    for g, w in zip(got, want):
        _eq(g, w)
    assert (int(got[4]) > 0) == (case == "overflow")


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_scatter_gather_match_jax(routing, case, world):
    x, ids, w = routing
    cap = CASES[case]["world_cap"]
    jplan = _jit(jmu.route_to_ranks, n_experts=E, world=world,
                 capacity=cap)(jnp.asarray(ids), jnp.asarray(w))
    tplan = tmu.route_to_ranks(_t(ids), _t(w), n_experts=E, world=world,
                               capacity=cap)
    for f in ("dest", "slot", "counts", "kept", "expert", "n_dropped"):
        _eq(getattr(tplan, f), getattr(jplan, f))
    _close(tplan.topk_weight, jplan.topk_weight)
    assert (int(tplan.n_dropped) > 0) == (case == "overflow")

    jsend, jids = _jit(jmu.scatter_to_capacity, world=world, capacity=cap)(
        jnp.asarray(x), jplan)
    tsend, tids = tmu.scatter_to_capacity(_t(x), tplan, world=world,
                                          capacity=cap)
    _eq(tsend, jsend)
    _eq(tids, jids)
    # The combine back from the send layout (each slot's row scaled).
    recv = np.asarray(jsend) * 1.5
    _close(tmu.gather_from_capacity(_t(recv), tplan, n_tokens=N),
           _jit(jmu.gather_from_capacity, n_tokens=N)(jnp.asarray(recv),
                                                      jplan))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_by_local_expert_and_back_match_jax(routing, case):
    """Rank 1 of 2 (experts 4..7): what two source ranks, each routing half
    of the tokens, send it is its arrival layout."""
    x, ids, w = routing
    world, cap, ecap = 2, 32, CASES[case]["expert_cap"]
    recv, recv_ids, counts = [], [], []
    for src in range(world):
        part = slice(src * N // world, (src + 1) * N // world)
        plan = _jit(jmu.route_to_ranks, n_experts=E, world=world,
                    capacity=cap)(jnp.asarray(ids[part]),
                                  jnp.asarray(w[part]))
        send, sids = _jit(jmu.scatter_to_capacity, world=world,
                          capacity=cap)(jnp.asarray(x[part]), plan)
        recv.append(np.asarray(send[1]))
        recv_ids.append(np.asarray(sids[1, :, 0]))
        counts.append(int(plan.counts[1]))
    recv, recv_ids = np.stack(recv), np.stack(recv_ids)
    counts = np.asarray(counts, np.int32)
    want = _jit(jmu.tokens_by_local_expert, n_local_experts=4,
                expert_base=4, expert_capacity=ecap)(
        jnp.asarray(recv), jnp.asarray(recv_ids), jnp.asarray(counts))
    got = tmu.tokens_by_local_expert(
        _t(recv), _t(recv_ids), _t(counts), n_local_experts=4,
        expert_base=4, expert_capacity=ecap)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert (int(got[3]) > 0) == (case == "overflow")
    out = np.asarray(want[0]) * -2.0
    _eq(tmu.scatter_back_from_experts(_t(out), got[2], world=world,
                                      capacity=cap),
        _jit(jmu.scatter_back_from_experts, world=world, capacity=cap)(
            jnp.asarray(out), want[2]))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_to_experts_and_combine_match_jax(routing, case, masked):
    """``masked``: some pairs carry the id ``E`` (pairs the dispatch
    dropped): never kept, not counted as dropped; the combine takes the
    real ids, as ``MoEMLP.dist_fwd`` passes them."""
    x, ids, w = routing
    routed = ids.copy()
    if masked:
        routed[::4, 1] = E
    cap = CASES[case]["expert_cap"]
    want = _jit(jmu.route_to_experts, n_experts=E, capacity=cap)(
        jnp.asarray(x), jnp.asarray(routed))
    got = tmu.route_to_experts(_t(x), _t(routed), n_experts=E, capacity=cap)
    assert len(got) == len(want) + 1
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert (int(got[3]) > 0) == (case == "overflow")
    assert not got[2].numpy()[routed == E].any()
    # The fifth output, the rows each expert holds (the JAX function drops
    # them): the clamped counts of the same slot assignment.
    _eq(got[4], _jit(jmu.sort_to_capacity, n_buckets=E, capacity=cap)(
        jnp.asarray(routed.reshape(-1)))[3])
    grid = np.asarray(want[0]) + 0.25
    _close(tmu.combine_from_experts(_t(grid), _t(ids), _t(w), got[1],
                                    got[2]),
           _jit(jmu.combine_from_experts)(jnp.asarray(grid),
                                          jnp.asarray(ids), jnp.asarray(w),
                                          want[1], want[2]))


def test_inverse_index_and_fill_match_jax():
    rng = np.random.default_rng(2)
    dst = rng.permutation(12)[:9].astype(np.int32)
    valid = rng.random(9) < 0.7
    rows = rng.standard_normal((9, 5)).astype(np.float32)
    _eq(tmu.inverse_index(_t(dst), _t(valid), 12, 9),
        _jit(jmu.inverse_index, size=12, n=9)(jnp.asarray(dst),
                                              jnp.asarray(valid)))
    for g, w in zip(tmu.fill_by_inverse(_t(rows), _t(dst), _t(valid), 12),
                    _jit(jmu.fill_by_inverse, size=12)(
                        jnp.asarray(rows), jnp.asarray(dst),
                        jnp.asarray(valid))):
        _eq(g, w)


COUNTS = [0, 0, 3, 0, 16, 1, 0, 0]


@pytest.mark.parametrize("stacked", [False, True])
def test_grouped_gemm_skip_ref_matches_jax_kernel(stacked):
    """The JAX test's case: leading, trailing and consecutive empty experts;
    rows past each count zero (the grid contract)."""
    rng = np.random.default_rng(3)
    E_, cap, d, f = 8, 16, 32, 128
    counts = np.asarray(COUNTS, np.int32)
    grouped = rng.standard_normal((E_, cap, d)).astype(np.float32)
    grouped[np.arange(cap)[None, :] >= counts[:, None]] = 0.0
    L = 3 if stacked else None
    w = rng.standard_normal(((L,) if stacked else ()) + (E_, d, f)).astype(
        np.float32)
    # One compile: the layer is a traced scalar, as in the model's scan.
    kernel = jax.jit(lambda g, w_, c, li: jmu.grouped_gemm_skip(
        g, w_, c, interpret=True, layer_idx=li))
    for li in (range(L) if stacked else [None]):
        want = kernel(jnp.asarray(grouped), jnp.asarray(w),
                      jnp.asarray(counts),
                      None if li is None else jnp.int32(li))
        got = tmu.grouped_gemm_skip(
            _t(grouped), _t(w), _t(counts),
            layer_idx=None if li is None else li)
        _close(got, want, tol=1e-5)
        np.testing.assert_array_equal(got[counts == 0].numpy(), 0.0)
        _close(tmu.grouped_gemm(_t(grouped), _t(w if li is None else w[li])),
               jmu.grouped_gemm(jnp.asarray(grouped),
                                jnp.asarray(w if li is None else w[li])),
               tol=1e-5)


def test_grouped_gemm_skip_checks_layer_idx():
    g = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="layer_idx"):
        tmu.grouped_gemm_skip(g, torch.zeros(3, 2, 8, 4),
                              torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="layer_idx"):
        tmu.grouped_gemm_skip(g, torch.zeros(2, 8, 4),
                              torch.ones(2, dtype=torch.int32), layer_idx=0)
