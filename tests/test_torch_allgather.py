"""The port's allgathers at world 8 against the JAX package's, on the CPU:
the plain versions of the ring and direct-push kernels against the JAX
kernels, run on the conftest 8-device mesh in interpret mode, bit for bit
in f32 and bf16; the low-latency allgather over five epochs on one
staging, outputs and staging bit for bit; ``AllGatherLayer`` for each
method with JAX's return types; the workspace registry; AUTO's rules and
the perf model's terms against JAX's; the world-1 identities and the 2-D
refusals. One module-scoped JAX program runs every interpreted kernel. No
case launches a kernel: every tensor lies on the CPU."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.kernels import allgather as jag
from triton_distributed_tpu.kernels import ll_allgather as jll
from triton_distributed_tpu.layers import allgather_layer as jlayer
from triton_distributed_tpu.runtime import perf_model as jpm
from triton_distributed_tpu.runtime import symm as jsymm
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu_torch.kernels import KERNELS, _build
from triton_distributed_tpu_torch.kernels import allgather as tag
from triton_distributed_tpu_torch.kernels import ll_allgather as tll
from triton_distributed_tpu_torch.layers import allgather_layer as tlayer
from triton_distributed_tpu_torch.runtime import perf_model as pm
from triton_distributed_tpu_torch.runtime import symm

W = 8
BF16 = ml_dtypes.bfloat16
EPOCHS = 5


def _no_launches():
    return all(kern.launches == 0 for kern in KERNELS.values())


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.itemsize == 2 else np.int32)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _tbits(t: torch.Tensor) -> np.ndarray:
    return _bits(t.view(torch.int16 if t.element_size() == 2
                        else torch.int32).numpy())


def _v5e():
    """The JAX model's own figures (its CPU fallback, the v5e row) as the
    port's ``Hardware``."""
    v5e = jpm.detect_hardware()
    return v5e, pm.Hardware("v5e", v5e.peak_bf16_flops, v5e.hbm_bw,
                            link_bw=v5e.ici_link_bw, links=v5e.ici_links,
                            hop_lat=v5e.ici_hop_lat, ring_bisection=True)


@pytest.fixture(scope="module")
def jax_ag(mesh8):
    """Every rank's gathered copy from the JAX kernels on the 8-device mesh,
    in one program: ring and direct push on an f32 (8, 2, 32) and a bf16
    (8, 4, 48) stack; the JAX ``AllGatherLayer`` with each method (the LL
    one with its staging and epoch 0); then the host ``ll_all_gather``
    over five epochs on one workspace (<= 12 KB a device)."""
    rng = np.random.default_rng(0)
    xs = {"f32": rng.standard_normal((W, 2, 32)).astype(np.float32),
          "bf16": rng.standard_normal((W, 4, 48)).astype(BF16)}
    jsymm.clear_workspaces()
    layer = jlayer.AllGatherLayer((2, 32), jnp.float32, mesh=mesh8,
                                  name="t_torch_layer")

    def f(a, b, stg):
        outs = [jag.ring_all_gather(a[0], axis="tp"),
                jag.ring_all_gather(b[0], axis="tp"),
                jag.a2a_all_gather(a[0], axis="tp"),
                jag.a2a_all_gather(b[0], axis="tp"),
                layer(a[0], method="ring_1d"),
                layer(a[0], method="all2all")]
        ll, _ = layer(a[0], method="ll", staging=stg[0],
                      epoch=jnp.asarray(0, jnp.int32))
        return tuple(o[None] for o in outs + [ll])

    spec = P("tp")
    outs = jax.jit(shard_map(f, mesh=mesh8, in_specs=(spec, spec, spec),
                             out_specs=(spec,) * 7, check_vma=False))(
        jnp.asarray(xs["f32"]), jnp.asarray(xs["bf16"]), layer.staging())
    outs = list(map(np.asarray, outs))
    got = {("ring", "f32"): outs[0], ("ring", "bf16"): outs[1],
           ("a2a", "f32"): outs[2], ("a2a", "bf16"): outs[3],
           ("layer", "ring_1d"): outs[4], ("layer", "all2all"): outs[5],
           ("layer", "ll"): outs[6]}

    ws = jll.make_ll_staging((2, 32), jnp.float32, mesh=mesh8, name="t_ll")
    ll_x, ll_out = [], []
    for epoch in range(EPOCHS):
        x = rng.standard_normal((W, 2, 32)).astype(np.float32)
        ll_x.append(x)
        ll_out.append(np.asarray(jll.ll_all_gather(jnp.asarray(x), ws, epoch,
                                                   mesh=mesh8)))
    got["ll"] = (ll_x, ll_out, np.asarray(ws.array))
    return xs, got


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", ["ring", "a2a"])
def test_all_gather_plain_matches_jax_bit_for_bit(jax_ag, method, dtype):
    """Stacked in (world, m, ...), stacked out (world, world m, ...): rank
    r's copy equals what JAX's kernel leaves on device r, bit for bit; the
    host wrapper returns one copy, (world m, ...)."""
    xs, want = jax_ag
    x = _torch(xs[dtype])
    _build.reset_counts()
    run = tag.ring_all_gather if method == "ring" else tag.a2a_all_gather
    got = run(x, world=W)
    host = tag.all_gather(x, world=W,
                          method="ring_1d" if method == "ring" else "all2all")
    assert _no_launches()
    assert got.shape == (W, W * x.shape[1], x.shape[2])
    np.testing.assert_array_equal(_tbits(got), _bits(want[method, dtype]))
    assert torch.equal(host, got[0])


def test_ll_all_gather_matches_jax_over_five_epochs(jax_ag):
    """The host LL allgather on one workspace over five epochs: every
    output is JAX's bits, the final staging holds epochs 3 and 4's pushes
    in its two parity halves, and the workspace is rebound to the same
    tensor."""
    _, want = jax_ag
    ll_x, ll_out, ll_staging = want["ll"]
    symm.clear_workspaces()
    ws = tll.make_ll_staging((2, 32), torch.float32, world=W, name="t_ll",
                             device="cpu")
    buf = ws.array
    _build.reset_counts()
    for epoch in range(EPOCHS):
        out = tll.ll_all_gather(_torch(ll_x[epoch]), ws, epoch, world=W)
        np.testing.assert_array_equal(_tbits(out), _bits(ll_out[epoch]))
    assert ws.array is buf
    # JAX's interpreter returns its aliased staging unfilled (NaN), so the
    # staging is held to what the pushes put there: rank d's half p holds
    # the sources other than d of the last epoch of parity p.
    for p, epoch in ((1, EPOCHS - 2), (0, EPOCHS - 1)):
        x = _torch(ll_x[epoch])
        for d in range(W):
            assert torch.equal(ws.array[d, p],
                               x[[s for s in range(W) if s != d]])
    assert np.isnan(ll_staging).all()
    assert _no_launches()


def test_ll_staging_is_a_symm_workspace():
    """JAX's workspace-identity case (tests/test_ll_allgather.py:32): the
    staging is (world, 2 parities, world - 1 sources, *local), and the same
    key returns the same object; ``zero`` and ``clear_workspaces``."""
    symm.clear_workspaces()
    ws = tll.make_ll_staging((4, 16), torch.bfloat16, world=W, name="t_ws",
                             device="cpu")
    assert ws.array.shape == (W, 2, W - 1, 4, 16)
    assert ws.local_shape == (2, W - 1, 4, 16)
    assert tll.make_ll_staging((4, 16), torch.bfloat16, world=W,
                               name="t_ws", device="cpu") is ws
    ws.array.fill_(1)
    assert int(ws.zero().array.abs().sum()) == 0
    symm.clear_workspaces()
    assert tll.make_ll_staging((4, 16), torch.bfloat16, world=W,
                               name="t_ws", device="cpu") is not ws


def test_allgather_layer_matches_jax(jax_ag, mesh8):
    """``AllGatherLayer`` with each method gives the JAX layer's bits, and
    JAX's return types: without staging the gathered tensor, with it
    ``(gathered, staging)`` whatever AUTO picks (the stateless methods hand
    the staging back unchanged); LL without an epoch raises JAX's error;
    each layer has a staging of its own."""
    xs, want = jax_ag
    x = _torch(xs["f32"])
    layer = tlayer.AllGatherLayer((2, 32), torch.float32, world=W,
                                  device="cpu")
    _build.reset_counts()
    for method in ("ring_1d", "all2all"):
        got = layer(x, method=method)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(_tbits(got),
                                      _bits(want["layer", method]))
    staging = layer.staging()
    got, stg = layer(x, method="ll", staging=staging,
                     epoch=layer.next_epoch())
    assert stg is staging and layer.epoch == 1
    np.testing.assert_array_equal(_tbits(got), _bits(want["layer", "ll"]))
    assert torch.equal(stg[3, 0], x[[0, 1, 2, 4, 5, 6, 7]])
    for method in ("auto", "ring_1d", "all2all"):
        out = layer(x, method=method, staging=staging, epoch=1)
        assert isinstance(out, tuple) and out[1] is staging
        assert torch.equal(out[0], got)
    assert isinstance(layer(x), torch.Tensor)
    with pytest.raises(ValueError, match="LL allgather needs staging"):
        layer(x, method="ll")
    jlay = jlayer.AllGatherLayer((2, 32), jnp.float32, mesh=mesh8)
    with pytest.raises(ValueError) as jerr:
        jax.eval_shape(shard_map(
            lambda a: jlay(a[0], method="ll")[None], mesh=mesh8,
            in_specs=P("tp"), out_specs=P("tp"), check_vma=False),
            jnp.zeros((W, 2, 32)))
    with pytest.raises(ValueError) as terr:
        layer(x, method="ll")
    assert str(terr.value) == str(jerr.value)
    other = tlayer.AllGatherLayer((2, 32), torch.float32, world=W,
                                  device="cpu")
    assert other.staging() is not layer.staging()
    assert _no_launches()


def test_auto_rules_and_perf_model_match_jax():
    """``choose_all_gather_method``, ``_ll_wins`` and ``est_ll_all_gather``
    against JAX's given the same figures (the v5e row, ring bisection);
    on the H100's (no bisection, 1 us assumed hop) the push beats the ring
    at every size and LL wins up to ~480 KB a rank at world 8: the
    decode activation (16, 5,120) bf16 goes LL, the prefill's (1,024,
    5,120) the push."""
    v5e, hw = _v5e()
    for world in (2, 4, 8, 16):
        for nbytes in (1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 26):
            assert tag.choose_all_gather_method(world, nbytes, hw=hw).value \
                == jag.choose_all_gather_method(world, nbytes).value
            assert tlayer._ll_wins(world, nbytes, hw) == \
                jlayer._ll_wins(world, nbytes)
            assert pm.est_ll_all_gather(nbytes, world, hw) == pytest.approx(
                jpm.est_ll_all_gather(nbytes, world, v5e), rel=1e-12)
            assert pm.est_ring_all_gather(nbytes, world, hw) == \
                pytest.approx(jpm.est_ring_all_gather(nbytes, world, v5e),
                              rel=1e-12)
    assert tag.choose_all_gather_method(8, 1 << 20, num_slices=2).value == \
        "ring_2d"
    h100 = pm.H100_SXM
    for nbytes in (16 * 5120 * 2, 1024 * 5120 * 2):
        assert tag.choose_all_gather_method(W, nbytes, hw=h100) is \
            tag.AllGatherMethod.ALL2ALL
    assert tlayer._ll_wins(W, 16 * 5120 * 2, h100)
    assert not tlayer._ll_wins(W, 1024 * 5120 * 2, h100)
    # Qwen3-32B TP = 8 prefill: 8 shards of 10 MB read, 8 copies of 80 MB
    # written.
    shard = 1024 * 5120 * 2
    assert pm.all_gather_bytes(W, shard) == (W + W * W) * shard


def test_world_one_and_refusals():
    """World 1 returns the input (JAX :163-164, ll :107-108); AUTO on a CPU
    tensor runs the push; the 2-D exchange over a ``dcn_axis`` raises
    NotImplementedError naming ROADMAP.md; ``ring_2d`` without one and an
    unknown method raise JAX's ValueError (JAX :245-247, layer :134-137)."""
    x = torch.randn(1, 6, 4)
    staging = torch.zeros(1, 2, 1, 6, 4)
    assert tag.ring_all_gather(x, world=1) is x
    assert tag.a2a_all_gather(x, world=1) is x
    out, stg = tll.ll_all_gather_device(x, staging, 3, world=1)
    assert out is x and stg is staging
    assert torch.equal(tag.all_gather(x, world=1), x[0])
    xs = torch.randn(W, 3, 4)
    _build.reset_counts()
    assert torch.equal(tag.all_gather(xs, world=W), xs.reshape(-1, 4))
    for kw in ({"dcn_axis": "dcn"}, {"method": "ring_2d", "dcn_axis": "dcn"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tag.all_gather(xs, world=W, **kw)
    with pytest.raises(ValueError, match="ring_2d needs dcn_axis"):
        tag.all_gather(xs, world=W, method="ring_2d")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tll.ll_all_gather_2d_device(xs, staging, 0)
    layer = tlayer.AllGatherLayer((3, 4), torch.float32, world=W,
                                  device="cpu")
    with pytest.raises(ValueError, match="spans one mesh axis"):
        layer(xs, method="ring_2d")
    with pytest.raises(ValueError) as want:
        jag.AllGatherMethod("tree")
    with pytest.raises(ValueError) as got:
        tag.all_gather(xs, world=W, method="tree")
    assert str(got.value) == str(want.value)
    assert _no_launches()
