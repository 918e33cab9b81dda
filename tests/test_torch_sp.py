"""The port's sequence-parallel attention at world 8 against the JAX
package's, on the CPU: the plain version of the SP prefill
(``sp_ag_attention_device``) against the JAX kernel, causal and not, with
its lse; ``flash_decode_device`` over the ring and over the LL allgather
and ``SpGQAFlashDecodeAttention`` with a ``kv_len`` that leaves ranks
empty, all against JAX on the conftest 8-device mesh (Pallas interpreted),
f32 at 1e-5; the decode partials' wire format; the world-1 paths; the
perf model's SP terms; the 2-D refusals. One module-scoped JAX program
runs every interpreted kernel. No case launches a kernel: every tensor
lies on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.kernels import sp_attention as jsp
from triton_distributed_tpu.layers import sp_flash_decode_layer as jsfd
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu_torch.kernels import KERNELS, _build
from triton_distributed_tpu_torch.kernels import sp_attention as tsp
from triton_distributed_tpu_torch.layers import SpGQAFlashDecodeAttention
from triton_distributed_tpu_torch.runtime import perf_model as pm
from triton_distributed_tpu_torch.runtime.mesh import World

W = 8
TOL = dict(atol=1e-5, rtol=1e-5)
# SP prefill: H heads, m rows a rank, head_dim (the JAX test's shapes).
PRE = dict(H=2, m=4, dh=32)
# SP decode: B rows, Hq/Hkv heads, head_dim, m_kv a rank; the global
# kv_len cuts rank 4's shard and leaves ranks 5-7 empty.
DEC = dict(B=2, Hq=4, Hkv=2, dh=16, m_kv=8)
KV_LEN = 4 * 8 + 3


def _no_launches():
    return all(kern.launches == 0 for kern in KERNELS.values())


@pytest.fixture(scope="module")
def jax_sp(mesh8):
    """The JAX results on the 8-device mesh, in one program: the SP prefill
    causal and not, each with return_partials; flash_decode_device over
    the ring (full cache) and over the LL allgather (B = Hq = Hkv = 1, so
    its staging stays under the interpreter's 12 KB); the decode layer
    with the global kv_len (<= 12 KB a device)."""
    rng = np.random.default_rng(0)
    H, m, dh = PRE["H"], PRE["m"], PRE["dh"]
    B, Hq, Hkv, dhd, m_kv = (DEC[k] for k in ("B", "Hq", "Hkv", "dh",
                                              "m_kv"))
    S = W * m_kv

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ins = dict(q=r(H, W * m, dh), k=r(H, W * m, dh), v=r(H, W * m, dh),
               dq=r(B, Hq, dhd), dk=r(B, Hkv, S, dhd), dv=r(B, Hkv, S, dhd),
               lq=r(1, 1, dhd), lk=r(1, 1, S, dhd), lv=r(1, 1, S, dhd))
    feat = jsp.decode_partial_feat(dhd)
    layer = jsfd.SpGQAFlashDecodeAttention(Hq, Hkv, dhd, axis="tp")

    def f(q, k, v, dq, dk, dv, lq, lk, lv, stg):
        outs = []
        for causal in (True, False):
            o, lse = jsp.sp_ag_attention_device(q, k, v, axis="tp",
                                                causal=causal,
                                                return_partials=True)
            outs += [o, lse]
        outs.append(jsp.flash_decode_device(dq, dk, dv, axis="tp"))
        lo, stg = jsp.flash_decode_device(lq, lk, lv, axis="tp",
                                          ll_staging=stg[0],
                                          ll_epoch=jnp.asarray(0, jnp.int32))
        outs.append(lo)
        outs.append(layer(dq, dk, dv, kv_len=KV_LEN))
        return tuple(outs)

    seq, kvs = P(None, "tp", None), P(None, None, "tp", None)
    run = jax.jit(shard_map(
        f, mesh=mesh8,
        in_specs=(seq, seq, seq, P(), kvs, kvs, P(), kvs, kvs, P("tp")),
        out_specs=(seq, P(None, "tp")) * 2 + (P(),) * 3,
        check_vma=False))
    stg = jnp.zeros((W, 2, W - 1, 1, feat), jnp.float32)
    outs = run(*(jnp.asarray(ins[k]) for k in ("q", "k", "v", "dq", "dk",
                                              "dv", "lq", "lk", "lv")), stg)
    names = ("causal", "causal_lse", "full", "full_lse", "decode_ring",
             "decode_ll", "layer")
    return ins, dict(zip(names, map(np.asarray, outs)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [True, False])
def test_sp_ag_attention_plain_matches_jax(jax_sp, causal):
    """Rank stacks in (world, H, m, dh), every rank's rows out, and the
    lse (world, H, m): JAX's per-device results joined along the sequence,
    f32 at 1e-5."""
    ins, want = jax_sp
    world = World(W)
    q, k, v = (world.split(_t(ins[n]), 1) for n in ("q", "k", "v"))
    _build.reset_counts()
    out, lse = tsp.sp_ag_attention_device(q, k, v, world=W, causal=causal,
                                          return_partials=True)
    assert out.shape == (W, PRE["H"], PRE["m"], PRE["dh"])
    key = "causal" if causal else "full"
    torch.testing.assert_close(world.join(out, 1), _t(want[key]), **TOL)
    torch.testing.assert_close(world.join(lse, 1), _t(want[key + "_lse"]),
                               **TOL)
    assert torch.equal(tsp.sp_ag_attention_device(q, k, v, world=W,
                                                  causal=causal), out)
    assert _no_launches()


def test_flash_decode_device_matches_jax_over_ring_and_ll(jax_sp):
    """One launch's worth of partials for every rank, packed in JAX's wire
    format and gathered over the ring (full cache) or the LL allgather
    (staging and epoch given: the result is (out, staging)); every rank's
    output equals JAX's at 1e-5."""
    ins, want = jax_sp
    world = World(W)
    dk, dv = (world.split(_t(ins[n]), 2) for n in ("dk", "dv"))
    _build.reset_counts()
    out = tsp.flash_decode_device(_t(ins["dq"]), dk, dv, world=W)
    assert out.shape == (W, DEC["B"], DEC["Hq"], DEC["dh"])
    for r in range(W):
        torch.testing.assert_close(out[r], _t(want["decode_ring"]), **TOL)
    feat = tsp.decode_partial_feat(DEC["dh"])
    staging = torch.zeros(W, 2, W - 1, 1, feat)
    lk, lv = (world.split(_t(ins[n]), 2) for n in ("lk", "lv"))
    lo, stg = tsp.flash_decode_device(_t(ins["lq"]), lk, lv, world=W,
                                      ll_staging=staging, ll_epoch=0)
    assert stg is staging and not staging[:, 1].any()
    for r in range(W):
        torch.testing.assert_close(lo[r], _t(want["decode_ll"]), **TOL)
    with pytest.raises(ValueError, match="decode_partial_feat"):
        tsp.flash_decode_device(_t(ins["lq"]), lk, lv, world=W,
                                ll_staging=torch.zeros(W, 2, W - 1, 1, 64),
                                ll_epoch=0)
    assert _no_launches()


def test_sp_decode_layer_with_empty_ranks_matches_jax(jax_sp):
    """``SpGQAFlashDecodeAttention`` with the global kv_len 35 over 8 x 8
    positions: rank 4 keeps 3, ranks 5-7 none; their partials weigh 0 and
    nothing turns NaN; every rank's output equals JAX's at 1e-5, and each
    rank's local length is JAX's clip (sp_flash_decode_layer.py:57-61)."""
    ins, want = jax_sp
    world = World(W)
    dk, dv = (world.split(_t(ins[n]), 2) for n in ("dk", "dv"))
    layer = SpGQAFlashDecodeAttention(DEC["Hq"], DEC["Hkv"], DEC["dh"],
                                      world=W)
    _build.reset_counts()
    out = layer(_t(ins["dq"]), dk, dv, kv_len=KV_LEN)
    assert torch.isfinite(out).all()
    for r in range(W):
        torch.testing.assert_close(out[r], _t(want["layer"]), **TOL)
    lens = np.clip(KV_LEN - np.arange(W) * DEC["m_kv"], 0, DEC["m_kv"])
    assert lens.tolist() == [8, 8, 8, 8, 3, 0, 0, 0]
    _, lse = tsp.flash_decode_local(
        _t(ins["dq"]).expand(W, *ins["dq"].shape).reshape(
            -1, *ins["dq"].shape[1:]),
        dk.reshape(-1, *dk.shape[2:]), dv.reshape(-1, *dv.shape[2:]),
        kv_len=torch.from_numpy(np.repeat(lens, DEC["B"])))
    packed = tsp._pack_decode_partial(torch.zeros(lse.shape + (DEC["dh"],)),
                                      lse, DEC["dh"])
    empty = packed.reshape(W, -1, packed.shape[-1])[5:, :, DEC["dh"]]
    assert (empty == tsp._NEG_INF).all()    # JAX's value on the wire
    # every rank empty: uniform weights over zero partials, as JAX's.
    zero = layer(_t(ins["dq"]), dk, dv, kv_len=0)
    assert torch.equal(zero, torch.zeros_like(zero))
    assert _no_launches()


def test_decode_partial_wire_format_and_world_one(jax_sp):
    """``decode_partial_feat`` and the packed rows match JAX's; at world 1
    the decode returns flash_decode_local's output and the prefill the
    dense attention (JAX :292), or the kernel path for partials."""
    ins, _ = jax_sp
    for dh in (16, 64, 127, 128, 256):
        assert tsp.decode_partial_feat(dh) == jsp.decode_partial_feat(dh)
    rng = np.random.default_rng(1)
    out, lse = rng.standard_normal((2, 3, 16)), rng.standard_normal((2, 3))
    out, lse = out.astype(np.float32), lse.astype(np.float32)
    np.testing.assert_array_equal(
        tsp._pack_decode_partial(_t(out), _t(lse), 16).numpy(),
        np.asarray(jsp._pack_decode_partial(jnp.asarray(out),
                                            jnp.asarray(lse), 16)))
    q, k, v = (_t(ins[n][:, :PRE["m"]]) for n in ("q", "k", "v"))
    for causal in (True, False):
        want = jsp._single_device_attn(*(jnp.asarray(t.numpy())
                                         for t in (q, k, v)), causal=causal,
                                       scale=PRE["dh"] ** -0.5)
        got = tsp.sp_ag_attention_device(q, k, v, causal=causal)
        torch.testing.assert_close(got, _t(np.asarray(want)), **TOL)
        o, lse1 = tsp.sp_ag_attention_device(q, k, v, causal=causal,
                                             return_partials=True)
        torch.testing.assert_close(o, got, **TOL)
        assert lse1.shape == (PRE["H"], PRE["m"])
    dq = _t(ins["dq"])
    dk, dv = (_t(ins[n][:, :, :DEC["m_kv"]]) for n in ("dk", "dv"))
    want, _ = tsp.flash_decode_local(dq, dk, dv, kv_len=5)
    torch.testing.assert_close(tsp.flash_decode_device(dq, dk, dv,
                                                       kv_len=5), want)
    layer = SpGQAFlashDecodeAttention(DEC["Hq"], DEC["Hkv"], DEC["dh"])
    torch.testing.assert_close(layer(dq, dk, dv, kv_len=5), want)
    assert _no_launches()


def test_sp_attention_bound_and_refusals():
    """The prefill's operations count the pairs the mask keeps (S (S + 1)
    / 2 a head when causal and aligned; unaligned offsets counted row by
    row), not JAX's unmasked cost_estimate; the 2-D variants and a dcn
    axis raise NotImplementedError naming ROADMAP.md."""
    S = W * 4096
    causal = pm.sp_attention_pairs(W, 4096, 4096, True)
    assert causal == S * (S + 1) // 2
    assert pm.sp_attention_pairs(W, 4096, 4096, False) == S * S
    t_ops, _ = pm.bound_seconds(pm.sp_attention_flops(64, 128, causal), 0,
                                pm.H100_SXM)
    assert t_ops == pytest.approx(17.79e-3, rel=1e-3)
    rows, cols = [-2, 1, 5], [1, 1, 1]
    want = sum(min(max(rows[r] + i - cols[r] + 1, 0), 6)
               for r in range(3) for i in range(4))
    assert pm.sp_attention_pairs(3, 4, 2, True, rows, cols) == want
    assert pm.sp_attention_bytes(W, 64, 4096, 4096, 128, 2) == \
        W * 64 * 4 * 4096 * 128 * 2
    for fn in (tsp.flash_decode_2d_device, tsp.sp_ag_attention_2d_device):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(None, None, None)
    layer = SpGQAFlashDecodeAttention(4, 2, 16, dcn_axis="dcn", world=W)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layer(torch.zeros(1, 4, 16), torch.zeros(W, 1, 2, 8, 16),
              torch.zeros(W, 1, 2, 8, 16))
    with pytest.raises(ValueError) as want_err:
        jsfd.SpGQAFlashDecodeAttention(6, 4, 16)
    with pytest.raises(ValueError) as got_err:
        SpGQAFlashDecodeAttention(6, 4, 16)
    assert str(got_err.value) == str(want_err.value)
