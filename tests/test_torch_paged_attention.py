"""Parity of the port's paged attention with the JAX package.

``paged_attention_ref`` (the plain version of ``csrc/paged_attention.cu``)
against the JAX ``paged_attention`` Pallas kernel, interpreted on the CPU,
on the same numpy-seeded f32 inputs: decode, chunked prefill in one query
tile and in several, ragged mixed rows with ``q_lens`` 0 and 1, shuffled
tables, dead slots, g in {1, 4}, block sizes 4 and 16, NaN in every pool
block no live table reaches, and unquantized, int8 and fp8 pools. Bar:
``atol=rtol=1e-5`` on the live slots (f32, the two sum in another order);
padding rows exactly zero. Then the port's own paths: ``"fused"`` equals
the ``"gather"`` oracle in ``paged_attn_with_cache``, and the CPU entry
points never launch a kernel."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import paged_attention as jpa
from triton_distributed_tpu.layers import nn as jnn
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import paged_attention as tpa
from triton_distributed_tpu_torch.layers import nn as tnn

WIRE = {"int8": (jnp.int8, torch.int8),
        "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _case(seed, *, B, L, Hq, Hkv, dh, bs, max_blocks, kv_lens, q_lens,
          dead=(), kv=None):
    """numpy inputs: a shuffled pool with NaN in every block no live table
    reaches (NaN scales for a quantized pool), dead slots whose stale
    tables name live blocks, zero padding past each live table."""
    rng = np.random.default_rng(seed)
    n_blocks = B * max_blocks + 3
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, max_blocks), np.int32)
    reached = set()
    for b in range(B):
        n = math.ceil(kv_lens[b] / bs)
        if b in dead:
            tables[b, :n] = perm[:n]
        else:
            tables[b, :n] = perm[b * max_blocks:b * max_blocks + n]
            reached.update(tables[b, :n].tolist())
    unreached = [i for i in range(n_blocks) if i not in reached]
    shape = (n_blocks, bs, Hkv, dh)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    c = dict(q=rng.standard_normal((B, L, Hq, dh)).astype(np.float32),
             block_tables=tables,
             kv_lens=np.asarray(kv_lens, np.int32),
             q_lens=np.asarray(q_lens, np.int32),
             slot_mask=np.array([b not in dead for b in range(B)]))
    if kv is None:
        k[unreached] = np.nan
        v[unreached] = np.nan
        c.update(k_pool=k, v_pool=v)
    else:
        # Quantize with the JAX function; the wire bytes travel as numpy.
        kq, ks = jnn.quantize_kv_rows(jnp.asarray(k), WIRE[kv][0])
        vq, vs = jnn.quantize_kv_rows(jnp.asarray(v), WIRE[kv][0])
        ks, vs = np.array(ks), np.array(vs)
        ks[unreached] = np.nan
        vs[unreached] = np.nan
        c.update(k_pool=np.asarray(kq), v_pool=np.asarray(vq), k_scale=ks,
                 v_scale=vs)
    return c


def _torch(c, kv=None):
    out = {}
    for name, x in c.items():
        if kv is not None and name in ("k_pool", "v_pool"):
            # numpy holds fp8 as ml_dtypes; carry the bytes, not the values
            raw = torch.from_numpy(np.array(x).view(np.uint8))
            out[name] = raw.view(WIRE[kv][1])
        else:
            out[name] = torch.from_numpy(np.array(x))
    return out


# name -> (geometry, JAX q_tile): q_tile None lets the JAX heuristic cover
# the chunk in one query tile; 4 splits L = 8 into two (causal straddle).
CASES = {
    "decode_g4_bs4": (dict(B=4, L=1, Hq=8, Hkv=2, dh=16, bs=4, max_blocks=8,
                           kv_lens=[1, 9, 32, 20], q_lens=[1, 1, 1, 1],
                           dead=(3,)), None),
    "prefill_one_tile_g1_bs16": (dict(B=2, L=8, Hq=4, Hkv=4, dh=16, bs=16,
                                      max_blocks=4, kv_lens=[8, 40],
                                      q_lens=[8, 8]), None),
    "prefill_tiles_g4_bs4": (dict(B=3, L=8, Hq=8, Hkv=2, dh=16, bs=4,
                                  max_blocks=8, kv_lens=[8, 20, 13],
                                  q_lens=[8, 8, 5]), 4),
    "mixed_ragged_dead": (dict(B=4, L=8, Hq=8, Hkv=2, dh=16, bs=4,
                               max_blocks=8, kv_lens=[8, 17, 3, 30],
                               q_lens=[8, 1, 0, 5], dead=(2,)), None),
    "int8_mixed_g1_bs16": (dict(B=3, L=4, Hq=4, Hkv=4, dh=16, bs=16,
                                max_blocks=4, kv_lens=[4, 33, 18],
                                q_lens=[4, 1, 2], kv="int8"), None),
    "fp8_mixed_g4_bs4": (dict(B=3, L=8, Hq=8, Hkv=2, dh=16, bs=4,
                              max_blocks=8, kv_lens=[8, 25, 6],
                              q_lens=[8, 1, 6], dead=(1,), kv="fp8"), 4),
    # The head dims and a GQA group of the tensor-core path over a
    # quantized pool (bf16 q at head_dim 64 / 128 on the card).
    "int8_mixed_g2_dh64": (dict(B=3, L=8, Hq=4, Hkv=2, dh=64, bs=16,
                                max_blocks=4, kv_lens=[8, 37, 20],
                                q_lens=[8, 1, 5], kv="int8"), None),
    "fp8_mixed_g2_dh128": (dict(B=3, L=8, Hq=4, Hkv=2, dh=128, bs=4,
                                max_blocks=8, kv_lens=[8, 29, 11],
                                q_lens=[8, 3, 0], dead=(2,), kv="fp8"), 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_attention_ref_matches_jax(name):
    geo, q_tile = CASES[name]
    c = _case(7, **geo)
    dead = geo.get("dead", ())
    live = [b for b in range(geo["B"]) if b not in dead]
    jkw = {k: jnp.asarray(v) for k, v in c.items()
           if k in ("k_scale", "v_scale")}
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k_pool"]),
        jnp.asarray(c["v_pool"]), jnp.asarray(c["block_tables"]),
        jnp.asarray(c["kv_lens"]), q_lens=jnp.asarray(c["q_lens"]),
        slot_mask=jnp.asarray(c["slot_mask"]), q_tile=q_tile,
        interpret=True, **jkw))
    got = tpa.paged_attention_ref(**_torch(c, geo.get("kv"))).numpy()
    assert np.isfinite(got[live]).all()
    for b in live:
        np.testing.assert_array_equal(got[b, geo["q_lens"][b]:], 0.0)
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("L", [1, 8])
def test_paged_attn_with_cache_fused_equals_gather(kv, L):
    """The port's fused read (the kernel's plain version on the CPU) and
    the gather oracle agree at decode and mixed shapes."""
    geo = dict(B=3, L=L, Hq=8, Hkv=2, dh=16, bs=4, max_blocks=8,
               kv_lens=[L, 13, 20], q_lens=[L, 1, min(L, 4)], kv=kv)
    t = _torch(_case(3, **geo), kv)
    offset = t["kv_lens"] - t["q_lens"]
    scales = (t["k_scale"], t["v_scale"]) if kv else None
    outs = [tnn.paged_attn_with_cache(
        t["q"], t["k_pool"], t["v_pool"], t["block_tables"], offset,
        scale=16 ** -0.5, slot_mask=t["slot_mask"],
        seq_lens=t["q_lens"] if L > 1 else None, paged_attn=mode,
        kv_scales=scales) for mode in ("fused", "gather")]
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="paged_attn"):
        tnn.paged_attn_with_cache(t["q"], t["k_pool"], t["v_pool"],
                                  t["block_tables"], offset, scale=1.0,
                                  paged_attn="turbo")


def test_decode_entry_and_cpu_paths_never_launch():
    c = _torch(_case(5, **CASES["decode_g4_bs4"][0]))
    _build.reset_counts()
    q1 = c["q"][:, 0]
    got = tpa.paged_decode_attention(q1, c["k_pool"], c["v_pool"],
                                     c["block_tables"], c["kv_lens"],
                                     slot_mask=c["slot_mask"])
    want = tpa.paged_attention(c["q"], c["k_pool"], c["v_pool"],
                               c["block_tables"], c["kv_lens"],
                               slot_mask=c["slot_mask"])[:, 0]
    # (the dead slot reads NaN block 0 in both: garbage, but the same)
    torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
    assert all(k.launches == 0 for k in _build.KERNELS.values())


def test_paged_attention_checks_operands():
    c = _torch(_case(6, **CASES["decode_g4_bs4"][0]))
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_attention(c["q"], c["k_pool"], c["v_pool"],
                            c["block_tables"].long(), c["kv_lens"])
    with pytest.raises(ValueError, match="together"):
        tpa.paged_attention(c["q"], c["k_pool"], c["v_pool"],
                            c["block_tables"], c["kv_lens"],
                            k_scale=torch.ones(c["k_pool"].shape[:3]))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_cuda(c["q"], c["k_pool"], c["v_pool"],
                                 c["block_tables"], c["kv_lens"])
