"""Parity of the port's KV quantization and paged pool writes with JAX.

``quantize_kv_rows`` must give the JAX wire bytes and scales exactly (int8
and fp8 e4m3fn, including all-zero rows, exact .5 ties and a row with one
huge element), ``dequantize_kv_rows`` the same values.
``paged_cache_update`` must leave the pool byte-identical to the JAX
function's for 1-D and 2-D write masks with positions crossing block edges,
including a dead slot whose table names block 0 while a live slot writes
block 0 (a masked write is dropped, never clamped or written back), and
the quantized append must put each row and its scale at the same line.
``paged_gather_kv`` must match the JAX table walk, clip and dead-slot
routing included. All comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import sp_attention as jsp
from triton_distributed_tpu.layers import nn as jnn
from triton_distributed_tpu_torch.kernels import sp_attention as tsp
from triton_distributed_tpu_torch.layers import nn as tnn

WIRE = {"int8": (jnp.int8, torch.int8),
        "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _bytes(x) -> np.ndarray:
    """Raw bytes of a JAX array or torch tensor, for exact comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.array(x).view(np.uint8)


def _rows(wire: str) -> np.ndarray:
    """(4, 2, 16) rows: random, all-zero, ties on the wire grid, and one
    huge element that rounds everything else to zero."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 2, 16)).astype(np.float32)
    x[1, 0] = 0.0
    qmax = 127.0 if wire == "int8" else 448.0
    # amax == qmax makes the multiplier exactly 1, so these values sit
    # halfway between two wire values and must round half to even (int8:
    # x.5; e4m3: 8.5, 9.5 at step 1, 17, 19 at step 2, 432 at step 32).
    ties = ([0.5, 1.5, 2.5, -0.5, -2.5, 126.5] if wire == "int8"
            else [8.5, 9.5, 17.0, 19.0, -17.0, 432.0])
    x[2, 1] = 0.0
    x[2, 1, 0] = qmax
    x[2, 1, 1:1 + len(ties)] = ties
    x[3, 0, 5] = 1e30
    return x


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantize_matches_jax_bytes(wire):
    x = _rows(wire)
    jq, js = jnn.quantize_kv_rows(jnp.asarray(x), WIRE[wire][0])
    tq, ts = tnn.quantize_kv_rows(torch.from_numpy(x), WIRE[wire][1])
    assert tq.dtype == WIRE[wire][1] and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(_bytes(ts), _bytes(js))
    assert (ts[1, 0] == 0).all() and (tq[1, 0].float() == 0).all()
    np.testing.assert_array_equal(
        tnn.dequantize_kv_rows(tq, ts).numpy(),
        np.asarray(jnn.dequantize_kv_rows(jq, js)))


def test_quantize_rejects_unknown_wire_dtype():
    with pytest.raises(ValueError, match="wire dtype"):
        tnn.quantize_kv_rows(torch.ones(2, 8), torch.int16)


def _update_case(seed, dead_slot: bool = True):
    """A pool of 10 blocks of 4 lines; 3 slots writing L = 6 tokens at
    offsets that cross block edges. With ``dead_slot``, slot 2's stale
    table names block 0, which slot 0 writes in the same step (the mask
    must drop slot 2); without, slot 2 owns blocks of its own."""
    rng = np.random.default_rng(seed)
    n_blocks, bs, H, dh, L = 10, 4, 2, 8, 6
    pool = rng.standard_normal((n_blocks, bs, H, dh)).astype(np.float32)
    new = rng.standard_normal((3, L, H, dh)).astype(np.float32)
    tables = np.array([[7, 0, 3, 0], [2, 5, 9, 8],
                       [0, 0, 0, 0] if dead_slot else [1, 4, 6, 0]],
                      np.int32)
    offsets = np.array([3, 6, 1], np.int32)
    return pool, new, tables, offsets


MASKS = {
    "none": None,
    "slots": np.array([True, True, False]),
    "tokens": np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0],
                        [1, 1, 1, 1, 1, 1]], bool) & np.array(
                            [True, True, False])[:, None],
}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("wire", [None, "int8", "fp8"])
def test_paged_cache_update_matches_jax(mask, wire):
    wm = MASKS[mask]
    pool, new, tables, offsets = _update_case(1, dead_slot=wm is not None)
    jkw = {} if wm is None else {"write_mask": jnp.asarray(wm)}
    tkw = {} if wm is None else {"write_mask": torch.from_numpy(wm)}
    tpool = torch.from_numpy(pool.copy())
    if wire is None:
        want = jnn.paged_cache_update(jnp.asarray(pool), jnp.asarray(new),
                                      jnp.asarray(tables),
                                      jnp.asarray(offsets), **jkw)
        got = tnn.paged_cache_update(tpool, torch.from_numpy(new),
                                     torch.from_numpy(tables),
                                     torch.from_numpy(offsets), **tkw)
        assert got is tpool                      # written in place
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
    else:
        jw, tw = WIRE[wire]
        jpool, jscale = jnn.quantize_kv_rows(jnp.asarray(pool), jw)
        tq, tscale = tnn.quantize_kv_rows(tpool, tw)
        want = jnn.paged_cache_update(jpool, jnp.asarray(new),
                                      jnp.asarray(tables),
                                      jnp.asarray(offsets), **jkw,
                                      scale_pool=jscale)
        got = tnn.paged_cache_update(tq, torch.from_numpy(new),
                                     torch.from_numpy(tables),
                                     torch.from_numpy(offsets), **tkw,
                                     scale_pool=tscale)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bytes(g), _bytes(w))
    # Lines no kept write reaches are untouched, block 0 included.
    written = set()
    keep = np.ones((3, 6), bool) if wm is None else (
        wm if wm.ndim == 2 else np.repeat(wm[:, None], 6, axis=1))
    for b in range(3):
        for j in range(6):
            if keep[b, j]:
                p = offsets[b] + j
                written.add((int(tables[b, min(p // 4, 3)]), p % 4))
    out = got if wire is None else got[0].float() * got[1][..., None]
    ref = pool if wire is None else (tq.float() * tscale[..., None]).numpy()
    untouched = [(blk, ln) for blk in range(10) for ln in range(4)
                 if (blk, ln) not in written]
    for blk, ln in untouched:
        np.testing.assert_array_equal(out[blk, ln].numpy(), ref[blk, ln])


def test_paged_cache_update_drops_every_write_of_a_dead_step():
    """No kept row at all: the pool comes back byte-identical."""
    pool, new, tables, offsets = _update_case(2)
    tpool = torch.from_numpy(pool.copy())
    tnn.paged_cache_update(tpool, torch.from_numpy(new),
                           torch.from_numpy(tables),
                           torch.from_numpy(offsets),
                           torch.zeros(3, dtype=torch.bool))
    np.testing.assert_array_equal(tpool.numpy(), pool)


@pytest.mark.parametrize("slot_mask", [None, [True, False, True]])
def test_paged_gather_kv_matches_jax(slot_mask):
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    tables = np.array([[5, 1, 7], [2, 0, 3], [4, -1, 6]], np.int32)
    jkw, tkw = {}, {}
    if slot_mask is not None:
        jkw["slot_mask"] = jnp.asarray(slot_mask)
        tkw["slot_mask"] = torch.tensor(slot_mask)
    want = jsp.paged_gather_kv(jnp.asarray(pool), jnp.asarray(tables), **jkw)
    got = tsp.paged_gather_kv(torch.from_numpy(pool),
                              torch.from_numpy(tables), **tkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scales = pool[..., 0]
    np.testing.assert_array_equal(
        tsp.paged_gather_kv(torch.from_numpy(scales),
                            torch.from_numpy(tables), **tkw).numpy(),
        np.asarray(jsp.paged_gather_kv(jnp.asarray(scales),
                                       jnp.asarray(tables), **jkw)))
    with pytest.raises(TypeError, match="int32"):
        tsp.paged_gather_kv(torch.from_numpy(pool),
                            torch.from_numpy(tables).long())
