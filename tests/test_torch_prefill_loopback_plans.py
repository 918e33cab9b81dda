"""The work items of the AG-GEMM loopback and of the dense flash prefill's
``wgmma`` kernel, as their Python mirrors list them, held on the CPU:

- the loopback (``allgather_gemm.ag_loopback_items``, ``csrc/ag_gemm.cuh``
  at world 1): every flag a consumer tile waits on is raised by a producer
  with a smaller ticket, the tiles cover the (M, cols) output once, no
  producer chunk straddles a segment, and the bare twin has no producers
  and no waits;
- the prefill (``sp_attention.flash_prefill_wgmma_items``,
  ``prefill_wgmma_tile``, ``csrc/flash_prefill.cu``): every (row,
  position, q head) lies in exactly one tile, each tile row's key limit is
  the plain version's mask (``prefill_mask``), and the chunk whose V rows
  are zeroed is flagged exactly where kv_len falls inside a loaded chunk;
- ``flash_prefill_ref`` against the JAX ``flash_prefill`` (Pallas
  interpreted) at a GQA group of 8 and at per-row offsets that are no
  multiple of 128, every buffer at most 12 KB (``atol=2e-5, rtol=2e-4``,
  as ``tests/test_torch_attention.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import sp_attention as jsp
from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
from triton_distributed_tpu_torch.kernels import sp_attention as tsp

# (M, cols, segments): bench.py's arm at the 3,200-, 640- and 128-column
# splits, a ragged 3-segment M (segments of 1,000 rows, chunks of 8), 96
# rows in 12 segments of 8, and a 96-column split (the 256 x 96 tile).
LOOPBACK_SHAPES = [(4096, 3200, 8), (4096, 640, 8), (4096, 128, 8),
                   (3000, 200, 3), (96, 128, 12), (512, 480, 8)]


def _tiles(items):
    return [(t, it) for t, it in enumerate(items) if it[0] == "tile"]


@pytest.mark.parametrize("M,cols,segments", LOOPBACK_SHAPES)
def test_loopback_waits_only_on_earlier_tickets(M, cols, segments):
    items = tg.ag_loopback_items(M, cols, segments)
    raised = {it[1]: t for t, it in enumerate(items) if it[0] == "produce"}
    chunk = tg.loopback_chunk_rows(M, segments)
    assert len(raised) == M // chunk
    bm, _ = tg.loopback_tile(M, cols)
    for t, (_, m0, _, waits) in _tiles(items):
        # Every chunk its rows touch, each raised by an earlier ticket.
        rows = range(m0, min(m0 + bm, M))
        assert set(waits) == {r // chunk for r in rows}
        assert all(raised[c] < t for c in waits)
    # Producers first, then the tiles row tile by row tile.
    kinds = [it[0] for it in items]
    assert kinds == ["produce"] * len(raised) + ["tile"] * (
        len(items) - len(raised))
    m0s = [it[1] for _, it in _tiles(items)]
    assert m0s == sorted(m0s)


@pytest.mark.parametrize("M,cols,segments", LOOPBACK_SHAPES)
@pytest.mark.parametrize("staged", [True, False])
def test_loopback_tiles_cover_the_output_once(M, cols, segments, staged):
    items = tg.ag_loopback_items(M, cols, segments, staged=staged)
    bm, bn = tg.loopback_tile(M, cols)
    seen = np.zeros((M, cols), np.int32)
    for _, (_, m0, n0, waits) in _tiles(items):
        seen[m0:m0 + bm, n0:n0 + bn] += 1
        assert staged or waits == ()
    assert (seen == 1).all()
    assert staged or all(it[0] == "tile" for it in items)


@pytest.mark.parametrize("M,cols,segments", LOOPBACK_SHAPES)
def test_loopback_chunks_never_straddle_a_segment(M, cols, segments):
    seg = M // segments
    chunks = [it for it in tg.ag_loopback_items(M, cols, segments)
              if it[0] == "produce"]
    covered = np.zeros(M, np.int32)
    for _, c, r0, r1 in chunks:
        assert r0 // seg == (r1 - 1) // seg
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert tg.loopback_chunk_rows(M, segments) == math.gcd(seg, 16)


def test_loopback_tile_shapes():
    assert tg.loopback_tile(4096, 3200) == (128, 128)
    assert tg.loopback_tile(4096, 480) == (256, 96)
    assert tg.loopback_tile(96, 480) == (128, 96)
    assert tg.loopback_tile(4096, 1920) == (128, 128)


# (B, L, Hq, Hkv, S, offset, kv_len, seq_lens): offsets 0 and 300, a
# varlen batch with a 1-row and a mid-chunk row, kv_len at 1, 127, 128
# and 129 (a per-row tensor), S no multiple of 128, L no multiple of a
# tile's positions.
PREFILL_CASES = {
    "offset0": (2, 200, 4, 2, 333, 0, None, None),
    "offset300": (2, 150, 16, 2, 600, 300, None, None),
    "varlen": (3, 260, 2, 2, 700, 5, None, [260, 1, 123]),
    "kv_len_edges": (4, 200, 16, 2, 512, 0, [1, 127, 128, 129], None),
    "gqa16": (1, 77, 16, 1, 96, 9, None, None),
}


def _case(name):
    B, L, Hq, Hkv, S, offset, kv_len, seq_lens = PREFILL_CASES[name]
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    lens = (None if seq_lens is None
            else torch.tensor(seq_lens, dtype=torch.int32))
    valid, _ = tsp.prefill_mask(offset, kv, lens, B, L, S, "cpu")
    rows = []
    for b in range(B):
        rows.append(dict(
            offset=offset,
            kv_len=(offset + (L if lens is None else seq_lens[b])
                    if kv is None else kv_len[b]),
            q_len=L if lens is None else seq_lens[b]))
    return (B, L, Hq, Hkv, S), valid, rows


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_tiles_cover_every_row_once_in_ticket_order(name):
    (B, L, Hq, Hkv, S), _, rows = _case(name)
    items = tsp.flash_prefill_wgmma_items(B, L, Hq, Hkv)
    seen = np.zeros((B, L, Hq), np.int32)
    for b, h, qt in items:
        tile = tsp.prefill_wgmma_tile(qt, h, L=L, Hq=Hq, Hkv=Hkv, S=S,
                                      **rows[b])
        assert len(tile["rows"]) == tsp.PREFILL_WGMMA_ROWS
        for p, qh in tile["rows"]:
            assert qh // (Hq // Hkv) == h  # the tile's kv head serves it
            if p < L:
                seen[b, p, qh] += 1
    assert (seen == 1).all()
    # One (row, kv head)'s tiles in a row, latest first.
    for i in range(1, len(items)):
        if items[i][:2] == items[i - 1][:2]:
            assert items[i][2] == items[i - 1][2] - 1


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_key_limits_match_the_plain_mask(name):
    (B, L, Hq, Hkv, S), valid, rows = _case(name)
    keys = torch.arange(S)
    for b, h, qt in tsp.flash_prefill_wgmma_items(B, L, Hq, Hkv):
        tile = tsp.prefill_wgmma_tile(qt, h, L=L, Hq=Hq, Hkv=Hkv, S=S,
                                      **rows[b])
        for (p, _), lim in zip(tile["rows"], tile["keys"]):
            if p < L:
                assert torch.equal(valid[b, p], keys < lim), (b, p, lim)
            else:
                assert lim == 0
        # The chunks loaded reach every key a row sees, and no further
        # than the last 128-key chunk that holds one.
        top = max(tile["keys"])
        assert tile["chunks"] == -(-top // tsp.PREFILL_WGMMA_KEYS)


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_boundary_chunk_is_where_kv_len_falls(name):
    (B, L, Hq, Hkv, S), _, rows = _case(name)
    C = tsp.PREFILL_WGMMA_KEYS
    for b, h, qt in tsp.flash_prefill_wgmma_items(B, L, Hq, Hkv):
        tile = tsp.prefill_wgmma_tile(qt, h, L=L, Hq=Hq, Hkv=Hkv, S=S,
                                      **rows[b])
        kv_len = min(rows[b]["kv_len"], S)
        inside = [j for j in range(tile["chunks"])
                  if j * C < kv_len < (j + 1) * C]
        assert tile["boundary"] == (inside[0] if inside else None)


def test_prefill_tile_of_padding_rows_loads_nothing():
    tile = tsp.prefill_wgmma_tile(3, 0, L=260, Hq=2, Hkv=2, S=700,
                                  offset=5, kv_len=6, q_len=1)
    assert tile["chunks"] == 0 and tile["boundary"] is None
    assert set(tile["keys"]) == {0}


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


@pytest.mark.parametrize("B,L,offsets", [(2, 1, [3, 6]), (1, 3, [5])])
def test_flash_prefill_ref_matches_jax_at_gqa8_and_row_offsets(B, L,
                                                               offsets):
    """q (B, L, 8, 128) against a cache of 8 positions and one kv head,
    f32, each buffer <= 12 KB; per-row offsets (3, 5, 6: no multiple of
    128), so each row's kv_len falls inside the JAX kernel's one chunk. The
    cache past kv_len holds finite values that the mask must drop: the JAX
    kernel multiplies a NaN there into its sum (0 x NaN) where the chunk
    straddles kv_len, which the plain version and the CUDA kernels do not
    (``test_torch_attention.py``, ``test_torch_gpu.py``)."""
    Hq, Hkv, dh, S = 8, 1, 128, 8
    q, k, v = _qkv((B, L, Hq, dh), (B, S, Hkv, dh), seed=B * 10 + L)
    assert max(x.nbytes for x in (q, k, v)) <= 12 * 1024
    offs = np.asarray(offsets, np.int32)
    want = np.asarray(jsp.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        offset=jnp.asarray(offs), chunk=8))
    got = tsp.flash_prefill_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                offset=torch.from_numpy(offs))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-4)
