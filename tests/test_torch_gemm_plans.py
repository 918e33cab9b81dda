"""The tile walk of the warp-specialised matmul and the work items of the
GEMM-RS loopback, as this file's Python mirrors of the CUDA sources list
them, held on the CPU:

- the matmul (``allgather_gemm.matmul_tile``, the host's tile-shape rule
  that the card tests check against the launched kernel, and ``tile_walk``
  here, ``csrc/gemm_ws.cuh`` ``Grouped``): 128 x 256 where those tiles
  give every SM one, else 128 x 128; every output tile taken by exactly
  one block of a grid of min(SMs, tiles); the grouped order's first wave
  inside one band of row tiles; at Qwen3-1.7B's four prefill projections
  (M = 8,192), at M = 64 and 130, on 132 SMs and on 7;
- the loopback (``loopback_items`` here, ``csrc/gemm_rs.cuh`` ``item_of``
  / ``run_items`` at ``make_loopback_geometry``): every fold waits only on
  flags raised by products with smaller tickets, each output tile is
  folded once, in the source order 0 .. S - 1, each product it needs is
  made once, for the fused items (rank by rank), the split items and the
  ``mma.sync`` items;
- the constants each mirror shares with its source, read from the source.

The plain versions (``matmul_ref``, ``gemm_rs_loopback_ref``) are held
against the JAX package in ``tests/test_torch_matmul.py`` and
``tests/test_torch_overlap.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs

CSRC = Path(tg.__file__).resolve().parent.parent / "csrc"
# Qwen3-1.7B's prefill projections at 4 x 2,048 tokens (chip_smoke.py
# PROJECTIONS: qkv, o and down, gate_up) as (M, N), then phase 2's and a
# ragged serving step's row counts, and phase 5's bare arm.
MATMUL_SHAPES = [(8192, 4096), (8192, 2048), (8192, 12288), (64, 2048),
                 (130, 2048), (130, 12288), (4096, 3200)]
SMS = [132, 7]


def _constant(path: str, name: str) -> str:
    m = re.search(rf"constexpr [^;]*?\b{name} = ([^,;]+)[,;]",
                  (CSRC / path).read_text())
    assert m, f"{path} has no {name}"
    return m.group(1).strip()


# The grouped order's band of row tiles, as the source sets it.
GROUP_M = int(_constant("gemm_ws.cuh", "GROUP_M"))


def tile_walk(M: int, N: int, sms: int) -> list[list[tuple]]:
    """Each block's output tiles (m0, n0) in the order it walks them
    (``csrc/gemm_ws.cuh`` ``Grouped::tile``, ``run``): the grid is min(SMs,
    tiles) blocks, block b takes tiles b, b + grid, ...; tile t lies in
    band t // (GROUP_M tiles_n) of GROUP_M row tiles (fewer in a short last
    band), swept column tile by column tile, its row tiles in a row."""
    bm, bn = tg.matmul_tile(M, N, sms)
    tm, tn = -(-M // bm), -(-N // bn)
    total = tm * tn
    grid = min(sms, total)

    def tile(t):
        per_band = GROUP_M * tn
        first = t // per_band * GROUP_M
        rows = min(GROUP_M, tm - first)
        r = t % per_band
        return (first + r % rows) * bm, r // rows * bn

    return [[tile(t) for t in range(blk, total, grid)]
            for blk in range(grid)]


def loopback_items(m: int, n: int, segments: int, *,
                   tma: bool = True) -> list[tuple]:
    """The loopback kernel's work items in ticket order (``csrc/gemm_rs.cuh``
    ``item_of`` / ``run_items`` at ``make_loopback_geometry``): ``("product",
    src, mt, nt)`` is source src's tile at row tile mt and column tile nt
    (128 x 128), pushed (src > 0) or, split, written to the f32 scratch
    (src 0), then its flag raised; ``("fold", mt, nt, waits, order)`` is
    the owner's output tile, which first acquires the flags ``waits``
    ((src, mt) pairs) and then adds the sources in ``order``. With ``tma``
    (the ``wgmma`` items) and m a multiple of 128 the items are fused (the
    fold computes source 0's tile itself), rank by rank; otherwise split.
    Without ``tma`` (the ``mma.sync`` items): every product, then the
    folds."""
    W, tm = segments, -(-m // trs.TILE_M)
    tn = -(-n // trs.TILE_N)
    fused = tma and m % trs.TILE_M == 0

    def fold(mt, nt):
        srcs = range(1, W) if fused else range(W)
        return ("fold", mt, nt, tuple((s, mt) for s in srcs),
                tuple(range(W)))

    if not tma:
        items = []
        for t in range(W * tm * tn):
            r, j, nt = t // (tm * tn), t // tn % tm, t % tn
            items.append(("product", r, ((r + 1) % W * m // trs.TILE_M + j)
                          % tm, nt))
        return items + [fold(u // tn % tm, u % tn) for u in range(tm * tn)]
    if fused:
        items = [("product", 1 + t // (tm * tn), t // tn % tm, t % tn)
                 for t in range((W - 1) * tm * tn)]
        return items + [fold(u // tn % tm, u % tn) for u in range(tm * tn)]
    per = W * tm + tm
    items = []
    for t in range(per * tn):
        nt, s = divmod(t, per)
        items.append(("product", s // tm, s % tm, nt) if s < W * tm else
                     fold((s - W * tm) % tm, nt))
    return items


def test_constants_match_the_sources():
    assert int(_constant("gemm_ws.cuh", "BM")) == tg.WS_TILE_M
    assert int(_constant("gemm_rs.cuh", "BM")) == trs.TILE_M


@pytest.mark.parametrize("sms", SMS)
def test_matmul_tile_rule(sms):
    for M, N in MATMUL_SHAPES:
        bm, bn = tg.matmul_tile(M, N, sms)
        wide = -(-M // 128) * -(-N // 256)
        assert bm == 128 and bn == (256 if wide >= sms else 128)
    if sms == 132:  # the projections take the wide tile, phase 2 the narrow
        assert tg.matmul_tile(8192, 2048, sms) == (128, 256)
        assert tg.matmul_tile(64, 2048, sms) == (128, 128)
        assert tg.matmul_tile(130, 2048, sms) == (128, 128)


@pytest.mark.parametrize("M,N", MATMUL_SHAPES)
@pytest.mark.parametrize("sms", SMS)
def test_matmul_walk_covers_every_tile_once(M, N, sms):
    bm, bn = tg.matmul_tile(M, N, sms)
    tm, tn = -(-M // bm), -(-N // bn)
    walk = tile_walk(M, N, sms)
    assert len(walk) == min(sms, tm * tn)
    seen = np.zeros((tm, tn), np.int32)
    for tiles in walk:
        for m0, n0 in tiles:
            assert m0 % bm == 0 and n0 % bn == 0
            seen[m0 // bm, n0 // bn] += 1
    assert (seen == 1).all()
    # Blocks take tiles b, b + grid, ...: no two blocks' counts differ by
    # more than one.
    counts = [len(t) for t in walk]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("M,N", MATMUL_SHAPES[:3])
def test_matmul_first_wave_shares_a_band(M, N):
    """The 132 tiles that run first lie in as few bands of GROUP_M row
    tiles as their count allows, so they share A's rows and B's columns."""
    bm, bn = tg.matmul_tile(M, N, 132)
    tn = -(-N // bn)
    first = [tiles[0] for tiles in tile_walk(M, N, 132)]
    rows = {m0 // bm for m0, _ in first}
    cols = {n0 // bn for _, n0 in first}
    bands = -(-132 // (GROUP_M * tn))
    assert len(rows) <= GROUP_M * bands
    assert len(cols) <= min(tn, -(-132 // GROUP_M))


# (m, N, segments, tma): bench.py's arm (fused), a 50-row segment (split),
# both on the mma.sync items, segments 1 and 2, a ragged N.
LOOPBACK_CASES = [(512, 5120, 8, True), (50, 256, 8, True),
                  (50, 256, 8, False), (512, 5120, 8, False),
                  (128, 128, 1, True), (128, 256, 2, True),
                  (64, 128, 2, True), (256, 200, 4, True),
                  (100, 136, 4, False)]


@pytest.mark.parametrize("m,n,segments,tma", LOOPBACK_CASES)
def test_loopback_folds_wait_only_on_earlier_tickets(m, n, segments, tma):
    items = loopback_items(m, n, segments, tma=tma)
    raised = {}
    for t, it in enumerate(items):
        if it[0] == "product":
            key = (it[1], it[2], it[3])  # (src, mt, nt)
            assert key not in raised, f"product {key} twice"
            raised[key] = t
    for t, it in enumerate(items):
        if it[0] == "fold":
            _, mt, nt, waits, _ = it
            for src, wmt in waits:
                assert raised[(src, wmt, nt)] < t


@pytest.mark.parametrize("m,n,segments,tma", LOOPBACK_CASES)
def test_loopback_folds_every_tile_once_in_source_order(m, n, segments,
                                                         tma):
    items = loopback_items(m, n, segments, tma=tma)
    tm, tn = -(-m // trs.TILE_M), -(-n // trs.TILE_N)
    fused = tma and m % trs.TILE_M == 0
    folds = [it for it in items if it[0] == "fold"]
    assert sorted((mt, nt) for _, mt, nt, _, _ in folds) == sorted(
        (mt, nt) for mt in range(tm) for nt in range(tn))
    for _, mt, nt, waits, order in folds:
        assert order == tuple(range(segments))
        # Every source but the one the fold computes itself, at its rows.
        assert set(waits) == {(s, mt) for s in range(1 if fused else 0,
                                                     segments)}
    products = {it[1:] for it in items if it[0] == "product"}
    srcs = range(1, segments) if fused else range(segments)
    assert products == {(s, mt, nt) for s in srcs for mt in range(tm)
                        for nt in range(tn)}
    # As many tickets as the kernel's geometry counts.
    per = segments * tm if fused else segments * tm + tm
    assert len(items) == per * tn


def test_loopback_fused_products_precede_every_fold():
    """Rank by rank, at bench.py's shape: every product ticket comes
    before every fold ticket."""
    kinds = [it[0] for it in loopback_items(512, 5120, 8)]
    first_fold = kinds.index("fold")
    assert "product" not in kinds[first_fold:]
