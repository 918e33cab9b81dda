"""The host-side plans of the one-shot all-reduce and the SP prefill's
wgmma path, on the CPU: the one-shot chunk plan covers every element once,
and both kernels' ticket orders hand out every item once and every item a
waiter depends on before it (the kernels' deadlock argument). The orders
here are the kernels' own (``item_of`` in ``csrc/oneshot_ar.cuh``,
``wg_item_of`` in ``csrc/sp_ag_attn.cu``), whose constants the tests hold
to the Python ones; the kernels run in ``tests/test_torch_gpu.py`` on the
card. Also the persistent scratch the serving all-reduce stages into."""

import re
from pathlib import Path

import pytest
import torch

from triton_distributed_tpu_torch.kernels import allreduce as tar
from triton_distributed_tpu_torch.kernels import sp_attention as tsp
from triton_distributed_tpu_torch.runtime import symm

CSRC = (Path(__file__).resolve().parent.parent / "triton_distributed_tpu_torch"
        / "csrc")


def _const(name: str, source: str) -> int:
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_python_orders_use_the_kernels_constants():
    # A round: kThreads threads x kRound 16-byte vectors (the one-shot's
    # items, shared with the loopback, live in oneshot_ar.cuh).
    assert (_const("kThreads", "oneshot_ar.cuh")
            * _const("kRound", "oneshot_ar.cuh") * 16
            == tar.ONESHOT_ROUND_BYTES)
    assert _const("kLag", "oneshot_ar.cuh") == 1  # oneshot_ar_items' default
    assert _const("kLookahead", "sp_ag_attn.cu") == tsp.SP_PUSH_LOOKAHEAD
    assert _const("BQ", "attn_wgmma.cuh") == tsp.SP_WGMMA_ROWS


@pytest.mark.parametrize("rows,hidden,dtype,chunk,n_chunks", [
    (128, 5120, torch.bfloat16, 8192, 80),      # bench.py's all-reduce
    (8, 5120, torch.bfloat16, 8192, 5),         # the ar serve's decode
    (8192, 5120, torch.bfloat16, 40960, 1024),  # its prefill: 5 rounds
    (1000, 384, torch.float32, 4096, 94),
    (7, 33, torch.float32, 4096, 1),            # n not a whole vector
    (3, 1, torch.bfloat16, 8192, 1),
])
def test_oneshot_plan_covers_every_element_once(rows, hidden, dtype, chunk,
                                                n_chunks):
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = rows * hidden
    got = tar.oneshot_ar_plan(n, itemsize)
    assert got == (chunk, n_chunks)
    # Whole rounds (so whole vectors of either dtype), at most MAX_CHUNKS.
    assert (chunk * itemsize) % tar.ONESHOT_ROUND_BYTES == 0
    assert n_chunks <= tar.MAX_CHUNKS
    covered = torch.zeros(n, dtype=torch.int32)
    for c in range(n_chunks):
        covered[c * chunk:min((c + 1) * chunk, n)] += 1
    assert bool((covered == 1).all())


@pytest.mark.parametrize("world,n_chunks", [(2, 1), (2, 5), (3, 4),
                                            (8, 80), (8, 1)])
def test_oneshot_items_once_each_and_waits_only_on_earlier_tickets(
        world, n_chunks):
    items = tar.oneshot_ar_items(world, n_chunks)
    assert len(items) == 2 * world * n_chunks
    assert len(set(items)) == len(items)
    assert {i for i in items if i[0] == "push"} == {
        ("push", c, s) for c in range(n_chunks) for s in range(world)}
    assert {i for i in items if i[0] == "fold"} == {
        ("fold", c, d) for c in range(n_chunks) for d in range(world)}
    at = {item: t for t, item in enumerate(items)}
    for c in range(n_chunks):
        for d in range(world):
            fold = at["fold", c, d]
            # Every flag (c, src != d) the fold waits on was raised by an
            # earlier ticket: a push never waits, so no wait can deadlock.
            assert all(at["push", c, s] < fold for s in range(world)
                       if s != d)
            # Right behind the pushes of chunk c + 1 (the lag of one chunk):
            # the staged lines are read while they are in L2.
            if c + 1 < n_chunks:
                assert max(at["push", c + 1, s]
                           for s in range(world)) < fold
            if c + 2 < n_chunks:
                assert fold < min(at["push", c + 2, s]
                                  for s in range(world))


@pytest.mark.parametrize("world,H,m", [(8, 64, 4096), (4, 3, 200), (2, 1, 77),
                                       (3, 2, 128), (8, 2, 129)])
def test_sp_items_once_each_and_waits_only_on_earlier_tickets(world, H, m):
    items = tsp.sp_ag_attn_items(world, H, m)
    nt = -(-m // tsp.SP_WGMMA_ROWS)
    assert len(items) == world * H * (1 + nt)
    assert len(set(items)) == len(items)
    at = {item: t for t, item in enumerate(items)}
    assert set(at) == ({("push", s, h) for s in range(world)
                        for h in range(H)}
                       | {("attend", r, h, q) for r in range(world)
                          for h in range(H) for q in range(nt)})
    attends = [i for i in items if i[0] == "attend"]
    for r in range(world):
        for h in range(H):
            first = at["attend", r, h, nt - 1]
            # A tile waits on the flags (r, src, h) that push (src, h)
            # raises: every one of them is an earlier ticket.
            assert max(at["push", s, h] for s in range(world)) < first
            # One (rank, head)'s tiles in a row, the latest first.
            assert [at["attend", r, h, q] for q in reversed(range(nt))] == \
                list(range(first, first + nt))
    # Head by head, the latest rank first within a head.
    assert [(a[2], -a[1], -a[3]) for a in attends] == sorted(
        (a[2], -a[1], -a[3]) for a in attends)
    # The pushes of a head go out SP_PUSH_LOOKAHEAD heads ahead of its
    # attend items (head h + lookahead's pushes before head h's attends).
    la = tsp.SP_PUSH_LOOKAHEAD
    for h in range(H - la):
        assert (max(at["push", s, h + la] for s in range(world))
                < min(at["attend", r, h, q] for r in range(world)
                      for q in range(nt)))


def test_serving_scratch_is_persistent_and_grows():
    symm.clear_workspaces()
    cpu = torch.device("cpu")
    a = symm.get_scratch("t.scratch", 100, torch.float32, world=8,
                         device=cpu, stream=7)
    assert a.array.shape == (8, 100)
    assert symm.get_scratch("t.scratch", 60, torch.float32, world=8,
                            device=cpu, stream=7) is a
    b = symm.get_scratch("t.scratch", 300, torch.float32, world=8,
                         device=cpu, stream=7)
    assert b is not a and b.array.shape == (8, 300)
    assert symm.get_scratch("t.scratch", 300, torch.float32, world=8,
                            device=cpu, stream=8) is not b  # another stream
    b.views["v"] = b.array[:, :10]
    assert symm.get_scratch("t.scratch", 1, torch.float32, world=8,
                            device=cpu, stream=7).views["v"] is b.views["v"]
    symm.clear_workspaces()
    assert symm.get_scratch("t.scratch", 1, torch.float32, world=8,
                            device=cpu, stream=7) is not b


def test_serving_staging_view_lays_out_every_rank_slot():
    x = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5)
    symm.clear_workspaces()
    st = tar.serving_staging(x, 0)
    assert st.shape == (3, 2, 4, 5) and st.is_contiguous()
    assert tar.serving_staging(x, 0).data_ptr() == st.data_ptr()
    ws = symm.get_scratch("oneshot_ar.staging", 2 * 20, x.dtype, world=3,
                          device=x.device, stream=0)
    assert st.data_ptr() == ws.array.data_ptr()
    symm.clear_workspaces()
