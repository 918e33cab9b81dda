"""The ring allgather's and the one-shot all-reduce loopback's work items
and launch plans, held on the CPU:

- the ring (``ring_items`` here, the Python mirror of ``csrc/ring_ag.cu``'s
  item loop): every (step, rank, piece) item once, step-major; every wait
  on a flag that an item with a smaller ticket raised; every flag raised
  once and awaited once, the last step raising none; step 0 storing every
  own slot; the items, run in ticket order on labels, leave every rank's
  output the shards in rank order;
- the loopback (``allreduce.oneshot_ar_items`` with one owner: the order of
  ``csrc/oneshot_ar.cuh`` ``item_of`` that ``csrc/oneshot_ar_loopback.cu``
  runs): every push and fold once, each fold behind its push and right
  behind the next chunk's push, every flag raised once and awaited once;
- both tickets: handed out by a simulated persistent grid, the items
  never deadlock for any block count, every block takes one ticket past
  the work, and the taker of ``items + blocks - 1``, the one the source
  names, leaves the counter at 0;
- the launch plans (``allgather.ag_plan``, ``allreduce.loopback_plan``):
  made once per key (one occupancy query, stubbed here) and reused, their
  geometry, and the loopback's persistent staging;
- that neither kernel's source makes a memset and neither wrapper takes an
  epoch.

The kernels run in ``tests/test_torch_gpu.py`` on the card.
"""

import importlib
import inspect
import random
import re
from pathlib import Path

import pytest
import torch

from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import allreduce as tar
from triton_distributed_tpu_torch.runtime import symm

tag = importlib.import_module("triton_distributed_tpu_torch.kernels.allgather")
CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"


def _const(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, f"{source} has no {name}"
    return int(m.group(1))


def ring_flag(world: int, n_pieces: int, d: int, s: int, q: int) -> int:
    """``flag_at(d, s, q)`` of ``csrc/ring_ag.cu``."""
    return (d * (world - 2) + s) * n_pieces + q


def ring_items(world: int, n_pieces: int) -> list[dict]:
    """``csrc/ring_ag.cu``'s items in ticket order. Item t is (step, r, q)
    with t = (step world + r) n_pieces + q: rank r forwards piece q of
    chunk c = (r - step) mod world to rank r + 1, from x at step 0 (and
    into its own slot too), else from its own output after waiting on the
    flag step - 1 raised there; steps before the last raise the piece's
    flag at rank r + 1."""
    W, items = world, []
    for t in range((W - 1) * W * n_pieces):
        step, r, q = t // (W * n_pieces), (t // n_pieces) % W, t % n_pieces
        c, right = (r - step) % W, (r + 1) % W
        dsts = [(right, c, q)] + ([(r, r, q)] if step == 0 else [])
        items.append(dict(
            step=step, r=r, q=q, c=c,
            src=("x", r, q) if step == 0 else ("out", r, c, q),
            dsts=dsts,
            wait=None if step == 0 else ring_flag(W, n_pieces, r, step - 1,
                                                   q),
            raises=(ring_flag(W, n_pieces, right, step, q)
                    if step < W - 2 else None)))
    return items


RING_CASES = [(8, 10), (8, 20), (8, 640), (2, 1), (2, 3), (3, 1), (3, 4),
              (5, 2)]


@pytest.mark.parametrize("world,n_pieces", RING_CASES)
def test_ring_items_once_each_step_major_and_flags_once(world, n_pieces):
    items = ring_items(world, n_pieces)
    keys = [(i["step"], i["r"], i["q"]) for i in items]
    assert len(set(keys)) == len(keys) == (world - 1) * world * n_pieces
    assert keys == sorted(keys)   # step-major
    raised = [i["raises"] for i in items if i["raises"] is not None]
    awaited = [i["wait"] for i in items if i["wait"] is not None]
    n_flags = world * (world - 2) * n_pieces
    assert sorted(raised) == sorted(awaited) == list(range(n_flags))
    assert all(i["raises"] is None for i in items if i["step"] == world - 2)
    # Every wait is on a flag an item with a smaller ticket raised.
    raised_at = {i["raises"]: t for t, i in enumerate(items)
                 if i["raises"] is not None}
    for t, i in enumerate(items):
        if i["wait"] is not None:
            assert raised_at[i["wait"]] < t
    # Step 0 stores every rank's own slot, every piece, and nothing else
    # does.
    own = [d for i in items for d in i["dsts"] if d[0] == d[1]]
    assert sorted(own) == [(r, r, q) for r in range(world)
                           for q in range(n_pieces)]
    assert all(i["step"] == 0 for i in items
               if any(d[0] == d[1] for d in i["dsts"]))


@pytest.mark.parametrize("world,n_pieces", RING_CASES)
def test_ring_items_gather_every_shard_in_jax_order(world, n_pieces):
    """Run on labels in ticket order: every read is of a piece an earlier
    item stored, behind the flag that guards it, and at the end out[d]
    holds every shard in rank order. At step s rank r forwards chunk (r -
    s) mod world, JAX's order (allgather.py:99-114)."""
    out, up = {}, set()
    for i in ring_items(world, n_pieces):
        assert i["c"] == (i["r"] - i["step"]) % world
        if i["wait"] is not None:
            assert i["wait"] in up
            up.discard(i["wait"])
            value = out[i["src"][1:]]
        else:
            value = i["src"][1:]
        for d in i["dsts"]:
            assert d not in out   # every slot stored once
            out[d] = value
        if i["raises"] is not None:
            assert i["raises"] not in up
            up.add(i["raises"])
    assert not up   # every flag lowered by its waiter
    assert out == {(d, s, q): (s, q) for d in range(world)
                   for s in range(world) for q in range(n_pieces)}


def simulate(deps: list[list[int]], blocks: int,
             seed: int) -> list[list[int]]:
    """A persistent grid of ``blocks`` blocks taking tickets from one
    counter in a random interleaving, a block its next ticket when its item
    is done (``gemm_tile.cuh`` ``take_ticket``); item t runs once every
    item in deps[t] has finished. Returns each block's tickets; fails if
    every live block waits (a deadlock)."""
    rng = random.Random(seed)
    total, counter, done = len(deps), 0, set()
    taken = [[] for _ in range(blocks)]
    cur = [None] * blocks
    live = set(range(blocks))

    def start(b):
        nonlocal counter
        t = counter
        counter += 1
        taken[b].append(t)
        if t >= total:
            live.discard(b)
        else:
            cur[b] = t

    for b in rng.sample(range(blocks), blocks):
        start(b)
    while live:
        ready = [b for b in live if all(d in done for d in deps[cur[b]])]
        assert ready, "every live block waits: deadlock"
        b = rng.choice(ready)
        done.add(cur[b])
        start(b)
    assert done == set(range(total))
    return taken


def _check_tickets(taken, total, blocks, source, marker):
    every = sorted(t for ts in taken for t in ts)
    assert every == list(range(total + blocks))
    # One ticket past the work a block; the last is items + blocks - 1,
    # the ticket whose taker the source has leave the counter at 0.
    assert all(sum(t >= total for t in ts) == 1 for ts in taken)
    assert max(every) == total + blocks - 1
    assert marker in (CSRC / source).read_text()


@pytest.mark.parametrize("world,n_pieces", [(8, 10), (3, 4), (2, 3)])
@pytest.mark.parametrize("blocks", [1, 3, 17, 10 ** 6])
def test_ring_tickets_never_deadlock_and_reset_the_counter(world, n_pieces,
                                                           blocks):
    items = ring_items(world, n_pieces)
    raised_at = {i["raises"]: t for t, i in enumerate(items)
                 if i["raises"] is not None}
    deps = [[raised_at[i["wait"]]] if i["wait"] is not None else []
            for i in items]
    blocks = min(blocks, len(items))   # persistent_blocks' cap
    for seed in range(3):
        taken = simulate(deps, blocks, seed=seed)
        _check_tickets(taken, len(items), blocks, "ring_ag.cu",
                       "take_ticket(ticket, total + (int)gridDim.x - 1)")


@pytest.mark.parametrize("n_chunks", [1, 2, 5, 80])
def test_loopback_items_once_each_and_folds_behind_their_push(n_chunks):
    items = tar.oneshot_ar_items(1, n_chunks)
    assert len(set(items)) == len(items) == 2 * n_chunks
    assert set(items) == ({("push", c, 0) for c in range(n_chunks)}
                          | {("fold", c, 0) for c in range(n_chunks)})
    at = {item: t for t, item in enumerate(items)}
    for c in range(n_chunks):
        fold = at["fold", c, 0]
        assert at["push", c, 0] < fold   # its flags raised earlier
        if c + 1 < n_chunks:              # right behind the next push
            assert at["push", c + 1, 0] == fold - 1
    # The world - 1 flags (c, slot): raised by push c, awaited by fold c,
    # once each.
    for world in (2, 8):
        raised = [(c, s) for kind, c, _ in items if kind == "push"
                  for s in range(world - 1)]
        awaited = [(c, s) for kind, c, _ in items if kind == "fold"
                   for s in range(world - 1)]
        assert sorted(raised) == sorted(awaited) == sorted(set(raised))
        assert len(raised) == n_chunks * (world - 1)


@pytest.mark.parametrize("n_chunks", [1, 5, 80])
@pytest.mark.parametrize("blocks", [1, 2, 7, 10 ** 6])
def test_loopback_tickets_never_deadlock_and_reset_the_counter(n_chunks,
                                                               blocks):
    items = tar.oneshot_ar_items(1, n_chunks)
    at = {item: t for t, item in enumerate(items)}
    deps = [[at["push", c, 0]] if kind == "fold" else []
            for kind, c, _ in items]
    blocks = min(blocks, len(items))
    for seed in range(3):
        taken = simulate(deps, blocks, seed=seed)
        _check_tickets(taken, len(items), blocks, "oneshot_ar_loopback.cu",
                       "take_ticket(ticket, total + (int)gridDim.x - 1)")


def test_loopback_runs_the_one_shot_items():
    """The loopback's item order is the one-shot's (``item_of`` of
    oneshot_ar.cuh with one source a chunk), and the ring's pieces are
    whole 16-byte moves, a decode shard's piece one round of its copy (at
    most kUnroll moves a thread)."""
    text = (CSRC / "oneshot_ar_loopback.cu").read_text()
    assert '#include "oneshot_ar.cuh"' in text
    assert "os::item_of(t, 1, n_chunks)" in text
    assert _const("oneshot_ar.cuh", "kLag") == 1   # oneshot_ar_items' lag
    round_bytes = (_const("ring_ag.cu", "kThreads")
                   * _const("ring_ag.cu", "kUnroll") * 16)
    for piece in (tag.RING_PIECE_SMALL, tag.RING_PIECE):
        assert piece % 16 == 0
    assert tag.RING_PIECE_SMALL <= round_bytes


def test_no_memset_and_no_host_epoch():
    for source in ("ring_ag.cu", "oneshot_ar_loopback.cu"):
        text = (CSRC / source).read_text()
        code = "\n".join(line.split("//")[0] for line in text.splitlines())
        assert "cudaMemsetAsync" not in code and "epoch" not in code
    for fn in (tag._ag_cuda, tar.oneshot_ar_loopback_cuda):
        src = inspect.getsource(fn)
        assert "next_epoch" not in src and "torch.empty(1" not in src


@pytest.fixture
def stub_blocks(monkeypatch):
    """``_build.persistent_blocks`` without a card: records each query and
    answers a block count of 7."""
    queries = []

    def fake(entry, device, *args):
        queries.append((entry, device, args))
        return 7

    monkeypatch.setattr(_build, "persistent_blocks", fake)
    monkeypatch.setattr(tag, "_AG_PLANS", {})
    monkeypatch.setattr(tar, "_LOOPBACK_PLANS", {})
    return queries


@pytest.mark.parametrize("shape,dtype,small", [
    ((8, 16, 5120), torch.bfloat16, True),     # phase 10's decode
    ((8, 1024, 5120), torch.bfloat16, False),  # and prefill
    ((8, 5, 33), torch.float32, True),         # 660 B a shard
    ((2, 10, 3), torch.bfloat16, True)])
def test_ag_plan_made_once_per_key(stub_blocks, shape, dtype, small):
    x = torch.zeros(shape, dtype=dtype)
    plan = tag.ag_plan(x)
    assert tag.ag_plan(x) is plan
    assert tag.ag_plan(torch.ones(shape, dtype=dtype)) is plan
    world = shape[0]
    assert plan.out_shape == (world, world * shape[1], *shape[2:])
    assert plan.seg == x[0].numel() * x.element_size()
    # The piece by the shard's bytes: the small piece up to a decode
    # activation's shard, the large one at a prefill's.
    assert plan.piece == (tag.RING_PIECE_SMALL if small else tag.RING_PIECE)
    assert plan.n_pieces == -(-plan.seg // plan.piece)
    assert plan.n_flags == world * (world - 2) * plan.n_pieces
    assert plan.blocks == 7
    assert stub_blocks == [("tdt_ring_ag_blocks", x.device,
                            (world, plan.n_pieces))]
    other = tag.ag_plan(torch.zeros((world, shape[1] + 1, *shape[2:]),
                                    dtype=dtype))
    assert other is not plan and len(stub_blocks) == 2
    with pytest.raises(ValueError):
        tag.ag_plan(torch.zeros((1, *shape[1:]), dtype=dtype))


@pytest.mark.parametrize("shape,dtype,world", [
    ((128, 5120), torch.bfloat16, 8),   # bench.py's ar arm
    ((1000, 384), torch.float32, 3),
    ((7, 3, 5), torch.float32, 2),
    ((9,), torch.bfloat16, 1),
    ((8192, 5120), torch.bfloat16, 8)])  # more than MAX_CHUNKS units
def test_loopback_plan_made_once_per_key(stub_blocks, shape, dtype, world):
    x = torch.zeros(shape, dtype=dtype)
    plan = tar.loopback_plan(x, world)
    assert tar.loopback_plan(x, world) is plan
    n, itemsize = x.numel(), x.element_size()
    assert plan.n == n
    # Whole units of LOOPBACK_CHUNK_BYTES (whole vectors of either dtype),
    # at most MAX_CHUNKS chunks, covering [0, n) once.
    assert (plan.chunk * itemsize) % tar.LOOPBACK_CHUNK_BYTES == 0
    assert plan.n_chunks == -(-n // plan.chunk) <= tar.MAX_CHUNKS
    assert (plan.n_chunks == tar.MAX_CHUNKS
            or plan.chunk * itemsize == tar.LOOPBACK_CHUNK_BYTES)
    assert plan.staging_shape == (world - 1, *shape)
    assert plan.n_flags == plan.n_chunks * (world - 1) and plan.blocks == 7
    code = _build.DTYPE_CODES[dtype]
    assert stub_blocks == [("tdt_oneshot_ar_loopback_blocks", x.device,
                            (plan.n_chunks, world, code))]
    assert tar.loopback_plan(x, world + 1) is not plan
    assert len(stub_blocks) == 2


def test_loopback_plan_refuses_what_the_kernel_cannot_take(stub_blocks):
    with pytest.raises(TypeError):
        tar.loopback_plan(torch.zeros(4, 8, dtype=torch.int8), 8)
    with pytest.raises(ValueError):
        tar.loopback_plan(torch.zeros(0, 8), 8)
    with pytest.raises(ValueError):
        tar.loopback_plan(torch.zeros(4, 8), 0)
    assert not stub_blocks


def test_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        tag.ring_all_gather_cuda(torch.zeros(8, 2, 4))
    with pytest.raises(ValueError):
        tag.a2a_all_gather_cuda(torch.zeros(8, 2, 4))
    with pytest.raises(ValueError):
        tar.oneshot_ar_loopback_cuda(torch.zeros(4, 8))


def test_loopback_staging_is_persistent_scratch():
    symm.clear_workspaces()
    x = torch.zeros(6, 5, dtype=torch.bfloat16)
    st = tar.loopback_staging(x, 8, 0)
    assert st.shape == (7, 6, 5) and st.is_contiguous()
    assert tar.loopback_staging(x, 8, 0) is st
    ws = symm.get_scratch("oneshot_ar_loopback.staging", x.numel(), x.dtype,
                          world=7, device=x.device, stream=0)
    assert st.data_ptr() == ws.array.data_ptr()
    # A smaller call views the same memory; another stream gets its own.
    small = tar.loopback_staging(torch.zeros(2, 5, dtype=x.dtype), 8, 0)
    assert small.shape == (7, 2, 5) and small.data_ptr() == st.data_ptr()
    assert tar.loopback_staging(x, 8, 1).data_ptr() != st.data_ptr()
    symm.clear_workspaces()
