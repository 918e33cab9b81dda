"""The port's collectives against the JAX package's, on the CPU: the one-shot
all-reduce loopback, the EP all-to-all loopback and the notify/wait
tutorial's ring (each kernel's plain version against the JAX kernel, run in
interpret mode as the JAX tests run it), the world-1 identities, and the
all-reduce mode (``TPMLP.ar_fwd``, ``TPAttn.ar_fwd``, ``Engine(mode="ar")``
and ``BatchEngine`` over it) against JAX at world 1.

Bars: the all-reduce fold is the kernel's order and rounding, so exact; the
all-to-all compares bytes below each count (fp8 crosses through
``ml_dtypes`` on the JAX side and ``torch.float8_e4m3fn`` here); the ring is
a copy, so exact; the layers fp32 ``rtol=atol=1e-5``; tokens identical.
Inputs come from numpy seeds."""

import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.kernels import allreduce as jar
from triton_distributed_tpu.kernels import ep_all_to_all as jea
from triton_distributed_tpu.layers.tp_attn import TPAttn as JaxAttn
from triton_distributed_tpu.layers.tp_mlp import TPMLP as JaxMLP
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu.runtime.mesh import make_mesh
from triton_distributed_tpu_torch import (
    BatchEngine,
    Engine,
    ModelConfig,
    params_from_jax,
)
from triton_distributed_tpu_torch.kernels import KERNELS, _build
from triton_distributed_tpu_torch.kernels import allreduce as tar
from triton_distributed_tpu_torch.kernels import ep_all_to_all as tea
from triton_distributed_tpu_torch.kernels import notify_wait as tnw
from triton_distributed_tpu_torch.layers import TPAttn, TPMLP
from triton_distributed_tpu_torch.models.qwen import Qwen3

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh({"tp": 1}, devices=jax.devices()[:1], set_default=False)


def _no_launches():
    return all(k.launches == 0 for k in KERNELS.values())


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.itemsize == 2 else np.uint8
                  if a.itemsize == 1 else np.uint32)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor's bytes as a numpy array of unsigned ints."""
    by_size = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return _bits(t.contiguous().view(by_size[t.element_size()]).numpy())


# -- 1. the one-shot all-reduce loopback ----------------------------------

@pytest.mark.parametrize("shape,dtype,world", [
    ((16, 128), "float32", 8),    # tests/test_collectives.py:135
    ((24, 256), "bfloat16", 3)])  # a world that is not a power of two
def test_oneshot_ar_loopback_matches_jax_exactly(shape, dtype, world):
    x = np.random.default_rng(world).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    want = np.asarray(jax.jit(
        lambda a: jar.oneshot_ar_loopback(a, world=world))(jx))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    _build.reset_counts()
    got = tar.oneshot_ar_loopback(tx, world=world)
    assert _no_launches()
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(_to_numpy(got), _bits(want))


def test_oneshot_ar_loopback_ref_folds_in_rank_order():
    """bf16 at world 8 is exactly 8 x (every partial sum is exact in f32);
    an f32 fold of x + x + x rounds as sequential adds do."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 40)).astype(np.float32))
    xb = x.bfloat16()
    assert torch.equal(tar.oneshot_ar_loopback_ref(xb, world=8), 8 * xb)
    assert torch.equal(tar.oneshot_ar_loopback_ref(x, world=3), x + x + x)
    assert torch.equal(tar.oneshot_ar_loopback_ref(x, world=1), x)
    with pytest.raises(ValueError, match="world"):
        tar.oneshot_ar_loopback_ref(x, world=0)


# -- 2. the EP all-to-all loopback ------------------------------------------

@pytest.mark.parametrize("counts", [
    [0, 16, 5, 9, 1, 8, 12, 3],            # empty, full, ragged
    [-2, 20, 16, 0, 7, 8, 15, 1]])         # below zero and past capacity
def test_a2a_loopback_matches_jax_below_each_count(counts):
    """tests/test_ep_a2a.py:287-294: cap 16, hidden 32, world 8, fp8
    tokens and (8, 16, 128) f32 scales."""
    cap, hidden, world = 16, 32, 8
    rng = np.random.default_rng(len(counts) + counts[0])
    toks = rng.standard_normal((world, cap, hidden)).astype(
        np.float32).astype(ml_dtypes.float8_e4m3fn)
    scales = rng.random((world, cap, 128), dtype=np.float32)
    jctx = jea.AllToAllContext(capacity=cap, hidden=hidden, axis="tp")
    (jt, js), jrc = jax.jit(lambda t, s, c: jea.a2a_loopback(
        (t, s), c, ctx=jctx, world=world))(
        jnp.asarray(toks), jnp.asarray(scales),
        jnp.asarray(counts, jnp.int32))
    tt = torch.from_numpy(toks.view(np.uint8)).view(torch.float8_e4m3fn)
    ctx = tea.AllToAllContext(capacity=cap, hidden=hidden)
    _build.reset_counts()
    (gt, gs), grc = tea.a2a_loopback((tt, torch.from_numpy(scales)),
                                     torch.tensor(counts, dtype=torch.int32),
                                     ctx=ctx, world=world)
    assert _no_launches()
    assert gt.dtype == torch.float8_e4m3fn and gs.dtype == torch.float32
    np.testing.assert_array_equal(grc.numpy(), np.asarray(jrc))
    np.testing.assert_array_equal(grc.numpy(), counts)
    for got, want, sent in ((gt, jt, toks), (gs, js, scales)):
        got, want, sent = _to_numpy(got), _bits(np.asarray(want)), _bits(sent)
        for i, c in enumerate(counts):
            n = min(max(c, 0), cap)
            np.testing.assert_array_equal(got[i, :n], want[i, :n])
            np.testing.assert_array_equal(got[i, :n], sent[i, :n])


@pytest.mark.parametrize("kw", [dict(capacity=12, hidden=8),
                                dict(capacity=24, hidden=8, chunk_rows=12),
                                dict(capacity=24, hidden=8, chunk_rows=16)])
def test_all_to_all_context_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jea.AllToAllContext(**kw)
    with pytest.raises(ValueError) as got:
        tea.AllToAllContext(**kw)
    assert str(got.value) == str(want.value)


def test_a2a_loopback_rejects_a_layout_that_is_not_world_by_capacity():
    ctx = tea.AllToAllContext(capacity=8, hidden=4)
    with pytest.raises(ValueError, match="capacity=8"):
        tea.a2a_loopback(torch.zeros(8, 16, 4), torch.zeros(8), ctx=ctx)


# The launch plan's shapes: (world, capacity, chunk_rows, piece_bytes, each
# payload's trailing shape and dtype). bench.py's dispatch (fp8 tokens of
# 7,168 and f32 scales of 128) at one chunk and at chunks of 8; rows that
# do not split into whole pieces; a row larger than a piece; one byte rows.
A2A_PLANS = [
    (8, 128, 128, tea.PIECE_BYTES,
     [((7168,), torch.float8_e4m3fn), ((128,), torch.float32)]),
    (8, 128, 8, tea.PIECE_BYTES,
     [((7168,), torch.float8_e4m3fn), ((128,), torch.float32)]),
    (3, 24, 8, 1000, [((5, 7), torch.bfloat16)]),
    (2, 16, 16, 4096, [((3000,), torch.float32), ((1,), torch.uint8),
                       ((2, 2), torch.int32)]),
    (1, 8, 8, 1, [((4,), torch.int8)] * 4)]


@pytest.mark.parametrize("world,cap,ch,piece_bytes,pays", A2A_PLANS)
def test_a2a_plan_matches_a_direct_computation(world, cap, ch, piece_bytes,
                                               pays):
    """The cached launch plan of ``a2a_loopback_cuda`` against the
    geometry computed from its definition: bytes a row, rows a piece (about
    ``piece_bytes``, at least one, at most a chunk), and one piece item per
    (slot, chunk, piece) of every payload; the size arrays the C entry
    reads hold the same numbers."""
    payloads = [torch.zeros(world, cap, *shape, dtype=dtype)
                for shape, dtype in pays]
    plan = tea._a2a_plan(payloads, cap, ch, world, piece_bytes)
    row_bytes = [int(np.prod(shape)) * torch.empty(0, dtype=dtype)
                 .element_size() for shape, dtype in pays]
    piece_rows = [max(1, min(ch, piece_bytes // rb)) for rb in row_bytes]
    items = sum(world * (cap // ch) * math.ceil(ch / pr)
                for pr in piece_rows)
    assert plan.row_bytes == tuple(row_bytes)
    assert plan.piece_rows == tuple(piece_rows)
    assert plan.items == items
    assert list(plan.c_row_bytes) == row_bytes
    assert list(plan.c_piece_rows) == piece_rows
    assert len(plan.c_pointers(*range(len(pays)))) == len(pays)


def test_a2a_plan_is_cached_and_renewed_when_a_shape_changes():
    """One plan serves every call with the same shapes, dtypes and
    geometry; a new hidden width, dtype, chunk, world or piece size makes a
    new one, and a payload with empty rows raises as the launch did."""
    toks = torch.zeros(8, 128, 7168, dtype=torch.float8_e4m3fn)
    scales = torch.zeros(8, 128, 128)
    plan = tea._a2a_plan((toks, scales), 128, 128, 8, tea.PIECE_BYTES)
    assert tea._a2a_plan([toks.clone(), scales.clone()], 128, 128, 8,
                         tea.PIECE_BYTES) is plan
    for other in (
            tea._a2a_plan((toks[..., :4096], scales), 128, 128, 8,
                          tea.PIECE_BYTES),
            tea._a2a_plan((toks.view(torch.uint8), scales), 128, 128, 8,
                          tea.PIECE_BYTES),
            tea._a2a_plan((toks, scales), 128, 8, 8, tea.PIECE_BYTES),
            tea._a2a_plan((toks[:4], scales[:4]), 128, 128, 4,
                          tea.PIECE_BYTES),
            tea._a2a_plan((toks, scales), 128, 128, 8, 128 * 7168)):
        assert other is not plan
    assert tea._a2a_plan((toks[..., :4096], scales), 128, 128, 8,
                         tea.PIECE_BYTES).row_bytes == (4096, 512)
    with pytest.raises(ValueError, match="non-empty rows"):
        tea._a2a_plan((torch.zeros(8, 16, 0),), 16, 8, 8, tea.PIECE_BYTES)


def test_collective_wrappers_refuse_as_before():
    """The launchers' refusals, in their order: the layout, the number of
    payloads, the card, for the dispatch loopback; the chunking and the
    card for the ring. None of them launches."""
    ctx = tea.AllToAllContext(capacity=8, hidden=4)
    _build.reset_counts()
    with pytest.raises(ValueError, match="capacity=8"):
        tea.a2a_loopback_cuda(torch.zeros(8, 16, 4), torch.zeros(8),
                              ctx=ctx)
    with pytest.raises(ValueError, match="1 to 4 payloads"):
        tea.a2a_loopback_cuda([torch.zeros(8, 8, 4)] * 5, torch.zeros(8),
                              ctx=ctx)
    with pytest.raises(ValueError, match="one CUDA device"):
        tea.a2a_loopback_cuda(torch.zeros(8, 8, 4), torch.zeros(8), ctx=ctx)
    with pytest.raises(ValueError, match="n_chunks"):
        tnw.producer_consumer_cuda(torch.zeros(8, 6, 4), chunk_rows=4)
    with pytest.raises(ValueError, match="contiguous CUDA tensor"):
        tnw.producer_consumer_cuda(torch.zeros(8, 8, 4), chunk_rows=4)
    assert _no_launches()


# -- 3. the notify/wait tutorial's ring -----------------------------------

def _tutorial():
    path = REPO / "tutorials" / "01-distributed-notify-wait.py"
    spec = importlib.util.spec_from_file_location("tutorial_01", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)   # its bootstrap keeps the 8 devices
    finally:
        sys.path[:] = saved
    return mod


def test_producer_consumer_ref_matches_the_tutorial_kernel(mesh8):
    """The tutorial's own kernel (:58) on the conftest mesh, at its shapes
    (8 ranks x 4 chunks of (4, 128) f32), against the plain version."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from triton_distributed_tpu.runtime.platform import resolve_interpret

    t = _tutorial()
    rows = t.N_CHUNKS * t.CHUNK[0]
    x = np.random.default_rng(3).standard_normal(
        (t.WORLD, rows, t.CHUNK[1])).astype(np.float32)

    def per_device(xl):
        out, _queue = pl.pallas_call(
            t.producer_consumer_kernel,
            out_shape=[jax.ShapeDtypeStruct((rows, t.CHUNK[1]), jnp.float32),
                       jax.ShapeDtypeStruct((2, *t.CHUNK), jnp.float32)],
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
            scratch_shapes=[pltpu.SemaphoreType.DMA(()),
                            pltpu.SemaphoreType.DMA((2,)),
                            pltpu.SemaphoreType.REGULAR,
                            pltpu.SemaphoreType.DMA(())],
            compiler_params=pltpu.CompilerParams(has_side_effects=True,
                                                 collective_id=0),
            interpret=resolve_interpret(True),
        )(xl[0])
        return out[None]

    want = np.asarray(jax.jit(shard_map(
        per_device, mesh=mesh8, in_specs=P("tp", None, None),
        out_specs=P("tp", None, None), check_vma=False))(jnp.asarray(x)))
    _build.reset_counts()
    got = tnw.producer_consumer(torch.from_numpy(x), chunk_rows=t.CHUNK[0])
    assert _no_launches()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.roll(x, 1, axis=0))


@pytest.mark.parametrize("shape,chunk_rows", [((8, 16, 128), 4),
                                              ((3, 256 * 2, 5), 2),
                                              ((1, 4, 2, 3), 4)])
def test_producer_consumer_ref_is_the_ring_shift(shape, chunk_rows):
    x = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    got = tnw.producer_consumer(x, chunk_rows=chunk_rows)
    assert torch.equal(got, torch.roll(x, 1, 0))
    with pytest.raises(ValueError, match="n_chunks"):
        tnw.producer_consumer(x[:, :1], chunk_rows=chunk_rows + 1)


# -- 4. the world-1 identities ----------------------------------------------

def test_world_one_identities_and_multi_rank_refusals():
    x = torch.randn(4, 8)
    assert tar.oneshot_all_reduce(x) is x
    assert tar.twoshot_all_reduce(x) is x
    # World 2 runs now (row 14 is ported): every rank's copy of the sum.
    stacked = torch.randn(2, 4, 8)
    for fn in (tar.oneshot_all_reduce, tar.twoshot_all_reduce):
        got = fn(stacked, world=2)
        assert got.shape == stacked.shape
        torch.testing.assert_close(got[0], stacked.sum(0))
        assert torch.equal(got[1], got[0])
    ctx = tea.AllToAllContext(capacity=8, hidden=4)
    pay, counts = torch.randn(1, 8, 4), torch.tensor([3], dtype=torch.int32)
    out, rc = tea.fast_all_to_all(pay, counts, ctx=ctx)
    assert out is pay and rc is counts
    (o1, o2), rc = tea.fast_all_to_all((pay, pay), counts, ctx=ctx,
                                       direction="combine")
    assert o1 is pay and o2 is pay and rc is counts
    # World 2 runs now (row 18 is ported): on rank stacks, out[r][p] =
    # in[p][r] below counts[p][r], the counts transposed.
    pays = torch.randn(2, 2, 8, 4)
    counts2 = torch.tensor([[3, 8], [0, 5]], dtype=torch.int32)
    out, rc = tea.fast_all_to_all(pays, counts2, ctx=ctx, world=2)
    assert torch.equal(rc, counts2.T)
    for r in range(2):
        for p in range(2):
            n = int(rc[r, p])
            assert torch.equal(out[r, p, :n], pays[p, r, :n])
    with pytest.raises(ValueError, match="world=2"):
        tea.fast_all_to_all(pay, counts, ctx=ctx, world=2)
    with pytest.raises(ValueError) as want:
        jea.fast_all_to_all(None, None, ctx=None, direction="sideways")
    with pytest.raises(ValueError) as got:
        tea.fast_all_to_all(pay, counts, ctx=ctx, direction="sideways")
    assert str(got.value) == str(want.value)
    assert [m.value for m in tar.AllReduceMethod] == \
        [m.value for m in jar.AllReduceMethod]


# -- 5. the ar layers at world 1 --------------------------------------------

D, DH, HQ, HKV, FF = 32, 8, 4, 2, 48


def _w(rng, *shape):
    return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)


def _jax_world1(mesh, fn, *args):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                             check_vma=False))(*args)


def test_tp_mlp_ar_fwd_matches_jax(mesh1):
    rng = np.random.default_rng(0)
    params = {"w_gate_up": _w(rng, D, 2 * FF), "w_down": _w(rng, FF, D)}
    x = rng.standard_normal((12, D)).astype(np.float32)
    jmlp = JaxMLP(d_model=D, d_ff=FF)
    want = _jax_world1(mesh1, jmlp.ar_fwd,
                       jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got = TPMLP(d_model=D, d_ff=FF).ar_fwd(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attn_params(rng):
    return {"w_qkv": _w(rng, D, (HQ + 2 * HKV) * DH),
            "w_o": _w(rng, HQ * DH, D),
            "q_norm": (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32),
            "k_norm": (1 + 0.1 * rng.standard_normal(DH)).astype(np.float32)}


def test_tp_attn_ar_fwd_matches_jax_contiguous(mesh1):
    """A prefill of 6 tokens, then a decode step, into a contiguous cache."""
    rng = np.random.default_rng(1)
    params = _attn_params(rng)
    B, S = 2, 16
    jattn = JaxAttn(d_model=D, n_heads=HQ, n_kv_heads=HKV, head_dim=DH,
                    dtype=jnp.float32)
    tattn = TPAttn(d_model=D, n_heads=HQ, n_kv_heads=HKV, head_dim=DH)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jk = jv = jnp.zeros((B, S, HKV, DH), jnp.float32)
    tk, tv = torch.zeros(B, S, HKV, DH), torch.zeros(B, S, HKV, DH)
    offset = 0
    for L in (6, 1):
        x = rng.standard_normal((B, L, D)).astype(np.float32)
        out, jk, jv = _jax_world1(
            mesh1, lambda p, x, k, v, o=offset: jattn.ar_fwd(p, x, k, v, o),
            jp, jnp.asarray(x), jk, jv)
        got = tattn.ar_fwd(tp, torch.from_numpy(x), tk, tv, offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        offset += L


def test_tp_attn_ar_fwd_matches_jax_paged(mesh1):
    """A ragged mixed step over a shuffled block pool: slot 0 at depth 3
    with 4 new tokens, slot 1 at depth 9 with 2, slot 2 dead. JAX reads the
    pool through its gather oracle, the port through the fused path's
    plain version."""
    rng = np.random.default_rng(2)
    params = _attn_params(rng)
    B, L, bs, n_blocks, max_blocks = 3, 4, 4, 12, 4
    pool = rng.standard_normal((2, n_blocks, bs, HKV, DH)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:B * max_blocks].reshape(
        B, max_blocks).astype(np.int32)
    offset = np.array([3, 9, 0], np.int32)
    seq_lens = np.array([4, 2, 0], np.int32)
    mask = np.array([True, True, False])
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    jattn = JaxAttn(d_model=D, n_heads=HQ, n_kv_heads=HKV, head_dim=DH,
                    dtype=jnp.float32)

    def jfn(p, x, k, v, o, t, m, sl):
        return jattn.ar_fwd(p, x, k, v, o, block_tables=t, slot_mask=m,
                            seq_lens=sl, paged_attn="gather")

    out, jk, jv = _jax_world1(
        mesh1, jfn, jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(pool[0]), jnp.asarray(pool[1]), jnp.asarray(offset),
        jnp.asarray(tables), jnp.asarray(mask), jnp.asarray(seq_lens))
    tk, tv = torch.from_numpy(pool[0].copy()), torch.from_numpy(pool[1].copy())
    got = TPAttn(d_model=D, n_heads=HQ, n_kv_heads=HKV, head_dim=DH).ar_fwd(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), tk, tv, torch.from_numpy(offset),
        block_tables=torch.from_numpy(tables),
        slot_mask=torch.from_numpy(mask), seq_lens=torch.from_numpy(seq_lens))
    for b, n in enumerate(seq_lens):   # padding rows are garbage in both
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(out)[b, :n], **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


# -- 6. the ar engines ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(mesh1):
    """JAX ``tiny`` weights carried over, a prompt, and the JAX ar-mode
    engine's greedy tokens."""
    jcfg = JaxConfig.from_name("tiny")
    cfg = ModelConfig.from_name("tiny")
    jparams = JaxQwen3(jcfg).init(jax.random.PRNGKey(0), mesh1)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 5)
                                            ).astype(np.int32)
    jeng = JaxEngine(jcfg, mesh=mesh1, mode="ar", params=jparams)
    return dict(cfg=cfg, params=params, ids=ids,
                jtokens=np.asarray(jeng.serve(jnp.asarray(ids), 5)))


def test_ar_engine_tokens_match_jax_and_xla(tiny):
    eng = Engine(tiny["cfg"], mode="ar", device="cpu", params=tiny["params"])
    _build.reset_counts()
    tokens = eng.serve(tiny["ids"], 5)
    assert _no_launches()
    np.testing.assert_array_equal(tokens.numpy(), tiny["jtokens"])
    xla = Engine(tiny["cfg"], mode="xla", device="cpu",
                 params=tiny["params"])
    assert torch.equal(tokens, xla.serve(tiny["ids"], 5))


def test_batch_engine_over_ar_matches_the_ar_engine(tiny):
    eng = Engine(tiny["cfg"], mode="ar", device="cpu", params=tiny["params"])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tiny["cfg"].vocab_size, size=n).tolist()
               for n in (7, 5, 9)]
    be = BatchEngine(eng, n_slots=2, block_size=4, prefill_chunk=4)
    rids = [be.submit(p, 4) for p in prompts]
    out = be.run(max_steps=200)
    for rid, p in zip(rids, prompts):
        assert out[rid] == eng.serve(np.asarray([p], np.int32), 4)[0].tolist()


def test_moe_ar_raises_the_jax_message(mesh1):
    jcfg = JaxConfig.from_name("tiny-moe")
    embed = jnp.zeros((jcfg.vocab_size, jcfg.d_model), jnp.float32)
    ids = jnp.zeros((1, 2), jnp.int32)
    with pytest.raises(ValueError) as want:
        _jax_world1(mesh1, lambda e, i: JaxQwen3(jcfg).forward_device(
            {"embed": e}, i, None, None, 0, mode="ar"), embed, ids)
    cfg = ModelConfig.from_name("tiny-moe")
    with pytest.raises(ValueError) as got:
        Engine(cfg, mode="ar", device="cpu")
    assert str(got.value) == str(want.value)
    eng = Engine(cfg, device="cpu")
    kv = eng.new_cache(1)
    with pytest.raises(ValueError) as got:
        Qwen3(cfg).forward(eng.params, torch.zeros((1, 2), dtype=torch.int32),
                           kv.k, kv.v, 0, mode="ar")
    assert str(got.value) == str(want.value)


# -- 7. kernel rules and bounds ---------------------------------------------

def test_perf_model_bytes_of_the_collectives():
    """The least bytes each loopback must move, at bench.py's shapes, by
    one rule (each input read once, each output written once; the
    simulated link's scratch not counted): the all-reduce (128, 5,120) bf16
    is 2.62 MB at any world (~0.78 us on an H100 SXM); the full-occupancy
    dispatch 2 x (7,340,032 + 524,288) B plus the counts; at 13 rows a slot
    a tenth of it; the ring 2 x x."""
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    ar = pm.oneshot_ar_loopback_bytes(128 * 5120 * 2)
    assert ar == 2_621_440
    assert pm.bound_seconds(0, ar, pm.H100_SXM) == (ar / 3.35e12, "bytes")
    full = pm.a2a_loopback_bytes([128] * 8, 128, [7168, 512])
    assert full == 2 * (7_340_032 + 524_288) + 64
    assert pm.a2a_loopback_bytes([13] * 8, 128, [7168, 512]) == \
        2 * 8 * 13 * (7168 + 512) + 64
    assert pm.a2a_loopback_bytes([-1, 0, 500], 128, [4]) == 2 * 128 * 4 + 24
    assert pm.producer_consumer_bytes(65536) == 131072



def test_launchers_refuse_cpu_tensors_and_entry_points_need_a_card():
    """A ``_cuda`` launcher never falls back to the plain version: a CPU
    tensor raises. The entry points above ran on CPU tensors with no launch;
    an Engine asked for the card without one raises."""
    x = torch.zeros(4, 8)
    ctx = tea.AllToAllContext(capacity=8, hidden=8)
    _build.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        tar.oneshot_ar_loopback_cuda(x, world=2)
    with pytest.raises(ValueError, match="CUDA"):
        tea.a2a_loopback_cuda(torch.zeros(2, 8, 8), torch.zeros(2), ctx=ctx,
                              world=2)
    with pytest.raises(ValueError, match="CUDA"):
        tnw.producer_consumer_cuda(torch.zeros(2, 8, 8))
    assert _no_launches()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(ModelConfig.from_name("tiny"), mode="ar")
