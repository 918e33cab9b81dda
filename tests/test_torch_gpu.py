"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
when there is none (decided when the test runs, never at import). Run on a
machine with an H100 with ``python -m pytest tests/test_torch_gpu.py -m gpu``.
Tolerances: bf16 output ``atol=rtol=2e-2``; fp32 output ``atol=rtol=1e-4``
(the kernel sums in another order than the plain version)."""

import functools
import importlib
import importlib.util
import math
import time

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch import BatchEngine, Engine, ModelConfig
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
from triton_distributed_tpu_torch.kernels import allreduce as tar
from triton_distributed_tpu_torch.kernels import ep_all_to_all as tea
from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs
from triton_distributed_tpu_torch.kernels import moe_overlap as tmo
from triton_distributed_tpu_torch.kernels import moe_utils as tmu
from triton_distributed_tpu_torch.kernels import notify_wait as tnw
from triton_distributed_tpu_torch.kernels import paged_attention as tpa
from triton_distributed_tpu_torch.kernels import sp_attention as tsp
from triton_distributed_tpu_torch.layers.nn import quantize_kv_rows
from triton_distributed_tpu_torch.runtime.mesh import World

# The kernels package exports functions under some of its modules' names.
trsc = importlib.import_module(
    "triton_distributed_tpu_torch.kernels.reduce_scatter")

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [
    (64, 128, 256), (130, 33, 77), (1000, 512, 1032), (64, 2048, 2048),
    (130, 2048, 2048), (1000, 2048, 2048), (8192, 2048, 2048),
    (64, 2048, 12288), (130, 2048, 12288), (1000, 2048, 12288),
    (8192, 2048, 12288), (1000, 33, 2048), (130, 2048, 77)])
def test_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    """bf16 whose rows TMA can read on the warp-specialised wgmma GEMM (the
    128 x 256 tile where it gives every SM a tile, else 128 x 128: M 64,
    130, 1,000 and 8,192 at N 2,048 and 12,288), K = 33 or N = 77 on the
    mma.sync tile, f32 on the SIMT tile; one device operation a call, the
    kernel the dispatch names."""
    gen = torch.Generator(device=cuda).manual_seed(M)
    a = _randn(gen, M, K, dtype=dtype)
    b = _randn(gen, K, N, dtype=dtype) * K ** -0.5
    _build.reset_counts()
    got = tg.ag_gemm_single_chip(a, b)
    torch.cuda.synchronize()
    assert tg.MATMUL.launches == 1
    tol = TOL[dtype]
    torch.testing.assert_close(got, tg.matmul_ref(a, b), atol=tol, rtol=tol)
    ops = _captured_ops(lambda: tg.matmul_cuda(a, b))
    assert len(ops) == 1, ops
    if dtype == torch.float32:
        assert "matmul_f32_kernel" in ops[0], ops
    elif K % 8 or N % 8:
        assert "matmul_bf16_kernel" in ops[0], ops
    else:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        bn = tg.matmul_tile(M, N, sms)[1]
        assert f"matmul_ws_kernelILi{bn}E" in ops[0], ops


def test_matmul_misaligned_view_keeps_the_mma_tile(cuda):
    """A contiguous view of ``a`` whose base is 2 bytes past a 16-byte
    boundary: TMA cannot read it, so the call runs the mma.sync tile."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    buf = _randn(gen, 1000 * 512 + 1, dtype=torch.bfloat16)
    a = buf[1:].view(1000, 512)
    b = _randn(gen, 512, 1024, dtype=torch.bfloat16) * 512 ** -0.5
    assert a.data_ptr() % 16 and _build.tma_rows((512, 1024), a, b) == 0
    got = tg.matmul_cuda(a, b)
    torch.testing.assert_close(got, tg.matmul_ref(a, b), atol=2e-2,
                               rtol=2e-2)
    ops = _captured_ops(lambda: tg.matmul_cuda(a, b))
    assert len(ops) == 1 and "matmul_bf16_kernel" in ops[0], ops


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("dh,Hq,Hkv", [(128, 8, 4), (64, 16, 2), (32, 4, 4)])
def test_flash_prefill_kernel_matches_plain(cuda, dtype, varlen, dh, Hq,
                                            Hkv):
    """bf16 at head_dim 64/128 takes the tensor-core kernel, the rest the
    CUDA-core one; both against the plain version, NaN tail included."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, L, S, off = 3, 140, 300, 7
    q = _randn(gen, B, L, Hq, dh, dtype=dtype)
    k = _randn(gen, B, S, Hkv, dh, dtype=dtype)
    v = _randn(gen, B, S, Hkv, dh, dtype=dtype)
    k[:, off + L:] = float("nan")
    v[:, off + L:] = float("nan")
    kw = dict(offset=off)
    if varlen:
        kw["seq_lens"] = torch.tensor([140, 67, 1], dtype=torch.int32,
                                      device=cuda)
    got = tsp.flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = TOL[dtype]
    torch.testing.assert_close(got, tsp.flash_prefill_ref(q, k, v, **kw),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_decode_kernel_matches_plain(cuda, dtype, layout):
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, Hq, Hkv, dh, S = 3, 16, 8, 128, 300
    q = _randn(gen, B, Hq, dh, dtype=dtype)
    k = _randn(gen, B, S, Hkv, dh, dtype=dtype)
    v = _randn(gen, B, S, Hkv, dh, dtype=dtype)
    kv_len = torch.tensor([300, 129, 1], dtype=torch.int32, device=cuda)
    for b in range(B):
        k[b, int(kv_len[b]):] = float("nan")
        v[b, int(kv_len[b]):] = float("nan")
    if layout == "bhsd":
        k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    out, lse = tsp.flash_decode_local(q, k, v, kv_len=kv_len,
                                      kv_layout=layout)
    torch.cuda.synchronize()
    ref_out, ref_lse = tsp.flash_decode_ref(q, k, v, kv_len=kv_len,
                                            kv_layout=layout)
    tol = TOL[dtype]
    torch.testing.assert_close(out, ref_out, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)


def test_engine_dist_matches_xla_on_card(cuda):
    cfg = ModelConfig.from_name("tiny")
    ids = torch.arange(64, dtype=torch.int32, device=cuda).reshape(8, 8) % 128
    dist = Engine(cfg, mode="dist", device=cuda, seed=0)
    xla = Engine(cfg, mode="xla", device=cuda, params=dist.params)
    _build.reset_counts()
    got = dist.serve(ids, 6)
    # Engine.serve runs the slice-1 kernels; the paged kernel is the
    # serving path's (test_batch_engine_matches_engine_on_card).
    assert all(_build.KERNELS[name].launches > 0
               for name in ("matmul", "flash_prefill", "flash_decode"))
    assert _build.KERNELS["paged_attention"].launches == 0
    torch.testing.assert_close(got, xla.serve(ids, 6), atol=0, rtol=0)


def _paged_case(seed, *, B, L, Hq, Hkv, dh, bs, max_blocks, kv_lens, q_lens,
                dead=(), kv=None, dtype=torch.float32, device="cuda"):
    """A shuffled block pool with NaN in every block no live table
    reaches (NaN scales for int8/fp8 pools), stale entries in the dead
    slots' tables, and zero padding past each table's live blocks."""
    rng = np.random.default_rng(seed)
    n_blocks = B * max_blocks + 3
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, max_blocks), np.int32)
    reached = set()
    for b in range(B):
        n = math.ceil(kv_lens[b] / bs)
        tables[b, :n] = perm[b * max_blocks:b * max_blocks + n]
        if b in dead:
            tables[b, :n] = perm[:n]          # stale: another slot's blocks
        else:
            reached.update(tables[b, :n].tolist())
    dead_blocks = [i for i in range(n_blocks) if i not in reached]
    shape = (n_blocks, bs, Hkv, dh)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, L, Hq, dh)).astype(
        np.float32)).to(device=device, dtype=dtype)
    scales = {}
    if kv is None:
        k[dead_blocks] = float("nan")
        v[dead_blocks] = float("nan")
        k, v = k.to(dtype), v.to(dtype)
    else:
        wire = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv]
        k, ks = quantize_kv_rows(k, wire)
        v, vs = quantize_kv_rows(v, wire)
        ks[dead_blocks] = float("nan")
        vs[dead_blocks] = float("nan")
        scales = dict(k_scale=ks.to(device), v_scale=vs.to(device))
    mask = torch.tensor([b not in dead for b in range(B)], device=device)
    return dict(q=q, k_pool=k.to(device), v_pool=v.to(device),
                block_tables=torch.from_numpy(tables).to(device),
                kv_lens=torch.tensor(kv_lens, dtype=torch.int32,
                                     device=device),
                q_lens=torch.tensor(q_lens, dtype=torch.int32, device=device),
                slot_mask=mask, **scales)


# name -> geometry: decode; chunked prefill in one query tile and in
# several (64 / g positions per tile, causal straddles); ragged mixed rows
# with q_lens 0 and 1 and a dead slot.
PAGED_CASES = {
    "decode": dict(B=4, L=1, Hq=8, Hkv=2, dh=128, bs=16, max_blocks=8,
                   kv_lens=[1, 17, 128, 50], q_lens=[1, 1, 1, 1], dead=(3,)),
    "prefill_one_tile": dict(B=2, L=8, Hq=4, Hkv=4, dh=128, bs=4,
                             max_blocks=8, kv_lens=[8, 30], q_lens=[8, 8]),
    "prefill_tiles": dict(B=3, L=40, Hq=8, Hkv=2, dh=128, bs=16,
                          max_blocks=8, kv_lens=[40, 100, 77],
                          q_lens=[40, 37, 20]),
    "mixed_ragged": dict(B=4, L=24, Hq=8, Hkv=2, dh=64, bs=4, max_blocks=16,
                         kv_lens=[24, 61, 5, 33], q_lens=[24, 1, 0, 9],
                         dead=(2,)),
    "small_head_dim": dict(B=2, L=6, Hq=4, Hkv=1, dh=32, bs=4, max_blocks=8,
                           kv_lens=[6, 19], q_lens=[6, 3]),
}


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_attention_kernel_matches_plain(cuda, case, dtype, kv):
    """Every path of csrc/paged_attention.cu (decode; prefill on mma.sync
    for bf16 at head_dim 64/128, on the CUDA cores otherwise; int8/fp8
    dequantized after the load) against paged_attention_ref, live slots
    only; NaN in unreached blocks stays out and padding rows are zeros."""
    geo = PAGED_CASES[case]
    dead = geo.get("dead", ())
    c = _paged_case(1, dtype=dtype, kv=kv, **geo)
    _build.reset_counts()
    got = tpa.paged_attention(**c)
    torch.cuda.synchronize()
    assert tpa.PAGED_ATTENTION.launches == 1
    want = tpa.paged_attention_ref(
        **{k: (t.cpu() if isinstance(t, torch.Tensor) else t)
           for k, t in c.items()}).to(cuda)
    live = [b for b in range(geo["B"]) if b not in dead]
    assert torch.isfinite(got[live]).all()
    for b in live:
        assert (got[b, geo["q_lens"][b]:] == 0).all()
    tol = TOL[dtype]
    torch.testing.assert_close(got[live], want[live], atol=tol, rtol=tol)


# -- the split-KV decode (csrc/flash_decode.cuh), contiguous and paged -------

SPLIT = tsp.DECODE_SPLIT


def _cpu(c):
    return {k: (t.cpu() if isinstance(t, torch.Tensor) else t)
            for k, t in c.items()}


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_at_split_edges(cuda, dtype, kv):
    """kv_len 0, 1, split - 1, split, split + 1 and a full 4,096-key table
    (16 splits; the short slots' later splits hold nothing) against
    paged_attention_ref; kv_len 0 gives exact zeros."""
    lens = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 4096]
    geo = dict(B=6, L=1, Hq=16, Hkv=8, dh=128, bs=16, max_blocks=256,
               kv_lens=lens, q_lens=[1] * 6)
    c = _paged_case(3, dtype=dtype, kv=kv, **geo)
    _build.reset_counts()
    got = tpa.paged_attention(**c)
    torch.cuda.synchronize()
    assert tpa.PAGED_ATTENTION.launches == 1
    want = tpa.paged_attention_ref(**_cpu(c)).to(cuda)
    assert torch.isfinite(got).all()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    tol = TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_paged_decode_over_a_32768_position_table(cuda):
    """B = 2 over 2,048 blocks of 16 (128 splits), one slot full."""
    geo = dict(B=2, L=1, Hq=8, Hkv=2, dh=128, bs=16, max_blocks=2048,
               kv_lens=[32768, 20001], q_lens=[1, 1])
    c = _paged_case(4, dtype=torch.bfloat16, **geo)
    got = tpa.paged_attention(**c)
    torch.cuda.synchronize()
    want = tpa.paged_attention_ref(**_cpu(c)).to(cuda)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_contiguous_and_paged_decode_agree_bit_for_bit(cuda, g):
    """f32 q over the same keys, a paged pool and its gathered contiguous
    copy (NaN past every kv_len in both): one kernel, one split count, so
    the same bits; and a second call of each gives the same bits again."""
    geo = dict(B=4, L=1, Hq=2 * g, Hkv=2, dh=128, bs=16, max_blocks=64,
               kv_lens=[0, 1, 300, 1024], q_lens=[1] * 4)
    c = _paged_case(5, dtype=torch.float32, **geo)
    paged = tpa.paged_attention(**c)[:, 0]
    k = tsp.paged_gather_kv(c["k_pool"], c["block_tables"])
    v = tsp.paged_gather_kv(c["v_pool"], c["block_tables"])
    out, lse = tsp.flash_decode_cuda(c["q"][:, 0], k, v, kv_len=c["kv_lens"],
                                     kv_layout="bshd")
    paged2 = tpa.paged_attention(**c)[:, 0]
    out2, lse2 = tsp.flash_decode_cuda(c["q"][:, 0], k, v,
                                       kv_len=c["kv_lens"], kv_layout="bshd")
    torch.cuda.synchronize()
    assert tpa.paged_decode_splits(c["block_tables"], 16) == \
        tsp.flash_decode_splits(k, "bshd") == 4
    assert torch.equal(out, paged)
    assert torch.equal(paged2, paged)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isneginf(lse[0]).all()
    want, want_lse = tsp.flash_decode_ref(c["q"][:, 0], k, v,
                                          kv_len=c["kv_lens"],
                                          kv_layout="bshd")
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse[1:], want_lse[1:], atol=1e-5, rtol=1e-5)


def test_split_decode_leaves_its_arrival_counters_at_zero(cuda):
    """The last block of each (row, kv head) resets its counter: after
    calls of both instantiations every arrival counter reads 0 again, so
    the host never resets them (_signal.arrivals)."""
    from triton_distributed_tpu_torch.kernels import _signal

    geo = dict(B=3, L=1, Hq=8, Hkv=2, dh=128, bs=16, max_blocks=64,
               kv_lens=[0, 700, 1024], q_lens=[1] * 3)
    c = _paged_case(6, dtype=torch.bfloat16, **geo)
    k = tsp.paged_gather_kv(c["k_pool"], c["block_tables"])
    v = tsp.paged_gather_kv(c["v_pool"], c["block_tables"])
    for _ in range(2):
        tpa.paged_attention(**c)
        tsp.flash_decode_cuda(c["q"][:, 0], k, v, kv_len=c["kv_lens"],
                              kv_layout="bshd")
    torch.cuda.synchronize()
    dev = c["q"].device
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    for name in ("paged_attention_arrivals", "flash_decode_arrivals"):
        assert (*key, name) in _signal._ARRIVALS, name  # the launches' own
        cells = _signal.arrivals(dev, name, 3 * 2)
        assert int(cells.abs().sum()) == 0, name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [8, 72, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_split_decode_every_group_and_head_dim(cuda, g, dh, dtype):
    """Every GQA group the kernel is built for, head dims that fill a
    16-byte vector, need a narrower one (int8 at dh 72) or a single lane,
    over three splits: the paged kernel for each pool type and the
    contiguous one against their plain versions."""
    lens = [0, 5, 300, 640]
    for kv in (None, "int8", "fp8"):
        geo = dict(B=4, L=1, Hq=2 * g, Hkv=2, dh=dh, bs=16, max_blocks=40,
                   kv_lens=lens, q_lens=[1] * 4)
        c = _paged_case(6, dtype=dtype, kv=kv, **geo)
        got = tpa.paged_attention(**c)
        torch.cuda.synchronize()
        want = tpa.paged_attention_ref(**_cpu(c)).to(cuda)
        tol = TOL[dtype]
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    gen = torch.Generator(device=cuda).manual_seed(dh * g)
    q = _randn(gen, 4, 2 * g, dh, dtype=dtype)
    k = _randn(gen, 4, 2, 640, dh, dtype=dtype)
    v = _randn(gen, 4, 2, 640, dh, dtype=dtype)
    kvl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out, lse = tsp.flash_decode_cuda(q, k, v, kv_len=kvl)
    want, want_lse = tsp.flash_decode_ref(q, k, v, kv_len=kvl)
    torch.testing.assert_close(out, want, atol=tol, rtol=tol)
    torch.testing.assert_close(lse[1:], want_lse[1:], atol=tol, rtol=tol)


def test_paged_attention_cuda_rejects_mismatched_pools(cuda):
    c = _paged_case(2, **PAGED_CASES["decode"])
    with pytest.raises(TypeError, match="scales"):
        tpa.paged_attention_cuda(c["q"], c["k_pool"].to(torch.int8),
                                 c["v_pool"].to(torch.int8),
                                 c["block_tables"], c["kv_lens"])
    with pytest.raises(TypeError, match="dtype"):
        tpa.paged_attention_cuda(c["q"].bfloat16(), c["k_pool"],
                                 c["v_pool"], c["block_tables"],
                                 c["kv_lens"])


@pytest.mark.parametrize("kv", [None, "int8"])
def test_batch_engine_matches_engine_on_card(cuda, kv):
    """fp32 tiny: the paged serving path through the kernels emits the
    per-request Engine's greedy tokens, with chunked prefill and a
    forced preemption."""
    cfg = ModelConfig.from_name("tiny")
    eng = Engine(cfg, mode="dist", device=cuda, seed=0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (7, 9, 5, 6)]
    be = BatchEngine(eng, n_slots=3, n_blocks=8, block_size=4,
                     prefill_chunk=4, kv_dtype=kv)
    rids = [be.submit(p, 6) for p in prompts]
    _build.reset_counts()
    out = be.run(max_steps=500)
    assert tpa.PAGED_ATTENTION.launches > 0
    assert be.metrics["preemptions"] > 0
    if kv is None:
        for rid, p in zip(rids, prompts):
            want = eng.serve(torch.tensor([p], device=cuda), 6)[0].tolist()
            assert out[rid] == want
    else:
        assert sorted(len(t) for t in out.values()) == [6] * 4


@pytest.mark.parametrize("kv", [None, "int8"])
def test_serving_steps_never_read_back_to_the_host(cuda, kv):
    """Both serving steps run under ``set_sync_debug_mode("error")``:
    no value inside a step is read back to the host, which is what a
    CUDA-graph capture of the steps needs."""
    cfg = ModelConfig.from_name("tiny")
    eng = Engine(cfg, mode="dist", device=cuda, seed=0)
    be = BatchEngine(eng, n_slots=3, block_size=4, prefill_chunk=4,
                     kv_dtype=kv)
    for n in (7, 9, 5):
        be.submit(list(range(1, n + 1)), 4)
    be.step()
    ids, *ops = be.mixed_operands()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for paged, first in (("prefill", ids), ("decode", ids[:, :1])):
            step = eng.make_paged_step(paged, kv_quant=kv is not None)
            rest = ops if paged == "prefill" else ops[:-1]
            torch.argmax(step(first, be.pool.state, *rest), dim=-1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("cap,d,f", [(16, 64, 256), (40, 72, 136),
                                     (200, 128, 96)])
def test_grouped_gemm_kernel_matches_plain(cuda, dtype, stacked, cap, d, f):
    """Leading, trailing and consecutive empty experts, a full one, ragged
    shapes; NaN in every row past a count and in every weight of an empty
    expert, which the kernel must never read."""
    gen = torch.Generator(device=cuda).manual_seed(cap)
    counts = torch.tensor([0, 0, 3, 0, cap, 1, cap // 2 + 1, 0],
                          dtype=torch.int32, device=cuda)
    E = counts.shape[0]
    past = (torch.arange(cap, device=cuda)[None, :] >= counts[:, None])
    x_clean = _randn(gen, E, cap, d, dtype=dtype).masked_fill(
        past[..., None], 0.0)
    x = x_clean.masked_fill(past[..., None], float("nan"))
    w = _randn(gen, *((3,) if stacked else ()), E, d, f, dtype=dtype)
    w = w * d ** -0.5
    w[..., counts == 0, :, :] = float("nan")
    layer_idx = 1 if stacked else None
    _build.reset_counts()
    got = tmu.grouped_gemm_skip(x, w, counts, layer_idx=layer_idx)
    torch.cuda.synchronize()
    assert tmu.GROUPED_GEMM.launches == 1
    assert torch.isfinite(got).all()
    assert (got[counts == 0] == 0).all() and (got[past] == 0).all()
    tol = TOL[dtype]
    torch.testing.assert_close(
        got, tmu.grouped_gemm_skip_ref(x_clean, w, counts,
                                       layer_idx=layer_idx),
        atol=tol, rtol=tol)


def test_grouped_gemm_cuda_rejects_bad_operands(cuda):
    g = torch.zeros(2, 16, 8, device=cuda)
    w = torch.zeros(2, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="counts"):
        tmu.grouped_gemm_skip(g, w, torch.ones(2, device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        tmu.grouped_gemm_skip(g, w.bfloat16(),
                              torch.ones(2, dtype=torch.int32, device=cuda))


def test_moe_engine_dist_matches_xla_on_card(cuda):
    cfg = ModelConfig.from_name("tiny-moe", moe_capacity_factor=64.0)
    ids = torch.arange(64, dtype=torch.int32, device=cuda).reshape(8, 8) % 128
    dist = Engine(cfg, mode="dist", device=cuda, seed=0)
    xla = Engine(cfg, mode="xla", device=cuda, params=dist.params)
    _build.reset_counts()
    got = dist.serve(ids, 6)
    assert tmu.GROUPED_GEMM.launches == 2 * cfg.n_layers * 6
    torch.testing.assert_close(got, xla.serve(ids, 6), atol=0, rtol=0)
    assert dist.moe_drop_stats(ids) == {"n_dropped_dispatch": 0,
                                        "n_dropped_expert": 0}


def test_moe_serving_steps_never_read_back_to_the_host(cuda):
    """The MoE routing inside both serving steps reads nothing back to the
    host either."""
    cfg = ModelConfig.from_name("tiny-moe", moe_capacity_factor=64.0)
    eng = Engine(cfg, mode="dist", device=cuda, seed=0)
    be = BatchEngine(eng, n_slots=3, block_size=4, prefill_chunk=4)
    for n in (7, 9, 5):
        be.submit(list(range(1, n + 1)), 4)
    be.step()
    ids, *ops = be.mixed_operands()
    torch.cuda.synchronize()
    _build.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for paged, first in (("prefill", ids), ("decode", ids[:, :1])):
            step = eng.make_paged_step(paged)
            rest = ops if paged == "prefill" else ops[:-1]
            torch.argmax(step(first, be.pool.state, *rest), dim=-1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tmu.GROUPED_GEMM.launches == 2 * 2 * cfg.n_layers


# -- the one-chip overlap kernels (bf16) ---------------------------------------

def _overlap_ab(cuda, seed, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (_randn(gen, M, K, dtype=torch.bfloat16),
            _randn(gen, K, N, dtype=torch.bfloat16) * K ** -0.5)


@pytest.mark.parametrize("M,K,N,segments,cols", [
    (1024, 256, 384, 8, 384), (1024, 256, 384, 8, 128),
    (192, 72, 200, 3, 200), (96, 64, 128, 12, 128)])
def test_ag_gemm_loopback_kernel_matches_plain(cuda, M, K, N, segments,
                                               cols):
    """Staged and bare consumers against their plain versions, with and
    without the tail; ragged shapes (segments of 64 and 8 rows, N and K not
    multiples of the tile) included."""
    a, b = _overlap_ab(cuda, M, M, K, N)
    cfg = tg.AGGEMMConfig(block_n=cols if N % 128 else 128,
                          overlap_cols=cols)
    want = tg.matmul_ref(a, b)
    _build.reset_counts()
    for fn in (tg.ag_gemm_loopback, tg.ag_gemm_segmented_bare):
        torch.testing.assert_close(fn(a, b, segments=segments, config=cfg),
                                   want, atol=2e-2, rtol=2e-2)
    out1, staged = tg.ag_gemm_loopback_cuda(a, b, segments=segments,
                                            cols=cols)
    torch.cuda.synchronize()
    assert torch.equal(staged, a)
    torch.testing.assert_close(out1, tg.ag_gemm_loopback_ref(
        a, b, cols=cols)[0], atol=2e-2, rtol=2e-2)
    assert tg.AG_LOOPBACK.launches == 3
    assert tg.TAIL_INTO.launches == 2 * (cols < N)


@pytest.mark.parametrize("M,K,N,segments", [(1024, 256, 384, 8),
                                            (4096, 5120, 3200, 8),
                                            (3000, 200, 640, 3)])
def test_ag_gemm_loopback_waits_for_delayed_producers(cuda, M, K, N,
                                                      segments):
    """Every producer item held back 1 ms behind a NaN-poisoned staging
    buffer: the consumer tiles must wait on the flags, so the result is
    bit-identical to the undelayed one, and the staging holds A after
    (bench.py's shape and a ragged 3-segment M among them)."""
    a, b = _overlap_ab(cuda, 7, M, K, N)
    want, _ = tg.ag_gemm_loopback_cuda(a, b, segments=segments, cols=N)
    poison = torch.full_like(a, float("nan"))
    torch.cuda.synchronize()
    got, st = tg.ag_gemm_loopback_cuda(a, b, segments=segments, cols=N,
                                       staging=poison,
                                       producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert st is poison and torch.equal(poison, a)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N,col_start", [(256, 128, 384, 128),
                                             (130, 40, 300, 100),
                                             (64, 64, 256, 0),
                                             (64, 64, 256, 256)])
def test_matmul_tail_into_kernel_matches_plain(cuda, M, K, N, col_start):
    a, b = _overlap_ab(cuda, N, M, K, N)
    c = torch.randn(M, col_start, device=cuda).bfloat16()
    got = tg.matmul_tail_into(c, a, b, col_start)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :col_start], c)
    torch.testing.assert_close(got, tg.matmul_tail_into_ref(c, a, b,
                                                            col_start),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("M,K,N,segments", [(1024, 256, 512, 8),
                                            (256, 64, 128, 2),
                                            (200, 40, 136, 4),
                                            (128, 64, 128, 1)])
def test_gemm_rs_loopback_kernel_matches_plain(cuda, M, K, N, segments):
    a, b = _overlap_ab(cuda, M + segments, M, K, N)
    _build.reset_counts()
    got = trs.gemm_rs_loopback(a, b, segments=segments)
    torch.cuda.synchronize()
    assert trs.GEMM_RS_LOOPBACK.launches == 1
    torch.testing.assert_close(got, trs.gemm_rs_loopback_ref(
        a, b, segments=segments), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("M,K,N", [(256, 128, 384), (130, 40, 200)])
def test_fused_step_kernel_updates_c_in_place(cuda, M, K, N):
    a, b = _overlap_ab(cuda, K, M, K, N)
    c = torch.randn(M, N, device=cuda)
    want = tg.fused_matmul_step_ref(c, a, b, 0.75)
    s = torch.tensor([0.75], device=cuda)  # read on the card
    for scalar in (0.75, s):
        cc = c.clone()
        got = tg.fused_matmul_step(cc, a, b, scalar)
        torch.cuda.synchronize()
        assert got.data_ptr() == cc.data_ptr()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    got = tg.fused_matmul_step(c.bfloat16(), a, b, 0.75)
    assert got.dtype == torch.float32


def test_consumer_whose_flag_does_not_arrive_raises(cuda):
    """Producers held back 5 s, past the waits' bound: a consumer tile
    traps after its bounded spin (~1 s) and the call raises instead of
    hanging; in a subprocess, so the sticky CUDA error stays out of this
    process."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from triton_distributed_tpu_torch.kernels import allgather_gemm "
        "as tg\n"
        "a = torch.zeros(256, 64, dtype=torch.bfloat16, device='cuda')\n"
        "b = torch.zeros(64, 128, dtype=torch.bfloat16, device='cuda')\n"
        "tg.ag_gemm_loopback_cuda(a, b, segments=8, cols=128, "
        "producer_delay_ns=5_000_000_000)\n"
        "torch.cuda.synchronize()\n")
    repo = Path(__file__).resolve().parent.parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode != 0, out
    # The trap surfaces as a launch failure at the synchronisation; the
    # kernel's own line names the flag when the printf buffer is flushed.
    assert "timed out" in out or "launch failure" in out, out
    assert time.perf_counter() - t0 < 60


# -- the collectives on one card ------------------------------------------


@pytest.mark.parametrize("shape,dtype,world", [
    ((128, 5120), torch.bfloat16, 8), ((1000, 384), torch.float32, 3),
    ((7, 3, 5), torch.float32, 2), ((9,), torch.bfloat16, 1)])
def test_oneshot_ar_loopback_kernel_is_bit_identical(cuda, shape, dtype,
                                                     world):
    """Vector and scalar paths, ragged chunks, world 1: bit for bit the
    plain version's fold; bf16 at world 8 is exactly 8 x."""
    gen = torch.Generator(device=cuda).manual_seed(world)
    x = _randn(gen, *shape, dtype=dtype)
    _build.reset_counts()
    got = tar.oneshot_ar_loopback(x, world=world)
    torch.cuda.synchronize()
    assert tar.ONESHOT_AR_LOOPBACK.launches == 1
    assert torch.equal(got, tar.oneshot_ar_loopback_ref(x, world=world))
    if dtype == torch.bfloat16 and world == 8:
        assert torch.equal(got, 8 * x)


def test_oneshot_ar_loopback_waits_for_delayed_producers(cuda):
    """Every producer item held back 1 ms behind NaN-poisoned staging: the
    folds must wait on the flags, so the result does not change, and every
    slot then holds x (the pushes landed)."""
    x = _randn(torch.Generator(device=cuda).manual_seed(2), 256, 384,
               dtype=torch.bfloat16)
    want = tar.oneshot_ar_loopback_cuda(x, world=8)
    staging = torch.full((7, 256, 384), float("nan"), dtype=x.dtype,
                         device=cuda)
    got = tar.oneshot_ar_loopback_cuda(x, world=8, staging=staging,
                                       producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, 8 * x)
    assert torch.equal(staging, x.expand_as(staging))


@pytest.mark.parametrize("chunk_rows", [8, 128])
def test_a2a_loopback_kernel_matches_plain_without_host_reads(cuda,
                                                               chunk_rows):
    """fp8 tokens (NaN past each count) and f32 scales over counts that
    include 0, 1, chunk edges, capacity, past capacity and below zero, under
    set_sync_debug_mode("error"): rows below each count byte-identical, the
    received counts unchanged."""
    world, cap, hidden = 8, 128, 7168
    gen = torch.Generator(device=cuda).manual_seed(chunk_rows)
    toks = _randn(gen, world, cap, hidden, dtype=torch.float32).to(
        torch.float8_e4m3fn)
    scales = _randn(gen, world, cap, 128, dtype=torch.float32)
    counts = torch.tensor([0, 1, 7, 8, 9, 128, 200, -3], dtype=torch.int32,
                          device=cuda)
    live = (torch.arange(cap, device=cuda)[None]
            < counts.clamp(0, cap)[:, None])
    toks.view(torch.uint8)[~live] = 0x7F
    scales[~live] = float("nan")
    ctx = tea.AllToAllContext(capacity=cap, hidden=hidden,
                              chunk_rows=chunk_rows)
    _build.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (gt, gs), rc = tea.a2a_loopback((toks, scales), counts, ctx=ctx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tea.A2A_LOOPBACK.launches == 1
    assert torch.equal(rc, counts)
    (wt, ws), _ = tea.a2a_loopback_ref((toks, scales), counts, ctx=ctx)
    m = live[..., None]
    assert torch.equal(gt.view(torch.uint8) * m, wt.view(torch.uint8) * m)
    assert torch.equal(gs.view(torch.int32) * m, ws.view(torch.int32) * m)


@pytest.mark.parametrize("shape,chunk_rows,delay_ns", [
    ((8, 16, 128), 4, 0), ((8, 256 * 64, 128), 64, 0),
    ((8, 256 * 64, 128), 64, 50_000), ((3, 10, 5), 1, 0), ((1, 8, 4), 4, 0)])
def test_notify_wait_kernel_is_the_ring_shift(cuda, shape, chunk_rows,
                                              delay_ns):
    """The tutorial's shape, the long run (each slot reused 128 times), the
    long run with every odd rank's producer held back, a byte-wise chunk
    and a single rank that feeds itself: out == roll(x, 1, 0) exactly, and
    each NaN-poisoned queue slot holds the last chunk pushed into it."""
    x = _randn(torch.Generator(device=cuda).manual_seed(shape[1]), *shape,
               dtype=torch.float32)
    queue = torch.full((shape[0], 2, chunk_rows, *shape[2:]), float("nan"),
                       device=cuda)
    _build.reset_counts()
    got = tnw.producer_consumer_cuda(x, chunk_rows=chunk_rows, queue=queue,
                                     producer_delay_ns=delay_ns)
    torch.cuda.synchronize()
    assert tnw.NOTIFY_WAIT.launches == 1
    assert torch.equal(got, torch.roll(x, 1, 0))
    n = shape[1] // chunk_rows
    chunks = torch.roll(x, 1, 0).view(shape[0], n, chunk_rows, *shape[2:])
    assert torch.equal(queue, chunks[:, [n - 1 - (n - 1 - s) % 2
                                         for s in range(2)]])


def test_notify_wait_refuses_ranks_the_card_cannot_hold(cuda):
    x = torch.zeros(1 << 20, 1, 4, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        tnw.producer_consumer_cuda(x, chunk_rows=1)


def _a2a_case(gen, cap, hidden, counts, cuda):
    """fp8 tokens and f32 scales (NaN past each count) and the counts."""
    toks = _randn(gen, 8, cap, hidden, dtype=torch.float32).to(
        torch.float8_e4m3fn)
    scales = _randn(gen, 8, cap, 128, dtype=torch.float32)
    counts = torch.tensor(counts, dtype=torch.int32, device=cuda)
    live = (torch.arange(cap, device=cuda)[None]
            < counts.clamp(0, cap)[:, None])[..., None]
    toks.view(torch.uint8)[~live[..., 0]] = 0x7F
    scales[~live[..., 0]] = float("nan")
    return toks, scales, counts, live


def _signals_at_zero(dev, stream) -> bool:
    """The dispatch loopback's persistent ticket and the ring's signals on
    the stream whose handle is given are back at 0."""
    from triton_distributed_tpu_torch.kernels import _signal
    ticket = _signal._ARRIVALS[(dev, stream, "a2a_loopback")][0]
    ring = _signal._ARRIVALS[(dev, stream, "notify_wait")]
    return int(ticket) == 0 and not bool(ring.any())


@pytest.mark.parametrize("two_streams", [False, True])
def test_collectives_back_to_back_without_host_resets(cuda, two_streams):
    """The dispatch loopback and the ring 40 times each, back to back with
    no host reset and no synchronize, alternating shapes and counts (full,
    13 rows a slot, zero and negative; the tutorial and a 32-chunk run),
    on one stream or two: every result matches its plain version, rows
    past a count stay untouched in NaN-poisoned receive buffers, and every
    self-reset ticket, counter and flag is back at 0 at the end."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    cap, hidden = 128, 7168
    a2a = [_a2a_case(gen, cap, hidden, c, cuda) for c in (
        [cap] * 8, [13] * 8, [0, -4, 128, 1, 0, 200, 64, -1])]
    rings = [(_randn(gen, 8, 16, 128, dtype=torch.float32), 4),
             (_randn(gen, 8, 32 * 64, 128, dtype=torch.float32), 64)]
    streams = [torch.cuda.Stream(cuda) for _ in range(1 + two_streams)]
    torch.cuda.synchronize()
    runs = []
    _build.reset_counts()
    for i in range(40):
        with torch.cuda.stream(streams[i % len(streams)]):
            toks, scales, counts, live = a2a[i % 3]
            ctx = tea.AllToAllContext(capacity=cap, hidden=hidden,
                                      chunk_rows=cap if i % 2 else 8)
            recv = (torch.full_like(toks.view(torch.uint8), 0x7F).view(
                toks.dtype), torch.full_like(scales, float("nan")))
            runs.append(("a2a", i % 3, tea.a2a_loopback_cuda(
                (toks, scales), counts, ctx=ctx, recv=recv)))
            x, ch = rings[i % 2]
            runs.append(("ring", i % 2, tnw.producer_consumer_cuda(
                x, chunk_rows=ch)))
    torch.cuda.synchronize()
    assert tea.A2A_LOOPBACK.launches == 40 and tnw.NOTIFY_WAIT.launches == 40
    for kind, j, got in runs:
        if kind == "ring":
            x, _ = rings[j]
            assert torch.equal(got, torch.roll(x, 1, 0))
            continue
        toks, scales, counts, live = a2a[j]
        (gt, gs), rc = got
        assert torch.equal(rc, counts)
        # Below each count the sent bytes; past it the poison, untouched.
        assert torch.equal(gt.view(torch.uint8), toks.view(torch.uint8))
        assert torch.equal(gs.view(torch.int32), scales.view(torch.int32))
    for s in streams:
        assert _signals_at_zero(rings[0][0].device, s.cuda_stream)


def test_notify_wait_default_queue_persists_per_stream(cuda):
    """The default queue is one buffer per (device, stream, shape): two
    calls on one stream share it, another stream gets its own, and a NaN
    left in it by an earlier call does not reach the result."""
    x = _randn(torch.Generator(device=cuda).manual_seed(5), 8, 64 * 8, 128,
               dtype=torch.float32)
    key = (x.device, torch.cuda.current_stream(cuda).cuda_stream,
           (8, 2, 64, 128), x.dtype)
    a = tnw.producer_consumer_cuda(x, chunk_rows=64)
    queue = tnw._QUEUES[key]
    queue.fill_(float("nan"))
    b = tnw.producer_consumer_cuda(x, chunk_rows=64)
    assert tnw._QUEUES[key] is queue
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        c = tnw.producer_consumer_cuda(x, chunk_rows=64)
    torch.cuda.synchronize()
    other = tnw._QUEUES[(x.device, side.cuda_stream, *key[2:])]
    assert other.data_ptr() != queue.data_ptr()
    want = torch.roll(x, 1, 0)
    assert torch.equal(a, want) and torch.equal(b, want) and \
        torch.equal(c, want)


# -- the multi-rank kernels (world simulated ranks on one card) -----------

def _exact_operands(gen, world, M, k, N, dtype, cuda):
    """a with one nonzero per row (a small integer) and b bf16-valued: every
    product is exact in f32, so every partial sum is the same bits in any
    order and the kernels' folds can be held bit for bit."""
    a = torch.zeros(world, M, k, device=cuda)
    cols = torch.randint(0, k, (world, M), generator=gen, device=cuda)
    vals = torch.randint(1, 4, (world, M), generator=gen, device=cuda)
    a.scatter_(2, cols[..., None], vals[..., None].float())
    b = _randn(gen, world, k, N, dtype=torch.bfloat16).float()
    return a.to(dtype), b.to(dtype)


@pytest.mark.parametrize("world,m,K,n,dtype", [
    (8, 1, 512, 384, torch.bfloat16),      # dist-mode decode: m = 1
    (8, 64, 256, 320, torch.bfloat16),
    (8, 16, 128, 200, torch.float32),
    (8, 1, 96, 72, torch.float32),
    (3, 40, 72, 136, torch.bfloat16),      # a world that is not 2^k
    (3, 21, 33, 77, torch.float32)])       # ragged, unvectorised
def test_ag_gemm_kernel_matches_plain(cuda, world, m, K, n, dtype):
    """Every rank's product against the plain version (tolerance of the
    dtype), and every rank's staging equal to the gathered A exactly."""
    gen = torch.Generator(device=cuda).manual_seed(m * K)
    a = _randn(gen, world, m, K, dtype=dtype)
    b = _randn(gen, world, K, n, dtype=dtype) * K ** -0.5
    _build.reset_counts()
    got = tg.ag_gemm_device(a, b, world=world)
    out1, staged = tg.ag_gemm_cuda(a, b, cols=n)
    torch.cuda.synchronize()
    assert tg.AG_GEMM.launches == 2 and tg.MATMUL.launches == 0
    want, want_staged = tg.ag_gemm_ref(a, b, cols=n)
    tol = TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.equal(out1, got)
    assert torch.equal(staged, want_staged)


def test_wgmma_tiles_refuse_rows_tma_cannot_read(cuda):
    """Rows that TMA cannot read (n 130, d 33: no whole number of 16-byte
    units) no longer raise: the bf16 AG-GEMM and AG-GroupGEMM run the same
    items on the mma.sync tile, one launch each, within bf16 tolerance of
    their plain versions, every staging slot the gathered rows, also with 1
    ms-delayed producers behind NaN staging (bit-identical); f32 takes them
    too."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    bf16 = torch.bfloat16
    a = _randn(gen, 3, 40, 72, dtype=bf16)
    b = _randn(gen, 3, 72, 130, dtype=bf16) * 72 ** -0.5
    grids = _randn(gen, 4, 2, 8, 33, dtype=bf16)
    w = _randn(gen, 4, 2, 33, 96, dtype=bf16) * 33 ** -0.5
    _build.reset_counts()
    out, staged = tg.ag_gemm_cuda(a, b, cols=130)
    up, st = tmo.ag_group_gemm_cuda(grids, w)
    torch.cuda.synchronize()
    assert tg.AG_GEMM.launches == 1 and tmo.AG_GROUP_GEMM.launches == 1
    want, want_staged = tg.ag_gemm_ref(a, b, cols=130)
    torch.testing.assert_close(out, want, atol=2e-2, rtol=2e-2)
    assert torch.equal(staged, want_staged)
    want, want_st = tmo.ag_group_gemm_ref(grids, w, return_staging=True)
    torch.testing.assert_close(up, want, atol=2e-2, rtol=2e-2)
    assert torch.equal(st, want_st)
    poison = torch.full_like(staged, float("nan"))
    slow, _ = tg.ag_gemm_cuda(a, b, cols=130, staging=poison,
                              producer_delay_ns=1_000_000)
    poison_g = torch.full_like(st, float("nan"))
    slow_g, _ = tmo.ag_group_gemm_cuda(grids, w, staging=poison_g,
                                       producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert torch.equal(slow, out) and torch.equal(poison, staged)
    assert torch.equal(slow_g, up) and torch.equal(poison_g, st)
    out, _ = tg.ag_gemm_cuda(a.float(), b.float(), cols=130)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tg.ag_gemm_ref(a.float(), b.float(),
                                                   cols=130)[0],
                               atol=1e-4, rtol=1e-4)


def test_ag_gemm_column_split_runs_the_tail_per_rank(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    world, m, K, n = 4, 32, 256, 384
    a = _randn(gen, world, m, K, dtype=torch.bfloat16)
    b = _randn(gen, world, K, n, dtype=torch.bfloat16) * K ** -0.5
    _build.reset_counts()
    got = tg.ag_gemm_device(a, b, world=world, config=tg.AGGEMMConfig(
        block_n=128, overlap_cols=128))
    torch.cuda.synchronize()
    assert tg.AG_GEMM.launches == 1 and tg.TAIL_INTO.launches == world
    want = tg.matmul_ref(a.reshape(1, world * m, K).expand(world, -1, -1), b)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ag_gemm_waits_for_delayed_producers(cuda, dtype):
    """Every producer held back 1 ms behind NaN staging: the tiles wait on
    the flags of the rows they read, so the result is the undelayed one bit
    for bit, and every staging slot then holds the pushed shard."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    world, m, K, n = 8, 48, 128, 256
    a = _randn(gen, world, m, K, dtype=dtype)
    b = _randn(gen, world, K, n, dtype=dtype)
    want, _ = tg.ag_gemm_cuda(a, b, cols=n)
    staging = torch.full((world, world, m, K), float("nan"), dtype=dtype,
                         device=cuda)
    got, _ = tg.ag_gemm_cuda(a, b, cols=n, staging=staging,
                             producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(staging, a.expand(world, -1, -1, -1))


@pytest.mark.parametrize("world,M,k,N,dtype", [
    (8, 8, 512, 384, torch.bfloat16),      # dist-mode decode: m = 1
    (8, 256, 128, 320, torch.bfloat16),
    (8, 64, 96, 200, torch.float32),
    (3, 60, 72, 130, torch.bfloat16),      # a world that is not 2^k
    (3, 21, 33, 77, torch.float32),        # ragged, unvectorised
    (8, 1024, 64, 256, torch.bfloat16),    # own product folded, grouped
    (2, 512, 128, 256, torch.bfloat16),    # world 2, grouped
    (2, 256, 2048, 2048, torch.bfloat16),  # world 2, rank by rank
    (3, 600, 64, 256, torch.bfloat16),     # fold tiles straddle segments
    (2, 256, 33, 130, torch.bfloat16)])    # rows TMA cannot read: mma.sync
def test_gemm_rs_kernel_matches_plain(cuda, world, M, k, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(M * k)
    a = _randn(gen, world, M, k, dtype=dtype)
    b = _randn(gen, world, k, N, dtype=dtype) * k ** -0.5
    _build.reset_counts()
    got = trs.gemm_rs_device(a, b, world=world)
    torch.cuda.synchronize()
    assert trs.GEMM_RS.launches == 1 and tg.MATMUL.launches == 0
    tol = TOL[dtype]
    torch.testing.assert_close(got, trs.gemm_rs_ref(a, b), atol=tol, rtol=tol)


@pytest.mark.parametrize("world,M,k,N", [
    (8, 16 * 8, 64, 192),       # bf16: own rows through f32 scratch
    (8, 1024, 64, 192),         # bf16: own product folded, grouped
    (2, 256, 2048, 2048),       # bf16: own product folded, rank by rank
    (3, 600, 33, 130)])         # bf16: mma.sync, tiles straddle segments
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("delay_ns", [0, 1_000_000])
def test_gemm_rs_fold_is_bit_identical(cuda, dtype, delay_ns, world, M, k,
                                       N):
    """Exact partials: the fold (remote partials rounded to the output
    dtype, own f32, src = 0 .. world - 1) is the plain fold's bits, with the
    product tiles held back 1 ms behind NaN staging or not, and every slot
    holds the pushed partial; for each item set of the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    a, b = _exact_operands(gen, world, M, k, N, dtype, cuda)
    staging = torch.full((world, world - 1, M // world, N), float("nan"),
                         dtype=dtype, device=cuda)
    got, _ = trs.gemm_rs_cuda(a, b, staging=staging,
                              producer_delay_ns=delay_ns)
    torch.cuda.synchronize()
    want, want_staging = trs.gemm_rs_fold(
        trs.gemm_rs_partials(a, b).cpu(), dtype, return_staging=True)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(staging.cpu(), want_staging)


@pytest.mark.parametrize("shape,dtype", [
    ((8, 128, 5120), torch.bfloat16), ((8, 1, 5120), torch.bfloat16),
    ((3, 1000, 384), torch.float32), ((8, 7, 33), torch.float32),
    ((2, 5, 3), torch.bfloat16)])
@pytest.mark.parametrize("method", ["one_shot", "two_shot"])
def test_all_reduce_kernels_are_bit_identical(cuda, shape, dtype, method):
    """Both all-reduces bit for bit their plain versions (pure adds in
    JAX's fixed orders), every rank's copy equal, every staging slot what
    was pushed; two-shot only where m splits into world chunks."""
    world = shape[0]
    if method == "two_shot" and shape[1] % world:
        with pytest.raises(ValueError, match="divisible by world"):
            tar.twoshot_all_reduce(torch.zeros(shape, device=cuda),
                                   world=world)
        return
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    x = _randn(gen, *shape, dtype=dtype)
    _build.reset_counts()
    if method == "one_shot":
        got, staging = tar.oneshot_all_reduce_cuda(x)
        want = tar.oneshot_all_reduce_ref(x)
        want_staging = torch.stack([torch.stack(
            [x[s] for s in range(world) if s != d]) for d in range(world)])
        assert tar.ONESHOT_AR.launches == 1
    else:
        got, staging = tar.twoshot_all_reduce_cuda(x)
        want, want_staging = tar.twoshot_all_reduce_ref(
            x.cpu(), return_staging=True)
        assert tar.TWOSHOT_AR.launches == 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert all(torch.equal(got[r], got[0]) for r in range(world))
    assert torch.equal(staging.cpu(), want_staging.cpu())


@pytest.mark.parametrize("method", ["one_shot", "two_shot"])
def test_all_reduce_kernels_wait_for_delayed_producers(cuda, method):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _randn(gen, 8, 64, 384, dtype=torch.bfloat16)
    run = (tar.oneshot_all_reduce_cuda if method == "one_shot"
           else tar.twoshot_all_reduce_cuda)
    want, want_staging = run(x)
    staging = torch.full_like(want_staging, float("nan"))
    got, _ = run(x, staging=staging, producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(staging, want_staging)


def test_epoch_wrap_leaves_no_stale_flag(cuda):
    """With the epoch counter at its wrap, calls whose producers are held
    back 1 ms behind NaN staging: the loopback's flags are arrival cells
    that every call raises to 1 and lowers again, so it takes no epoch and
    no fold reads a flag of an earlier call as raised: every result is 8 x,
    every slot holds x, and the cells are 0 after."""
    from triton_distributed_tpu_torch.kernels import _signal

    x = _randn(torch.Generator(device=cuda).manual_seed(4), 64, 384,
               dtype=torch.bfloat16)
    _signal._EPOCH[x.device] = 2 ** 31 - 2
    for _ in range(4):
        staging = torch.full((7, 64, 384), float("nan"), dtype=x.dtype,
                             device=cuda)
        got = tar.oneshot_ar_loopback_cuda(x, world=8, staging=staging,
                                           producer_delay_ns=1_000_000)
        torch.cuda.synchronize()
        assert torch.equal(got, 8 * x)
        assert torch.equal(staging, x.expand_as(staging))
    assert _signal._EPOCH[x.device] == 2 ** 31 - 2   # no epoch taken
    stream = torch.cuda.current_stream().cuda_stream
    assert _cells_zero(cuda, "oneshot_ar_loopback", (stream,))


# -- the multi-rank EP all-to-all (world simulated ranks on one card) -------

def _ep_payloads(gen, world, cap, kind, cuda):
    """Stacked (world, world, cap, ...) payloads of a dispatch: bf16 tokens
    of 2,048 (one 4 KB row a piece row: pieces of one chunk) with int32
    expert ids; fp8 tokens of 7,168 (pieces cut a chunk) with f32 scales of
    128 (pieces of whole chunks); f32 rows of 12 B (byte copies) with ids."""
    shape = (world, world, cap)
    ids = torch.randint(-1, 128, (*shape, 1), generator=gen, device=cuda,
                        dtype=torch.int32)
    if kind == "bf16":
        return (_randn(gen, *shape, 2048, dtype=torch.bfloat16), ids)
    if kind == "fp8":
        return (_randn(gen, *shape, 7168, dtype=torch.float32).to(
            torch.float8_e4m3fn), _randn(gen, *shape, 128,
                                         dtype=torch.float32))
    return (_randn(gen, *shape, 3, dtype=torch.float32), ids)


def _ep_counts(gen, world, cap, cuda):
    """Per (src, dst): zero, one, a chunk edge, full, past capacity, below
    zero, and random ones."""
    c = torch.randint(0, cap + 1, (world, world), generator=gen, device=cuda,
                      dtype=torch.int32)
    edge = torch.tensor([0, 1, 8, cap, cap + 9, -3], dtype=torch.int32,
                        device=cuda)[:world * world]
    c.view(-1)[:edge.numel()] = edge
    return c


def _ep_same_below_counts(got, want, rcounts, cap):
    live = (torch.arange(cap, device=rcounts.device)[None, None]
            < rcounts.clamp(0, cap)[..., None])
    for g, w in zip(got, want):
        gb = g.contiguous().view(torch.uint8).reshape(*g.shape[:3], -1)
        wb = w.contiguous().view(torch.uint8).reshape(*w.shape[:3], -1)
        if not torch.equal(gb * live[..., None], wb * live[..., None]):
            return False
    return True


@pytest.mark.parametrize("world,cap,kind", [
    (4, 64, "bf16"), (8, 32, "fp8"), (4, 40, "bytes"), (2, 8, "bf16")])
def test_ep_a2a_kernel_matches_plain(cuda, world, cap, kind):
    """Every rank's exchange in one launch, under set_sync_debug_mode
    ("error") (no host read of the counts): rows below each count
    byte-identical to the plain version's, the counts transposed."""
    gen = torch.Generator(device=cuda).manual_seed(world * cap)
    pays = _ep_payloads(gen, world, cap, kind, cuda)
    counts = _ep_counts(gen, world, cap, cuda)
    ctx = tea.AllToAllContext(capacity=cap, hidden=pays[0].shape[-1])
    _build.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, rc = tea.fast_all_to_all(pays, counts, ctx=ctx, world=world)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tea.EP_A2A.launches == 1
    want, wrc = tea.fast_all_to_all_ref(pays, counts, ctx=ctx, world=world)
    assert torch.equal(rc, wrc) and torch.equal(rc, counts.T)
    assert _ep_same_below_counts(got, want, rc, cap)


@pytest.mark.parametrize("world", [4, 8])
def test_ep_a2a_waits_for_delayed_producers(cuda, world):
    """Every producer item held back 1 ms behind NaN-poisoned receive
    buffers: the result below the counts is bit-identical to the undelayed
    one, and the rows past each count are never written (still NaN)."""
    cap = 32
    gen = torch.Generator(device=cuda).manual_seed(world)
    pays = _ep_payloads(gen, world, cap, "fp8", cuda)
    counts = _ep_counts(gen, world, cap, cuda)
    ctx = tea.AllToAllContext(capacity=cap, hidden=7168)
    want, wrc = tea.fast_all_to_all_cuda(pays, counts, ctx=ctx, world=world)
    recv = tuple(torch.full_like(p.view(torch.uint8), 0xFF).view(p.dtype)
                 for p in pays)
    got, rc = tea.fast_all_to_all_cuda(pays, counts, ctx=ctx, world=world,
                                       direction="combine", recv=recv,
                                       producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert got[0] is recv[0] and torch.equal(rc, wrc)
    assert _ep_same_below_counts(got, want, rc, cap)
    past = (torch.arange(cap, device=cuda)[None, None]
            >= rc.clamp(0, cap)[..., None])
    assert (got[0].view(torch.uint8)[past] == 0xFF).all()
    assert torch.isnan(got[1][past]).all()


# -- the reduce-scatters and the MoE-TP kernels (simulated ranks) ------------

@pytest.mark.parametrize("shape,dtype", [
    ((8, 1024, 5120), torch.bfloat16), ((8, 16, 5120), torch.bfloat16),
    ((3, 999, 384), torch.float32), ((8, 56, 33), torch.float32),
    ((2, 10, 3), torch.bfloat16)])
@pytest.mark.parametrize("method", ["oneshot", "ring"])
def test_reduce_scatter_kernels_are_bit_identical(cuda, shape, dtype,
                                                  method):
    """Both reduce-scatters bit for bit their plain versions (pure adds in
    JAX's fixed orders: the ring rounds at every hop), every staging slot
    what was pushed, one launch each."""
    world = shape[0]
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    x = _randn(gen, *shape, dtype=dtype)
    _build.reset_counts()
    if method == "oneshot":
        got, staging = trsc.oneshot_reduce_scatter_cuda(x)
        want, want_staging = trsc.oneshot_reduce_scatter_ref(
            x, return_staging=True)
        assert trsc.ONESHOT_RS.launches == 1
    else:
        got, staging = trsc.ring_reduce_scatter_cuda(x)
        want, want_staging = trsc.ring_reduce_scatter_ref(
            x, return_staging=True)
        assert trsc.RING_RS.launches == 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(staging, want_staging)
    assert torch.equal(trsc.reduce_scatter(x, world=world, method=method),
                       got.reshape(-1, *shape[2:]))


@pytest.mark.parametrize("method", ["oneshot", "ring"])
def test_reduce_scatter_kernels_wait_for_delayed_producers(cuda, method):
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = _randn(gen, 8, 64, 384, dtype=torch.bfloat16)
    run = (trsc.oneshot_reduce_scatter_cuda if method == "oneshot"
           else trsc.ring_reduce_scatter_cuda)
    want, want_staging = run(x)
    staging = torch.full_like(want_staging, float("nan"))
    got, _ = run(x, staging=staging, producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(staging, want_staging)


def _grids(gen, world, E, cap, d, dtype, cuda, exact=False):
    """Capacity grids with ragged counts (empty slots zero, some experts
    empty); ``exact``: one small integer per live row."""
    counts = torch.randint(0, cap + 1, (world, E), generator=gen,
                           device=cuda)
    counts[:, ::3] = 0
    live = torch.arange(cap, device=cuda) < counts[..., None]
    if exact:
        g = _exact_operands(gen, world, E * cap, d, 1, torch.float32,
                            cuda)[0].reshape(world, E, cap, d)
    else:
        g = _randn(gen, world, E, cap, d, dtype=torch.float32)
    return (g * live[..., None]).to(dtype)


@pytest.mark.parametrize("world,E,cap,d,f,dtype", [
    (8, 16, 8, 256, 96, torch.bfloat16),      # decode-like, f 96 < tile
    (8, 4, 128, 128, 96, torch.bfloat16),     # one source a row tile
    (4, 6, 40, 72, 136, torch.bfloat16),      # rows span sources
    (8, 5, 128, 72, 136, torch.bfloat16),     # K tail, two column tiles
    (3, 5, 21, 33, 77, torch.float32)])       # ragged, unvectorised
def test_ag_group_gemm_kernel_matches_plain(cuda, world, E, cap, d, f,
                                            dtype):
    gen = torch.Generator(device=cuda).manual_seed(cap * d)
    grids = _grids(gen, world, E, cap, d, dtype, cuda)
    w = _randn(gen, world, E, d, f, dtype=dtype) * d ** -0.5
    _build.reset_counts()
    got, staging = tmo.ag_group_gemm_cuda(grids, w)
    torch.cuda.synchronize()
    assert tmo.AG_GROUP_GEMM.launches == 1
    want, want_staging = tmo.ag_group_gemm_ref(grids, w, return_staging=True)
    tol = TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.equal(staging, want_staging)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("delay_ns", [0, 1_000_000])
def test_ag_group_gemm_is_bit_identical_on_exact_products(cuda, dtype,
                                                          delay_ns):
    """Exact products: bit for bit the plain version, with every producer
    held back 1 ms behind NaN staging or not."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    world, E, cap, d, f = 8, 12, 24, 128, 96
    grids = _grids(gen, world, E, cap, d, dtype, cuda, exact=True)
    w = _randn(gen, world, E, d, f, dtype=torch.bfloat16).to(dtype)
    staging = torch.full((world, E, world, cap, d), float("nan"),
                         dtype=dtype, device=cuda)
    got, _ = tmo.ag_group_gemm_cuda(grids, w, staging=staging,
                                    producer_delay_ns=delay_ns)
    torch.cuda.synchronize()
    want, want_staging = tmo.ag_group_gemm_ref(grids, w, return_staging=True)
    assert torch.equal(got, want)
    assert torch.equal(staging, want_staging)


@pytest.mark.parametrize("world,E,cap,f,d,dtype", [
    (8, 16, 8, 96, 512, torch.bfloat16),
    (8, 3, 128, 96, 768, torch.bfloat16),
    (4, 5, 40, 72, 136, torch.bfloat16),
    (3, 4, 21, 33, 77, torch.float32),
    (2, 4, 128, 96, 256, torch.bfloat16),   # world 2, own product folded
    (3, 2, 200, 64, 256, torch.bfloat16),   # fold tiles straddle segments
    (2, 3, 40, 33, 130, torch.bfloat16)])   # rows TMA cannot read
def test_group_gemm_rs_kernel_matches_plain(cuda, world, E, cap, f, d,
                                            dtype):
    gen = torch.Generator(device=cuda).manual_seed(cap * f)
    act = _randn(gen, world, E, world * cap, f, dtype=dtype)
    w = _randn(gen, world, E, f, d, dtype=dtype) * f ** -0.5
    _build.reset_counts()
    got = tmo.group_gemm_rs_device(act, w, world=world, capacity=cap)
    torch.cuda.synchronize()
    assert tmo.GROUP_GEMM_RS.launches == 1
    tol = TOL[dtype]
    torch.testing.assert_close(got, tmo.group_gemm_rs_ref(act, w), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("world,E,cap,f,d", [
    (8, 6, 16, 96, 320),        # bf16: own rows through f32 scratch
    (8, 2, 128, 96, 256),       # bf16: own product folded, grouped
    (3, 2, 200, 64, 256),       # bf16: fold tiles straddle segments
    (2, 3, 40, 33, 130)])       # bf16: rows TMA cannot read (mma.sync)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("delay_ns", [0, 1_000_000])
def test_group_gemm_rs_fold_is_bit_identical(cuda, dtype, delay_ns, world,
                                             E, cap, f, d):
    """Exact partials: the fold (remote partials rounded to the output
    dtype, own f32, src = 0 .. world - 1) is the plain fold's bits, with the
    product tiles held back 1 ms behind NaN staging or not, and every slot
    holds the pushed partial; for each item set of the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    act = _exact_operands(gen, world, E * world * cap, f, d, dtype,
                          cuda)[0].reshape(world, E, world * cap, f)
    w = _randn(gen, world, E, f, d, dtype=torch.bfloat16).to(dtype)
    staging = torch.full((world, world - 1, E, cap, d), float("nan"),
                         dtype=dtype, device=cuda)
    got, _ = tmo.group_gemm_rs_cuda(act, w, staging=staging,
                                    producer_delay_ns=delay_ns)
    torch.cuda.synchronize()
    want, want_staging = tmo.group_gemm_rs_ref(act, w, return_staging=True)
    assert torch.equal(got, want)
    assert torch.equal(staging, want_staging)


def test_ag_moe_mlp_device_matches_plain_on_card(cuda):
    """The pipeline at world 8 through both kernels (one launch each, the
    routing in one call) against the plain pipeline on the card: bf16
    tolerance, drop counts equal, at a capacity that drops."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    world, m, k, d, f, E = 8, 24, 4, 256, 768, 16
    x = _randn(gen, world, m, d, dtype=torch.bfloat16)
    ids = torch.stack([torch.randperm(E, generator=gen, device=cuda)[:k]
                       for _ in range(world * m)]).reshape(world, m, k)
    wts = torch.rand(world, m, k, generator=gen, device=cuda)
    wu = World(world).split(_randn(gen, E, d, f, dtype=torch.bfloat16)
                            * d ** -0.5, 2)
    wd = World(world).split(_randn(gen, E, f, d, dtype=torch.bfloat16)
                            * f ** -0.5, 1)
    for cap in (m, 4):
        _build.reset_counts()
        out, n_dropped = tmo.ag_moe_mlp_device(x, ids, wts, wu, wd,
                                               world=world, n_experts=E,
                                               capacity=cap)
        torch.cuda.synchronize()
        assert (tmo.AG_GROUP_GEMM.launches, tmo.GROUP_GEMM_RS.launches) == \
            (1, 1)
        want, want_dropped = tmo.ag_moe_mlp_ref(x, ids, wts, wu, wd,
                                                world=world, n_experts=E,
                                                capacity=cap)
        assert torch.equal(n_dropped, want_dropped)
        assert bool((n_dropped > 0).any()) == (cap < m)
        torch.testing.assert_close(out, want, atol=2e-2, rtol=2e-2)


def test_epoch_wrap_across_the_new_kernels(cuda):
    """The epoch counter crosses its wrap between calls of the four new
    kernels, each with its producers held back 1 ms behind NaN staging: no
    flag an earlier call raised near 2**31 reads as raised to a later one,
    so every result is its plain version's bits."""
    from triton_distributed_tpu_torch.kernels import _signal

    gen = torch.Generator(device=cuda).manual_seed(29)
    x = _randn(gen, 8, 64, 256, dtype=torch.bfloat16)
    grids = _grids(gen, 8, 4, 16, 128, torch.bfloat16, cuda, exact=True)
    w_up = _randn(gen, 8, 4, 128, 96, dtype=torch.bfloat16)
    act = _exact_operands(gen, 8, 4 * 8 * 16, 96, 1, torch.bfloat16,
                          cuda)[0].reshape(8, 4, 8 * 16, 96)
    w_dn = _randn(gen, 8, 4, 96, 256, dtype=torch.bfloat16)
    runs = [
        (trsc.oneshot_reduce_scatter_cuda, (x,),
         trsc.oneshot_reduce_scatter_ref(x, return_staging=True)),
        (trsc.ring_reduce_scatter_cuda, (x,),
         trsc.ring_reduce_scatter_ref(x, return_staging=True)),
        (tmo.ag_group_gemm_cuda, (grids, w_up),
         tmo.ag_group_gemm_ref(grids, w_up, return_staging=True)),
        (tmo.group_gemm_rs_cuda, (act, w_dn),
         tmo.group_gemm_rs_ref(act, w_dn, return_staging=True))]
    _signal._EPOCH[x.device] = 2 ** 31 - 3
    for _ in range(2):
        for run, args, (want, want_staging) in runs:
            staging = torch.full_like(want_staging, float("nan"))
            got, _ = run(*args, staging=staging, producer_delay_ns=1_000_000)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(staging,
                                                          want_staging)
    assert _signal._EPOCH[x.device] == 6   # 2**31 - 2, 2**31 - 1, 1 .. 6


# -- sequence parallelism: the allgathers and the SP attention ---------------

tag = importlib.import_module("triton_distributed_tpu_torch.kernels.allgather")
tll = importlib.import_module(
    "triton_distributed_tpu_torch.kernels.ll_allgather")


@pytest.mark.parametrize("shape,dtype", [
    ((8, 1024, 5120), torch.bfloat16), ((8, 16, 5120), torch.bfloat16),
    ((3, 999, 384), torch.float32), ((8, 5, 33), torch.float32),
    ((2, 10, 3), torch.bfloat16)])
@pytest.mark.parametrize("method", ["ring", "a2a"])
def test_all_gather_kernels_are_bit_identical(cuda, shape, dtype, method):
    """Both allgathers give every rank the shards in rank order, bit for
    bit, one launch each (ragged byte counts too: (8, 5, 33) f32 is 660
    bytes a shard, (2, 10, 3) bf16 60)."""
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    x = _randn(gen, *shape, dtype=dtype)
    run = (tag.ring_all_gather_cuda if method == "ring"
           else tag.a2a_all_gather_cuda)
    _build.reset_counts()
    got = run(x)
    torch.cuda.synchronize()
    assert torch.equal(got, tag.all_gather_ref(x))
    kern = tag.RING_AG if method == "ring" else tag.A2A_AG
    assert kern.launches == 1
    host = tag.all_gather(x, world=shape[0],
                          method="ring_1d" if method == "ring" else "all2all")
    assert torch.equal(host, got[0])


@pytest.mark.parametrize("method", ["ring", "a2a"])
def test_all_gather_kernels_wait_for_delayed_producers(cuda, method):
    gen = torch.Generator(device=cuda).manual_seed(17)
    x = _randn(gen, 8, 64, 384, dtype=torch.bfloat16)
    run = (tag.ring_all_gather_cuda if method == "ring"
           else tag.a2a_all_gather_cuda)
    out = torch.full((8, 8 * 64, 384), float("nan"), dtype=x.dtype,
                     device=cuda)
    got = run(x, out=out, producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert got is out and torch.equal(got, tag.all_gather_ref(x))


def test_ll_allgather_parity_epochs_and_restart(cuda):
    """Five epochs on one staging, each bit-identical to the plain version;
    a call writes only its parity's half (the other keeps what the call
    before left there, NaN at first); a restart at epoch 0 after 4 and a
    device-held epoch are still right; delayed pushes behind a NaN output
    give the same bits; every call leaves the flags at 0."""
    from triton_distributed_tpu_torch.kernels import _signal

    gen = torch.Generator(device=cuda).manual_seed(23)
    staging = torch.full((8, 2, 7, 256, 256), float("nan"), device=cuda)
    mirror = staging.clone()
    _build.reset_counts()
    epochs = [0, 1, 2, 3, 4, 0, torch.tensor(1, dtype=torch.int32,
                                              device=cuda)]
    for i, epoch in enumerate(epochs):
        x = _randn(gen, 8, 256, 256, dtype=torch.float32)
        before = staging.clone()
        delayed = i == 3
        out = (torch.full((8, 8 * 256, 256), float("nan"), device=cuda)
               if delayed else None)
        got, st = tll.ll_all_gather_cuda(
            x, staging, epoch, out=out,
            producer_delay_ns=1_000_000 if delayed else 0)
        want, mirror = tll.ll_all_gather_ref(x, mirror, epoch)
        torch.cuda.synchronize()
        p = int(epoch) % 2
        assert st is staging and torch.equal(got, want)
        assert torch.equal(staging[:, p], mirror[:, p])
        assert torch.equal(staging[:, 1 - p].isnan(),
                           before[:, 1 - p].isnan())
        assert torch.equal(staging[:, 1 - p].nan_to_num(),
                           before[:, 1 - p].nan_to_num())
        flags = _signal.flags(x.device, tll.LL_AG.name, 1)
        assert int(flags.abs().sum()) == 0
    assert tll.LL_AG.launches == len(epochs)


def test_flash_decode_kernel_at_local_length_zero(cuda):
    """A rank whose shard holds no valid position: the kernel gives out 0
    and lse -inf (no NaN), so its partial's merge weight is 0, and the SP
    decode over ranks that own nothing matches the plain pipeline."""
    from triton_distributed_tpu_torch.layers import SpGQAFlashDecodeAttention

    gen = torch.Generator(device=cuda).manual_seed(31)
    q = _randn(gen, 4, 8, 128, dtype=torch.bfloat16)
    k = _randn(gen, 4, 2, 64, 128, dtype=torch.bfloat16)
    v = _randn(gen, 4, 2, 64, 128, dtype=torch.bfloat16)
    lens = torch.tensor([0, 5, 0, 64], dtype=torch.int32, device=cuda)
    out, lse = tsp.flash_decode_cuda(q, k, v, kv_len=lens)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isneginf(lse[0]).all() and torch.isneginf(lse[2]).all()
    assert torch.isfinite(lse[1]).all() and torch.isfinite(lse[3]).all()
    layer = SpGQAFlashDecodeAttention(8, 2, 128, world=8)
    kc = _randn(gen, 8, 4, 2, 256, 128, dtype=torch.bfloat16)
    vc = _randn(gen, 8, 4, 2, 256, 128, dtype=torch.bfloat16)
    got = layer(q, kc, vc, kv_len=3 * 256 + 17)     # ranks 4-7 own nothing
    want = layer(q.cpu(), kc.cpu(), vc.cpu(), kv_len=3 * 256 + 17)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.float32, 32),
                                      (torch.bfloat16, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_sp_ag_attention_kernel_matches_plain(cuda, dtype, dh, causal):
    """The SP prefill kernel against its plain version at world 4 with
    ragged tiles (m 200, m_kv 136), the lse too; and with unaligned row and
    column offsets, where some rows see no key at all (lse -1e30)."""
    gen = torch.Generator(device=cuda).manual_seed(dh)
    q = _randn(gen, 4, 3, 200, dh, dtype=dtype)
    k = _randn(gen, 4, 3, 136, dh, dtype=dtype)
    v = _randn(gen, 4, 3, 136, dh, dtype=dtype)
    for kw in ({}, dict(row_offset=[-50, 150, 371, 600], col_offset=3)):
        _build.reset_counts()
        out, lse, _, _ = tsp.sp_ag_attention_cuda(
            q, k, v, causal=causal, return_partials=True, **kw)
        want, want_lse = tsp.sp_ag_attention_ref(
            q, k, v, causal=causal, return_partials=True, **kw)
        torch.cuda.synchronize()
        assert tsp.SP_AG_ATTN.launches == 1
        tol = TOL[dtype]
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)


def test_sp_ag_attention_waits_for_delayed_producers(cuda):
    gen = torch.Generator(device=cuda).manual_seed(37)
    q, k, v = (_randn(gen, 8, 4, 256, 128, dtype=torch.bfloat16)
               for _ in range(3))
    want, _, kf, vf = tsp.sp_ag_attention_cuda(q, k, v)
    k_full = torch.full_like(kf, float("nan"))
    v_full = torch.full_like(vf, float("nan"))
    got, _, _, _ = tsp.sp_ag_attention_cuda(q, k, v, k_full=k_full,
                                            v_full=v_full,
                                            producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(k_full, k[None].expand(8, *k.shape))
    assert torch.equal(v_full, v[None].expand(8, *v.shape))


def test_epoch_wrap_across_the_sp_kernels(cuda):
    """The epoch counter crosses its wrap between calls of the ring
    allgather and the SP prefill, producers held back behind NaN: no flag
    an earlier call raised near 2**31 reads as raised to a later one. The
    ring takes no epoch (its flags are arrival cells, 0 after a call)."""
    from triton_distributed_tpu_torch.kernels import _signal

    gen = torch.Generator(device=cuda).manual_seed(41)
    x = _randn(gen, 8, 64, 256, dtype=torch.bfloat16)
    q, k, v = (_randn(gen, 4, 2, 128, 64, dtype=torch.bfloat16)
               for _ in range(3))
    want_sp = tsp.sp_ag_attention_cuda(q, k, v)[0]
    _signal._EPOCH[x.device] = 2 ** 31 - 2
    for _ in range(2):
        out = torch.full((8, 8 * 64, 256), float("nan"), dtype=x.dtype,
                         device=cuda)
        got = tag.ring_all_gather_cuda(x, out=out,
                                       producer_delay_ns=1_000_000)
        sp, _, kf, _ = tsp.sp_ag_attention_cuda(
            q, k, v, k_full=torch.full((4, 4, 2, 128, 64), float("nan"),
                                       dtype=q.dtype, device=cuda),
            producer_delay_ns=1_000_000)
        torch.cuda.synchronize()
        assert torch.equal(got, tag.all_gather_ref(x))
        assert torch.equal(sp, want_sp)
    assert _signal._EPOCH[x.device] == 1   # the prefill's 2**31 - 1, 1
    stream = torch.cuda.current_stream().cuda_stream
    assert _cells_zero(cuda, "ring_ag", (stream,))


# --- the one-shot all-reduce (one push a source) and the SP wgmma tile ----


def _cuda_ops(fn) -> list[str]:
    """The device operations (kernels, memsets, copies) one call of fn
    makes, by torch.profiler, after a warm-up call. A session that
    recorded no device operation at all (seen late in a long run of
    sessions) is run again, at most three times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return ops


@pytest.mark.parametrize("shape,dtype", [
    ((2, 3, 1001), torch.float32), ((3, 7, 2051), torch.bfloat16),
    ((8, 5, 3277), torch.bfloat16), ((8, 128, 5120), torch.bfloat16),
    ((3, 2, 4099), torch.float32), ((8, 8, 5120), torch.float32)])
@pytest.mark.parametrize("delayed", [False, True])
def test_oneshot_ar_bit_identical_at_ragged_sizes(cuda, shape, dtype,
                                                 delayed):
    """Worlds 2, 3 and 8, n neither a whole number of vectors nor of
    chunks (and more than one chunk): out bit for bit the plain version's,
    every staging slot what was pushed; with 1 ms-delayed pushes behind NaN
    staging the same."""
    world = shape[0]
    x = _randn(torch.Generator(device=cuda).manual_seed(shape[2]), *shape,
               dtype=dtype)
    pushed = torch.stack([torch.stack([x[s] for s in range(world) if s != d])
                          for d in range(world)])
    staging = (torch.full_like(pushed, float("nan")) if delayed else None)
    got, staging = tar.oneshot_all_reduce_cuda(
        x, staging=staging, producer_delay_ns=1_000_000 if delayed else 0)
    torch.cuda.synchronize()
    assert torch.equal(got, tar.oneshot_all_reduce_ref(x))
    assert torch.equal(staging, pushed)


def test_oneshot_ar_back_to_back_leaves_its_ticket_at_zero(cuda):
    """100 calls back to back, no host reset and no synchronize between
    them, alternating shapes, dtypes and the two entry points: every result
    is the plain version's bits, and the persistent ticket is 0 after."""
    from triton_distributed_tpu_torch.kernels import _signal

    gen = torch.Generator(device=cuda).manual_seed(13)
    xs = [_randn(gen, 8, 128, 5120, dtype=torch.bfloat16),
          _randn(gen, 8, 8, 5120, dtype=torch.bfloat16),
          _randn(gen, 3, 7, 2051, dtype=torch.float32)]
    torch.cuda.synchronize()
    _build.reset_counts()
    outs = []
    for i in range(100):
        x = xs[i % 3]
        outs.append(tar.oneshot_all_reduce(x, world=x.shape[0]) if i % 2
                    else tar.oneshot_all_reduce_cuda(x)[0])
    torch.cuda.synchronize()
    assert tar.ONESHOT_AR.launches == 100
    for i, got in enumerate(outs):
        assert torch.equal(got, tar.oneshot_all_reduce_ref(xs[i % 3]))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert int(_signal._ARRIVALS[(xs[0].device, stream, "oneshot_ar")][0]) \
        == 0


def test_oneshot_ar_serving_path_stages_into_persistent_scratch(cuda):
    """The serving entry point gives the same bits as the kernel on a new
    staging, its pushes land in the stream's persistent scratch (the same
    storage call after call, grown for a larger call), and the call makes
    one device operation: the kernel, no memset, no copy."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = _randn(gen, 8, 128, 5120, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    got = tar.oneshot_all_reduce(x, world=8)
    want, staged = tar.oneshot_all_reduce_cuda(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    st = tar.serving_staging(x, stream)
    assert torch.equal(st, staged)
    tar.oneshot_all_reduce(x, world=8)
    assert tar.serving_staging(x, stream).data_ptr() == st.data_ptr()
    ops = _cuda_ops(lambda: tar.oneshot_all_reduce(x, world=8))
    assert len(ops) == 1 and "oneshot_ar_kernel" in ops[0], ops
    big = _randn(gen, 8, 256, 5120, dtype=torch.bfloat16)
    assert torch.equal(tar.oneshot_all_reduce(big, world=8),
                       tar.oneshot_all_reduce_ref(big))
    assert torch.equal(tar.oneshot_all_reduce(x, world=8), want)


def _sp_kernel_names(run) -> str:
    return " ".join(n for n in _cuda_ops(run) if "sp_ag_attn" in n)


@pytest.mark.parametrize("world,m,m_kv", [(3, 200, 77), (8, 200, 77),
                                          (2, 128, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offsets", [False, True])
def test_sp_wgmma_tile_matches_plain(cuda, world, m, m_kv, causal, offsets):
    """bf16 at head_dim 128 on the wgmma tile against the plain version
    at 2e-2, the lse at 1e-3: tiles and chunks ragged (m 200, m_kv 77),
    uneven row and column offsets (rows that see no key: lse -1e30)."""
    gen = torch.Generator(device=cuda).manual_seed(world * m + m_kv)
    q = _randn(gen, world, 3, m, 128, dtype=torch.bfloat16)
    k = _randn(gen, world, 3, m_kv, 128, dtype=torch.bfloat16)
    v = _randn(gen, world, 3, m_kv, 128, dtype=torch.bfloat16)
    kw = {}
    if offsets:
        kw = dict(row_offset=[-31 + 97 * r for r in range(world)],
                  col_offset=[5 + 3 * r for r in range(world)])
    run = lambda: tsp.sp_ag_attention_cuda(q, k, v, causal=causal,
                                           return_partials=True, **kw)
    out, lse, _, _ = run()
    want, want_lse = tsp.sp_ag_attention_ref(q, k, v, causal=causal,
                                             return_partials=True, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
    assert "sp_ag_attn_wgmma_kernel" in _sp_kernel_names(run)


def test_sp_wgmma_tile_waits_for_delayed_producers(cuda):
    """Ragged world-3 tiles with 1 ms-delayed pushes behind NaN staging:
    the same bits, and every staged K and V is what was pushed."""
    gen = torch.Generator(device=cuda).manual_seed(43)
    q = _randn(gen, 3, 2, 200, 128, dtype=torch.bfloat16)
    k = _randn(gen, 3, 2, 77, 128, dtype=torch.bfloat16)
    v = _randn(gen, 3, 2, 77, 128, dtype=torch.bfloat16)
    want, _, _, _ = tsp.sp_ag_attention_cuda(q, k, v)
    k_full = torch.full((3, 3, 2, 77, 128), float("nan"), dtype=q.dtype,
                        device=cuda)
    v_full = torch.full_like(k_full, float("nan"))
    got, _, _, _ = tsp.sp_ag_attention_cuda(
        q, k, v, k_full=k_full, v_full=v_full, producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(k_full, k[None].expand(3, *k.shape))
    assert torch.equal(v_full, v[None].expand(3, *v.shape))


@pytest.mark.parametrize("dtype,dh,scale,tile", [
    (torch.bfloat16, 128, None, "sp_ag_attn_wgmma_kernel"),
    (torch.bfloat16, 64, None, "sp_ag_attn_kernel"),
    (torch.float32, 128, None, "sp_ag_attn_kernel"),
    (torch.bfloat16, 128, -0.05, "sp_ag_attn_kernel")])
def test_sp_prefill_paths_and_persistent_ticket(cuda, dtype, dh, scale,
                                                tile):
    """bf16 at head_dim 128 runs the wgmma kernel; head_dim 64, f32 and a
    scale that is not positive keep the earlier tiles (all in one launch
    path, each against the plain version); every call leaves the stream's
    ticket at 0."""
    from triton_distributed_tpu_torch.kernels import _signal

    gen = torch.Generator(device=cuda).manual_seed(dh)
    q, k, v = (_randn(gen, 4, 2, 150, dh, dtype=dtype) for _ in range(3))
    run = lambda: tsp.sp_ag_attention_cuda(q, k, v, scale=scale)[0]
    names = _sp_kernel_names(run)
    assert tile in names and (tile.endswith("wgmma_kernel")
                              or "wgmma" not in names), names
    got = run()
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(
        got.float(), tsp.sp_ag_attention_ref(q, k, v, scale=scale).float(),
        atol=tol, rtol=tol)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert int(_signal._ARRIVALS[(q.device, stream, "sp_ag_attn")][0]) == 0


# --- the int8/fp8 mixed step on the tensor cores, the LL allgather's host
# path ------------------------------------------------------------------------


def _q8_geo(g: int, dh: int) -> dict:
    """A mixed step over a quantized pool: rows straddling 16-row pages, a
    1-row and a 0-row slot, a slot of two query tiles at g 1, a dead slot
    (its stale table names live blocks), keys over several 64-key chunks."""
    Hkv = 1 if g == 8 else 2
    return dict(B=6, L=70, Hq=Hkv * g, Hkv=Hkv, dh=dh, bs=16, max_blocks=24,
                kv_lens=[70, 201, 37, 50, 333, 90],
                q_lens=[70, 45, 1, 0, 3, 17], dead=(5,))


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_quantized_mixed_step_on_the_tensor_cores(cuda, kv, dh, g):
    """bf16 q over an int8 / fp8 pool at head_dim 64 and 128 runs one
    launch of the tensor-core kernel (its name by torch.profiler, the only
    device operation of the call) and matches paged_attention_ref on the
    live slots; NaN scales of unreached blocks stay out, padding rows are
    zeros."""
    geo = _q8_geo(g, dh)
    dead = geo["dead"]
    c = _paged_case(11 + g + dh, dtype=torch.bfloat16, kv=kv, **geo)
    run = lambda: tpa.paged_attention_slots(
        c["q"], c["k_pool"], c["v_pool"], slots, k_scale=c["k_scale"],
        v_scale=c["v_scale"])
    slots = tpa.paged_slots(c["block_tables"], c["kv_lens"], geo["L"],
                            q_lens=c["q_lens"], slot_mask=c["slot_mask"])
    _build.reset_counts()
    got = tpa.paged_attention(**c)
    torch.cuda.synchronize()
    assert tpa.PAGED_ATTENTION.launches == 1
    want = tpa.paged_attention_ref(**_cpu(c)).to(cuda)
    live = [b for b in range(geo["B"]) if b not in dead]
    assert torch.isfinite(got[live]).all()
    for b in live:
        assert (got[b, geo["q_lens"][b]:] == 0).all()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got[live], want[live], atol=tol, rtol=tol)
    assert torch.equal(run()[live], got[live])   # dead slots: garbage
    ops = _cuda_ops(run)
    assert len(ops) == 1 and "flash_prefill_mma_q8_kernel" in ops[0], ops


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_mixed_step_converts_every_wire_value_exactly(cuda, kv):
    """Query row 0 of a slot attends its key 0 alone, so its output is V's
    row 0 dequantized and rounded to bf16 once. With scales of 1 and every
    wire value in those rows (all 256 int8 values; every finite e4m3 byte,
    subnormals included), the output equals float(wire) bit for bit."""
    if kv == "int8":
        wire = torch.arange(-128, 128, dtype=torch.int8)
    else:
        raw = torch.arange(256, dtype=torch.int32)
        raw = torch.where((raw & 0x7F) == 0x7F, 0, raw)   # the two NaNs
        wire = raw.to(torch.uint8).view(torch.float8_e4m3fn)
    B, dh, bs = 4, 64, 16
    gen = torch.Generator().manual_seed(5)
    k = torch.randint(-100, 100, (B + 1, bs, 1, dh), generator=gen)
    v = torch.randint(-100, 100, (B + 1, bs, 1, dh), generator=gen)
    if kv == "int8":
        k, v = k.to(torch.int8), v.to(torch.int8)
    else:
        k = (k.float() / 8).to(torch.float8_e4m3fn)
        v = (v.float() / 8).to(torch.float8_e4m3fn)
    v[1:, 0, 0] = wire.reshape(B, dh)   # block b + 1 holds slot b's keys
    ones = torch.ones((B + 1, bs, 1))
    c = dict(q=torch.randn(B, 2, 1, dh, generator=gen).to(cuda,
                                                          torch.bfloat16),
             k_pool=k.to(cuda), v_pool=v.to(cuda),
             block_tables=torch.arange(1, B + 1, dtype=torch.int32,
                                       device=cuda)[:, None],
             kv_lens=torch.full((B,), 2, dtype=torch.int32, device=cuda),
             k_scale=ones.to(cuda), v_scale=ones.to(cuda))
    got = tpa.paged_attention(**c)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0, 0].float().cpu(),
                       wire.float().reshape(B, dh))
    want = tpa.paged_attention_ref(**_cpu(c)).to(cuda)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


def test_ll_allgather_back_to_back_leaves_its_signals_at_zero(cuda):
    """100 calls back to back on one stream, no host reset and no
    synchronize between them, alternating shapes and dtypes, the epoch an
    int or a 0-d tensor advanced on the card, one call with 1 ms-delayed
    pushes behind a NaN-poisoned output: every result is the plain
    version's bits, the staging what the plain version leaves, and the
    ticket cell and every flag are 0 after. A call makes one device
    operation, the launch."""
    from triton_distributed_tpu_torch.kernels import _signal

    gen = torch.Generator(device=cuda).manual_seed(29)
    xs = [_randn(gen, 8, 256, 256, dtype=torch.float32),
          _randn(gen, 3, 7, 2051, dtype=torch.bfloat16),
          _randn(gen, 2, 5, 33, dtype=torch.float32)]
    stagings = [torch.full((x.shape[0], 2, x.shape[0] - 1, *x.shape[1:]),
                           float("nan"), dtype=x.dtype, device=cuda)
                for x in xs]
    mirrors = [s.clone() for s in stagings]
    epoch_t = torch.zeros((), dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    _build.reset_counts()
    outs = []
    for i in range(100):
        j = i % 3
        delayed = i == 50
        out = (torch.full((xs[j].shape[0], xs[j].shape[0] * xs[j].shape[1],
                           *xs[j].shape[2:]), float("nan"),
                          dtype=xs[j].dtype, device=cuda)
               if delayed else None)
        epoch = epoch_t if i % 2 else i
        got, st = tll.ll_all_gather_cuda(
            xs[j], stagings[j], epoch, out=out,
            producer_delay_ns=1_000_000 if delayed else 0)
        assert st is stagings[j]
        outs.append(got)
        epoch_t.add_(1)
    torch.cuda.synchronize()
    assert tll.LL_AG.launches == 100
    for i, got in enumerate(outs):
        j = i % 3
        want, mirrors[j] = tll.ll_all_gather_ref(xs[j], mirrors[j], i)
        assert torch.equal(got, want), i
    for st, mirror in zip(stagings, mirrors):
        assert torch.equal(st.isnan(), mirror.isnan())
        assert torch.equal(st.nan_to_num(), mirror.nan_to_num())
    dev = xs[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert int(_signal._ARRIVALS[(dev, stream, tll.LL_AG.name)][0]) == 0
    assert int(_signal.flags(dev, tll.LL_AG.name, 1).abs().sum()) == 0
    ops = _cuda_ops(lambda: tll.ll_all_gather_cuda(xs[0], stagings[0],
                                                   epoch_t))
    assert len(ops) == 1 and "ll_allgather_kernel" in ops[0], ops


# --- the dense flash prefill on the wgmma tile, the AG-GEMM loopback's ------
# wgmma items -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _smoke():
    """This checkout's chip_smoke.py, for its checks (it imports only torch
    at its top)."""
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _captured_ops(fn) -> list[str]:
    """chip_smoke.captured_ops: the device operations one call of fn
    enqueues, exactly (the call captured into a CUDA graph, never
    replayed). A call that copies from the host cannot be captured."""
    return _smoke().captured_ops(fn)


# (B, L, Hkv, S, offset, kv_len, seq_lens, layout): offsets 0 and 300;
# varlen rows of 1 and of a length that ends mid-chunk; kv_len at 1, 127,
# 128 and 129 (and past 256) per row; S no multiple of 128; the bhsd
# layout; L no multiple of a tile's 128 / g positions. NaN in K and V at
# and past every row's kv_len.
PREFILL_WGMMA_CASES = {
    "offset0": (2, 200, 2, 333, 0, None, None, "bshd"),
    "offset300": (2, 150, 2, 600, 300, None, None, "bshd"),
    "varlen": (3, 260, 2, 700, 5, None, [260, 1, 123], "bshd"),
    "kv_len_edges": (4, 200, 2, 512, 0, [1, 127, 128, 129], None, "bshd"),
    "kv_len_past_256": (4, 400, 1, 512, 0, [257, 383, 384, 385], None,
                        "bshd"),
    "bhsd": (2, 300, 2, 400, 17, None, None, "bhsd"),
}


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", sorted(PREFILL_WGMMA_CASES))
def test_flash_prefill_wgmma_tile_matches_plain(cuda, case, g):
    """bf16 at head_dim 128 on the wgmma kernel against the plain version
    (2e-2): finite output, padding rows exact zeros, and the call runs the
    wgmma kernel once (its captured graph, the one device operation, where
    the offsets are ints; by torch.profiler where they are tensors)."""
    B, L, Hkv, S, off, kv_len, seq_lens, layout = PREFILL_WGMMA_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(L + g)
    q = _randn(gen, B, L, Hkv * g, 128, dtype=torch.bfloat16)
    k = _randn(gen, B, S, Hkv, 128, dtype=torch.bfloat16)
    v = _randn(gen, B, S, Hkv, 128, dtype=torch.bfloat16)
    kw = dict(offset=off, kv_layout=layout)
    q_lens = [L] * B
    if seq_lens is not None:
        kw["seq_lens"] = torch.tensor(seq_lens, dtype=torch.int32,
                                      device=cuda)
        lens, q_lens = [off + n for n in seq_lens], seq_lens
    elif kv_len is not None:
        kw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
        lens = kv_len
    else:
        lens = [off + L] * B
    for b, n in enumerate(lens):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    if layout == "bhsd":
        k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    _build.reset_counts()
    got = tsp.flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tsp.FLASH_PREFILL.launches == 1
    assert torch.isfinite(got).all()
    for b, n in enumerate(q_lens):
        assert (got[b, n:] == 0).all()
    torch.testing.assert_close(got, tsp.flash_prefill_ref(q, k, v, **kw),
                               atol=2e-2, rtol=2e-2)
    run = lambda: tsp.flash_prefill(q, k, v, **kw)
    if seq_lens is None and kv_len is None:
        ops = _captured_ops(run)
        assert len(ops) == 1 and "flash_prefill_wgmma_kernel" in ops[0], ops
    else:
        ops = [op for op in _cuda_ops(run) if "flash_prefill" in op]
        assert len(ops) == 1 and "flash_prefill_wgmma_kernel" in ops[0], ops


def test_flash_prefill_misaligned_stride_keeps_the_mma_tile(cuda):
    """A cache whose batch stride is no whole number of 16-byte units (one
    batch row: cp.async never steps by it, TMA refuses it) runs the
    mma.sync kernel, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(91)
    S, Hkv, L = 300, 2, 150
    q = _randn(gen, 1, L, 8, 128, dtype=torch.bfloat16)
    store = _randn(gen, 2, S * Hkv * 128 + 8, dtype=torch.bfloat16)
    k, v = (s.as_strided((1, S, Hkv, 128), (3, Hkv * 128, 128, 1))
            for s in store)
    assert not tsp.prefill_wgmma_ready(q, k, 128 ** -0.5)
    run = lambda: tsp.flash_prefill(q, k, v, offset=0)
    got = run()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tsp.flash_prefill_ref(q, k, v, offset=0),
                               atol=2e-2, rtol=2e-2)
    ops = [op for op in _cuda_ops(run) if "flash_prefill" in op]
    assert len(ops) == 1 and "flash_prefill_mma_kernel" in ops[0], ops


def test_flash_prefill_back_to_back_leaves_its_ticket_at_zero(cuda):
    """100 calls back to back on one stream, no host reset and no
    synchronize between them, alternating shapes, int and per-row offsets:
    every result is the first call's bits for its inputs, and the stream's
    ticket is 0 after."""
    from triton_distributed_tpu_torch.kernels import _signal

    gen = torch.Generator(device=cuda).manual_seed(92)
    cases = []
    for B, L, Hq, Hkv, S, kw in (
            (2, 300, 16, 2, 512, dict(offset=40)),
            (3, 128, 8, 8, 200, dict(offset=torch.tensor(
                [0, 7, 72], dtype=torch.int32, device=cuda)))):
        q = _randn(gen, B, L, Hq, 128, dtype=torch.bfloat16)
        k = _randn(gen, B, S, Hkv, 128, dtype=torch.bfloat16)
        v = _randn(gen, B, S, Hkv, 128, dtype=torch.bfloat16)
        cases.append((q, k, v, kw))
    firsts = [tsp.flash_prefill(q, k, v, **kw) for q, k, v, kw in cases]
    torch.cuda.synchronize()
    _build.reset_counts()
    outs = [tsp.flash_prefill(*cases[i % 2][:3], **cases[i % 2][3])
            for i in range(100)]
    torch.cuda.synchronize()
    assert tsp.FLASH_PREFILL.launches == 100
    for i, got in enumerate(outs):
        assert torch.equal(got, firsts[i % 2]), i
    dev = cases[0][0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert int(_signal._ARRIVALS[(dev, stream, tsp.FLASH_PREFILL.name)]
               [0]) == 0


@pytest.mark.parametrize("M,K,N,segments,cols,tile", [
    (4096, 5120, 3200, 8, 3200, "wgmma"), (4096, 5120, 3200, 8, 640,
                                           "wgmma"),
    (4096, 5120, 3200, 8, 128, "wgmma"), (3000, 200, 640, 3, 200, "wgmma"),
    (3000, 200, 640, 3, 640, "wgmma"), (3000, 2052, 640, 3, 640, "mma")])
def test_ag_gemm_loopback_wgmma_items(cuda, M, K, N, segments, cols, tile):
    """Staged and bare against their plain versions (2e-2) at bench.py's
    shape with 3,200, 640 and 128 columns and at a ragged 3-segment M
    (segments of 1,000 rows, chunks of 8) with 200 and 640; K = 2,052 (no
    whole 16-byte rows) runs the mma.sync tile in the same one launch.
    Each call is one device operation, its kernel."""
    a, b = _overlap_ab(cuda, M + K, M, K, N)
    want = tg.matmul_ref(a, b[:, :cols])
    staged = lambda: tg.ag_gemm_loopback_cuda(a, b, segments=segments,
                                              cols=cols)
    bare = lambda: tg.ag_gemm_segmented_bare_cuda(a, b, segments=segments,
                                                  cols=cols)
    _build.reset_counts()
    out1, st = staged()
    out2 = bare()
    torch.cuda.synchronize()
    assert tg.AG_LOOPBACK.launches == 2
    assert torch.equal(st, a)
    for got in (out1, out2):
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    for run in (staged, bare):
        ops = _captured_ops(run)
        assert len(ops) == 1 and f"ag_loopback_kernel_{tile}" in ops[0], ops


def test_ag_gemm_loopback_back_to_back_leaves_its_ticket_at_zero(cuda):
    """100 calls back to back, no host reset and no synchronize between
    them, staged and bare, two shapes (the wgmma and the mma.sync items):
    every result is the first call's bits, and the ticket is 0 after."""
    from triton_distributed_tpu_torch.kernels import _signal

    shapes = [(1024, 256, 384, 8), (300, 36, 200, 3)]
    ops = []
    for i, (M, K, N, segs) in enumerate(shapes):
        a, b = _overlap_ab(cuda, 50 + i, M, K, N)
        ops.append(lambda a=a, b=b, s=segs, n=N:
                   tg.ag_gemm_loopback_cuda(a, b, segments=s, cols=n)[0])
        ops.append(lambda a=a, b=b, s=segs, n=N:
                   tg.ag_gemm_segmented_bare_cuda(a, b, segments=s, cols=n))
    firsts = [op() for op in ops]
    torch.cuda.synchronize()
    _build.reset_counts()
    outs = [ops[i % 4]() for i in range(100)]
    torch.cuda.synchronize()
    assert tg.AG_LOOPBACK.launches == 100
    for i, got in enumerate(outs):
        assert torch.equal(got, firsts[i % 4]), i
    dev = firsts[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert int(_signal._ARRIVALS[(dev, stream, tg.AG_LOOPBACK.name)][0]) \
        == 0


# --- the warp-specialised matmul's SASS, the GEMM-RS loopback's wgmma items -


def test_new_gemm_kernels_issue_hgmma(cuda):
    """chip_smoke.sass_count: the built library's warp-specialised matmul
    and GEMM-RS loopback wgmma kernels hold HGMMA in their SASS."""
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for kernel in ("matmul_ws_kernel", "gemm_rs_loopback_kernel_wgmma"):
        smoke.sass_count("test", kernel, "HGMMA")


# (M, K, N, segments, kernel): bench.py's arm (fused wgmma items), m = 50
# (split), K = 40 (80-byte rows: TMA reads them), K = 36 (72-byte rows:
# the mma.sync items), segments 1 and 2.
RS_LOOPBACK_CASES = [(4096, 3200, 5120, 8, "wgmma"), (400, 64, 256, 8,
                                                     "wgmma"),
                     (400, 40, 256, 8, "wgmma"), (400, 36, 256, 8, "mma"),
                     (512, 256, 384, 1, "wgmma"), (512, 256, 384, 2,
                                                   "wgmma"),
                     (100, 64, 200, 2, "wgmma")]


@pytest.mark.parametrize("M,K,N,segments,kernel", RS_LOOPBACK_CASES)
def test_gemm_rs_loopback_wgmma_items(cuda, M, K, N, segments, kernel):
    """Each item set against the plain version (2e-2); one device operation
    a call, the kernel its operands take."""
    a, b = _overlap_ab(cuda, M + K, M, K, N)
    _build.reset_counts()
    got = trs.gemm_rs_loopback(a, b, segments=segments)
    torch.cuda.synchronize()
    assert trs.GEMM_RS_LOOPBACK.launches == 1
    torch.testing.assert_close(got, trs.gemm_rs_loopback_ref(
        a, b, segments=segments), atol=2e-2, rtol=2e-2)
    ops = _captured_ops(lambda: trs.gemm_rs_loopback_cuda(
        a, b, segments=segments))
    assert len(ops) == 1 and "gemm_rs_loopback_kernel" in ops[0], ops
    assert ("kernel_wgmma" in ops[0]) == (kernel == "wgmma"), ops


@pytest.mark.parametrize("M,K,N,segments", [(4096, 3200, 5120, 8),
                                            (400, 64, 256, 8),
                                            (400, 36, 256, 8)])
def test_gemm_rs_loopback_waits_for_delayed_producers(cuda, M, K, N,
                                                      segments):
    """Every product tile held back 1 ms before its flag, behind NaN
    staging: the folds must wait, so the result is bit-identical to the
    undelayed one (fused, split and mma.sync items)."""
    a, b = _overlap_ab(cuda, 11, M, K, N)
    want = trs.gemm_rs_loopback_cuda(a, b, segments=segments)
    poison = torch.full((segments - 1, M // segments, N), float("nan"),
                        dtype=torch.bfloat16, device=cuda)
    got = trs.gemm_rs_loopback_cuda(a, b, segments=segments, staging=poison,
                                    producer_delay_ns=1_000_000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.isfinite(poison).all()


def test_gemm_rs_loopback_back_to_back_leaves_its_ticket_at_zero(cuda):
    """100 calls back to back, no host reset and no synchronize between
    them, on the wgmma (fused and split) and mma.sync items: every result
    is the first call's bits, and the ticket is 0 after."""
    from triton_distributed_tpu_torch.kernels import _signal

    ops = []
    for i, (M, K, N, segs) in enumerate([(1024, 256, 384, 8),
                                         (400, 64, 256, 8),
                                         (400, 36, 256, 8)]):
        a, b = _overlap_ab(cuda, 60 + i, M, K, N)
        ops.append(lambda a=a, b=b, s=segs:
                   trs.gemm_rs_loopback_cuda(a, b, segments=s))
    firsts = [op() for op in ops]
    torch.cuda.synchronize()
    _build.reset_counts()
    outs = [ops[i % 3]() for i in range(100)]
    torch.cuda.synchronize()
    assert trs.GEMM_RS_LOOPBACK.launches == 100
    for i, got in enumerate(outs):
        assert torch.equal(got, firsts[i % 3]), i
    dev = firsts[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert int(_signal._ARRIVALS[(dev, stream,
                                  trs.GEMM_RS_LOOPBACK.name)][0]) == 0


# --- the ring allgather and the all-reduce loopback: signals on the card ---

SELF_RESET = {
    "ring decode": ((8, 16, 5120), torch.bfloat16, None),
    "ring ragged": ((8, 5, 33), torch.float32, None),
    "loopback bench": ((128, 5120), torch.bfloat16, 8),
    "loopback ragged": ((1000, 384), torch.float32, 3),
}


def _self_reset_case(case):
    shape, dtype, world = SELF_RESET[case]
    if world is None:
        return (tag.ring_all_gather_cuda, tag.all_gather_ref,
                tag.RING_AG.name, "ring_ag_kernel", shape, dtype)
    return (lambda x: tar.oneshot_ar_loopback_cuda(x, world=world),
            lambda x: tar.oneshot_ar_loopback_ref(x, world=world),
            tar.ONESHOT_AR_LOOPBACK.name, "ar_loopback_kernel", shape, dtype)


def _cells_zero(cuda, name, streams) -> bool:
    """Every arrival cell of ``name`` on each stream (handles) exists and
    is 0."""
    from triton_distributed_tpu_torch.kernels import _signal

    dev = torch.device("cuda", torch.cuda.current_device())
    keys = [(dev, s, name) for s in streams]
    assert all(k in _signal._ARRIVALS for k in keys), keys
    return not any(bool(_signal._ARRIVALS[k].any()) for k in keys)


@pytest.mark.parametrize("case", sorted(SELF_RESET))
def test_captured_call_replays_on_fresh_inputs(cuda, case):
    """One call captured in a CUDA graph and replayed 100 times, a fresh
    input copied into the static one before each replay: every result is
    the plain version's bits (the graph holds no epoch and no memset: the
    ticket and flags are arrival cells the kernel leaves at 0), the cells
    are 0 after, and the call is one device operation, the kernel."""
    run, ref, name, kernel, shape, dtype = _self_reset_case(case)
    gen = torch.Generator(device=cuda).manual_seed(71)
    x = _randn(gen, *shape, dtype=dtype)
    side = _smoke().graph_replays(case, run, x.clone(),
                                  lambda i: _randn(gen, *shape, dtype=dtype),
                                  ref)
    assert _cells_zero(cuda, name,
                       (side, torch.cuda.current_stream().cuda_stream))
    ops = _captured_ops(lambda: run(x))
    assert len(ops) == 1 and kernel in ops[0], ops


def test_ring_back_to_back_without_host_reset(cuda):
    """100 calls back to back on one stream, no host reset and no
    synchronize between them, alternating phase 10's decode and prefill
    shapes (each result compared on the card as it comes): every one is
    the plain version's bits and every arrival cell is 0 after."""
    gen = torch.Generator(device=cuda).manual_seed(72)
    xs = [_randn(gen, 8, 16, 5120, dtype=torch.bfloat16),
          _randn(gen, 8, 1024, 5120, dtype=torch.bfloat16)]
    wants = [tag.all_gather_ref(x) for x in xs]
    torch.cuda.synchronize()
    _build.reset_counts()
    same = []
    for i in range(100):
        got = tag.ring_all_gather_cuda(xs[i % 2])
        same.append((got == wants[i % 2]).all())
        del got
    torch.cuda.synchronize()
    assert tag.RING_AG.launches == 100
    assert all(bool(ok) for ok in same)
    assert _cells_zero(cuda, tag.RING_AG.name,
                       (torch.cuda.current_stream().cuda_stream,))


def test_loopback_back_to_back_without_host_reset(cuda):
    """100 calls back to back on one stream, no host reset and no
    synchronize between them, alternating bf16 (128, 5120) at world 8 and
    ragged f32 (1000, 384) at world 3, each on the default staging (the
    stream's persistent scratch) or a caller's: every result is the plain
    version's bits, every arrival cell is 0 after, and every staging slot
    holds x (the pushes landed)."""
    gen = torch.Generator(device=cuda).manual_seed(73)
    cases = [(_randn(gen, 128, 5120, dtype=torch.bfloat16), 8),
             (_randn(gen, 1000, 384, dtype=torch.float32), 3)]
    given = [torch.full((w - 1, *x.shape), float("nan"), dtype=x.dtype,
                        device=cuda) for x, w in cases]
    torch.cuda.synchronize()
    _build.reset_counts()
    outs = []
    for i in range(100):
        x, world = cases[i % 2]
        outs.append(tar.oneshot_ar_loopback_cuda(
            x, world=world, staging=given[i % 2] if i % 4 >= 2 else None))
    torch.cuda.synchronize()
    assert tar.ONESHOT_AR_LOOPBACK.launches == 100
    for i, got in enumerate(outs):
        x, world = cases[i % 2]
        assert torch.equal(got, tar.oneshot_ar_loopback_ref(x, world=world))
    stream = torch.cuda.current_stream().cuda_stream
    assert _cells_zero(cuda, tar.ONESHOT_AR_LOOPBACK.name, (stream,))
    for (x, world), st in zip(cases, given):
        assert torch.equal(st, x.expand_as(st))
        scratch = tar.loopback_staging(x, world, stream)
        assert torch.equal(scratch, x.expand_as(scratch))


def test_loopback_default_staging_persists(cuda):
    """Without a staging the pushes land in the stream's persistent scratch:
    the same storage call after call, grown for a larger call, the result
    unchanged."""
    gen = torch.Generator(device=cuda).manual_seed(74)
    x = _randn(gen, 128, 5120, dtype=torch.bfloat16)
    big = _randn(gen, 256, 5120, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    got = tar.oneshot_ar_loopback(x, world=8)
    st = tar.loopback_staging(x, 8, stream)
    assert torch.equal(got, 8 * x) and torch.equal(st, x.expand_as(st))
    tar.oneshot_ar_loopback(x, world=8)
    assert tar.loopback_staging(x, 8, stream).data_ptr() == st.data_ptr()
    assert torch.equal(tar.oneshot_ar_loopback(big, world=8), 8 * big)
    assert torch.equal(tar.oneshot_ar_loopback(x, world=8), got)
