"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
when there is none (decided when the test runs, never at import). Run on a
machine with an H100 with ``python -m pytest tests/test_torch_gpu.py -m gpu``.
Tolerances: bf16 output ``atol=rtol=2e-2``; fp32 output ``atol=rtol=1e-4``
(the kernel sums in another order than the plain version)."""

import pytest
import torch

from triton_distributed_tpu_torch import Engine, ModelConfig
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
from triton_distributed_tpu_torch.kernels import sp_attention as tsp

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
@pytest.mark.parametrize("M,K,N", [(64, 128, 256), (130, 33, 77),
                                   (1000, 512, 1032)])
def test_matmul_kernel_matches_plain(cuda, dtype, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(M)
    a = _randn(gen, M, K, dtype=dtype)
    b = _randn(gen, K, N, dtype=dtype) * K ** -0.5
    _build.reset_counts()
    got = tg.ag_gemm_single_chip(a, b)
    torch.cuda.synchronize()
    assert tg.MATMUL.launches == 1
    tol = TOL[dtype]
    torch.testing.assert_close(got, tg.matmul_ref(a, b), atol=tol, rtol=tol)


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
    assert all(k.launches > 0 for k in _build.KERNELS.values())
    torch.testing.assert_close(got, xla.serve(ids, 6), atol=0, rtol=0)
