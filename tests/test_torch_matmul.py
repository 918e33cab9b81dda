"""Parity of the port's single-card matmul with the JAX package's
``ag_gemm_single_chip``: explicit blocks make the JAX side run its Pallas
``_matmul_kernel`` (interpreted on the CPU), the port runs ``matmul_ref``.
fp32, ``rtol=atol=1e-5`` (the two sum the products in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels.allgather_gemm import (
    ag_gemm_single_chip as jax_matmul,
)
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
from triton_distributed_tpu_torch.kernels.gemm_reduce_scatter import (
    gemm_rs_device,
)


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


@pytest.mark.parametrize("shape,blocks", [
    ((64, 128, 256), (64, 128, 128)),
    ((128, 128, 384), (64, 128, 128)),
])
def test_matmul_ref_matches_pallas_kernel(shape, blocks):
    M, K, N = shape
    a, b = _inputs(M, K, N)
    bm, bn, bk = blocks
    want = jax_matmul(jnp.asarray(a), jnp.asarray(b), block_m=bm, block_n=bn,
                      block_k=bk)
    got = tg.matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("M", [8, 63, 64, 96])
def test_single_chip_routing_on_cpu(M):
    """M < 64 is the library product (the JAX package's XLA delegation),
    M >= 64 the kernel's plain version on a CPU tensor; neither launches the
    CUDA kernel, and both agree with the JAX entry point."""
    a, b = _inputs(M, 128, 128, seed=M)
    _build.reset_counts()
    got = tg.ag_gemm_single_chip(torch.from_numpy(a), torch.from_numpy(b))
    assert tg.MATMUL.launches == 0
    want = jax_matmul(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_world1_wrappers_and_multi_rank_refusal():
    a, b = _inputs(64, 32, 48)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ref = tg.matmul_ref(ta, tb)
    torch.testing.assert_close(tg.ag_gemm_device(ta, tb), ref)
    torch.testing.assert_close(gemm_rs_device(ta, tb), ref)
    # World 2 runs now (rows 12-13 are ported) on every rank's shards
    # stacked; the world-1 (unstacked) operands are refused there.
    with pytest.raises(ValueError, match="stacked"):
        tg.ag_gemm_device(ta, tb, world=2)
    with pytest.raises(ValueError, match="stacked"):
        gemm_rs_device(ta, tb, world=2)
    ag = tg.ag_gemm_device(ta.reshape(2, 32, 32), tb[None].expand(2, -1, -1),
                           world=2)
    torch.testing.assert_close(ag, ref.expand(2, -1, -1))
    rs = gemm_rs_device(ta[None].expand(2, -1, -1), tb[None].expand(2, -1, -1),
                        world=2)
    torch.testing.assert_close(rs.reshape(64, 48), 2 * ref)
    with pytest.raises(ValueError, match="K mismatch"):
        tg.ag_gemm_device(ta, tb.T.contiguous())


def test_matmul_ref_casts_to_promoted_dtype():
    a = torch.ones((64, 16), dtype=torch.bfloat16)
    b = torch.ones((16, 8), dtype=torch.bfloat16)
    assert tg.matmul_ref(a, b).dtype == torch.bfloat16
    assert tg.matmul_ref(a, b.float()).dtype == torch.float32


def test_matmul_cuda_refuses_cpu_tensors():
    a, b = (torch.zeros((64, 8)), torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        tg.matmul_cuda(a, b)
