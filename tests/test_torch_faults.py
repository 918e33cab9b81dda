"""The port against the JAX package where the port used to refuse what JAX
runs, on the CPU: bf16 AG-GEMM at a local width of 130 and AG-GroupGEMM at
d = 33 (rows that TMA cannot read: on the card they take the ``mma.sync``
tile, here the plain versions run), against JAX's kernels on the conftest
8-device mesh in interpret mode, bit for bit on exact products; the host
``all_gather`` with ``method="ll"`` (JAX runs the direct push) bit for bit;
and ``ring_2d`` raising JAX's exception type. One module-scoped JAX program
runs both interpreted GEMMs (buffers <= 12 KB a device). No case launches a
kernel: every tensor lies on the CPU."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.kernels import allgather as jag
from triton_distributed_tpu.kernels import allgather_gemm as jgemm
from triton_distributed_tpu.kernels import moe_overlap as jmo
from triton_distributed_tpu.layers import allgather_layer as jlayer
from triton_distributed_tpu.runtime.compat import shard_map
from triton_distributed_tpu_torch.kernels import KERNELS, _build
from triton_distributed_tpu_torch.kernels import allgather as tag
from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
from triton_distributed_tpu_torch.kernels import moe_overlap as tmo
from triton_distributed_tpu_torch.layers import allgather_layer as tlayer

W = 8
BF16 = ml_dtypes.bfloat16
AG = (4, 8, 130)                 # m, K, n_local: n_local no multiple of 8
MOE = dict(m=2, k=2, d=33, f=8, E=2, cap=4)   # d no multiple of 8


def _no_launches():
    return all(kern.launches == 0 for kern in KERNELS.values())


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


def _one_hot_rows(rng, shape):
    """Rows with one small integer each: every product with bf16 values is
    exact in f32, so any summation order gives the same bits."""
    a = np.zeros(shape, np.float32)
    flat = a.reshape(-1, shape[-1])
    rows = np.arange(flat.shape[0])
    flat[rows, rng.integers(0, shape[-1], len(rows))] = rng.integers(
        1, 4, len(rows))
    return a.astype(BF16)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    m, K, n = AG
    c = MOE
    return dict(
        a=_one_hot_rows(rng, (W, m, K)),
        b=rng.standard_normal((W, K, n)).astype(BF16),
        x=_one_hot_rows(rng, (W, c["m"], c["d"])),
        ids=rng.integers(0, c["E"], (W, c["m"], c["k"])).astype(np.int32),
        wu=rng.standard_normal((W, c["E"], c["d"], c["f"])).astype(BF16))


@pytest.fixture(scope="module")
def jax_out(mesh8, case):
    """JAX's bf16 ``ag_gemm_device`` at n_local 130 and
    ``ag_group_gemm_device`` at d 33 on the 8-device mesh, in one program:
    both run."""
    c = MOE

    def f(a, b, x, ids, wu):
        out = jgemm.ag_gemm_device(a[0], b[0])
        up, st = jmo.ag_group_gemm_device(x[0], ids[0], wu[0],
                                          n_experts=c["E"],
                                          capacity=c["cap"])
        return out[None], up[None], st["n_dropped"][None]

    outs = jax.jit(shard_map(f, mesh=mesh8, in_specs=(P("tp"),) * 5,
                             out_specs=(P("tp"),) * 3, check_vma=False))(
        *(jnp.asarray(case[n]) for n in ("a", "b", "x", "ids", "wu")))
    return dict(zip(("ag", "up", "dropped"), map(np.asarray, outs)))


def test_ag_gemm_bf16_at_local_width_130_matches_jax(case, jax_out):
    """JAX runs bf16 AG-GEMM with n_local 130 (one 130-wide block); the
    port's ``ag_gemm_device`` gives its bits. On the card this width takes
    the ``mma.sync`` tile (no TMA refusal): ``_build.tma_rows`` says 0."""
    a, b = _torch(case["a"]), _torch(case["b"])
    _build.reset_counts()
    got = tg.ag_gemm_device(a, b, world=W)
    assert _no_launches()
    assert got.shape == (W, W * AG[0], AG[2])
    np.testing.assert_array_equal(_bits(got), _jbits(jax_out["ag"]))
    assert _build.tma_rows((AG[1], AG[2]), a, b) == 0
    assert _build.tma_rows((AG[1], 136), a, b) == 1


def test_ag_group_gemm_at_d33_does_what_jax_does(case, jax_out):
    """JAX runs ``ag_group_gemm_device`` at d = 33 (no exception); so does
    the port, with JAX's bits and drop counts."""
    c = MOE
    x, ids, wu = (_torch(case[n]) for n in ("x", "ids", "wu"))
    _build.reset_counts()
    up, state = tmo.ag_group_gemm_device(x, ids, wu, world=W,
                                         n_experts=c["E"], capacity=c["cap"])
    assert _no_launches()
    assert up.shape == (W, c["E"], W * c["cap"], c["f"])
    np.testing.assert_array_equal(_bits(up), _jbits(jax_out["up"]))
    np.testing.assert_array_equal(state["n_dropped"].numpy(),
                                  jax_out["dropped"].reshape(W))
    assert _build.tma_rows((c["d"], c["f"]), x, wu) == 0


def test_host_all_gather_ll_matches_jax(mesh8):
    """JAX's host ``all_gather`` runs the direct push for ``"ll"`` (its
    ``_build_ag`` :267-273); the port's gives the same bits."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((W, 2, 32)).astype(np.float32)
    want = np.asarray(jag.all_gather(jnp.asarray(x), mesh=mesh8,
                                     method="ll"))
    _build.reset_counts()
    got = tag.all_gather(torch.from_numpy(x), world=W, method="ll")
    assert _no_launches()
    assert got.shape == want.shape == (W * 2, 32)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_ring_2d_raises_jax_exception_type(mesh8):
    """``ring_2d`` with no ``dcn_axis``: JAX's host ``all_gather`` and its
    ``AllGatherLayer`` raise ``ValueError`` before any kernel; the port's
    raise the same type. A ``dcn_axis`` (the 2-D exchange, which JAX runs
    and the port has not ported) stays ``NotImplementedError``."""
    x = np.zeros((W, 2, 4), np.float32)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError) as jax_host:
        jag.all_gather(jnp.asarray(x), mesh=mesh8, method="ring_2d")
    with pytest.raises(type(jax_host.value)):
        tag.all_gather(xt, world=W, method="ring_2d")
    jl = jlayer.AllGatherLayer((2, 4), jnp.float32, mesh=mesh8,
                               name="t_faults_layer")
    with pytest.raises(ValueError) as jax_layer:
        jl(x[0], method="ring_2d")
    layer = tlayer.AllGatherLayer((2, 4), torch.float32, world=W,
                                  device="cpu")
    with pytest.raises(type(jax_layer.value)) as port_layer:
        layer(xt, method="ring_2d")
    assert str(port_layer.value) == str(jax_layer.value)
    with pytest.raises(NotImplementedError):
        tag.all_gather(xt, world=W, method="ring_2d", dcn_axis="dcn")
