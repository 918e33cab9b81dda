"""Parity of the port's flash attention plain versions with the JAX
package's Pallas kernels (interpreted on the CPU), at the shapes of
``tests/test_sp_attention.py``: ``flash_prefill_ref`` against
``flash_prefill`` (offsets, varlen, a NaN cache tail; ``atol=2e-5,
rtol=2e-4``) and ``flash_decode_ref`` (out and lse) against
``flash_decode_local`` on its block-diagonal and per-head paths, with a
scalar and a per-row ``kv_len`` (``atol=rtol=1e-4``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import sp_attention as jsp
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import sp_attention as tsp


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("offset", [0, 8])
def test_flash_prefill_ref_matches_jax_with_nan_tail(offset):
    B, L, Hq, Hkv, dh, S = 2, 16, 8, 4, 128, 48
    kv_len = offset + L
    q, k, v = _qkv((B, L, Hq, dh), (B, S, Hkv, dh), seed=offset)
    k[:, kv_len:] = np.nan
    v[:, kv_len:] = np.nan
    want = jsp.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             offset=offset, kv_len=kv_len, chunk=8)
    got = tsp.flash_prefill_ref(*_t(q, k, v), offset=offset, kv_len=kv_len)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-4)


def test_flash_prefill_ref_nan_inside_partial_chunk():
    """The plain version keeps NaN out even where a chunk straddles kv_len
    (the case the JAX kernel's chunking never meets in its own test)."""
    B, L, Hq, Hkv, dh, S = 1, 5, 4, 2, 16, 24
    q, k, v = _qkv((B, L, Hq, dh), (B, S, Hkv, dh), seed=7)
    k[:, 9:] = np.nan
    v[:, 9:] = np.nan
    got = tsp.flash_prefill_ref(*_t(q, k, v), offset=4)
    assert torch.isfinite(got).all()
    clean = tsp.flash_prefill_ref(*_t(q, np.nan_to_num(k), np.nan_to_num(v)),
                                  offset=4)
    torch.testing.assert_close(got, clean, atol=0, rtol=0)


@pytest.mark.parametrize("offset", [0, 8])
def test_flash_prefill_ref_varlen_matches_jax(offset):
    B, L, Hq, Hkv, dh, S = 3, 16, 4, 2, 128, 64
    lens = np.array([16, 9, 5], np.int32)
    q, k, v = _qkv((B, L, Hq, dh), (B, S, Hkv, dh), seed=10 + offset)
    want = np.asarray(jsp.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), offset=offset,
        seq_lens=jnp.asarray(lens), chunk=8))
    got = tsp.flash_prefill_ref(*_t(q, k, v), offset=offset,
                                seq_lens=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(got[b, n:], 0.0)


def test_flash_prefill_ref_bhsd_layout_and_per_row_offsets():
    B, L, Hq, Hkv, dh, S = 2, 8, 4, 2, 128, 32
    q, k, v = _qkv((B, L, Hq, dh), (B, S, Hkv, dh), seed=3)
    want = np.asarray(jsp.flash_prefill(
        jnp.asarray(q), jnp.asarray(k.swapaxes(1, 2)),
        jnp.asarray(v.swapaxes(1, 2)), offset=4, kv_layout="bhsd", chunk=8))
    tq, tk, tv = _t(q, k, v)
    got = tsp.flash_prefill_ref(tq, tk.transpose(1, 2), tv.transpose(1, 2),
                                offset=4, kv_layout="bhsd")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-4)
    per_row = tsp.flash_prefill_ref(tq, tk, tv,
                                    offset=torch.tensor([4, 4], dtype=torch.int32))
    torch.testing.assert_close(per_row, got, atol=0, rtol=0)


@pytest.mark.parametrize("path,B,Hq,Hkv,dh,S,layout", [
    ("bd", 2, 16, 8, 128, 64, "bshd"),         # Hkv * g >= 16, bshd
    ("per_head", 2, 8, 4, 32, 64, "bshd"),     # Hkv * g < 16
    ("per_head", 3, 4, 2, 16, 48, "bhsd"),
])
@pytest.mark.parametrize("per_row", [False, True])
def test_flash_decode_ref_matches_jax(path, B, Hq, Hkv, dh, S, layout,
                                      per_row):
    q, k, v = _qkv((B, Hq, dh), (B, S, Hkv, dh), seed=B + dh)
    if layout == "bhsd":
        k, v = k.swapaxes(1, 2).copy(), v.swapaxes(1, 2).copy()
    kv_len = (np.array([S - 3, 17, 40][:B], np.int32) if per_row
              else np.int32(S - 5))
    j_out, j_lse = jsp.flash_decode_local(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(kv_len), kv_layout=layout, chunk=16)
    t_kv = torch.from_numpy(kv_len) if per_row else int(kv_len)
    out, lse = tsp.flash_decode_ref(*_t(q, k, v), kv_len=t_kv,
                                    kv_layout=layout)
    assert out.dtype == torch.float32 and lse.shape == (B, Hq)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-4,
                               rtol=1e-4)


def test_cpu_entry_points_never_launch():
    """On CPU tensors the entry points run the plain versions; the launch
    counts stay at 0."""
    q, k, v = _qkv((1, 8, 4, 16), (1, 16, 2, 16), seed=1)
    _build.reset_counts()
    out = tsp.flash_prefill(*_t(q, k, v), offset=0)
    torch.testing.assert_close(out, tsp.flash_prefill_ref(*_t(q, k, v),
                                                          offset=0))
    dq = torch.from_numpy(q[:, 0])
    o1, l1 = tsp.flash_decode_local(dq, *_t(k, v), kv_len=9,
                                    kv_layout="bshd")
    o2, l2 = tsp.flash_decode_ref(dq, *_t(k, v), kv_len=9, kv_layout="bshd")
    torch.testing.assert_close((o1, l1), (o2, l2))
    assert all(kern.launches == 0 for kern in _build.KERNELS.values())


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = _t(*_qkv((1, 8, 4, 16), (1, 16, 2, 16), seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        tsp.flash_prefill_cuda(q, k, v, offset=0)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.flash_decode_cuda(q[:, 0], k, v, kv_len=4, kv_layout="bshd")
