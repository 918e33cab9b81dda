"""Parity of the port's ``layers/nn.py`` with the JAX package's: the same
numpy inputs through both, fp32, ``atol=1e-6`` (element-wise ops in f32;
the two frameworks' libm may differ in the last ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.layers import nn as jnn
from triton_distributed_tpu_torch.layers import nn as tnn

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(tnn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jnn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192),
                                     (32.0, 1.0, 4.0, 8192)])
def test_rope_angles_match_jax(scaling):
    pos = np.arange(0, 40, dtype=np.int32)[None] + np.array([[0], [3]],
                                                            np.int32)
    cos_t, sin_t = tnn.rope_angles(torch.from_numpy(pos), 128, 5e5, scaling)
    cos_j, sin_j = jnn.rope_angles(jnp.asarray(pos), 128, 5e5, scaling)
    assert cos_t.shape == (2, 40, 64)
    _close(cos_t, cos_j, atol=ATOL)
    _close(sin_t, sin_j, atol=ATOL)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None] + 5
    cos, sin = jnn.rope_angles(jnp.asarray(pos), 16, 1e4)
    want = jnn.apply_rope(jnp.asarray(x), cos, sin)
    got = tnn.apply_rope(torch.from_numpy(x), torch.tensor(np.asarray(cos)),
                         torch.tensor(np.asarray(sin)))
    _close(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_cache_update_matches_jax(per_row):
    rng = np.random.default_rng(2)
    cache = rng.standard_normal((3, 12, 2, 8)).astype(np.float32)
    new = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    offset = np.array([0, 5, 8], np.int32) if per_row else np.int32(3)
    want = jnn.cache_update(jnp.asarray(cache), jnp.asarray(new),
                            jnp.asarray(offset))
    t_cache = torch.from_numpy(cache.copy())
    t_off = torch.from_numpy(offset) if per_row else int(offset)
    got = tnn.cache_update(t_cache, torch.from_numpy(new), t_off)
    assert got is t_cache  # written in place
    _close(got, want, atol=0)


def test_cache_update_past_end_raises():
    cache = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError):
        tnn.cache_update(cache, torch.zeros((1, 2, 1, 8)), 3)


@pytest.mark.parametrize("L,use_flash", [(1, True), (1, False), (5, True),
                                         (5, False)])
def test_attn_with_cache_matches_jax(L, use_flash):
    """Decode and prefill through ``attn_with_cache``, both routings: on the
    CPU the port's flash branches run the kernels' plain versions."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, dh, S, off = 2, 4, 2, 8, 16, 6
    q = rng.standard_normal((B, L, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    want = jnn.attn_with_cache(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(off), scale=dh ** -0.5,
                               use_flash_decode=use_flash)
    got = tnn.attn_with_cache(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), off, scale=dh ** -0.5,
                              use_flash_decode=use_flash)
    _close(got, want, atol=ATOL)


def test_attn_with_cache_varlen_dense_matches_jax():
    rng = np.random.default_rng(4)
    B, L, Hq, Hkv, dh, S = 3, 6, 4, 2, 8, 16
    q = rng.standard_normal((B, L, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    lens = np.array([6, 2, 4], np.int32)
    want = jnn.attn_with_cache(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(2), scale=dh ** -0.5,
                               use_flash_decode=False,
                               seq_lens=jnp.asarray(lens))
    for flash in (False, True):
        got = tnn.attn_with_cache(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 2, scale=dh ** -0.5,
                                  use_flash_decode=flash,
                                  seq_lens=torch.from_numpy(lens))
        _close(got, want, atol=ATOL)
