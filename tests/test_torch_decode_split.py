"""The split-KV decode's rules on the CPU: its split count comes from the
cache's static length alone, the same for the contiguous and the paged
kernel, and its split-and-merge algebra (``flash_decode_split_ref``, a
torch model of what ``csrc/flash_decode.cuh`` computes) gives the plain
versions' answer. The kernel itself runs in ``tests/test_torch_gpu.py``
on the card."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import paged_attention as tpa
from triton_distributed_tpu_torch.kernels import sp_attention as tsp

CSRC = (Path(__file__).resolve().parent.parent / "triton_distributed_tpu_torch"
        / "csrc")


def test_the_kernel_and_the_wrappers_share_one_split():
    # One number: the build compiles _build.DECODE_SPLIT into the kernel,
    # whose header holds no split of its own, and the wrappers count with
    # the same constant.
    assert f"-DTDT_DECODE_SPLIT={tsp.DECODE_SPLIT}" in _build.NVCC_FLAGS
    assert tsp.DECODE_SPLIT == _build.DECODE_SPLIT
    src = (CSRC / "flash_decode.cuh").read_text()
    assert re.search(r"constexpr int SPLIT = TDT_DECODE_SPLIT;", src)
    assert not re.search(r"constexpr int SPLIT = \d", src)


@pytest.mark.parametrize("S", [0, 1, 255, 256, 257, 640, 4096, 32768])
def test_split_count_depends_on_the_static_length_only(S):
    want = max(1, math.ceil(S / tsp.DECODE_SPLIT))
    assert tsp.decode_splits(S) == want
    # The contiguous cache of S positions, in both layouts.
    k = torch.empty(2, S, 4, 8)
    assert tsp.flash_decode_splits(k, "bshd") == want
    assert tsp.flash_decode_splits(k.transpose(1, 2), "bhsd") == want
    # Paged tables of S positions, whatever block size and valid lengths.
    for bs in (1, 16, 64):
        if S % bs:
            continue
        tables = torch.zeros((3, S // bs), dtype=torch.int32)
        assert tpa.paged_decode_splits(tables, bs) == want


def _pool(rng, n_blocks, bs, Hkv, dh):
    shape = (n_blocks, bs, Hkv, dh)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


@pytest.mark.parametrize("Hq,Hkv,dh", [(8, 2, 32), (4, 4, 16), (16, 1, 8)])
def test_split_merge_model_matches_the_paged_reference(Hq, Hkv, dh):
    """Random lengths with 0, one key, both sides of a split edge and a full
    table (so splits that start past kv_len hold nothing): the model over
    the gathered cache equals paged_attention_ref at 1e-6 in f32, its lse
    equals flash_decode_ref's, and an empty row gives 0 and lse -inf."""
    rng = np.random.default_rng(Hq * dh)
    bs, max_blocks = 16, 48                      # S = 768: three splits
    S = bs * max_blocks
    lens = [0, 1, 255, 256, 257, S] + rng.integers(0, S + 1, 4).tolist()
    B = len(lens)
    n_blocks = B * max_blocks + 1
    perm = rng.permutation(n_blocks)
    tables = torch.from_numpy(perm[:B * max_blocks].reshape(B, max_blocks)
                              .astype(np.int32))
    kp, vp = _pool(rng, n_blocks, bs, Hkv, dh)
    q = torch.from_numpy(rng.standard_normal((B, Hq, dh)).astype(np.float32))
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    want = tpa.paged_attention_ref(q[:, None], kp, vp, tables, kv_lens)[:, 0]
    k = tsp.paged_gather_kv(kp, tables)
    v = tsp.paged_gather_kv(vp, tables)
    got, lse = tsp.flash_decode_split_ref(q, k, v, kv_len=kv_lens,
                                          kv_layout="bshd")
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    _, want_lse = tsp.flash_decode_ref(q, k, v, kv_len=kv_lens,
                                       kv_layout="bshd")
    live = kv_lens > 0
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-6,
                               rtol=1e-6)
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    assert torch.isneginf(lse[~live]).all()
    # The algebra does not depend on where the splits fall.
    other, _ = tsp.flash_decode_split_ref(q, k, v, kv_len=kv_lens,
                                          kv_layout="bshd", split=48)
    torch.testing.assert_close(other, got, atol=1e-6, rtol=1e-6)
