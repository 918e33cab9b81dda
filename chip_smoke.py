"""Drive the PyTorch/H100 port's main path on one card and check it.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one NVIDIA Hopper
card. The script builds the CUDA kernels from
``triton_distributed_tpu_torch/csrc/`` (into ``build/torch_kernels/``) and
runs these phases, each printing its own line; any failure raises and the
script exits non-zero without its result line:

1. kernels against their plain versions at the slices' shapes, on seeded
   inputs (bf16 output ``atol=rtol=2e-2``, fp32 output ``atol=rtol=1e-4``),
   the paged kernel at Qwen3-1.7B geometry for a decode and a ragged mixed
   step over bf16, int8 and fp8 pools (shuffled tables, a dead slot, NaN
   in every block no live table reaches), each live slot held at 1% (decode)
   or 2% (mixed) of its own max |output|, each pool's mixed step run by its
   tensor-core kernel (the one prefill launch in a call's captured CUDA
   graph, and torch.profiler's records; the int8/fp8 kernel's SASS holding
   HMMA); the dense prefill at bf16 head_dim 128 on its wgmma kernel (one
   device operation a call in its captured CUDA graph, HGMMA in its SASS);
   the attention kernels again at
   Qwen3-30B-A3B's GQA group of 8 (32 query heads, 4 kv heads); the grouped
   GEMM at Qwen3-30B-A3B's expert shapes (gate_up 2,048 -> 1,536, down 768
   -> 2,048) at the capacities phase 3c serves (16, 2,048 and 8,192) and
   those of the default capacity factor (256, 1,024), with counts from a
   seeded top-8 routing (leading, trailing and consecutive empty experts),
   NaN in every weight of an empty expert and in every row past a count,
   empty experts exactly zero; plus a layer-stacked and a small fp32 case;
2. small fp32 engines (``tiny``, a head_dim-128 config and ``tiny-moe``):
   ``Engine(mode="dist")`` must produce the same tokens as
   ``Engine(mode="xla")`` (prefill M = 64 goes through the matmul kernel);
   ``BatchEngine`` must produce each request's per-request ``Engine``
   tokens with chunked prefill and a forced preemption, and its int8/fp8
   pools must give the same tokens warm (prefix cache hit) as cold; both
   serving steps run with no host read-back; on the dense configs
   ``Engine(mode="ar")`` must give the xla tokens (attention kernels only)
   and ``BatchEngine`` over it the per-request ar tokens;
3. full width, slice 1: Qwen3-1.7B (28 layers, bf16, random weights from a
   seed) serves 4 requests of 2,048 prompt tokens and 64 new tokens
   through ``Engine.serve``; the kernels' launch counts are reset just
   before and read just after, and the prefill logits are held against
   the xla golden (cosine >= 0.999, max |diff| <= 5% of max |logit|); the
   same request through ``Engine(mode="ar")`` on the same weights (exact
   counts: matmul 0, flash prefill 28, flash decode 28 x 63; its logits
   held with the same bars);
3b. full width, slice 2: ``BatchEngine(n_slots=8, block_size=16,
   prefill_chunk=256, max_seq_len=4096)`` serves 16 seeded requests (256
   to 2,048 prompt tokens, four opening with a 1,024-token prefix of an
   earlier request, 32 new tokens each) over bf16, int8 and fp8 pools;
   the launch counts of each run must be exact (paged attention 28 per
   step, matmul 4 x 28 per mixed step, the flash kernels none), and one
   mixed step's logits through the kernels are held against the xla
   golden's gather oracle (same bars as phase 3);
3c. full width, slice 3: Qwen3-30B-A3B (48 layers, 128 experts, top-8,
   bf16, random weights from a seed) serves 4 requests of 2,048 prompt
   tokens and 32 new tokens through ``Engine.serve`` (exact launch counts:
   grouped GEMM 2 x 48 x 32, matmul 2 x 48, flash prefill 48, flash decode
   48 x 31) at the dropless capacity factor 16 (the drop audit prints the
   factors below it), every capacity it serves one that phase 1 held; the
   prefill logits with the dist path's expert choices replayed in the
   golden and one MoE block at layers 0 and 24 on the same hidden states
   are held against the xla golden (phase 3's bars), and the free-running
   prefill logits within 1.5x the drift of a witness (the golden's dense
   attention with P rounded to bf16, as the kernel rounds it: random
   weights make the router chaotic at depth); then ``BatchEngine`` on a
   bf16 pool with phase 3b's requests (paged 48 and grouped GEMM 2 x 48
   per step, matmul 2 x 48 per mixed step);
4. times of each kernel, its plain version and one PyTorch call computing
   the same function (CUDA events, L2 flushed before each launch), beside
   the least time the card could take for the same work; the grouped GEMM
   at the three capacities phase 3c serves; the paged kernel's decode and
   mixed steps also by device time alone (torch.profiler) beside SDPA's;
   the flash prefill also by device time alone, and again at the GQA-8
   shape, each beside SDPA's and its bar (events / SDPA <= 2.0);
5. the one-chip overlap path at bench.py's Qwen3-32B TP=8 per-rank shapes
   (bf16, seeded): the AG-GEMM loopback (A (4,096 x 5,120), B (5,120 x
   3,200), 8 segments; the first work items of one persistent kernel
   stage A and raise a flag per chunk, its consumer tiles wait on them),
   its segmented bare twin,
   ``matmul_tail_into``, the GEMM-RS loopback ((4,096 x 3,200) x (3,200 x
   5,120) -> (512 x 5,120)) and the fused step (c f32 (4,096 x 3,200),
   s = 0.75). Each kernel is held against its plain version: the loopback
   and the bare twin at the auto ``overlap_cols``, at ``n`` and at a
   pinned 128-column split, the loopback again with the producer held back
   ~1 ms and its staging buffer poisoned with NaN (it must equal the
   undelayed result bit for bit), ``matmul_tail_into`` at ``col_start``
   640, GEMM-RS at 8 segments and at 2 with one N tile, and the fused step
   in place on ``c``. The path (the bench arms at the auto split and at
   the JAX package's 640-column split, GEMM-RS, the fused step) runs once
   with the counts reset, each count exact. Then the times: each kernel,
   its plain version, the library call and the bound (the loopback also by
   device time alone beside ``torch.matmul``'s, and its bar, events <= 2.0x
   ``torch.matmul``; one device operation a call for it and its bare twin,
   HGMMA in their wgmma tile's SASS); the loopback at a
   sweep of ``overlap_cols`` (the auto rule's evidence); and bench.py's
   decomposition under its own names;
6. the collectives on one card (seeded): the one-shot all-reduce loopback
   bit-identical to its plain version at bench.py's (128, 5,120) bf16 at
   world 8 (== 8 x), at (1,000, 384) f32 at world 3, and with every
   producer held back 1 ms behind NaN staging (every slot then holds x);
   one call captured in a CUDA graph and replayed 100 times on fresh
   inputs, and 100 calls back to back over both shapes, each bit for bit,
   every arrival cell 0 after, one device operation a call;
   the EP all-to-all loopback at bench.py's dispatch shape (fp8 tokens,
   f32 scales, full occupancy) and at ragged counts with chunks of 8, NaN
   past every count, rows below the counts byte-identical, under
   ``set_sync_debug_mode("error")``; the notify/wait ring at the
   tutorial's shape and a long run (with every odd rank's producer
   delayed) == ``roll(x, 1, 0)``, each NaN queue slot then holding the
   last chunk pushed into it. Then bench.py's arms once with the counts
   reset (the M = 128 ar MLP: matmul 2, all-reduce 1; its
   no-communication twin: matmul 2; the ``torch.matmul`` twin: none; the
   a2a arm: 1; the tutorial: 1), the times (kernel, plain, library call,
   bound; the all-reduce loopback's bars against ``x.mul(8)``, reported;
   the a2a's pieces against one item per chunk) and bench.py's
   decomposition;
7. tensor-parallel Qwen3 at world 8 on one card (seeded; the ranks are
   simulated, so the link is bypassed): the multi-rank AG-GEMM, GEMM-RS,
   one-shot and two-shot all-reduce kernels against their plain versions
   at bench.py's Qwen3-32B TP=8 shapes with all 8 ranks, at m = 1 and in
   f32 (bf16 ``atol=rtol=2e-2``, f32 ``1e-4``; the all-reduces and the
   GEMM-RS fold on exact products bit for bit, every staging slot holding
   what was pushed, and again with 1 ms-delayed producers behind NaN
   staging; GEMM-RS also on exact products at each item set of
   ``gemm_rs.cuh``: the owner's product folded in place in groups and rank
   by rank, tiles straddling segments, rows TMA cannot read), AG-GEMM at
   the JAX 640-column split (``matmul_tail_into`` per rank) and at n 130,
   rows TMA cannot read (the ``mma.sync`` tile, one launch a call); their
   times (kernel, device alone, plain, library call, bound; GEMM-RS's
   library call ``torch.addbmm``, the two-call figure beside it, and its
   decode shape m = 1); fp32 ``tiny`` at world 8 (dist and ar tokens == xla); then Qwen3-32B at
   world 8, full width and depth, serving 8 prompts of 1,024 tokens and 32
   new ones through ``Engine.serve`` in dist mode (exact counts: AG-GEMM
   and GEMM-RS 2 x 64 per forward, flash prefill 64, flash decode 64 x 31)
   and in ar mode (one-shot all-reduce 2 x 64 per forward), each one's
   prefill logits held against the xla golden with phase 3's bars, TTFT,
   decode tokens/s and the peak memory; and the host ``all_reduce`` at
   bench.py's all-reduce shape (the perf model's pick: two-shot). The
   one-shot all-reduce is timed on its serving path (its staging a
   persistent scratch) at bench.py's shape and at the ar serve's decode,
   (8, 8, 5,120), beside ``x.float().sum(0)`` and its bars (device alone
   <= 0.050 ms, events / library <= 2.0), also 50 calls back to back
   without an L2 flush between them;
8. expert-parallel Qwen3-30B-A3B at world 4 on one card (seeded; the ranks
   simulated): the multi-rank EP all-to-all (``csrc/ep_a2a.cu``: bf16
   tokens of 2,048 and int32 expert ids) against its plain version, bit
   for bit below every count, at the world-4 prefill's shape (capacity
   16,384 a rank pair) and the decode's (capacity 8) over full, partial
   and zero counts, each also with every producer held back 1 ms behind
   NaN-poisoned receive buffers (bit-identical, every row past a count
   untouched); AG-GEMM and GEMM-RS at this slice's attention shapes
   (qkv (4, 2,048, 2,048) x (4, 2,048, 1,280), o_proj (4, 8,192, 1,024) x
   (4, 1,024, 2,048), both at m = 1 too); the exchange's times (kernel,
   device alone, plain, the library's transpose copies, bound); fp32
   ``tiny-moe`` at world 4 (dist tokens == xla); then Qwen3-30B-A3B at
   world 4, full width and depth, 4 prompts of 2,048 tokens and 32 new
   through ``Engine.serve`` in dist mode at the dropless factor 16 (no
   drops; exact counts: ``ep_a2a`` and the grouped GEMM 2 x 48 per
   forward, AG-GEMM and GEMM-RS 48 per forward, flash prefill 48, flash
   decode 48 x 31), the prefill logits unchanged with every receive
   buffer NaN-poisoned and held against the xla golden with phase 3c's
   bars, TTFT, decode tokens/s, the peak memory and a device profile;
9. the MoE tensor-parallel pipeline and the reduce-scatter at world 8 on
   one card (seeded; the ranks simulated): AG-GroupGEMM at d 33, rows TMA
   cannot read (the ``mma.sync`` tile, one launch a call); the one-shot
   and ring reduce-scatters (``csrc/oneshot_rs.cu``, ``ring_rs.cu``) bit for bit
   their plain versions at a Qwen3-32B TP = 8 layer's partial output (8,
   8,192, 5,120) and (8, 128, 5,120) bf16 and in f32; AG-GroupGEMM and
   GroupGEMM-RS (``csrc/ag_group_gemm.cu``, ``group_gemm_rs.cu``) at
   Qwen3-30B-A3B's width (128 experts, top-8, d 2,048, f_local 96) on the
   prefill's grids (capacity 128) and the decode's (capacity 8), at bf16
   tolerance and bit for bit on exact products; every staging slot what
   was pushed, and each again with 1 ms-delayed producers behind NaN
   staging; then the path with exact launch counts: ``ag_moe_mlp_device``
   at 8 x 1,024 and 8 x 4 tokens (no drops, held against the plain
   pipeline on the card and the dense f32 golden with phase 3's bars) and
   the host ``reduce_scatter`` at both Qwen3-32B shapes, AUTO and ring;
   the four kernels' times (kernel, device alone, plain, library call,
   bound; GroupGEMM-RS's library call one ``torch.einsum``, the two-call
   figure beside it, at the prefill and the decode) and the peak memory;
10. sequence parallelism at world 8 at Qwen3-32B's attention width
   (64 query heads, 8 kv heads, dh 128), bf16: the ring and direct-push
   allgathers (``csrc/ring_ag.cu``, ``a2a_ag.cu``) bit for bit their plain
   version at the TP = 8 activations (8, 1,024, 5,120) and (8, 16, 5,120),
   also with 1 ms-delayed producers behind a NaN output, and the ring
   captured in a CUDA graph (replayed 100 times on fresh inputs) and 100
   calls back to back over both shapes, each bit for bit, every arrival
   cell 0 after, one device operation a call; the LL allgather
   (``csrc/ll_allgather.cu``) over five epochs and a restart on one
   NaN-poisoned staging, bit for bit, the other parity untouched, and 100
   calls back to back after which its ticket and flags are 0; then the
   path with exact launch counts: the host ``all_gather`` (AUTO),
   ``AllGatherLayer`` at the decode activation with each method,
   ``SpGQAFlashDecodeAttention`` (B 4 over a 32,768-position cache, kv_len
   30,000 and 20,000, once over the ring and three steps over LL) and
   ``sp_ag_attention_device`` (``csrc/sp_ag_attn.cu``, 8 x 4,096 tokens,
   causal), each held against its plain pipeline and an f32 dense golden
   with phase 3's bars; a smaller non-causal prefill holds the lse; the
   prefill again with 1 ms-delayed producers behind NaN staging; the four
   kernels' times (the LL call also back to back, and one device operation,
   its kernel, in a call's captured CUDA graph); the SP prefill's (the
   wgmma tile of ``csrc/attn_wgmma.cuh``) events / SDPA against its bar
   (<= 2.0) and its SASS holding HGMMA.

The second-to-last line is the JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. No card, or no package beside the script,
means a non-zero exit and no result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# Qwen3-1.7B at full width: the slice's shapes.
B, L0, GEN = 4, 2048, 64
D, DFF, HQ, HKV, DH, S = 2048, 6144, 16, 8, 128, 4096
PROJECTIONS = {"qkv": (B * L0, D, (HQ + 2 * HKV) * DH),
               "o": (B * L0, HQ * DH, D),
               "gate_up": (B * L0, D, 2 * DFF),
               "down": (B * L0, DFF, D)}
DECODE_KV_LENS = [2049, 2080, 2111, 1999]
VARLEN = dict(offset=512, seq_lens=[2048, 1531, 777, 1])
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SLICE1_KERNELS = ("matmul", "flash_prefill", "flash_decode")

# The paged kernel at Qwen3-1.7B geometry: 8 slots, tables of 256 blocks of
# 16 (4,096 positions). Decode: ragged kv_lens, slot 7 dead. Mixed: a
# 512-token chunk with ragged q_lens (0 and 1 included), offsets up to
# ~3,000, slot 6 dead.
PAGED = dict(Hq=HQ, Hkv=HKV, dh=DH, bs=16, max_blocks=256)
PAGED_CASES = {
    "decode": dict(L=1, kv_lens=[1, 100, 517, 1024, 2049, 3001, 4096, 777],
                   q_lens=[1] * 8, dead=(7,)),
    "mixed": dict(L=512, kv_lens=[512, 1300, 2997, 3001, 18, 0, 2700, 364],
                  q_lens=[512, 300, 17, 1, 1, 0, 200, 64], dead=(6,)),
}
POOLS = (None, "int8", "fp8")
WIRE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# The paged kernel's bar, per live slot: max |got - want| <= the fraction
# times that slot's max |want|. A long slot's output is small (std about
# sqrt(e / kv_len)), so one absolute bar for every slot would be as large
# as the values of the 4,096-key slot. Decode keeps P in f32 (only the bf16
# output is rounded); the mixed step's bf16 path rounds P to bf16 for
# mma.sync.
PAGED_SLOT_TOL = {"decode": 1e-2, "mixed": 2e-2}

# Phase 3b: the serving path at full width.
SERVE = dict(n_slots=8, block_size=16, prefill_chunk=256, max_seq_len=4096)
SERVE_REQUESTS, SERVE_GEN, SHARED_PREFIX = 16, 32, 1024

# Qwen3-30B-A3B (slice 3): GQA group 8, and the expert GEMMs of its MoE FFN.
GQA8 = dict(Hq=32, Hkv=4)
MOE_E, MOE_K, MOE_D, MOE_FF = 128, 8, 2048, 768
GROUPED = {"gate_up": (MOE_D, 2 * MOE_FF), "down": (MOE_FF, MOE_D)}
# Phase 3c serves at the capacity factor n_experts / top-k: every expert's
# capacity is then every token of the step, so nothing can drop (the golden
# has no capacity). Tokens routed by the steps it serves: a decode of 8
# slots, a mixed step of 8 x 256 and a prefill of 4 x 2,048. Their grids'
# capacities (MoEMLP._capacities at that factor: 16, 2,048 and 8,192) are
# where phases 1 and 4 hold and time the grouped GEMM; phase 1 adds those of
# the default factor 2 (256 and 1,024).
MOE_FACTOR = MOE_E / MOE_K
MOE_STEP_TOKENS = (8, 8 * 256, B * L0)
# Free-running prefill logits may drift from the golden by at most this
# multiple of the drift of a witness: the golden's dense attention with P
# rounded to bf16, as the flash-prefill kernel rounds it.
MOE_DRIFT_MARGIN = 1.5
# Experts no token may pick: leading, consecutive and trailing empties.
EMPTY_EXPERTS = (0, 1, 5, 6, 7, 126, 127)
MOE_GEN, MOE_LAYERS_CHECKED = 32, (0, 24)

# Phase 5: bench.py's one-chip overlap arms at Qwen3-32B TP=8 per-rank
# width (bench.py:100, :2725-2737, :2659-2661): AG-GEMM (M, K) x (K, N),
# GEMM-RS (M, K_RS) x (K_RS, N_RS), 8 segments.
AG_M, AG_K, AG_N = 4096, 5120, 3200
RS_K, RS_N = 3200, 5120
SEGMENTS = 8
# overlap_cols of the JAX package's auto rule at this shape (its tail block
# 640: _split_blocks, _auto_overlap_cols), and the pinned split.
JAX_SPLIT_COLS, PINNED_COLS = 640, 128
OVERLAP_COLS_SWEEP = (128, 640, 1280, 1920, 3200)
DECOMPOSITION_ROUNDS = 8
TAIL_COL_START = 640
FUSED_S = 0.75
# Every producer item of the loopback held back 1 ms before its copy.
PRODUCER_DELAY_NS = 1_000_000
# Phase 5's kernels; the serving paths of phases 3-3c launch none of them.
OVERLAP_KERNELS = ("ag_gemm_loopback", "matmul_tail_into",
                   "gemm_rs_loopback", "fused_step")

# Phase 6: the collectives on one card. bench.py's M = 128 all-reduce-mode
# MLP arm at Qwen3-32B TP = 8 per-rank shapes (bench.py:2990-3053): x (128,
# 5,120), w_gate_up (5,120, 6,400), w_down (3,200, 5,120), a one-shot
# all-reduce loopback at world 8; its EP all-to-all dispatch arm
# (:2763-2804): (8, 128, 7,168) fp8 tokens and (8, 128, 128) f32 scales,
# capacity 128, chunk_rows 128, world 8, full occupancy (and 13 rows a slot,
# ~10%, beside it); the notify/wait tutorial at world 8 (chunks of (4, 128)
# f32, 4 a rank: tutorials/01-distributed-notify-wait.py:54-55) and a long
# run of 256 chunks of (64, 128) that reuses each queue slot 128 times.
AR_M, AR_D, AR_FF, AR_WORLD = 128, 5120, 3200, 8
A2A_WORLD, A2A_CAP, A2A_HIDDEN, A2A_SCALE_COLS = 8, 128, 7168, 128
A2A_LOW_COUNT = 13
A2A_RAGGED_COUNTS, A2A_RAGGED_CHUNK = [0, 1, 7, 8, 9, 64, 127, 128], 8
TUTORIAL_SHAPE, TUTORIAL_CHUNK = (8, 16, 128), 4
LONG_RUN_SHAPE, LONG_RUN_CHUNK = (8, 256 * 64, 128), 64
ODD_RANK_DELAY_NS = 50_000
COLLECTIVE_KERNELS = ("oneshot_ar_loopback", "a2a_loopback", "notify_wait")
# Calls of a captured CUDA graph replayed, and eager calls back to back, in
# the self-resetting collectives' checks (phases 6 and 10).
REPLAYS = 100
# The all-reduce loopback's bars at bench.py's shape: events at most this
# multiple of x.mul(8) in the same run, and its device time at most this
# (reported, not gated).
AR_LOOPBACK_BAR, AR_LOOPBACK_DEVICE_BAR_MS = 1.5, 0.010

# Phase 7: tensor-parallel Qwen3 at world 8 on one card. The kernels at
# bench.py's Qwen3-32B TP=8 shapes with all 8 ranks: AG-GEMM a (8, 512,
# 5,120), b (8, 5,120, 3,200); GEMM-RS a (8, 4,096, 3,200), b (8, 3,200,
# 5,120); the all-reduces at (8, 128, 5,120) bf16 (bench.py's M = 128 arm);
# each also at m = 1 (two-shot: m = world, the least that splits) and at an
# f32 size. The slice: Engine.serve of Qwen3-32B at full width and depth,
# 8 prompts of 1,024 tokens + 32 new, max_length 1,056.
TP_WORLD = 8
TP_AG = (512, 5120, 3200)        # m, K, n_local per rank
TP_RS = (4096, 3200, 5120)       # M, k_local, N per rank
TP_AR = (128, 5120)
TP_B, TP_L0, TP_GEN, TP_MAXLEN = 8, 1024, 32, 1056
TP_KERNELS = ("ag_gemm", "gemm_rs", "oneshot_ar", "twoshot_ar")

# Phase 8: expert-parallel Qwen3-30B-A3B at world 4 on one card (its 4 kv
# heads do not split over 8). A prefill of 4 x 2,048 tokens is 2,048 a
# rank, 16,384 (token, expert) pairs: at the served factor (MOE_FACTOR)
# the dispatch capacity per rank pair is all 16,384 of them
# (MoEMLP._capacities) and a decode step's (one token a rank) is 8; the
# expert grids are (4 x 32, 8,192) at prefill. The exchange carries bf16
# tokens of 2,048 and int32 expert ids, dispatch and combine in each MoE
# layer. The attention half reuses phase 7's kernels at new shapes: AG-GEMM
# a (4, 2,048, 2,048) x b (4, 2,048, 1,280) (8 query heads and one kv head a
# rank), GEMM-RS (4, 8,192, 1,024) x (4, 1,024, 2,048), both at m = 1 too.
EP_WORLD = 4
EP_PREFILL_CAP, EP_DECODE_CAP = 16384, 8
EP_AG = (2048, 2048, 1280)      # m, K, n_local per rank
EP_RS = (8192, 1024, 2048)      # M, k_local, N per rank
EP_KERNELS = ("ep_a2a",)
# Per (src, dst) rank pair of a prefill: full, zero and partial counts, a
# row of the balanced router's 4,096 (16,384 pairs over 4 ranks).
EP_COUNTS = [[16384, 0, 4099, 1], [4096, 4096, 4096, 4096],
             [0, 0, 0, 16384], [7, 8, 9, 4095]]
EP_BALANCED = [[4096] * 4] * 4
EP_DECODE_COUNTS = [[8, 0, 1, 2], [2, 2, 2, 2], [0, 0, 0, 8], [1, 3, 5, 7]]

# Phase 9: the MoE tensor-parallel pipeline (ag_moe_mlp_device) at world 8
# and Qwen3-30B-A3B's width (models/config.py:83-86: d 2,048, 128 experts,
# top-8, moe_d_ff 768, so f_local 96 a rank): a prefill of 8,192 tokens
# (phases 3c and 8's 4 x 2,048), 1,024 a rank, at capacity 128 (twice the
# mean 64 tokens of one (source, expert)), and a decode of 32 tokens (4 a
# rank) at capacity 8 (no drop is possible: a token's 8 ids are distinct).
# The reduce-scatter at a Qwen3-32B TP = 8 layer's partial output: (8,
# 8,192, 5,120) bf16 at prefill (8 x 1,024 tokens) and (8, 128, 5,120) at
# decode, and an f32 case.
MT_WORLD = 8
MT_PREFILL = (1024, 128)           # tokens a rank, capacity
MT_DECODE = (4, 8)
MT_RS_PREFILL, MT_RS_DECODE, MT_RS_F32 = (8192, 5120), (128, 5120), (1000,
                                                                     384)
MT_GOLDEN_TOKENS = 256             # prefill tokens held against the golden
MT_KERNELS = ("ag_group_gemm", "group_gemm_rs", "oneshot_rs", "ring_rs")
# Phases 5-9's kernels: the world-1 serving paths launch none of them.
# Phase 10: sequence parallelism at world 8 on one card, at Qwen3-32B's
# attention width (models/config.py:67: 64 query heads, 8 kv heads, head_dim
# 128). The allgathers at the TP = 8 activations, the counterpart of phase
# 9's reduce-scatter: a rank's (1,024, 5,120) prefill shard and (16, 5,120)
# decode one. SP decode: B = 4 (phase 3's decode batch) over a global cache
# of 32,768 positions (Qwen3-32B's native context), 4,096 a rank, at kv_len
# 30,000 and 20,000 (ranks 5-7 then own nothing); its partials are 4 x 64
# rows of decode_partial_feat(128) = 256 f32 a rank. SP prefill: 8 x 4,096
# = 32,768 tokens, causal; the golden covers SP_GOLDEN_HEADS; the lse is
# held on a non-causal run of SP_LSE_M rows a rank.
SP_WORLD = 8
SP_HQ, SP_HKV, SP_DH = 64, 8, 128
SP_AG = {"prefill": (1024, 5120), "decode": (16, 5120)}
SP_B, SP_CTX = 4, 32768
SP_KV_LENS = (30000, 20000)
SP_LL_STEPS = 3
SP_LL_EPOCHS = (0, 1, 2, 3, 4, 0)       # five epochs, then a restart
LL_B2B_CALLS = 100
SP_M = 4096
SP_GOLDEN_HEADS = (0, 37)
SP_LSE_M = 512
SP_KERNELS = ("ring_ag", "a2a_ag", "ll_allgather", "sp_ag_attn")
# The ring allgather's bars at the decode shape: events at most this
# multiple of the library's copy in the same run, device time at most this
# (reported, not gated).
RING_DECODE_BAR, RING_DECODE_DEVICE_BAR_MS = 1.6, 0.012
NOT_SERVED = dict.fromkeys(OVERLAP_KERNELS + COLLECTIVE_KERNELS + TP_KERNELS
                           + EP_KERNELS + MT_KERNELS + SP_KERNELS, 0)


def say(*parts):
    print(*parts, flush=True)


def free_card() -> None:
    """Return the memory of dropped engines to the card. An engine and its
    steps hold reference cycles, so ``del`` alone leaves their weights and
    pools allocated until the cyclic collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_close(name, got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{name}: {m}")
    return (got.float() - want.float()).abs().max().item()


class Timer:
    """Mean device time of one call: CUDA events around each launch, the
    L2 cache flushed before each (a 256 MB write), after warm-up."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def check_close_scaled(name, got, want, rel=1e-5):
    """f32 outputs of long sums whose terms do not shrink with K (the fused
    step: s = 0.75 rides on every one of its 5,120 terms, so outputs reach
    ~250 and cancel to ~0 elsewhere): max |got - want| <= rel x max |want|,
    the scale at which two f32 summation orders differ."""
    diff = (got.float() - want.float()).abs().max().item()
    bar = rel * want.float().abs().max().item()
    if not diff <= bar:
        raise AssertionError(f"{name}: max |diff| {diff:.4g} > {bar:.4g} "
                             f"({rel:g} x max |want|)")
    return diff


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for bf16 work on the tensor
    cores (the port's perf model, from the card's published peaks)."""
    from triton_distributed_tpu_torch.runtime.perf_model import (
        bound_seconds)

    t, by = bound_seconds(flops, nbytes)
    return t * 1e3, by


def randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    x = torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


# -- phase 1 -----------------------------------------------------------------

def phase_kernels(gen, tg, tsp):
    err = {"matmul": 0.0, "flash_prefill": 0.0, "flash_decode": 0.0}
    inputs = {}
    for name, (M, K, N) in PROJECTIONS.items():
        a = randn(gen, M, K)
        b = randn(gen, K, N, scale=K ** -0.5)
        e = check_close(f"matmul {name}", tg.matmul_cuda(a, b),
                        tg.matmul_ref(a, b), torch.bfloat16)
        err["matmul"] = max(err["matmul"], e)
        inputs[f"matmul_{name}"] = (a, b)
        say(f"phase 1: matmul {name} ({M}x{K})x({K}x{N}) bf16 "
            f"max_abs_err={e:.4g}")
    a, b = randn(gen, 300, 200, dtype=torch.float32), randn(
        gen, 200, 333, dtype=torch.float32)
    e = check_close("matmul fp32", tg.matmul_cuda(a, b), tg.matmul_ref(a, b),
                    torch.float32)
    say(f"phase 1: matmul (300x200)x(200x333) fp32 max_abs_err={e:.4g}")

    q = randn(gen, B, L0, HQ, DH)
    k = randn(gen, B, S, HKV, DH)
    v = randn(gen, B, S, HKV, DH)
    k[:, L0:] = float("nan")
    v[:, L0:] = float("nan")
    out = tsp.flash_prefill(q, k, v, offset=0)
    assert torch.isfinite(out).all(), "flash prefill let the NaN tail in"
    e = check_close("flash_prefill", out, tsp.flash_prefill_ref(q, k, v,
                                                                offset=0),
                    torch.bfloat16)
    err["flash_prefill"] = e
    inputs["flash_prefill"] = (q, k, v)
    say(f"phase 1: flash_prefill B={B} L={L0} Hq={HQ} Hkv={HKV} dh={DH} "
        f"S={S} offset 0, NaN tail bf16 max_abs_err={e:.4g}")
    one_wgmma_op("phase 1: flash_prefill", PREFILL_WGMMA,
                 lambda: tsp.flash_prefill(q, k, v, offset=0))
    sass_count("phase 1", PREFILL_WGMMA, "HGMMA")

    off = VARLEN["offset"]
    lens = torch.tensor(VARLEN["seq_lens"], dtype=torch.int32, device="cuda")
    kv2, vv2 = randn(gen, B, S, HKV, DH), randn(gen, B, S, HKV, DH)
    for row, n in enumerate(VARLEN["seq_lens"]):
        kv2[row, off + n:] = float("nan")
        vv2[row, off + n:] = float("nan")
    out = tsp.flash_prefill(q, kv2, vv2, offset=off, seq_lens=lens)
    assert torch.isfinite(out).all(), "varlen prefill let NaN in"
    for row, n in enumerate(VARLEN["seq_lens"]):
        assert (out[row, n:] == 0).all(), "padding rows must be exact zeros"
    e = check_close("flash_prefill varlen", out, tsp.flash_prefill_ref(
        q, kv2, vv2, offset=off, seq_lens=lens), torch.bfloat16)
    err["flash_prefill"] = max(err["flash_prefill"], e)
    say(f"phase 1: flash_prefill varlen offset {off} seq_lens "
        f"{VARLEN['seq_lens']} NaN tails bf16 max_abs_err={e:.4g}")
    qs, ks, vs = (randn(gen, 2, 37, 8, 128, dtype=torch.float32),
                  randn(gen, 2, 96, 4, 128, dtype=torch.float32),
                  randn(gen, 2, 96, 4, 128, dtype=torch.float32))
    e = check_close("flash_prefill fp32",
                    tsp.flash_prefill(qs, ks, vs, offset=11),
                    tsp.flash_prefill_ref(qs, ks, vs, offset=11),
                    torch.float32)
    say(f"phase 1: flash_prefill fp32 small max_abs_err={e:.4g}")

    qd = randn(gen, B, HQ, DH)
    kv_len = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device="cuda")
    kd, vd = randn(gen, B, S, HKV, DH), randn(gen, B, S, HKV, DH)
    for row, n in enumerate(DECODE_KV_LENS):
        kd[row, n:] = float("nan")
        vd[row, n:] = float("nan")
    inputs["flash_decode"] = (qd, kd, vd, kv_len)
    for layout in ("bshd", "bhsd"):
        kk, vv = ((kd, vd) if layout == "bshd" else
                  (kd.transpose(1, 2).contiguous(),
                   vd.transpose(1, 2).contiguous()))
        o, lse = tsp.flash_decode_local(qd, kk, vv, kv_len=kv_len,
                                        kv_layout=layout)
        ro, rlse = tsp.flash_decode_ref(qd, kk, vv, kv_len=kv_len,
                                        kv_layout=layout)
        e = max(check_close(f"flash_decode {layout} out", o, ro,
                            torch.float32),
                check_close(f"flash_decode {layout} lse", lse, rlse,
                            torch.float32))
        err["flash_decode"] = max(err["flash_decode"], e)
        say(f"phase 1: flash_decode {layout} B={B} S={S} kv_len "
            f"{DECODE_KV_LENS} bf16 in, f32 out max_abs_err={e:.4g}")
    torch.cuda.synchronize()
    return err, inputs


def paged_case(gen, quantize, *, L, kv_lens, q_lens, dead, kv,
               heads=(PAGED["Hq"], PAGED["Hkv"])):
    """Operands of ``paged_attention`` on the card: a shuffled pool with
    NaN in every block no live table reaches (NaN scales for int8/fp8),
    the dead slot's stale table naming live blocks, bf16 queries."""
    (Hq, Hkv), dh, bs, mb = heads, PAGED["dh"], PAGED["bs"], PAGED[
        "max_blocks"]
    B = len(kv_lens)
    n_blocks = B * mb + 3
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator()
                          .manual_seed(L)) + 1
    tables = torch.zeros((B, mb), dtype=torch.int32)
    reached = torch.zeros(n_blocks, dtype=torch.bool)
    for b, n_tok in enumerate(kv_lens):
        n = math.ceil(n_tok / bs)
        rows = perm[:n] if b in dead else perm[b * mb:b * mb + n]
        tables[b, :n] = rows
        if b not in dead:
            reached[rows] = True
    unreached = (~reached).cuda()
    k = randn(gen, n_blocks, bs, Hkv, dh, dtype=torch.float32)
    v = randn(gen, n_blocks, bs, Hkv, dh, dtype=torch.float32)
    c = dict(q=randn(gen, B, L, Hq, dh), block_tables=tables.cuda(),
             kv_lens=torch.tensor(kv_lens, dtype=torch.int32, device="cuda"),
             q_lens=torch.tensor(q_lens, dtype=torch.int32, device="cuda"),
             slot_mask=torch.tensor([b not in dead for b in range(B)],
                                    device="cuda"))
    if kv is None:
        k[unreached] = float("nan")
        v[unreached] = float("nan")
        c.update(k_pool=k.bfloat16(), v_pool=v.bfloat16())
    else:
        (kq, ks), (vq, vs) = quantize(k, WIRE[kv]), quantize(v, WIRE[kv])
        ks[unreached] = float("nan")
        vs[unreached] = float("nan")
        c.update(k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs)
    return c


def check_paged(label, tpa, c, name, geo):
    """One paged case against the plain version: live rows finite,
    padding rows zero, each live slot within its bar."""
    live = [b for b in range(8) if b not in geo["dead"]]
    got = tpa.paged_attention(**c)
    want = tpa.paged_attention_ref(**c)
    torch.cuda.synchronize()
    if not torch.isfinite(got[live]).all():
        raise AssertionError(f"{label}: NaN reached a live row")
    for b in live:
        if not (got[b, geo["q_lens"][b]:] == 0).all():
            raise AssertionError(f"{label}: padding rows of slot {b} are "
                                 f"not zeros")
    return check_slots(label, got, want, live, PAGED_SLOT_TOL[name])


def device_ops(fn, name: str = "", n: int = 10) -> list[str]:
    """Names of the device operations (kernels, memsets, copies) whose name
    holds ``name`` that n calls of fn make, by torch.profiler, after a
    warm-up call. The profiler may still drop records, some or all of a
    session's, so a session that recorded none is run again, at most three
    times in all, and a caller checks what was recorded (each operation one
    it expects, no more than the n calls can make), not an exact count:
    ``captured_ops`` counts exactly."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ops = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and name in ev.name]
        if ops:
            break
    return ops


# CUgraphNodeType values (cuda.h) that name a device operation.
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _kernel_node_name(cu, node) -> str:
    """The kernel's (mangled) name of a captured kernel node, by libcuda's
    cuFuncGetName (CUDA 12.3 and later); '?' where libcuda cannot say."""
    par = _KernelNodeParams()
    if cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(par)):
        return "?"
    func = ctypes.c_void_p(par.func)
    if not par.func and par.kern:
        if cu.cuKernelGetFunction(ctypes.byref(func),
                                  ctypes.c_void_p(par.kern)):
            return "?"
    name = ctypes.c_char_p()
    if not func.value or cu.cuFuncGetName(ctypes.byref(name), func):
        return "?"
    return name.value.decode()


def captured_ops(fn) -> list[str]:
    """The device operations one call of fn enqueues, exactly: the call is
    captured into a CUDA graph (relaxed mode, on a side stream that ran fn
    once first, so its per-stream buffers exist) and never replayed; one
    entry a node, "kernel <name>", "memcpy", "memset" or "node type <n>"
    for any other node. Unlike torch.profiler's records, none is lost."""
    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    raw = ctypes.c_void_p(side.cuda_stream)
    graph = ctypes.c_void_p()
    if cu.cuStreamBeginCapture_v2(raw, 2):  # CU_STREAM_CAPTURE_MODE_RELAXED
        raise RuntimeError("cuStreamBeginCapture failed")
    try:
        with torch.cuda.stream(side):
            fn()
    finally:
        err = cu.cuStreamEndCapture(raw, ctypes.byref(graph))
    if err:
        raise RuntimeError(f"cuStreamEndCapture failed: CUresult {err}")
    try:
        n = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * max(n.value, 1))()
        if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        ops = []
        for node in nodes[:n.value]:
            kind = ctypes.c_int(-1)
            if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)):
                raise RuntimeError("cuGraphNodeGetType failed")
            label = GRAPH_NODE_KINDS.get(kind.value,
                                         f"node type {kind.value}")
            if kind.value == 0:
                label += " " + _kernel_node_name(cu, ctypes.c_void_p(node))
            ops.append(label)
        return ops
    finally:
        cu.cuGraphDestroy(graph)


def one_wgmma_op(label: str, kernel: str, fn) -> None:
    """One call of fn is one device operation, a launch of ``kernel``
    (its captured CUDA graph: no memset, no copy, no other kernel)."""
    ops = captured_ops(fn)
    if len(ops) != 1 or kernel not in ops[0]:
        raise AssertionError(f"{label}: a call enqueued {ops}, not one "
                             f"{kernel}")
    say(f"{label}: one device operation a call, {kernel} (its captured "
        f"CUDA graph)")


def graph_replays(label: str, fn, x, fresh, ref, n: int = REPLAYS) -> int:
    """One call fn(x) captured into a CUDA graph (on a side stream that ran
    it once first, so its plan, its arrival cells and its scratch exist)
    and replayed n times, fresh(i) copied into x before replay i: every
    result must be ref(x)'s bits. Returns the side stream's handle, whose
    arrival cells the caller checks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn(x)
    for i in range(n):
        x.copy_(fresh(i))
        graph.replay()
        if not torch.equal(out, ref(x)):
            raise AssertionError(f"{label}: replay {i} of {n} of a captured "
                                 f"call differs from the plain version")
    torch.cuda.synchronize()
    return side.cuda_stream


def cells_at_zero(label: str, signal, name: str, streams) -> None:
    """Every arrival cell of ``name`` on each stream (handles) exists and
    is 0."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for stream in streams:
        cells = signal._ARRIVALS.get((dev, stream, name))
        if cells is None:
            raise AssertionError(f"{label}: no arrival cells of {name} on "
                                 f"stream {stream}")
        if cells.any():
            raise AssertionError(f"{label}: {int(cells.count_nonzero())} "
                                 f"arrival cells of {name} are not 0")


# The wgmma kernels of the dense flash prefill (bf16 at head_dim 128) and
# of the AG-GEMM loopback's tiles at phase 5's shapes.
PREFILL_WGMMA = "flash_prefill_wgmma_kernel"
LOOPBACK_WGMMA = "ag_loopback_kernel_wgmma"
# The warp-specialised matmul (bf16 whose rows TMA reads) and the GEMM-RS
# loopback's wgmma items.
MATMUL_WS = "matmul_ws_kernel"
RS_LOOPBACK_WGMMA = "gemm_rs_loopback_kernel_wgmma"
# The matmul's bar: the four projections together, and phase 5's two bare
# matmuls, at most this multiple of torch.matmul by events; the GEMM-RS
# loopback's: at most this multiple of torch.addbmm.
MATMUL_BAR, RS_LOOPBACK_BAR = 1.5, 2.0
# The tensor-core kernel of each pool's mixed step (bf16 q at head_dim 128).
MIXED_KERNEL = {None: "flash_prefill_mma_kernel",
                "int8": "flash_prefill_mma_q8_kernel",
                "fp8": "flash_prefill_mma_q8_kernel"}


def phase_paged_kernel(gen, tpa, quantize):
    err, inputs = 0.0, {}
    for name, geo in PAGED_CASES.items():
        for kv in POOLS:
            c = paged_case(gen, quantize, kv=kv, **geo)
            e, worst = check_paged(f"paged_attention {name} {kv}", tpa, c,
                                   name, geo)
            err = max(err, e)
            inputs[(name, kv)] = c
            if geo["L"] > 1:
                run = lambda: tpa.paged_attention(**c)
                cap = [op for op in captured_ops(run)
                       if "flash_prefill" in op]
                ran = device_ops(run, "flash_prefill")
                if (len(cap) != 1 or MIXED_KERNEL[kv] not in cap[0]
                        or len(ran) > 10
                        or any(MIXED_KERNEL[kv] not in op for op in ran)):
                    raise AssertionError(
                        f"phase 1: a {kv or 'bf16'} mixed step enqueued the "
                        f"prefill kernels {cap} (captured graph), 10 ran "
                        f"{ran} (torch.profiler), not one "
                        f"{MIXED_KERNEL[kv]} each")
                say(f"phase 1: paged_attention {name} {kv or 'bf16'} pool "
                    f"runs {MIXED_KERNEL[kv]} (one launch in its captured "
                    f"graph; torch.profiler recorded {len(ran)} of 10)")
                if kv == "int8":
                    sass_count("phase 1", MIXED_KERNEL[kv], "HMMA")
            say(f"phase 1: paged_attention {name} L={geo['L']} kv_lens "
                f"{geo['kv_lens']} q_lens {geo['q_lens']} dead "
                f"{list(geo['dead'])}, {kv or 'bf16'} pool, bf16 q: "
                f"max_abs_err={e:.4g}, worst slot's max err / max |want| "
                f"{worst:.4g} (bar {PAGED_SLOT_TOL[name]})")
    return err, inputs


def phase_gqa8(gen, tsp, tpa):
    """The three attention kernels at Qwen3-30B-A3B's heads: 32 query heads
    over 4 kv heads (a GQA group of 8), head_dim 128."""
    Hq, Hkv = GQA8["Hq"], GQA8["Hkv"]
    err = {}
    q = randn(gen, 2, L0, Hq, DH)
    k, v = randn(gen, 2, S, Hkv, DH), randn(gen, 2, S, Hkv, DH)
    k[:, L0:] = float("nan")
    v[:, L0:] = float("nan")
    out = tsp.flash_prefill(q, k, v, offset=0)
    if not torch.isfinite(out).all():
        raise AssertionError("flash prefill (GQA 8) let the NaN tail in")
    err["flash_prefill"] = check_close(
        "flash_prefill GQA 8", out, tsp.flash_prefill_ref(q, k, v, offset=0),
        torch.bfloat16)
    say(f"phase 1: flash_prefill GQA 8: B=2 L={L0} Hq={Hq} Hkv={Hkv} "
        f"dh={DH} S={S}, NaN tail, bf16 max_abs_err="
        f"{err['flash_prefill']:.4g}")
    one_wgmma_op("phase 1: flash_prefill GQA 8", PREFILL_WGMMA,
                 lambda: tsp.flash_prefill(q, k, v, offset=0))
    del q, k, v, out
    qd = randn(gen, B, Hq, DH)
    kd, vd = randn(gen, B, S, Hkv, DH), randn(gen, B, S, Hkv, DH)
    for row, n in enumerate(DECODE_KV_LENS):
        kd[row, n:] = float("nan")
        vd[row, n:] = float("nan")
    kv_len = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device="cuda")
    o, lse = tsp.flash_decode_local(qd, kd, vd, kv_len=kv_len,
                                    kv_layout="bshd")
    ro, rlse = tsp.flash_decode_ref(qd, kd, vd, kv_len=kv_len,
                                    kv_layout="bshd")
    err["flash_decode"] = max(
        check_close("flash_decode GQA 8 out", o, ro, torch.float32),
        check_close("flash_decode GQA 8 lse", lse, rlse, torch.float32))
    say(f"phase 1: flash_decode GQA 8: B={B} Hq={Hq} Hkv={Hkv} kv_len "
        f"{DECODE_KV_LENS} bshd, bf16 in, f32 out max_abs_err="
        f"{err['flash_decode']:.4g}")
    err["paged_attention"] = 0.0
    for name, geo in PAGED_CASES.items():
        c = paged_case(gen, None, kv=None, heads=(Hq, Hkv), **geo)
        e, worst = check_paged(f"paged_attention GQA 8 {name}", tpa, c,
                               name, geo)
        err["paged_attention"] = max(err["paged_attention"], e)
        say(f"phase 1: paged_attention GQA 8 {name}: Hq={Hq} Hkv={Hkv}, "
            f"bf16 pool: max_abs_err={e:.4g}, worst slot's max err / max "
            f"|want| {worst:.4g} (bar {PAGED_SLOT_TOL[name]})")
    return err


def moe_caps(MoEMLP, factor: float) -> dict:
    """{grid capacity: tokens} of the steps of ``MOE_STEP_TOKENS`` at
    Qwen3-30B-A3B's widths and capacity ``factor``, sized by the port's own
    ``MoEMLP._capacities``."""
    mlp = MoEMLP(d_model=MOE_D, d_ff=MOE_FF, n_experts=MOE_E, topk=MOE_K,
                 capacity_factor=factor)
    return {mlp._capacities(n)[1]: n for n in MOE_STEP_TOKENS}


class CapacitySpy:
    """Records the grid capacity of every grouped-GEMM call the MoE path
    makes while active (the launch counts stay the wrapper's own)."""

    def __init__(self, tmu):
        self.tmu, self.real, self.caps = tmu, tmu.grouped_gemm_skip, set()

    def __enter__(self):
        def spy(grouped, *args, **kw):
            self.caps.add(grouped.shape[1])
            return self.real(grouped, *args, **kw)

        self.tmu.grouped_gemm_skip = spy
        return self

    def __exit__(self, *exc):
        self.tmu.grouped_gemm_skip = self.real

    def check(self, label, held):
        say(f"{label}: grouped GEMM capacities served {sorted(self.caps)}, "
            f"held against the plain version in phase 1 {sorted(held)}")
        if not self.caps <= set(held):
            raise AssertionError(f"{label}: capacities "
                                 f"{sorted(self.caps - set(held))} were "
                                 f"served but not held in phase 1")


def moe_counts(cap: int, tokens: int) -> torch.Tensor:
    """Rows per expert of a seeded top-8 routing of ``tokens`` tokens over
    128 experts that never picks one of ``EMPTY_EXPERTS``, clamped to
    ``cap`` (what ``route_to_experts`` gives the grouped GEMM)."""
    g = torch.Generator(device="cuda").manual_seed(cap)
    scores = torch.rand(tokens, MOE_E, generator=g, device="cuda")
    scores[:, list(EMPTY_EXPERTS)] = -1.0
    ids = torch.topk(scores, MOE_K, dim=-1).indices.reshape(-1)
    counts = torch.bincount(ids, minlength=MOE_E)
    return torch.clamp(counts, max=cap).to(torch.int32)


def grouped_case(counts, cap, d, f, dtype=torch.bfloat16, n_layers=None,
                 seed=0):
    """Operands of the grouped GEMM: ``x`` (E, cap, d) with NaN in every row
    past its expert's count, ``x_clean`` the same with those rows zero (what
    the grid contract says they hold: the plain version's input), and
    weights (E, d, f), or (n_layers, E, d, f), with NaN in every weight of
    an empty expert."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E = counts.shape[0]
    past = (torch.arange(cap, device="cuda")[None, :]
            >= counts[:, None])[..., None]
    x_clean = randn(gen, E, cap, d, dtype=dtype).masked_fill(past, 0.0)
    x = x_clean.masked_fill(past, float("nan"))
    lead = () if n_layers is None else (n_layers,)
    w = randn(gen, *lead, E, d, f, dtype=dtype, scale=d ** -0.5)
    w[..., counts == 0, :, :] = float("nan")
    return x, x_clean, w


def check_grouped(label, tmu, counts, x, x_clean, w, layer_idx=None):
    got = tmu.grouped_gemm_skip(x, w, counts, layer_idx=layer_idx)
    want = tmu.grouped_gemm_skip_ref(x_clean, w, counts, layer_idx=layer_idx)
    torch.cuda.synchronize()
    cap = x.shape[1]
    past = torch.arange(cap, device="cuda")[None, :] >= counts[:, None]
    err = 0.0
    # 16 experts at a time: the f32 copies of a whole (128, 8,192, 2,048)
    # output would not fit beside it.
    for e in range(0, x.shape[0], 16):
        g = got[e:e + 16]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: NaN of an unread row or weight "
                                 f"reached the output")
        if not ((g[counts[e:e + 16] == 0] == 0).all()
                and (g[past[e:e + 16]] == 0).all()):
            raise AssertionError(f"{label}: an empty expert or a row past "
                                 f"its count is not exactly zero")
        err = max(err, check_close(label, g, want[e:e + 16], x.dtype))
    return err


def phase_grouped_gemm(tmu, caps):
    """The grouped GEMM against its plain version at Qwen3-30B-A3B's expert
    shapes and the steps' capacities ``caps`` ({capacity: tokens})."""
    err = 0.0
    for cap, tokens in sorted(caps.items()):
        counts = moe_counts(cap, tokens)
        n_live = int((counts > 0).sum())
        for name, (d, f) in GROUPED.items():
            x, x_clean, w = grouped_case(counts, cap, d, f, seed=cap + d)
            e = check_grouped(f"grouped_gemm {name} cap {cap}", tmu, counts,
                              x, x_clean, w)
            err = max(err, e)
            say(f"phase 1: grouped_gemm {name} E={MOE_E} cap={cap} d={d} "
                f"f={f} bf16, {tokens} tokens x top-{MOE_K} -> {n_live} "
                f"non-empty experts, {int(counts.sum())} rows: "
                f"max_abs_err={e:.4g}, empty experts and rows past counts "
                f"exactly 0, NaN never read")
            del x, x_clean, w
    counts = moe_counts(16, 8)
    d, f = GROUPED["down"]
    x, x_clean, w = grouped_case(counts, 16, d, f, n_layers=3, seed=1)
    e = check_grouped("grouped_gemm stacked", tmu, counts, x, x_clean, w,
                      layer_idx=2)
    err = max(err, e)
    say(f"phase 1: grouped_gemm stacked (3, {MOE_E}, {d}, {f}) layer_idx 2 "
        f"cap 16 bf16: max_abs_err={e:.4g}")
    del x, x_clean, w
    counts = torch.tensor([0, 0, 3, 0, 40, 17, 0, 0], dtype=torch.int32,
                          device="cuda")
    x, x_clean, w = grouped_case(counts, 40, 72, 136, dtype=torch.float32,
                                 seed=2)
    e = check_grouped("grouped_gemm fp32", tmu, counts, x, x_clean, w)
    err = max(err, e)
    say(f"phase 1: grouped_gemm fp32 E=8 cap=40 d=72 f=136 counts "
        f"{counts.tolist()}: max_abs_err={e:.4g}")
    return err


def check_slots(name, got, want, live, frac):
    """Hold each live slot at ``frac`` of its own max |want|; returns the
    max abs error and the worst slot's ratio."""
    err, worst = 0.0, 0.0
    for b in live:
        d = (got[b].float() - want[b].float()).abs().max().item()
        top = want[b].float().abs().max().item()
        if d > frac * top:
            raise AssertionError(f"{name}: slot {b} max |diff| {d:.4g} > "
                                 f"{frac} x max |want| {top:.4g}")
        err, worst = max(err, d), max(worst, d / top if top else 0.0)
    return err, worst


# -- phase 2 -----------------------------------------------------------------

def phase_small_engines(Engine, BatchEngine, ModelConfig, kernels):
    configs = {
        "tiny": ("tiny", {}),
        "dh128": ("tiny", dict(d_model=256, n_heads=4, n_kv_heads=2,
                               head_dim=128, d_ff=512, vocab_size=512,
                               max_length=64, tie_embeddings=True)),
        # Capacities roomy enough for no drops: dist == xla needs them, and
        # BatchEngine routes its padding rows too.
        "tiny-moe": ("tiny-moe", dict(moe_capacity_factor=64.0)),
    }
    for name, (preset, overrides) in configs.items():
        cfg = ModelConfig.from_name(preset, **overrides)
        ids = torch.randint(0, cfg.vocab_size, (8, 8), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(5), dtype=torch.int32)
        dist = Engine(cfg, mode="dist", device="cuda", seed=3)
        xla = Engine(cfg, mode="xla", device="cuda", params=dist.params)
        kernels.reset_counts()
        got = dist.serve(ids, 6)
        counts = {k: v.launches for k, v in kernels.KERNELS.items()}
        want = xla.serve(ids, 6)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 2 {name}: dist tokens {got.tolist()}"
                                 f" != xla tokens {want.tolist()}")
        used = SLICE1_KERNELS + (("grouped_gemm",) if cfg.n_experts else ())
        if min(counts[k] for k in used) == 0:
            raise AssertionError(f"phase 2 {name}: a kernel never launched "
                                 f"{counts}")
        say(f"phase 2: {name} fp32 B=8 L0=8 gen 6: dist == xla tokens, "
            f"launches {counts}")
        small_serving(name, dist, BatchEngine, kernels)
        if not cfg.n_experts:
            small_ar(name, Engine(cfg, mode="ar", device="cuda",
                                  params=dist.params), ids, want,
                     BatchEngine, kernels)


def small_ar(name, ar, ids, want, BatchEngine, kernels):
    """The all-reduce mode on a small fp32 config: ``Engine(mode="ar")``
    gives the xla tokens through the attention kernels alone (its products
    are ``torch.matmul``), and ``BatchEngine`` over it gives each request's
    per-request ar tokens."""
    kernels.reset_counts()
    got = ar.serve(ids, 6)
    counts = {k: v.launches for k, v in kernels.KERNELS.items()}
    if not torch.equal(got, want):
        raise AssertionError(f"phase 2 {name}: ar tokens {got.tolist()} != "
                             f"xla tokens {want.tolist()}")
    used = {k for k, n in counts.items() if n}
    if used != {"flash_prefill", "flash_decode"}:
        raise AssertionError(f"phase 2 {name}: ar launches {counts}")
    g = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, ar.config.vocab_size, (n,),
                             generator=g).tolist() for n in (7, 9, 5, 6)]
    be = BatchEngine(ar, n_slots=3, n_blocks=8, block_size=4,
                     prefill_chunk=4)
    rids = [be.submit(p, 6) for p in prompts]
    kernels.reset_counts()
    out = be.run(max_steps=500)
    served = {k: v.launches for k, v in kernels.KERNELS.items() if v.launches}
    for rid, p in zip(rids, prompts):
        one = ar.serve(torch.tensor([p], device=ar.device), 6)[0].tolist()
        if out[rid] != one:
            raise AssertionError(f"phase 2 {name}: ar BatchEngine "
                                 f"{out[rid]} != ar Engine {one}")
    if set(served) != {"paged_attention"}:
        raise AssertionError(f"phase 2 {name}: ar BatchEngine launches "
                             f"{served}")
    say(f"phase 2: {name} ar: Engine == xla tokens (launches {used}), "
        f"BatchEngine == per-request ar Engine for 4 requests, "
        f"{be.metrics['preemptions']} preemptions, launches {served}")


def steps_never_sync(name, eng, BatchEngine, prompts):
    """Both serving steps, over an f32 and an int8 pool, run under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing inside a step
    reads a value back to the host (what a CUDA-graph capture needs)."""
    for kv in (None, "int8"):
        be = BatchEngine(eng, n_slots=3, block_size=4, prefill_chunk=4,
                         kv_dtype=kv)
        for p in prompts:
            be.submit(p, 4)
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
    say(f"phase 2: {name} decode and mixed steps (f32 and int8 pools) ran "
        f"with no host read-back")


def small_serving(name, eng, BatchEngine, kernels):
    """fp32 BatchEngine on a small config: per-request Engine tokens
    through chunked prefill and preemption; warm == cold on int8/fp8."""
    g = torch.Generator().manual_seed(9)
    V = eng.config.vocab_size
    prompts = [torch.randint(0, V, (n,), generator=g).tolist()
               for n in (7, 9, 5, 6)]
    be = BatchEngine(eng, n_slots=3, n_blocks=8, block_size=4,
                     prefill_chunk=4)
    rids = [be.submit(p, 6) for p in prompts]
    kernels.reset_counts()
    out = be.run(max_steps=500)
    launches = kernels.KERNELS["paged_attention"].launches
    for rid, p in zip(rids, prompts):
        want = eng.serve(torch.tensor([p], device=eng.device), 6)[0].tolist()
        if out[rid] != want:
            raise AssertionError(f"phase 2 {name}: BatchEngine {out[rid]} != "
                                 f"Engine {want}")
    if be.metrics["preemptions"] == 0 or launches == 0:
        raise AssertionError(f"phase 2 {name}: preemptions "
                             f"{be.metrics['preemptions']}, paged launches "
                             f"{launches}")
    say(f"phase 2: {name} BatchEngine == Engine tokens for 4 requests, "
        f"chunk 4, {be.metrics['preemptions']} preemptions, paged_attention "
        f"launches {launches}")
    steps_never_sync(name, eng, BatchEngine, prompts)
    shared = prompts[1] + prompts[0]
    for kv in ("int8", "fp8"):
        runs = []
        for cache in (False, True):
            be = BatchEngine(eng, n_slots=3, block_size=4, prefill_chunk=4,
                             kv_dtype=kv, prefix_cache=cache)
            first = be.submit(prompts[1] + prompts[2], 4)
            be.run()
            second = be.submit(shared, 4)
            be.run()
            runs.append((be.finished[first].output,
                         be.finished[second].output,
                         be.metrics["prefix_hits"]))
        if runs[0][:2] != runs[1][:2] or runs[1][2] == 0:
            raise AssertionError(f"phase 2 {name} {kv}: warm {runs[1]} != "
                                 f"cold {runs[0]}")
        say(f"phase 2: {name} {kv} pool: warm == cold tokens, prefix hits "
            f"{runs[1][2]}")


# -- phase 3 -----------------------------------------------------------------

def phase_full_width(Engine, ModelConfig, kernels):
    cfg = ModelConfig.from_name("qwen3-1.7b")
    t0 = time.perf_counter()
    eng = Engine(cfg, mode="dist", device="cuda", seed=0)
    torch.cuda.synchronize()
    say(f"phase 3: qwen3-1.7b random init {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ids = torch.randint(0, cfg.vocab_size, (B, L0), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7), dtype=torch.int32)
    eng.serve(ids[:, :128], 2)  # warm-up: kernel library, allocator
    torch.cuda.synchronize()

    kernels.reset_counts()
    t0 = time.perf_counter()
    tokens = eng.serve(ids, GEN)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    expected = {"matmul": 4 * cfg.n_layers, "flash_prefill": cfg.n_layers,
                "flash_decode": cfg.n_layers * (GEN - 1),
                "paged_attention": 0, "grouped_gemm": 0, **NOT_SERVED}
    say(f"phase 3: serve B={B} L0={L0} gen={GEN} launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if tokens.shape != (B, GEN) or tokens.dtype != torch.int32:
        raise AssertionError(f"tokens {tokens.shape} {tokens.dtype}")
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError("token ids out of range")

    t0 = time.perf_counter()
    logits, _ = eng.prefill(ids, eng.new_cache(B))
    first = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    xla = Engine(cfg, mode="xla", device="cuda", params=eng.params)
    x_logits, _ = xla.prefill(ids, xla.new_cache(B))
    if not golden_bars("phase 3: prefill logits dist vs xla", logits,
                       x_logits):
        raise AssertionError("prefill logits disagree with the xla golden")
    if not torch.equal(first.to(torch.int32), tokens[:, 0]):
        say("phase 3: note: first token of serve differs from the re-run "
            "prefill's argmax")
    x_tokens = xla.serve(ids, GEN)
    agree = (x_tokens == tokens).float().mean().item()
    decode_s = max(t_serve - ttft, 1e-9)
    say(f"phase 3: greedy tokens equal to xla's: {100 * agree:.1f}% of "
        f"{B}x{GEN} (information only)")
    say(f"phase 3: TTFT {ttft * 1e3:.2f} ms (prefill of {B}x{L0} + argmax), "
        f"serve {t_serve:.3f} s, decode {B * (GEN - 1) / decode_s:.1f} "
        f"tokens/s ({B} rows), on {card_line()}")
    del xla
    ar_full_width(Engine, cfg, eng, ids, x_logits, kernels)
    del x_logits
    decode_profile(eng, ids)
    return launches, eng


def ar_full_width(Engine, cfg, eng, ids, x_logits, kernels):
    """Phase 3's request through ``Engine(mode="ar")`` on the same weights
    (shared, not copied): the launch counts exact (the products are
    ``torch.matmul``; the attention runs the flash kernels; the world-1
    all-reduce is the identity), the prefill logits held against the xla
    golden with phase 3's bars."""
    ar = Engine(cfg, mode="ar", device="cuda", params=eng.params)
    kernels.reset_counts()
    t0 = time.perf_counter()
    tokens = ar.serve(ids, GEN)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    expected = {"matmul": 0, "flash_prefill": cfg.n_layers,
                "flash_decode": cfg.n_layers * (GEN - 1),
                "paged_attention": 0, "grouped_gemm": 0, **NOT_SERVED}
    say(f"phase 3: ar serve B={B} L0={L0} gen={GEN} launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"ar launch counts {launches} != {expected}")
    if tokens.shape != (B, GEN) or not ((tokens >= 0)
                                        & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"ar tokens {tokens.shape} out of range")
    t0 = time.perf_counter()
    logits, _ = ar.prefill(ids, ar.new_cache(B))
    torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    if not golden_bars("phase 3: ar prefill logits vs xla", logits,
                       x_logits):
        raise AssertionError("ar prefill logits disagree with the xla golden")
    decode_s = max(t_serve - ttft, 1e-9)
    say(f"phase 3: ar TTFT {ttft * 1e3:.2f} ms, serve {t_serve:.3f} s, "
        f"decode {B * (GEN - 1) / decode_s:.1f} tokens/s ({B} rows)")


# -- phase 3b ----------------------------------------------------------------

def serving_prompts(vocab: int) -> list[list[int]]:
    """16 seeded prompts of 256..2,048 tokens; requests 12-15 open with the
    first 1,024 tokens of requests 0-3 (which carry 1,088..1,536)."""
    g = torch.Generator().manual_seed(11)

    def tokens(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    def length(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=g))

    prompts = [tokens(length(SHARED_PREFIX + 64, 1536)) for _ in range(4)]
    prompts += [tokens(length(256, 2048)) for _ in range(8)]
    prompts += [prompts[i][:SHARED_PREFIX] + tokens(length(256, 1024))
                for i in range(4)]
    return prompts


def logits_fused_vs_gather(eng, golden, BatchEngine, prompts, kv):
    """One mixed step (8 rows mid-prefill, after two chunks) through the
    serving step (the paged kernel, the matmul kernel) and through the
    gather oracle of the xla golden (the gathered view, dense attention,
    ``torch.matmul``), each on its own copy of the pool."""
    be = BatchEngine(eng, kv_dtype=kv, **SERVE)
    for p in prompts[:SERVE["n_slots"]]:
        be.submit(p, SERVE_GEN)
    be.step()
    be.step()
    ops = be.mixed_operands()
    quant = be.pool.kv_quant
    logits = {}
    for mode, engine in (("fused", eng), ("gather", golden)):
        st = be.pool.state
        pool = type(st)(*(None if t is None else t.clone()
                          for t in (st.k, st.v, st.k_scale, st.v_scale)))
        step = engine.make_paged_step("prefill", paged_attn=mode,
                                      kv_quant=quant)
        logits[mode] = step(ops[0], pool, *ops[1:])
        if mode == "fused":
            # Where a mixed step's time goes (it rewrites the same rows).
            device_profile("phase 3b", f"{kv or 'bf16'} mixed step, 8 rows "
                           f"x {SERVE['prefill_chunk']} tokens",
                           lambda: step(ops[0], pool, *ops[1:]), 1)
        del pool
    live = ops[-1] > 0
    if not golden_bars(f"phase 3b: {kv or 'bf16'} pool, one mixed step's "
                       f"logits, fused vs gather", logits["fused"][live],
                       logits["gather"][live]):
        raise AssertionError(f"phase 3b {kv}: fused logits disagree with "
                             f"the gather oracle")


def moe_mixed_step(eng, BatchEngine, prompts, phase):
    """One MoE mixed step (8 rows after two chunks): its device profile, and
    the (token, expert) pairs its static capacities drop. Padding rows are
    routed as the JAX stack routes them and take expert capacity."""
    be = BatchEngine(eng, **SERVE)
    for p in prompts[:SERVE["n_slots"]]:
        be.submit(p, SERVE_GEN)
    be.step()
    be.step()
    ids, offsets, tables, mask, seq_lens = be.mixed_operands()
    step = eng.make_paged_step("prefill")
    pool = be.pool.state
    device_profile(phase, f"bf16 mixed step, 8 rows x "
                   f"{SERVE['prefill_chunk']} tokens",
                   lambda: step(ids, pool, offsets, tables, mask, seq_lens),
                   1)
    with torch.inference_mode():
        _, stats = eng.model.forward(
            eng.params, ids, pool.k, pool.v, offsets, mode="dist",
            seq_lens=seq_lens, block_tables=tables, slot_mask=mask,
            return_moe_stats=True)
    say(f"{phase}: that mixed step routes {ids.numel()} rows "
        f"({int(seq_lens.sum())} live): drops summed over layers "
        f"{ {k: int(v) for k, v in stats.items()} }")


def phase_serving(eng, Engine, BatchEngine, kernels, pools=POOLS,
                  phase="phase 3b"):
    """The serving main path at full width, once per pool dtype. A dense
    model's mixed step is held against the gather oracle; an MoE model's
    is profiled and audited for drops."""
    prompts = serving_prompts(eng.config.vocab_size)
    L, moe = eng.config.n_layers, bool(eng.config.n_experts)
    golden = (None if moe else Engine(eng.config, mode="xla",
                                      device=eng.device, params=eng.params))
    tokens, all_launches = {}, {}
    for kv in pools:
        if moe:
            moe_mixed_step(eng, BatchEngine, prompts, phase)
        else:
            logits_fused_vs_gather(eng, golden, BatchEngine, prompts, kv)
        free_card()
        be = BatchEngine(eng, kv_dtype=kv, **SERVE)
        times = {"decode": [], "mixed": []}
        profiled, untimed_tokens = False, 0

        def drive(done):
            nonlocal profiled, untimed_tokens
            while not done():
                dec0 = be.metrics["decode_steps"]
                queue_empty = not len(be.scheduler)
                t0 = time.perf_counter()
                if not be.step():
                    return
                dt = time.perf_counter() - t0
                kind = ("decode" if be.metrics["decode_steps"] > dec0
                        else "mixed")
                times[kind].append(dt)
                if kind == "decode" and queue_empty and not profiled:
                    # The queue is empty and no row prefills: the next step
                    # is a decode step too.
                    profiled = True
                    tok0 = be.metrics["tokens_generated"]
                    device_profile(phase, f"{kv or 'bf16'} decode step",
                                   be.step, 1)
                    untimed_tokens += be.metrics["tokens_generated"] - tok0

        torch.cuda.synchronize()
        kernels.reset_counts()
        rids = [be.submit(p, SERVE_GEN) for p in prompts[:12]]
        drive(lambda: all(r in be.finished for r in rids[:4]))
        rids += [be.submit(p, SERVE_GEN) for p in prompts[12:]]
        drive(lambda: False)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in kernels.KERNELS.items()}
        m = be.metrics
        steps = m["decode_steps"] + m["prefill_steps"]
        expected = {"matmul": (2 if moe else 4) * L * m["prefill_steps"],
                    "grouped_gemm": 2 * L * steps if moe else 0,
                    "flash_prefill": 0, "flash_decode": 0,
                    "paged_attention": L * steps, **NOT_SERVED}
        say(f"{phase}: {kv or 'bf16'} pool: {m['requests_completed']} "
            f"requests, {m['decode_steps']} decode + {m['prefill_steps']} "
            f"mixed steps, launches {launches} (expected {expected})")
        if launches != expected:
            raise AssertionError(f"{phase} {kv}: launch counts {launches} "
                                 f"!= {expected}")
        out = be.finished
        if (sorted(out) != sorted(rids)
                or any(len(out[r].output) != SERVE_GEN for r in rids)):
            raise AssertionError(f"{phase} {kv}: not every request "
                                 f"finished with {SERVE_GEN} tokens")
        if not all(0 <= t < eng.config.vocab_size
                   for r in rids for t in out[r].output):
            raise AssertionError(f"{phase} {kv}: token ids out of range")
        if m["prefix_hits"] == 0:
            raise AssertionError(f"{phase} {kv}: no prefix-cache hit")
        tokens[kv] = [out[r].output for r in rids]
        wall = sum(times["decode"]) + sum(times["mixed"])
        agree = sum(a == b for x, y in zip(tokens[kv], tokens[None])
                    for a, b in zip(x, y)) / (SERVE_REQUESTS * SERVE_GEN)
        say(f"{phase}: {kv or 'bf16'} pool: generated "
            f"{(m['tokens_generated'] - untimed_tokens) / wall:.1f} tokens/s"
            f" (timed steps; the profiled one left out), prompt "
            f"{m['prefill_tokens'] / max(sum(times['mixed']), 1e-9):.1f} "
            f"tokens/s over mixed-step time, mean decode step "
            f"{1e3 * sum(times['decode']) / max(len(times['decode']), 1):.2f}"
            f" ms, mean mixed step "
            f"{1e3 * sum(times['mixed']) / max(len(times['mixed']), 1):.2f} "
            f"ms, {wall:.3f} s in steps, preemptions {m['preemptions']}, "
            f"prefix hits {m['prefix_hits']} ({m['prefix_cached_tokens']} "
            f"cached tokens), tokens equal to the bf16 run "
            f"{100 * agree:.1f}% (information only), on {card_line()}")
        for k, n in launches.items():
            all_launches[k] = all_launches.get(k, 0) + n
        del be
        free_card()
    return all_launches


# -- phase 3c ----------------------------------------------------------------

def golden_bars(label, got, want) -> bool:
    """Phase 3's bars, row by row: cosine >= 0.999 and max |diff| <= 5% of
    max |want|. Prints the numbers; returns whether they held."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{label}: non-finite values")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min()
    diff = (got - want).abs().max().item()
    top = want.abs().max().item()
    say(f"{label}: min cosine {cos.item():.6f}, max |diff| {diff:.4g} = "
        f"{100 * diff / top:.3f}% of max |want| {top:.4g}")
    return cos.item() >= 0.999 and diff <= 0.05 * top


def moe_inputs(eng, ids, MoEMLP, layers) -> dict:
    """The hidden states entering the MoE block of each of ``layers`` during
    one prefill of ``ids`` through ``eng`` (its own mode's path)."""
    method = "dist_fwd" if eng.mode == "dist" else "xla_fwd"
    real, seen, calls = getattr(MoEMLP, method), {}, [0]

    def spy(self, params, x, **kw):
        if calls[0] in layers:
            seen[calls[0]] = x.clone()
        calls[0] += 1
        return real(self, params, x, **kw)

    setattr(MoEMLP, method, spy)
    try:
        eng.prefill(ids, eng.new_cache(ids.shape[0]))
    finally:
        setattr(MoEMLP, method, real)
    return seen


@torch.inference_mode()
def moe_block_check(eng, ids, MoEMLP) -> None:
    """One MoE block, ``dist_fwd`` (the grouped-GEMM kernel) against
    ``xla_fwd``, on the same real hidden states: the same routing, so this
    isolates the kernel and the capacity grid."""
    mlp, lp = eng.model.mlp, eng.params["layers"]["mlp"]
    for i, x in moe_inputs(eng, ids, MoEMLP, MOE_LAYERS_CHECKED).items():
        stacked = {"router": lp["router"][i], "w_gate_up": lp["w_gate_up"],
                   "w_down": lp["w_down"]}
        got, stats = mlp.dist_fwd(stacked, x, return_stats=True, layer_idx=i)
        want = mlp.xla_fwd({k: v[i] for k, v in lp.items()}, x)
        drops = {k: int(v) for k, v in stats.items()}
        if not golden_bars(f"phase 3c: MoE block of layer {i} on its prefill "
                           f"hidden states ({x.shape[0]} tokens, drops "
                           f"{drops}), dist vs xla", got, want):
            raise AssertionError(f"phase 3c: MoE block of layer {i} "
                                 f"disagrees with the xla golden")


@torch.inference_mode()
def replayed_prefill_logits(eng, xla, ids, MoEMLP):
    """Prefill logits of the dist path and of the golden with the dist
    path's expert choices replayed: each layer's golden routing takes the
    top-k set the dist run chose there (the golden weighs it with its own
    router probabilities). Random weights make the router chaotic at depth
    (any attention other than the golden's own, float64 included, flips
    top-8 choices by layer 24: ``scripts/torch_moe_drift.py``), so only
    with the same choices do the logits measure the kernels."""
    real, chosen = MoEMLP.route, []

    def record(self, router, x):
        w, sel = real(self, router, x)
        chosen.append(sel)
        return w, sel

    def replay(self, router, x):
        sel = next(choices)
        w = torch.softmax(x.float() @ router.float(), dim=-1).gather(
            -1, sel.long())
        return (w / w.sum(dim=-1, keepdim=True) if self.norm_topk_prob
                else w), sel

    out = []
    for engine, spy in ((eng, record), (xla, replay)):
        choices = iter(chosen)
        MoEMLP.route = spy
        try:
            out.append(engine.prefill(ids, engine.new_cache(ids.shape[0]))[0])
        finally:
            MoEMLP.route = real
    return out


def dense_attention(q, k, v, *, offset, scale, p_dtype=torch.bfloat16,
                    acc=torch.float32, **_):
    """Causal GQA attention from ``offset`` with sums in ``acc`` and P cast
    to ``p_dtype`` before the P V product (by default the flash-prefill
    kernel's rounding with the golden's f32 sums); one batch row at a time,
    so the scores of a 4 x 2,048 prefill fit beside the weights. The
    signature of ``nn.flash_prefill`` on a contiguous (B, S, Hkv, dh)
    cache."""
    L, hq, dh = q.shape[1:]
    S, hkv = k.shape[1], k.shape[2]
    pos = offset + torch.arange(L, device=q.device)
    mask = torch.arange(S, device=q.device)[None, :] <= pos[:, None]
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        qr = q[b].to(acc).reshape(L, hkv, hq // hkv, dh)
        s = torch.einsum("lhgd,shd->lhgs", qr, k[b].to(acc)) * scale
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("lhgs,shd->lhgd", p.to(p_dtype).to(acc),
                         v[b].to(acc))
        out[b] = (o / p.sum(-1, keepdim=True)).reshape(L, hq, dh)
    return out


def drift(got, want) -> tuple[float, float]:
    """(1 - min cosine, max |diff| / max |want|) of two logit sets."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("drift: non-finite logits")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min()
    return (1.0 - cos.item(),
            ((got - want).abs().max() / want.abs().max()).item())


def free_running_gate(logits, witness, golden, phase="phase 3c") -> None:
    """The kernels' free-running prefill logits against the golden, held at
    ``MOE_DRIFT_MARGIN`` times the witness's drift, on both measures."""
    got, wit = drift(logits, golden), drift(witness, golden)
    say(f"{phase}: free-running prefill logits vs xla: kernels min cosine "
        f"{1 - got[0]:.6f}, max |diff| {100 * got[1]:.3f}% of max |want|; "
        f"witness (dense attention, P in bf16) {1 - wit[0]:.6f}, "
        f"{100 * wit[1]:.3f}%; bar {MOE_DRIFT_MARGIN} x the witness's drift")
    if got[0] > MOE_DRIFT_MARGIN * wit[0] or got[1] > MOE_DRIFT_MARGIN * wit[1]:
        raise AssertionError(f"{phase}: free-running prefill logits drift "
                             "further from the golden than the witness "
                             "allows")


def moe_logit_gates(eng, xla, ids, logits, MoEMLP, nn, phase) -> None:
    """Phase 3c's bars on the dist engine's prefill ``logits`` against the
    xla golden on the same weights. Free-running, each path routing on its
    own hidden states: the router is chaotic at depth with random weights,
    so the bars are held against a witness's drift (the dist path with the
    golden's dense attention, P rounded to bf16 as the flash-prefill kernel
    rounds it). Then with the dist path's expert choices replayed in the
    golden: cosine and max |diff| as phase 3."""
    x_logits, _ = xla.prefill(ids, xla.new_cache(ids.shape[0]))
    shipped = nn.flash_prefill
    nn.flash_prefill = dense_attention
    try:
        w_logits, _ = eng.prefill(ids, eng.new_cache(ids.shape[0]))
    finally:
        nn.flash_prefill = shipped
    free_running_gate(logits, w_logits, x_logits, phase)
    del x_logits, w_logits
    if not golden_bars(f"{phase}: prefill logits dist vs xla, the dist "
                       f"path's expert choices replayed in the golden",
                       *replayed_prefill_logits(eng, xla, ids, MoEMLP)):
        raise AssertionError(f"{phase}: prefill logits disagree with the xla "
                             f"golden")


@torch.inference_mode()
def top8_sets_differ(eng, xla, ids, MoEMLP, layer: int) -> int:
    """How many tokens pick another top-8 expert set at ``layer`` on the
    dist path's hidden states than on the xla path's."""
    router = eng.params["layers"]["mlp"]["router"][layer]
    sets = [eng.model.mlp.route(router, moe_inputs(e, ids, MoEMLP,
                                                   (layer,))[layer])[1]
            .sort(dim=-1).values for e in (eng, xla)]
    return int((sets[0] != sets[1]).any(dim=-1).sum())


def phase_moe_full_width(Engine, ModelConfig, kernels, MoEMLP, nn, tmu,
                         held_caps):
    """Slice 3: Qwen3-30B-A3B at full width through ``Engine.serve``.
    ``held_caps``: the grid capacities phase 1 held the grouped GEMM at."""
    cfg = ModelConfig.from_name("qwen3-30b-a3b")
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # A cache just long enough: 0.8 GiB of KV instead of 1.6 next to ~57 GiB
    # of experts and a prefill's capacity grids.
    eng = Engine(cfg, mode="dist", device="cuda", seed=0,
                 max_length=L0 + MOE_GEN)
    torch.cuda.synchronize()
    say(f"phase 3c: qwen3-30b-a3b ({L} layers, {cfg.n_experts} experts, "
        f"top-{cfg.n_experts_per_tok}) random init "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ids = torch.randint(0, cfg.vocab_size, (B, L0), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7), dtype=torch.int32)
    # The capacity audit the JAX Engine documents, from the default factor
    # up to the served one (MOE_FACTOR, dropless by construction: the golden
    # has no capacity, so the bars below need a drop-free dist path).
    while True:
        drops = eng.moe_drop_stats(ids)
        say(f"phase 3c: moe_drop_stats of the prompt at moe_capacity_factor "
            f"{cfg.moe_capacity_factor}: {drops}")
        if cfg.moe_capacity_factor >= MOE_FACTOR:
            break
        cfg = dataclasses.replace(cfg, moe_capacity_factor=min(
            2 * cfg.moe_capacity_factor, MOE_FACTOR))
        eng = Engine(cfg, mode="dist", device="cuda", params=eng.params,
                     max_length=L0 + MOE_GEN)
    if any(drops.values()):
        raise AssertionError(f"phase 3c: drops at the served factor "
                             f"{MOE_FACTOR}: {drops}")
    eng.serve(ids[:, :128], 2)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_counts()
    t0 = time.perf_counter()
    with CapacitySpy(tmu) as spy:
        tokens = eng.serve(ids, MOE_GEN)
        torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    spy.check("phase 3c: serve", held_caps)
    expected = {"matmul": 2 * L, "grouped_gemm": 2 * L * MOE_GEN,
                "flash_prefill": L, "flash_decode": L * (MOE_GEN - 1),
                "paged_attention": 0, **NOT_SERVED}
    say(f"phase 3c: serve B={B} L0={L0} gen={MOE_GEN} launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"phase 3c: launch counts {launches} != "
                             f"{expected}")
    if (tokens.shape != (B, MOE_GEN)
            or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"phase 3c: tokens {tokens.shape} out of range")

    t0 = time.perf_counter()
    logits, _ = eng.prefill(ids, eng.new_cache(B))
    torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    xla = Engine(cfg, mode="xla", device="cuda", params=eng.params,
                 max_length=L0 + MOE_GEN)
    moe_logit_gates(eng, xla, ids, logits, MoEMLP, nn, "phase 3c")
    del logits
    say(f"phase 3c: tokens whose top-8 expert set differs between the two "
        f"free-running paths at layer 24: "
        f"{top8_sets_differ(eng, xla, ids, MoEMLP, 24)} of {B * L0}")
    moe_block_check(eng, ids, MoEMLP)
    del xla
    decode_s = max(t_serve - ttft, 1e-9)
    say(f"phase 3c: TTFT {ttft * 1e3:.2f} ms (prefill of {B}x{L0} + argmax), "
        f"serve {t_serve:.3f} s, decode {B * (MOE_GEN - 1) / decode_s:.1f} "
        f"tokens/s ({B} rows), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on "
        f"{card_line()}")
    decode_profile(eng, ids, phase="phase 3c")
    return launches, eng


def decode_profile(eng, ids, steps: int = 4, phase: str = "phase 3"):
    """Where the time goes: torch.profiler over one prefill and over a few
    decode steps after it, each summarised as wall time, device busy time
    and share, and the kernels that took the most device time."""
    kv = eng.new_cache(B)
    device_profile(phase, "prefill", lambda: eng.prefill(ids, kv), 1)
    logits, kv = eng.prefill(ids, kv.clear())
    tok = torch.argmax(logits, dim=-1)

    def step():
        nonlocal tok
        out, _ = eng.decode_step(tok, kv)
        tok = torch.argmax(out, dim=-1)

    step()
    device_profile(phase, "decode step", step, steps)


def device_profile(phase: str, label: str, fn, n: int):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels only: a CPU op's entry repeats the device time of the
    # kernels it launched.
    by_name = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0}
    busy = sum(by_name.values()) / 1e6
    if busy == 0:
        say(f"{phase}: {label} device busy share: not measured (the "
            f"profiler saw no device time)")
    else:
        top = sorted(by_name.items(), key=lambda item: -item[1])[:6]
        say(f"{phase}: profiled {label}: {wall / n * 1e3:.2f} ms wall, "
            f"device busy {busy / n * 1e3:.2f} ms ({100 * busy / wall:.1f}%);"
            f" top: " + "; ".join(f"{k[:60]} {v / n / 1e3:.3f} ms"
                                  for k, v in top))
    # The host's side of the same run: operators called, kernels launched
    # through the CUDA runtime, and the host time spent inside each
    # operator itself (profiler overhead included).
    cpu = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CPU]
    ops = sum(ev.count for ev in cpu if ev.key.startswith("aten::"))
    launches = sum(ev.count for ev in cpu if "LaunchKernel" in ev.key)
    host = sum(ev.self_cpu_time_total for ev in cpu) / 1e6
    top = sorted(cpu, key=lambda ev: -ev.self_cpu_time_total)[:6]
    say(f"{phase}: host side of {label}: {ops / n:.0f} aten operator calls "
        f"(nested included), {launches / n:.0f} runtime kernel launches, "
        f"{host / n * 1e3:.2f} ms self time in operators and runtime calls "
        f"({100 * host / wall:.1f}% of wall); top: "
        + "; ".join(f"{ev.key[:40]} x{ev.count // n} "
                    f"{ev.self_cpu_time_total / n / 1e3:.3f} ms"
                    for ev in top))


# -- phase 4 -----------------------------------------------------------------

def phase_times(inputs, tg, tsp, card):
    import torch.nn.functional as F

    timer = Timer("cuda")
    rows = {}
    ms = plain = lib = bnd = 0.0
    for name, (M, K, N) in PROJECTIONS.items():
        a, b = inputs[f"matmul_{name}"]
        t_k = timer(lambda: tg.matmul_cuda(a, b))
        t_p = timer(lambda: tg.matmul_ref(a, b), reps=3)
        t_l = timer(lambda: torch.matmul(a, b))
        t_b, _ = bound_ms(2 * M * N * K, 2 * (M * K + K * N + M * N))
        t_d = kernel_device_ms(lambda: tg.matmul_cuda(a, b), MATMUL_WS)
        t_ld = call_device_ms(lambda: torch.matmul(a, b))
        flops = 2 * M * N * K
        say(f"phase 4: matmul {name} ({M}x{K})x({K}x{N}): kernel {t_k:.4f} "
            f"ms (device alone {t_d:.4f}, {flops / t_d / 1e9:.1f} TFLOP/s), "
            f"plain {t_p:.4f} ms, torch.matmul {t_l:.4f} ms (device alone "
            f"{t_ld:.4f}, {flops / t_ld / 1e9:.1f} TFLOP/s), kernel / "
            f"torch.matmul {t_k / t_l:.3f}, bound {t_b:.4f} ms [{card}]")
        ms, plain, lib, bnd = ms + t_k, plain + t_p, lib + t_l, bnd + t_b
    rows["matmul"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bnd, bound_by="operations")
    say(f"phase 4: matmul, the four projections: kernel {ms:.4f} ms, "
        f"torch.matmul {lib:.4f} ms, kernel / torch.matmul {ms / lib:.3f} "
        f"(bar <= {MATMUL_BAR}: "
        f"{'met' if ms / lib <= MATMUL_BAR else 'missed'}) [{card}]")
    a, b = inputs["matmul_qkv"]
    one_wgmma_op("phase 4: matmul", MATMUL_WS, lambda: tg.matmul_cuda(a, b))
    sass_count("phase 4", MATMUL_WS, "HGMMA")

    q, k, v = inputs["flash_prefill"]
    t_k = timer(lambda: tsp.flash_prefill(q, k, v, offset=0), reps=5)
    t_p = timer(lambda: tsp.flash_prefill_ref(q, k, v, offset=0), reps=2)
    qt = q.transpose(1, 2).contiguous()
    kt = k[:, :L0].transpose(1, 2).contiguous()
    vt = v[:, :L0].transpose(1, 2).contiguous()
    t_l = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=5)
    # Causal from offset 0: query j attends j + 1 keys, every (row, head).
    pairs = B * HQ * L0 * (L0 + 1) / 2
    nbytes = 2 * (2 * B * L0 * HQ * DH + 2 * B * L0 * HKV * DH)
    t_b, by = bound_ms(4 * DH * pairs, nbytes)
    rows["flash_prefill"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                 bound_ms=t_b, bound_by=by)
    t_d = kernel_device_ms(lambda: tsp.flash_prefill(q, k, v, offset=0),
                           PREFILL_WGMMA)
    t_ld = call_device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    say(f"phase 4: flash_prefill B={B} L={L0} S={S}: kernel {t_k:.4f} ms "
        f"(device alone {t_d:.4f}, {4 * DH * pairs / t_d / 1e9:.1f} "
        f"TFLOP/s), plain {t_p:.4f} ms, sdpa {t_l:.4f} ms (device alone "
        f"{t_ld:.4f}), kernel / sdpa {t_k / t_l:.3f} (bar <= 2.0: "
        f"{'met' if t_k / t_l <= 2.0 else 'missed'}), bound {t_b:.4f} ms "
        f"({by}) [{card}]")
    del qt, kt, vt
    prefill_gqa8_times(timer, tsp, card)

    qd, kd, vd, kv_len = inputs["flash_decode"]
    t_k = timer(lambda: tsp.flash_decode_local(qd, kd, vd, kv_len=kv_len,
                                               kv_layout="bshd"), reps=50)
    t_p = timer(lambda: tsp.flash_decode_ref(qd, kd, vd, kv_len=kv_len,
                                             kv_layout="bshd"), reps=5)
    qdt = qd[:, :, None]
    kdt = torch.nan_to_num(kd).transpose(1, 2).contiguous()
    vdt = torch.nan_to_num(vd).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None] < kv_len[:, None])
    mask = mask[:, None, None, :]
    t_l = timer(lambda: F.scaled_dot_product_attention(
        qdt, kdt, vdt, attn_mask=mask, enable_gqa=True), reps=50)
    keys = sum(DECODE_KV_LENS)
    nbytes = (2 * keys * HKV * DH * 2 + B * HQ * DH * 2
              + B * HQ * (DH + 1) * 4)
    t_b, by = bound_ms(4 * HQ * DH * keys, nbytes)
    t_d = kernel_device_ms(lambda: tsp.flash_decode_local(
        qd, kd, vd, kv_len=kv_len, kv_layout="bshd"), "flash_decode_kernel")
    t_ld = call_device_ms(lambda: F.scaled_dot_product_attention(
        qdt, kdt, vdt, attn_mask=mask, enable_gqa=True))
    rows["flash_decode"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=t_b, bound_by=by)
    say(f"phase 4: flash_decode B={B} S={S} kv_len {DECODE_KV_LENS} bshd "
        f"({tsp.decode_splits(S)} splits): kernel {t_k:.4f} ms (device alone "
        f"{t_d:.4f}), plain {t_p:.4f} ms, sdpa {t_l:.4f} ms (device alone "
        f"{t_ld:.4f}), kernel / sdpa {t_k / t_l:.3f} (device alone "
        f"{t_d / t_ld:.3f}), bound {t_b:.4f} ms ({by}) [{card}]")
    return rows


def prefill_gqa8_times(timer, tsp, card) -> None:
    """Phase 4 for the flash prefill at Qwen3-30B-A3B's heads (phase 1's
    GQA-8 shape: B 2 x 2,048, 32 / 4 heads, a NaN tail past L): events
    and device time beside SDPA's (``is_causal``, ``enable_gqa``), and the
    bar (events / SDPA <= 2.0)."""
    import torch.nn.functional as F

    Hq, Hkv = GQA8["Hq"], GQA8["Hkv"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = randn(gen, 2, L0, Hq, DH)
    k, v = randn(gen, 2, S, Hkv, DH), randn(gen, 2, S, Hkv, DH)
    k[:, L0:] = float("nan")
    v[:, L0:] = float("nan")
    run = lambda: tsp.flash_prefill(q, k, v, offset=0)
    qt = q.transpose(1, 2).contiguous()
    kt = k[:, :L0].transpose(1, 2).contiguous()
    vt = v[:, :L0].transpose(1, 2).contiguous()
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
    t_k, t_l = timer(run, reps=5), timer(lib, reps=5)
    t_d = kernel_device_ms(run, PREFILL_WGMMA)
    t_ld = call_device_ms(lib)
    flops = 4 * DH * 2 * Hq * L0 * (L0 + 1) / 2
    t_b, by = bound_ms(flops, 2 * (2 * 2 * L0 * Hq * DH
                                   + 2 * 2 * L0 * Hkv * DH))
    say(f"phase 4: flash_prefill GQA 8 B=2 L={L0} Hq={Hq} Hkv={Hkv}: kernel "
        f"{t_k:.4f} ms (device alone {t_d:.4f}, {flops / t_d / 1e9:.1f} "
        f"TFLOP/s), sdpa {t_l:.4f} ms (device alone {t_ld:.4f}), kernel / "
        f"sdpa {t_k / t_l:.3f} (bar <= 2.0: "
        f"{'met' if t_k / t_l <= 2.0 else 'missed'}), bound {t_b:.4f} ms "
        f"({by}) [{card}]")


def paged_times(inputs, tpa, sp_gather, card):
    """Phase 4 for the paged kernel: each case and pool dtype. The
    record's kernel time is one ``paged_attention(**case)`` call, its slots
    built inside the call. The decode also prints, labelled apart, the call
    a serving step makes in every layer: ``paged_attention_slots`` on the
    slots the step built once before its first layer. The library
    yardstick is SDPA over the ALREADY GATHERED contiguous view (the gather
    and the dequantization are not timed): no PyTorch call reads a paged
    pool. The bound counts each live slot's K/V rows (and scales) once, q
    and out once, and 4 * dh operations per (query head, attended key)."""
    import torch.nn.functional as F

    timer = Timer("cuda")
    rows = {}
    Hq, Hkv, dh = PAGED["Hq"], PAGED["Hkv"], PAGED["dh"]
    for (name, kv), c in inputs.items():
        kvl, ql = c["kv_lens"].tolist(), c["q_lens"].tolist()
        B, L = c["q"].shape[:2]
        t_k = timer(lambda: tpa.paged_attention(**c), reps=20)
        t_p = timer(lambda: tpa.paged_attention_ref(**c), reps=2)
        tables = torch.where(c["slot_mask"][:, None], c["block_tables"], 0)
        views = []
        for pool, sc in (("k_pool", "k_scale"), ("v_pool", "v_scale")):
            x = sp_gather(c[pool], tables)
            if sc in c:
                x = x.float() * sp_gather(c[sc], tables)[..., None]
            views.append(torch.nan_to_num(x.bfloat16()).transpose(1, 2)
                         .contiguous())
        S = views[0].shape[2]
        j = torch.arange(L, device="cuda")
        qpos = (c["kv_lens"] - c["q_lens"])[:, None] + j               # (B, L)
        mask = ((torch.arange(S, device="cuda")[None, None] <= qpos[..., None])
                & (j[None, :, None] < c["q_lens"][:, None, None]))[:, None]
        qt = c["q"].transpose(1, 2).contiguous()
        t_l = timer(lambda: F.scaled_dot_product_attention(
            qt, views[0], views[1], attn_mask=mask, enable_gqa=True), reps=20)
        # Dead slots' rows are garbage the caller discards: no work.
        live = c["slot_mask"].tolist()
        work = [(k, q) for k, q, m in zip(kvl, ql, live) if m and q > 0]
        keys = sum(k for k, _ in work)
        itemsize = c["k_pool"].element_size()
        nbytes = (2 * keys * Hkv * dh * itemsize
                  + (2 * keys * Hkv * 4 if "k_scale" in c else 0)
                  + sum(q for _, q in work) * Hq * dh * 2       # live q rows
                  + sum(live) * L * Hq * dh * 2)    # live slots' out rows
        pairs = sum(q * (k - q) + q * (q + 1) // 2 for k, q in work)
        t_b, by = bound_ms(4 * dh * Hq * pairs, nbytes)
        rows[(name, kv)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=t_b, bound_by=by)
        # The decode is the split-KV kernel (flash_decode.cuh): its device
        # time alone, the per-layer call on prebuilt slots, and the ratios
        # of each to the library.
        extra = lib_extra = ""
        if L == 1:
            slots = tpa.paged_slots(c["block_tables"], c["kv_lens"], L,
                                    q_lens=c["q_lens"],
                                    slot_mask=c["slot_mask"])
            scales = {k: c[k] for k in ("k_scale", "v_scale") if k in c}
            layer = lambda: tpa.paged_attention_slots(
                c["q"], c["k_pool"], c["v_pool"], slots, **scales)
            t_s = timer(layer, reps=20)
            t_d = kernel_device_ms(layer, "flash_decode_kernel")
            t_ld = call_device_ms(lambda: F.scaled_dot_product_attention(
                qt, views[0], views[1], attn_mask=mask, enable_gqa=True))
            splits = tpa.paged_decode_splits(c["block_tables"], PAGED["bs"])
            extra = (f" (device alone {t_d:.4f}, {splits} splits), "
                     f"kernel / sdpa {t_k / t_l:.3f} (device alone "
                     f"{t_d / t_ld:.3f}); per-layer paged_attention_slots on "
                     f"prebuilt slots {t_s:.4f} ms, / sdpa {t_s / t_l:.3f}")
            lib_extra = f" (device alone {t_ld:.4f})"
        else:
            # The mixed step's prefill kernel (MIXED_KERNEL) alone, and
            # SDPA's kernels alone.
            t_d = kernel_device_ms(lambda: tpa.paged_attention(**c),
                                   "flash_prefill")
            t_ld = call_device_ms(lambda: F.scaled_dot_product_attention(
                qt, views[0], views[1], attn_mask=mask, enable_gqa=True))
            extra = (f" (device alone {t_d:.4f}, {MIXED_KERNEL[kv]}), "
                     f"kernel / sdpa {t_k / t_l:.3f} (device alone "
                     f"{t_d / t_ld:.3f})")
            lib_extra = f" (device alone {t_ld:.4f})"
        say(f"phase 4: paged_attention {name} L={L} {kv or 'bf16'} pool: "
            f"kernel {t_k:.4f} ms{extra}, plain {t_p:.4f} ms, sdpa on the "
            f"gathered view {t_l:.4f} ms{lib_extra}, bound {t_b:.4f} ms "
            f"({by}) [{card}]")
    # The record's row: the bf16 pool's decode and mixed steps together.
    bf16 = [rows[(name, None)] for name in PAGED_CASES]
    out = {key: sum(r[key] for r in bf16)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                     for r in bf16) else "operations"
    return out


def grouped_times(tmu, caps):
    """Phase 4 for the grouped GEMM at each served capacity of ``caps``
    ({capacity: tokens}) and expert GEMM: the kernel, its plain version,
    and ``torch.bmm`` over the same grid (what the JAX einsum does: every
    expert's weights read). The bound counts what the function must move:
    the non-empty experts' weights and the live rows read once, the whole
    (E, cap, f) output written once (the zeros are part of it), and
    2 * d * f operations per live row."""
    timer = Timer("cuda")
    rows = {}
    for cap, tokens in sorted(caps.items()):
        counts = moe_counts(cap, tokens)
        n_live, n_rows = int((counts > 0).sum()), int(counts.sum())
        for name, (d, f) in GROUPED.items():
            x, x_clean, w = grouped_case(counts, cap, d, f, seed=cap + d)
            t_k = timer(lambda: tmu.grouped_gemm_skip(x, w, counts), reps=20)
            t_p = timer(lambda: tmu.grouped_gemm_skip_ref(x_clean, w, counts),
                        reps=3)
            t_l = timer(lambda: torch.bmm(x_clean, w), reps=20)
            nbytes = 2 * (n_live * d * f + n_rows * d + MOE_E * cap * f) \
                + 4 * MOE_E
            t_b, by = bound_ms(2 * n_rows * d * f, nbytes)
            rows[(cap, name)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                     bound_ms=t_b, bound_by=by)
            say(f"phase 4: grouped_gemm {name} cap {cap} ({n_live} non-empty "
                f"experts, {n_rows} rows): kernel {t_k:.4f} ms, plain "
                f"{t_p:.4f} ms, torch.bmm {t_l:.4f} ms, bound {t_b:.4f} ms "
                f"({by})")
            del x, x_clean, w
    # The record's row: both GEMMs at the three served capacities together.
    out = {key: sum(r[key] for r in rows.values())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                     for r in rows.values()) else "operations"
    return out


# -- phase 5 -----------------------------------------------------------------

def overlap_path(tg, trs, a, b, ar, br, c):
    """Phase 5's main path, once: bench.py's arms through the entry points
    (the loopback and its bare twin at the port's auto split and at the
    JAX package's, GEMM-RS, the fused step)."""
    split = tg.AGGEMMConfig(overlap_cols=JAX_SPLIT_COLS)
    return {
        "loopback auto": tg.ag_gemm_loopback(a, b, segments=SEGMENTS),
        "segmented bare auto": tg.ag_gemm_segmented_bare(
            a, b, segments=SEGMENTS),
        f"loopback {JAX_SPLIT_COLS}": tg.ag_gemm_loopback(
            a, b, segments=SEGMENTS, config=split),
        f"segmented bare {JAX_SPLIT_COLS}": tg.ag_gemm_segmented_bare(
            a, b, segments=SEGMENTS, config=split),
        "gemm_rs": trs.gemm_rs_loopback(ar, br, segments=SEGMENTS),
        "fused": tg.fused_matmul_step(c, a, b, FUSED_S),
    }


def phase_overlap(gen, tg, trs, kernels, card):
    """Phase 5: returns (launches, max abs errors, times) of the four
    overlap kernels."""
    bf16 = torch.bfloat16
    a = randn(gen, AG_M, AG_K)
    b = randn(gen, AG_K, AG_N, scale=AG_K ** -0.5)
    ar = randn(gen, AG_M, RS_K)
    br = randn(gen, RS_K, RS_N, scale=RS_K ** -0.5)
    c = randn(gen, AG_M, AG_N, dtype=torch.float32)
    m = AG_M // SEGMENTS
    auto_cols = tg._split(a, b, SEGMENTS, None)
    say(f"phase 5: auto overlap_cols {auto_cols} of n {AG_N}")

    # The main path, counts reset just before and read just after.
    c_path = c.clone()
    kernels.reset_counts()
    outs = overlap_path(tg, trs, a, b, ar, br, c_path)
    torch.cuda.synchronize()
    launches = {k: kernels.KERNELS[k].launches for k in OVERLAP_KERNELS}
    # Four consumers; a tail after each split one (the JAX split's two, and
    # the auto split's when it leaves columns over).
    want_launches = {"ag_gemm_loopback": 4,
                     "matmul_tail_into": 2 + 2 * (auto_cols < AG_N),
                     "gemm_rs_loopback": 1, "fused_step": 1}
    others = {k: v.launches for k, v in kernels.KERNELS.items()
              if k not in OVERLAP_KERNELS and v.launches}
    say(f"phase 5: path launches {launches}, other kernels {others}")
    if launches != want_launches or others:
        raise AssertionError(f"phase 5: launch counts {launches} (others "
                             f"{others}) != {want_launches}")
    want_ag = tg.matmul_ref(a, b)
    for label, got in outs.items():
        if label == "gemm_rs":
            want = trs.gemm_rs_loopback_ref(ar, br, segments=SEGMENTS)
            check_close(f"phase 5: path {label}", got, want, bf16)
        elif label == "fused":
            if got.data_ptr() != c_path.data_ptr():
                raise AssertionError("phase 5: the fused step did not "
                                     "update c in place")
            want = tg.fused_matmul_step_ref(c, a, b, FUSED_S)
            check_close_scaled(f"phase 5: path {label}", got, want)
        else:
            check_close(f"phase 5: path {label}", got, want_ag, bf16)
        if not torch.isfinite(got).all():
            raise AssertionError(f"phase 5: path {label}: non-finite")
    del outs, c_path

    # (a) Each kernel against its plain version.
    err = dict.fromkeys(OVERLAP_KERNELS, 0.0)
    for label, cols in (("auto", auto_cols), ("n", AG_N),
                        ("pinned", PINNED_COLS)):
        cfg = tg.AGGEMMConfig(overlap_cols=cols)
        e_l = check_close(f"phase 5: loopback cols {cols}", tg.ag_gemm_loopback(
            a, b, segments=SEGMENTS, config=cfg), want_ag, bf16)
        e_b = check_close(f"phase 5: segmented bare cols {cols}",
                          tg.ag_gemm_segmented_bare(
                              a, b, segments=SEGMENTS, config=cfg),
                          want_ag, bf16)
        out1, staged = tg.ag_gemm_loopback_cuda(a, b, segments=SEGMENTS,
                                                cols=cols)
        ref1, _ = tg.ag_gemm_loopback_ref(a, b, cols=cols)
        e_k = check_close(f"phase 5: consumer cols {cols}", out1, ref1, bf16)
        if not torch.equal(staged, a):
            raise AssertionError("phase 5: the staged A differs from A")
        err["ag_gemm_loopback"] = max(err["ag_gemm_loopback"], e_l, e_b, e_k)
        if cols < AG_N:
            err["matmul_tail_into"] = max(err["matmul_tail_into"], e_l, e_b)
        say(f"phase 5: ag_gemm_loopback / segmented bare, overlap_cols "
            f"{cols} ({label}): max_abs_err {e_l:.4g} / {e_b:.4g}, consumer "
            f"alone {e_k:.4g}, staged A == A")
    # The producers held back 1 ms, the staging buffer poisoned: the
    # consumer tiles must wait on the flags, not race them.
    undelayed, _ = tg.ag_gemm_loopback_cuda(a, b, segments=SEGMENTS,
                                            cols=AG_N)
    poison = torch.full_like(a, float("nan"))
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    delayed, _ = tg.ag_gemm_loopback_cuda(
        a, b, segments=SEGMENTS, cols=AG_N, staging=poison,
        producer_delay_ns=PRODUCER_DELAY_NS)
    t1.record()
    torch.cuda.synchronize()
    if not torch.equal(delayed, undelayed):
        raise AssertionError("phase 5: the delayed producer changed the "
                             "loopback's result (the consumer raced a flag)")
    e = check_close("phase 5: delayed producer", delayed, want_ag, bf16)
    say(f"phase 5: delayed producers (1 ms sleep, NaN staging): call took "
        f"{t0.elapsed_time(t1):.3f} ms, result bit-identical to the "
        f"undelayed run, max_abs_err {e:.4g}")
    del poison, delayed, undelayed

    ct = randn(gen, AG_M, TAIL_COL_START)
    got = tg.matmul_tail_into(ct, a, b, TAIL_COL_START)
    if not torch.equal(got[:, :TAIL_COL_START], ct):
        raise AssertionError("phase 5: matmul_tail_into's pass-through "
                             "columns differ from c")
    e = check_close("phase 5: matmul_tail_into", got,
                    tg.matmul_tail_into_ref(ct, a, b, TAIL_COL_START), bf16)
    err["matmul_tail_into"] = max(err["matmul_tail_into"], e)
    say(f"phase 5: matmul_tail_into col_start {TAIL_COL_START}: "
        f"max_abs_err {e:.4g}, pass-through columns == c")

    for segs, (Mr, Nr) in ((SEGMENTS, (AG_M, RS_N)), (2, (2 * m, 128))):
        x, w = ar[:Mr], br[:, :Nr].contiguous()
        e = check_close(f"phase 5: gemm_rs_loopback segments {segs}",
                        trs.gemm_rs_loopback(x, w, segments=segs),
                        trs.gemm_rs_loopback_ref(x, w, segments=segs), bf16)
        err["gemm_rs_loopback"] = max(err["gemm_rs_loopback"], e)
        say(f"phase 5: gemm_rs_loopback ({Mr}x{RS_K})x({RS_K}x{Nr}) "
            f"segments {segs}: max_abs_err {e:.4g}")
    # Every product tile held back 1 ms behind NaN staging: the folds must
    # wait on the flags, not race them.
    undelayed = trs.gemm_rs_loopback_cuda(ar, br, segments=SEGMENTS)
    poison = torch.full((SEGMENTS - 1, m, RS_N), float("nan"), dtype=bf16,
                        device="cuda")
    delayed = trs.gemm_rs_loopback_cuda(ar, br, segments=SEGMENTS,
                                        staging=poison,
                                        producer_delay_ns=PRODUCER_DELAY_NS)
    torch.cuda.synchronize()
    if not torch.equal(delayed, undelayed):
        raise AssertionError("phase 5: the delayed producers changed the "
                             "GEMM-RS loopback's result (a fold raced a "
                             "flag)")
    say("phase 5: gemm_rs_loopback delayed producers (1 ms sleep, NaN "
        "staging): result bit-identical to the undelayed run")
    del poison, delayed, undelayed

    cf = c.clone()
    got = tg.fused_matmul_step(cf, a, b, FUSED_S)
    if got.data_ptr() != cf.data_ptr():
        raise AssertionError("phase 5: fused step output is not c")
    e = check_close_scaled("phase 5: fused step", got,
                           tg.fused_matmul_step_ref(c, a, b, FUSED_S))
    err["fused_step"] = e
    say(f"phase 5: fused step s={FUSED_S} f32 c ({AG_M}x{AG_N}): in place, "
        f"max_abs_err {e:.4g} (bar 1e-5 x max |want| = "
        f"{1e-5 * got.abs().max().item():.4g})")
    del cf, got

    # (c) Times.
    timer = Timer("cuda")
    flops_ag = 2 * AG_M * AG_K * AG_N
    rows = {}
    t_k = timer(lambda: tg.ag_gemm_loopback_cuda(a, b, segments=SEGMENTS,
                                                 cols=AG_N), reps=20)
    t_p = timer(lambda: tg.ag_gemm_loopback_ref(a, b, cols=AG_N), reps=3)
    t_l = timer(lambda: torch.matmul(a, b), reps=20)
    t_b, by = bound_ms(flops_ag, 2 * (AG_M * AG_K + AG_K * AG_N
                                      + AG_M * AG_N))
    rows["ag_gemm_loopback"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                    bound_ms=t_b, bound_by=by)
    staged = lambda: tg.ag_gemm_loopback_cuda(a, b, segments=SEGMENTS,
                                              cols=AG_N)
    bare = lambda: tg.ag_gemm_segmented_bare_cuda(a, b, segments=SEGMENTS,
                                                  cols=AG_N)
    t_d = kernel_device_ms(staged, LOOPBACK_WGMMA)
    t_bd = kernel_device_ms(bare, LOOPBACK_WGMMA)
    t_ld = call_device_ms(lambda: torch.matmul(a, b))
    say(f"phase 5: ag_gemm_loopback over all {AG_N} columns, staging "
        f"included: kernel {t_k:.4f} ms (device alone {t_d:.4f}, "
        f"{flops_ag / t_d / 1e9:.1f} TFLOP/s; bare twin device {t_bd:.4f}), "
        f"plain {t_p:.4f} ms, torch.matmul {t_l:.4f} ms (device alone "
        f"{t_ld:.4f}), kernel / torch.matmul {t_k / t_l:.3f} (bar <= 2.0: "
        f"{'met' if t_k / t_l <= 2.0 else 'missed'}), bound {t_b:.4f} ms "
        f"({by}) [{card}]")
    one_wgmma_op("phase 5: ag_gemm_loopback", LOOPBACK_WGMMA, staged)
    one_wgmma_op("phase 5: ag_gemm_segmented_bare", LOOPBACK_WGMMA, bare)
    sass_count("phase 5", LOOPBACK_WGMMA, "HGMMA")

    ncols = AG_N - TAIL_COL_START
    t_k = timer(lambda: tg.matmul_tail_into(ct, a, b, TAIL_COL_START),
                reps=20)
    t_p = timer(lambda: tg.matmul_tail_into_ref(ct, a, b, TAIL_COL_START),
                reps=3)
    t_b, by = bound_ms(2 * AG_M * AG_K * ncols,
                       2 * (AG_M * TAIL_COL_START + AG_M * AG_K
                            + AG_K * ncols + AG_M * AG_N))
    rows["matmul_tail_into"] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                                    bound_ms=t_b, bound_by=by)
    say(f"phase 5: matmul_tail_into col_start {TAIL_COL_START}: kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, library: none (no one call "
        f"assembles it), bound {t_b:.4f} ms ({by}) [{card}]")

    a3 = ar.view(SEGMENTS, m, RS_K)
    b3 = br.expand(SEGMENTS, RS_K, RS_N)
    z = torch.empty((m, RS_N), dtype=bf16, device="cuda")
    t_k = timer(lambda: trs.gemm_rs_loopback(ar, br, segments=SEGMENTS),
                reps=20)
    t_p = timer(lambda: trs.gemm_rs_loopback_ref(ar, br, segments=SEGMENTS),
                reps=3)
    t_l = timer(lambda: torch.addbmm(z, a3, b3, beta=0), reps=20)
    t_b, by = bound_ms(2 * AG_M * RS_K * RS_N,
                       2 * (AG_M * RS_K + RS_K * RS_N + m * RS_N))
    rows["gemm_rs_loopback"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                    bound_ms=t_b, bound_by=by)
    rs_run = lambda: trs.gemm_rs_loopback(ar, br, segments=SEGMENTS)
    t_d = kernel_device_ms(rs_run, RS_LOOPBACK_WGMMA)
    t_ld = call_device_ms(lambda: torch.addbmm(z, a3, b3, beta=0))
    say(f"phase 5: gemm_rs_loopback ({AG_M}x{RS_K})x({RS_K}x{RS_N}) "
        f"segments {SEGMENTS}: kernel {t_k:.4f} ms (device alone {t_d:.4f}, "
        f"{2 * AG_M * RS_K * RS_N / t_d / 1e9:.1f} TFLOP/s), plain "
        f"{t_p:.4f} ms, torch.addbmm {t_l:.4f} ms (device alone "
        f"{t_ld:.4f}), kernel / torch.addbmm {t_k / t_l:.3f} (bar <= "
        f"{RS_LOOPBACK_BAR}: "
        f"{'met' if t_k / t_l <= RS_LOOPBACK_BAR else 'missed'}), bound "
        f"{t_b:.4f} ms ({by}) [{card}]")
    one_wgmma_op("phase 5: gemm_rs_loopback", RS_LOOPBACK_WGMMA, rs_run)
    sass_count("phase 5", RS_LOOPBACK_WGMMA, "HGMMA")
    # The matmul's bar on the bare arms: matmul_cuda at both of bench.py's
    # per-rank products against torch.matmul.
    for label, (x, w) in (("AG", (a, b)), ("RS", (ar, br))):
        t_k = timer(lambda: tg.matmul_cuda(x, w), reps=20)
        t_l = timer(lambda: torch.matmul(x, w), reps=20)
        t_d = kernel_device_ms(lambda: tg.matmul_cuda(x, w), MATMUL_WS)
        t_ld = call_device_ms(lambda: torch.matmul(x, w))
        flops = 2 * x.shape[0] * x.shape[1] * w.shape[1]
        say(f"phase 5: bare matmul_cuda {label} ({x.shape[0]}x{x.shape[1]})"
            f"x({w.shape[0]}x{w.shape[1]}): kernel {t_k:.4f} ms (device "
            f"alone {t_d:.4f}, {flops / t_d / 1e9:.1f} TFLOP/s), "
            f"torch.matmul {t_l:.4f} ms (device alone {t_ld:.4f}), kernel / "
            f"torch.matmul {t_k / t_l:.3f} (bar <= {MATMUL_BAR}: "
            f"{'met' if t_k / t_l <= MATMUL_BAR else 'missed'}) [{card}]")

    cf = c.clone()
    s_b = torch.tensor(FUSED_S, dtype=bf16, device="cuda")
    t_k = timer(lambda: tg.fused_matmul_step(cf, a, b, FUSED_S), reps=20)
    t_p = timer(lambda: tg.fused_matmul_step_ref(c, a, b, FUSED_S), reps=3)
    t_e = timer(lambda: c + torch.matmul(a, b + s_b), reps=20)
    t_b, by = bound_ms(flops_ag, 2 * (AG_M * AG_K + AG_K * AG_N)
                       + 4 * 2 * AG_M * AG_N)
    rows["fused_step"] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                              bound_ms=t_b, bound_by=by)
    say(f"phase 5: fused step: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"library: none (no one call takes bf16 operands into an f32 c), "
        f"bound {t_b:.4f} ms ({by}) [{card}]")
    del cf

    # The auto rule's evidence: the loopback and its bare twin at each
    # overlap_cols of the sweep, in turns.
    sweep = {}
    for cols in OVERLAP_COLS_SWEEP:
        cfg = tg.AGGEMMConfig(overlap_cols=cols)
        sweep[cols] = (
            timer(lambda: tg.ag_gemm_loopback(a, b, segments=SEGMENTS,
                                              config=cfg), reps=20),
            timer(lambda: tg.ag_gemm_segmented_bare(
                a, b, segments=SEGMENTS, config=cfg), reps=20))
    say("phase 5: overlap_cols sweep (loopback ms / segmented bare ms): "
        + ", ".join(f"{k}: {v[0]:.4f} / {v[1]:.4f}"
                    for k, v in sweep.items()) + f" [{card}]")

    # bench.py's decomposition: its arms timed in turns, the order reversed
    # every round (A B C .. C B A ..), the median of the rounds kept.
    arms = {
        "loopback": lambda: tg.ag_gemm_loopback(a, b, segments=SEGMENTS),
        "segbare": lambda: tg.ag_gemm_segmented_bare(a, b,
                                                     segments=SEGMENTS),
        "bare": lambda: tg.matmul_cuda(a, b),
        "rs_loopback": lambda: trs.gemm_rs_loopback(ar, br,
                                                    segments=SEGMENTS),
        "rs_bare": lambda: tg.matmul_cuda(ar, br),
        "fused": lambda: tg.fused_matmul_step(c, a, b, FUSED_S),
        "fused_torch": lambda: c + torch.matmul(a, b + s_b),
    }
    rounds = {name: [] for name in arms}
    order = list(arms)
    for rnd in range(DECOMPOSITION_ROUNDS):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            rounds[name].append(timer(arms[name], reps=10))
    t = {name: statistics.median(v) for name, v in rounds.items()}
    dec = {
        "ag_gemm_loopback_m4096_qwen32b_tp8_ms": t["loopback"],
        "ag_segmented_bare_ms": t["segbare"],
        "bare_consumer_matmul_ms": t["bare"],
        "overlap_efficiency": t["bare"] / t["loopback"],
        "ag_grid_structure_ms": t["segbare"] - t["bare"],
        "ag_staging_machinery_ms": t["loopback"] - t["segbare"],
        "ag_staging_bound_ms": bound_ms(
            0, 2 * (SEGMENTS - 1) * m * AG_K * 2)[0],
        "gemm_rs_loopback_m4096_ms": t["rs_loopback"],
        "gemm_rs_bare_matmul_ms": t["rs_bare"],
        "gemm_rs_overlap_efficiency": t["rs_bare"] / t["rs_loopback"],
        "fused_step_kernel_ms": t["fused"],
        "fused_step_torch_ms": t["fused_torch"],
    }
    for key, v in dec.items():
        say(f"phase 5: {key} = {v:.4f} [{card}]")
    return launches, err, rows


# -- phase 6 -----------------------------------------------------------------

def mlp_arm(tg, tar, TPMLP, x, w_gate_up, w_down, comm: bool):
    """bench.py's M = 128 arm through the port's entry points: the matmul
    kernel's GEMMs and the GLU, then (``comm``) the one-shot all-reduce
    loopback at world 8 (``body_small_ar``), or not (``body_small_pallas``,
    the no-communication twin)."""
    h = TPMLP._glu(tg.ag_gemm_single_chip(x, w_gate_up))
    partial = tg.ag_gemm_single_chip(h, w_down)
    return tar.oneshot_ar_loopback(partial, world=AR_WORLD) if comm \
        else partial


def mlp_torch(TPMLP, x, w_gate_up, w_down):
    """bench.py's ``body_small_xla``: library GEMMs + GLU, no
    communication (a world-1 all-reduce is free)."""
    return torch.matmul(TPMLP._glu(torch.matmul(x, w_gate_up)), w_down)


def a2a_inputs(gen, counts):
    """bench.py's dispatch payloads: fp8 tokens and f32 scales, every row
    at or past its slot's count poisoned (fp8 0x7f and f32 NaN are NaN)."""
    toks = randn(gen, A2A_WORLD, A2A_CAP, A2A_HIDDEN,
                 dtype=torch.float32).to(torch.float8_e4m3fn)
    scales = torch.rand(A2A_WORLD, A2A_CAP, A2A_SCALE_COLS, generator=gen,
                        device="cuda")
    counts = torch.tensor(counts, dtype=torch.int32, device="cuda")
    live = (torch.arange(A2A_CAP, device="cuda")[None]
            < counts.clamp(0, A2A_CAP)[:, None])
    toks.view(torch.uint8)[~live] = 0x7F
    scales[~live] = float("nan")
    return toks, scales, counts, live


def check_a2a(label, tea, toks, scales, counts, live, chunk_rows):
    """The kernel under set_sync_debug_mode("error") (no host read of the
    counts) against the plain version: rows below each count byte-identical,
    the received counts equal. Returns max |got - want| over those rows."""
    ctx = tea.AllToAllContext(capacity=A2A_CAP, hidden=A2A_HIDDEN,
                              chunk_rows=chunk_rows)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (gt, gs), rc = tea.a2a_loopback((toks, scales), counts, ctx=ctx,
                                        world=A2A_WORLD)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    (wt, ws), wrc = tea.a2a_loopback_ref((toks, scales), counts, ctx=ctx,
                                         world=A2A_WORLD)
    m = live[..., None]
    same = (torch.equal(rc, wrc) and torch.equal(rc, counts)
            and torch.equal(gt.view(torch.uint8) * m, wt.view(torch.uint8) * m)
            and torch.equal(gs.view(torch.int32) * m, ws.view(torch.int32) * m))
    if not same:
        raise AssertionError(f"phase 6: a2a_loopback {label}: rows below the "
                             f"counts or the counts differ")
    err = max(torch.where(m, gt.float() - wt.float(), 0).abs().max().item(),
              torch.where(m, gs - ws, 0).abs().max().item())
    say(f"phase 6: a2a_loopback {label}: rows below the counts "
        f"byte-identical, received counts {rc.tolist()} (read after the "
        f"check), no host read inside the call")
    return err


def kernel_device_ms(fn, kernel: str, n: int = 20) -> float:
    """Mean device time of the kernel whose name holds ``kernel`` over n
    calls of fn, each after an L2 flush, from torch.profiler's kernel
    records: the card's share alone, without the host's launch path that
    CUDA events around a short call also catch. The mean is over the
    launches the profiler recorded (it may miss a few of n). A session
    that recorded none of them (seen late in a run of many sessions) is run
    again, at most three times in all; after that the device time is not
    measured and the result is NaN. It only reports a time: no check of a
    kernel's result reads it."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and kernel in ev.key]
        seen = sum(ev.count for ev in evs)
        if seen:
            break
        say(f"the profiler saw no launch of {kernel} in {n} calls "
            f"(session {attempt + 1} of 3)")
    if seen > n:
        raise AssertionError(f"the profiler saw {seen} launches of {kernel} "
                             f"in {n} calls")
    if not seen:
        say(f"{kernel}: device time alone not measured (the profiler "
            f"recorded no launch in 3 sessions)")
        return float("nan")
    return sum(ev.self_device_time_total for ev in evs) / seen / 1e3


def call_device_ms(fn, n: int = 20) -> float:
    """Mean device time of one call of fn (a library call: every kernel it
    launches, its own fills and memsets included), each call after an L2
    flush, from torch.profiler's kernel records less the flush's fill (the
    only uint8 fill). The profiler may miss a few records at a session's
    start (seen late in a run of many sessions), so each kernel's mean is
    over the launches it recorded, times its launches per call (its count
    over the flushes recorded, rounded: a call whose records were missed
    took its flush's with it, so a library call that launches one kernel
    name twice still counts 2); a session whose flushes or kernels were
    recorded too seldom for that (flushes more than a quarter of n short,
    or a count more than a quarter of the flushes from a whole number of
    launches per call) is run again, at most three times in all, and then
    the time is not measured (NaN). Only reports a time."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        flush_key = "FillFunctor<unsigned char>"
        fills = sum(ev.count for ev in evs if flush_key in ev.key)
        own = [ev for ev in evs if flush_key not in ev.key]
        whole = 4 * abs(fills - n) <= n and bool(own)
        per_call = 0.0
        for ev in own:
            k = round(ev.count / max(fills, 1))
            whole = (whole and k >= 1
                     and 4 * abs(ev.count - k * fills) <= fills)
            per_call += k * ev.self_device_time_total / ev.count
        if whole:
            return per_call / 1e3
        say(f"the profiler lost records of a library call ({fills} of {n} "
            f"flushes; session {attempt + 1} of 3)")
    return float("nan")


def b2b_ms(fn, n: int = 200) -> float:
    """Host clock per call over n back-to-back calls of fn with no flush
    and one synchronize at the end (after a warm-up): what a caller's loop
    sees, the host's launch path included wherever it outlasts the
    device's work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def collectives_back_to_back(tea, tnw, gen, tut, long_run, calls=100):
    """``calls`` calls of each of the dispatch loopback and the ring, back
    to back on one stream with no host reset and no synchronize between
    them, alternating shapes and counts (full, 13 rows a slot, zero and
    negative counts, at chunk_rows 128 and 8; the tutorial and the long
    run). Then every result must match its plain version (the a2a bytes
    below each count and the counts, the ring bit for bit) and every
    self-reset signal must be back at 0: the loopback's ticket, and the
    ring's arrival flags, ack counters and barrier counter."""
    a2a = [a2a_inputs(gen, counts) for counts in (
        [A2A_CAP] * A2A_WORLD, [A2A_LOW_COUNT] * A2A_WORLD,
        [0, -1, 0, -128, 0, 0, -7, 0])]
    rings = [(tut, TUTORIAL_CHUNK), (long_run, LONG_RUN_CHUNK)]
    ctxs = [tea.AllToAllContext(capacity=A2A_CAP, hidden=A2A_HIDDEN,
                                chunk_rows=ch) for ch in (A2A_CAP, 8)]
    torch.cuda.synchronize()
    runs = []
    for i in range(calls):
        toks, scales, counts, _ = a2a[i % 3]
        runs.append(tea.a2a_loopback_cuda((toks, scales), counts,
                                          ctx=ctxs[i % 2], world=A2A_WORLD))
        t, ch = rings[i % 2]
        runs.append(tnw.producer_consumer_cuda(t, chunk_rows=ch))
    torch.cuda.synchronize()
    for i in range(calls):
        toks, scales, counts, live = a2a[i % 3]
        (gt, gs), rc = runs[2 * i]
        m = live[..., None]
        if not (torch.equal(rc, counts)
                and torch.equal(gt.view(torch.uint8) * m,
                                toks.view(torch.uint8) * m)
                and torch.equal(gs.view(torch.int32) * m,
                                scales.view(torch.int32) * m)):
            raise AssertionError(f"phase 6: a2a_loopback call {i} of "
                                 f"{calls} back to back differs from its "
                                 f"plain version")
        t, _ = rings[i % 2]
        if not torch.equal(runs[2 * i + 1], torch.roll(t, 1, 0)):
            raise AssertionError(f"phase 6: notify_wait call {i} of {calls} "
                                 f"back to back != roll(x, 1, 0)")
    dev = tut.device
    ticket = int(tea._signal.arrivals(dev, "a2a_loopback", 1)[0])
    ring = tnw._signal.arrivals(dev, "notify_wait", 1)
    if ticket != 0 or bool(ring.any()):
        raise AssertionError(f"phase 6: a self-reset signal is not back at "
                             f"0 after {calls} calls: ticket {ticket}, ring "
                             f"signals {int(ring.count_nonzero())} nonzero")
    say(f"phase 6: {calls} calls each of a2a_loopback and notify_wait back "
        f"to back, no host reset: every result matches its plain version; "
        f"the ticket and every ring signal are back at 0")


def busy_device_ms(fn, n: int = 3) -> float:
    """Device time of one call of a long kernel, where the profiler keeps
    no record of it: CUDA events around n back-to-back calls enqueued
    behind an L2 flush, so the device never waits for the host (each launch
    is enqueued while the one before runs); the mean per call. Only
    reports a time."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flush.zero_()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def queue_after(x, chunk_rows):
    """What the ring's queue holds after a run of at least two chunks: rank
    r's slot s holds the last chunk that rank r - 1 pushed into it (chunk c
    goes to slot c % 2)."""
    n = x.shape[1] // chunk_rows
    chunks = torch.roll(x, 1, 0).view(x.shape[0], n, chunk_rows,
                                      *x.shape[2:])
    return chunks[:, [n - 1 - (n - 1 - s) % 2 for s in range(2)]]


def loopback_self_reset(tar, gen, partial, xf):
    """The all-reduce loopback with no host reset: one call at bench.py's
    shape captured in a CUDA graph and replayed REPLAYS times on fresh
    inputs, then REPLAYS eager calls back to back alternating that shape
    (world 8, bf16) and the ragged f32 one (world 3), every result the
    plain version's bits and every arrival cell 0 after; one call is one
    device operation, the kernel (its captured graph)."""
    from triton_distributed_tpu_torch.kernels import _signal

    name = tar.ONESHOT_AR_LOOPBACK.name
    side = graph_replays(
        "phase 6: oneshot_ar_loopback",
        lambda t: tar.oneshot_ar_loopback(t, world=AR_WORLD),
        partial.clone(), lambda i: randn(gen, *partial.shape),
        lambda t: tar.oneshot_ar_loopback_ref(t, world=AR_WORLD))
    cases = [(partial, AR_WORLD), (xf, 3)]
    torch.cuda.synchronize()
    outs = []
    for i in range(REPLAYS):
        t, world = cases[i % 2]
        outs.append(tar.oneshot_ar_loopback(t, world=world))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        t, world = cases[i % 2]
        if not torch.equal(got, tar.oneshot_ar_loopback_ref(t, world=world)):
            raise AssertionError(f"phase 6: oneshot_ar_loopback call {i} of "
                                 f"{REPLAYS} back to back differs from the "
                                 f"plain version")
    cells_at_zero("phase 6: oneshot_ar_loopback", _signal, name,
                  (side, torch.cuda.current_stream().cuda_stream))
    ops = captured_ops(lambda: tar.oneshot_ar_loopback(partial,
                                                       world=AR_WORLD))
    if len(ops) != 1 or "ar_loopback_kernel" not in ops[0]:
        raise AssertionError(f"phase 6: an oneshot_ar_loopback call "
                             f"enqueued {ops}, not one launch")
    say(f"phase 6: oneshot_ar_loopback: a captured call replayed {REPLAYS} "
        f"times on fresh inputs and {REPLAYS} eager calls back to back "
        f"((128, 5120) bf16 world 8 and (1000, 384) f32 world 3 in turns), "
        f"no host reset: every result bit-identical to the plain version, "
        f"every arrival cell 0 after; one call's captured graph: {ops}")


def phase_collectives(gen, kernels, card):
    """Phase 6: returns (launches, max abs errors, times) of the three
    collective kernels."""
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import allreduce as tar
    from triton_distributed_tpu_torch.kernels import ep_all_to_all as tea
    from triton_distributed_tpu_torch.kernels import notify_wait as tnw
    from triton_distributed_tpu_torch.layers import TPMLP
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    bf16 = torch.bfloat16
    x = randn(gen, AR_M, AR_D)
    w_gate_up = randn(gen, AR_D, 2 * AR_FF, scale=AR_D ** -0.5)
    w_down = randn(gen, AR_FF, AR_D, scale=AR_FF ** -0.5)
    err = dict.fromkeys(COLLECTIVE_KERNELS, 0.0)

    # (a) Each kernel against its plain version.
    partial = mlp_arm(tg, tar, TPMLP, x, w_gate_up, w_down, comm=False)
    xf = randn(gen, 1000, 384, dtype=torch.float32)
    for label, t, world in (("(128, 5120) bf16 world 8", partial, AR_WORLD),
                            ("(1000, 384) f32 world 3", xf, 3)):
        got = tar.oneshot_ar_loopback_cuda(t, world=world)
        want = tar.oneshot_ar_loopback_ref(t, world=world)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 6: oneshot_ar_loopback {label}: "
                                 f"not bit-identical to the plain version")
        if world == AR_WORLD and not torch.equal(got, 8 * t):
            raise AssertionError("phase 6: oneshot_ar_loopback != 8 x")
        say(f"phase 6: oneshot_ar_loopback {label}: bit-identical to the "
            f"plain version" + (", == 8 x" if world == AR_WORLD else ""))
    undelayed = tar.oneshot_ar_loopback_cuda(partial, world=AR_WORLD)
    staging = torch.full((AR_WORLD - 1, *partial.shape), float("nan"),
                         dtype=bf16, device="cuda")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    delayed = tar.oneshot_ar_loopback_cuda(partial, world=AR_WORLD,
                                           staging=staging,
                                           producer_delay_ns=PRODUCER_DELAY_NS)
    t1.record()
    torch.cuda.synchronize()
    if not torch.equal(delayed, undelayed):
        raise AssertionError("phase 6: the delayed producers changed the "
                             "all-reduce loopback's result")
    # The pushes landed: every slot now holds x, so the fold read them.
    if not torch.equal(staging, partial.expand_as(staging)):
        raise AssertionError("phase 6: a staging slot does not hold x after "
                             "the all-reduce loopback")
    say(f"phase 6: oneshot_ar_loopback with every producer held back 1 ms "
        f"behind NaN staging: call took {t0.elapsed_time(t1):.3f} ms, "
        f"result bit-identical to the undelayed run, every slot == x")
    loopback_self_reset(tar, gen, partial, xf)
    del staging, delayed, undelayed, xf

    full = a2a_inputs(gen, [A2A_CAP] * A2A_WORLD)
    err["a2a_loopback"] = max(
        check_a2a("bench shape, full occupancy, chunk_rows 128", tea, *full,
                  A2A_CAP),
        check_a2a(f"counts {A2A_RAGGED_COUNTS}, chunk_rows "
                  f"{A2A_RAGGED_CHUNK}", tea,
                  *a2a_inputs(gen, A2A_RAGGED_COUNTS), A2A_RAGGED_CHUNK))

    tut = randn(gen, *TUTORIAL_SHAPE, dtype=torch.float32)
    long_run = randn(gen, *LONG_RUN_SHAPE, dtype=torch.float32)
    for label, t, ch, delay in (
            ("tutorial shape", tut, TUTORIAL_CHUNK, 0),
            ("long run", long_run, LONG_RUN_CHUNK, 0),
            ("long run, odd ranks' producers delayed", long_run,
             LONG_RUN_CHUNK, ODD_RANK_DELAY_NS)):
        queue = torch.full((t.shape[0], 2, ch, *t.shape[2:]), float("nan"),
                           device="cuda")
        got = tnw.producer_consumer_cuda(t, chunk_rows=ch, queue=queue,
                                         producer_delay_ns=delay)
        if not torch.equal(got, torch.roll(t, 1, 0)):
            raise AssertionError(f"phase 6: notify_wait {label}: out != "
                                 f"roll(x, 1, 0)")
        if not torch.equal(queue, queue_after(t, ch)):
            raise AssertionError(f"phase 6: notify_wait {label}: the queue "
                                 f"does not hold the last pushes")
        say(f"phase 6: notify_wait {label} {tuple(t.shape)}, chunks of "
            f"{ch} rows: out == roll(x, 1, 0), each NaN queue slot holds "
            f"the last chunk pushed into it")
    collectives_back_to_back(tea, tnw, gen, tut, long_run)

    # (b) The path, once, with the counts reset: bench.py's arms.
    a2a_ctx = tea.AllToAllContext(capacity=A2A_CAP, hidden=A2A_HIDDEN,
                                  chunk_rows=A2A_CAP)
    toks, scales, counts, _ = full
    arms = {
        "ar arm": (lambda: mlp_arm(tg, tar, TPMLP, x, w_gate_up, w_down,
                                   comm=True),
                   {"matmul": 2, "oneshot_ar_loopback": 1}),
        "no-communication arm": (lambda: mlp_arm(
            tg, tar, TPMLP, x, w_gate_up, w_down, comm=False),
            {"matmul": 2}),
        "torch.matmul arm": (lambda: mlp_torch(TPMLP, x, w_gate_up, w_down),
                             {}),
        "a2a arm": (lambda: tea.a2a_loopback((toks, scales), counts,
                                             ctx=a2a_ctx, world=A2A_WORLD),
                    {"a2a_loopback": 1}),
        "tutorial": (lambda: tnw.producer_consumer(
            tut, chunk_rows=TUTORIAL_CHUNK), {"notify_wait": 1}),
    }
    kernels.reset_counts()
    outs, before = {}, {k: 0 for k in kernels.KERNELS}
    for label, (fn, want) in arms.items():
        outs[label] = fn()
        now = {k: v.launches for k, v in kernels.KERNELS.items()}
        diff = {k: now[k] - before[k] for k in now if now[k] != before[k]}
        if diff != want:
            raise AssertionError(f"phase 6: {label} launches {diff} != "
                                 f"{want}")
        before = now
    torch.cuda.synchronize()
    launches = {k: before[k] for k in COLLECTIVE_KERNELS}
    say(f"phase 6: path launches {launches}, each arm's exact")
    if not torch.equal(outs["ar arm"], 8 * outs["no-communication arm"]):
        raise AssertionError("phase 6: the ar arm != 8 x the "
                             "no-communication arm")
    check_close("phase 6: torch.matmul arm vs the kernels'",
                outs["no-communication arm"], outs["torch.matmul arm"], bf16)
    (ot, osc), orc = outs["a2a arm"]
    if not (torch.equal(ot.view(torch.uint8), toks.view(torch.uint8))
            and torch.equal(osc, scales) and torch.equal(orc, counts)):
        raise AssertionError("phase 6: a2a arm did not round-trip")
    if not torch.equal(outs["tutorial"], torch.roll(tut, 1, 0)):
        raise AssertionError("phase 6: tutorial path != roll(x, 1, 0)")
    del outs

    # (c) Times.
    timer = Timer("cuda")
    rows = {}
    nbytes = partial.numel() * partial.element_size()
    t_k = timer(lambda: tar.oneshot_ar_loopback_cuda(partial,
                                                     world=AR_WORLD), reps=50)
    t_p = timer(lambda: tar.oneshot_ar_loopback_ref(partial, world=AR_WORLD),
                reps=20)
    t_d = kernel_device_ms(lambda: tar.oneshot_ar_loopback_cuda(
        partial, world=AR_WORLD), "ar_loopback_kernel")
    t_l = timer(lambda: partial.mul(AR_WORLD), reps=50)
    t_ld = call_device_ms(lambda: partial.mul(AR_WORLD))
    t_b, by = bound_ms(0, pm.oneshot_ar_loopback_bytes(nbytes))
    b_k = b2b_ms(lambda: tar.oneshot_ar_loopback(partial, world=AR_WORLD))
    b_l = b2b_ms(lambda: partial.mul(AR_WORLD))
    rows["oneshot_ar_loopback"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                       bound_ms=t_b, bound_by=by, b2b_ms=b_k,
                                       library_b2b_ms=b_l)
    met = (t_k / t_l <= AR_LOOPBACK_BAR
           and t_d <= AR_LOOPBACK_DEVICE_BAR_MS)
    say(f"phase 6: oneshot_ar_loopback (128, 5120) bf16 world 8: kernel "
        f"{t_k:.4f} ms (device alone {t_d:.4f}), plain {t_p:.4f} ms, "
        f"x.mul(8) (the same bits) {t_l:.4f} ms (device alone {t_ld:.4f}), "
        f"bound {t_b:.4f} ms ({by}); events / library {t_k / t_l:.3f} (bar "
        f"<= {AR_LOOPBACK_BAR}), device bar <= {AR_LOOPBACK_DEVICE_BAR_MS} "
        f"ms: {'met' if met else 'missed'}; host clock back to back, per "
        f"call: kernel {b_k:.4f} ms, x.mul(8) {b_l:.4f} ms [{card}]")

    a2a_rows = [A2A_HIDDEN, A2A_SCALE_COLS * 4]
    low = a2a_inputs(gen, [A2A_LOW_COUNT] * A2A_WORLD)
    a2a_t = {}
    for label, (tk, sc, cn, _) in (("full", full), ("10%", low)):
        def call():
            return tea.a2a_loopback_cuda((tk, sc), cn, ctx=a2a_ctx,
                                         world=A2A_WORLD)
        a2a_t[label] = (
            timer(call, reps=50),
            kernel_device_ms(call, "a2a_loopback_kernel"),
            bound_ms(0, pm.a2a_loopback_bytes(cn.tolist(), A2A_CAP,
                                              a2a_rows)))
    t_k, t_d, (t_b, by) = a2a_t["full"]
    t_p = timer(lambda: tea.a2a_loopback_ref((toks, scales), counts,
                                             ctx=a2a_ctx, world=A2A_WORLD),
                reps=20)
    dst_t, dst_s = torch.empty_like(toks), torch.empty_like(scales)

    def copies():
        dst_t.copy_(toks)
        dst_s.copy_(scales)

    t_l = timer(copies, reps=50)
    b_k = b2b_ms(lambda: tea.a2a_loopback_cuda((toks, scales), counts,
                                               ctx=a2a_ctx, world=A2A_WORLD))
    b_l = b2b_ms(copies)
    rows["a2a_loopback"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=t_b, bound_by=by, b2b_ms=b_k,
                                library_b2b_ms=b_l)
    say(f"phase 6: a2a_loopback bench shape, full occupancy: kernel "
        f"{t_k:.4f} ms (device alone {t_d:.4f}), plain {t_p:.4f} ms, copy_ "
        f"of both payloads {t_l:.4f} ms, bound {t_b:.4f} ms ({by}); host "
        f"clock back to back, per call: kernel {b_k:.4f} ms, copy_ "
        f"{b_l:.4f} ms [{card}]")
    lk, ld, (lb, _) = a2a_t["10%"]
    say(f"phase 6: a2a_loopback at {A2A_LOW_COUNT} rows a slot (~10%): "
        f"kernel {lk:.4f} ms (device alone {ld:.4f}), bound {lb:.4f} ms; "
        f"full / 10% time {t_k / lk:.2f}x (device {t_d / ld:.2f}x) for "
        f"{t_b / lb:.2f}x the bytes [{card}]")
    # The pieces inside a chunk against one work item per chunk: the
    # kernel's device time (the host's path is the same for both), in turns.
    pieces = {tea.PIECE_BYTES: [], A2A_CAP * A2A_HIDDEN: []}
    (ct, cs), _ = tea.a2a_loopback_cuda((toks, scales), counts, ctx=a2a_ctx,
                                        world=A2A_WORLD,
                                        piece_bytes=A2A_CAP * A2A_HIDDEN)
    if not (torch.equal(ct.view(torch.uint8), toks.view(torch.uint8))
            and torch.equal(cs, scales)):
        raise AssertionError("phase 6: a2a_loopback with one item per chunk "
                             "did not round-trip")
    for rnd in range(DECOMPOSITION_ROUNDS):
        for pb in (list(pieces) if rnd % 2 == 0 else list(pieces)[::-1]):
            pieces[pb].append(kernel_device_ms(lambda: tea.a2a_loopback_cuda(
                (toks, scales), counts, ctx=a2a_ctx, world=A2A_WORLD,
                piece_bytes=pb), "a2a_loopback_kernel", n=10))
    t_pc, t_ch = (statistics.median(v) for v in pieces.values())
    say(f"phase 6: a2a_loopback full occupancy, device alone, median of "
        f"{DECOMPOSITION_ROUNDS} rounds: pieces of {tea.PIECE_BYTES} B "
        f"{t_pc:.4f} ms, one item per chunk {t_ch:.4f} ms [{card}]")

    tut_rows = {}
    for label, t, ch in (("tutorial shape", tut, TUTORIAL_CHUNK),
                         ("long run", long_run, LONG_RUN_CHUNK)):
        nb = pm.producer_consumer_bytes(t.numel() * t.element_size())
        t_k = timer(lambda: tnw.producer_consumer_cuda(t, chunk_rows=ch),
                    reps=50)
        t_p = timer(lambda: tnw.producer_consumer_ref(t, chunk_rows=ch),
                    reps=50)
        t_d = kernel_device_ms(lambda: tnw.producer_consumer_cuda(
            t, chunk_rows=ch), "notify_wait_kernel")
        t_l = timer(lambda: torch.roll(t, 1, 0), reps=50)
        b_k = b2b_ms(lambda: tnw.producer_consumer_cuda(t, chunk_rows=ch))
        b_l = b2b_ms(lambda: torch.roll(t, 1, 0))
        t_b, by = bound_ms(0, nb)
        tut_rows[label] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                               bound_ms=t_b, bound_by=by, b2b_ms=b_k,
                               library_b2b_ms=b_l)
        say(f"phase 6: notify_wait {label} {tuple(t.shape)}: kernel "
            f"{t_k:.4f} ms (device alone {t_d:.4f}), plain {t_p:.4f} ms, "
            f"torch.roll {t_l:.4f} ms, bound {t_b:.6f} ms ({by}); host "
            f"clock back to back, per call: kernel {b_k:.4f} ms, "
            f"torch.roll {b_l:.4f} ms [{card}]")
    rows["notify_wait"] = tut_rows["tutorial shape"]

    # bench.py's decomposition (:3108, :3119-3126): the arms timed in turns,
    # the order reversed every round, the median of the rounds kept.
    dec_arms = {name: arms[label][0] for name, label in (
        ("ar", "ar arm"), ("nocomm", "no-communication arm"),
        ("xla", "torch.matmul arm"), ("a2a", "a2a arm"))}
    tk, sc, cn, _ = low
    dec_arms["a2a_low"] = lambda: tea.a2a_loopback(
        (tk, sc), cn, ctx=a2a_ctx, world=A2A_WORLD)
    rounds = {name: [] for name in dec_arms}
    order = list(dec_arms)
    for rnd in range(DECOMPOSITION_ROUNDS):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            rounds[name].append(timer(dec_arms[name], reps=10))
    t = {name: statistics.median(v) for name, v in rounds.items()}
    a2a_bound = a2a_t["full"][2][0]
    dec = {
        "mlp_m128_ar_loopback_ms": t["ar"],
        "mlp_m128_pallas_nocomm_ms": t["nocomm"],
        "mlp_m128_xla_free_comm_ms": t["xla"],
        "mlp_m128_weight_stream_floor_ms": bound_ms(
            0, (AR_D * 2 * AR_FF + AR_FF * AR_D) * 2)[0],
        "mlp_m128_ar_machinery_ms": t["ar"] - t["nocomm"],
        "mlp_m128_ar_ratio": t["xla"] / t["ar"],
        "a2a_dispatch_loopback_us": t["a2a"] * 1e3,
        "a2a_loopback_hbm_frac": a2a_bound / t["a2a"],
        "a2a_dispatch_loopback_10pct_us": t["a2a_low"] * 1e3,
    }
    for key, v in dec.items():
        say(f"phase 6: {key} = {v:.4f} [{card}]")
    return launches, err, rows

# -- phase 7 -----------------------------------------------------------------

def tp_exact(gen, world, M, k, N, dtype=torch.bfloat16):
    """GEMM-RS operands whose products are exact in f32 (one small integer
    per row of a, bf16 values in b): every partial is the same bits in any
    summation order, so the fold can be held bit for bit."""
    a = torch.zeros(world, M, k, device="cuda")
    cols = torch.randint(0, k, (world, M, 1), generator=gen, device="cuda")
    vals = torch.randint(1, 4, (world, M, 1), generator=gen, device="cuda")
    a.scatter_(2, cols, vals.float())
    return a.to(dtype), randn(gen, world, k, N).to(dtype)


def tp_check_ag(tg, label, a, b, err, delayed=False, phase="phase 7"):
    """One AG-GEMM case against the plain version; the staging must hold
    every rank's gathered A. ``delayed``: again with the producers held
    back 1 ms behind NaN staging, bit-identical."""
    world, m, K = a.shape
    n = b.shape[2]
    got, staged = tg.ag_gemm_cuda(a, b, cols=n)
    want, want_staged = tg.ag_gemm_ref(a, b, cols=n)
    e = check_close(f"{phase}: ag_gemm {label}", got, want, a.dtype)
    if not torch.equal(staged, want_staged):
        raise AssertionError(f"{phase}: ag_gemm {label}: staging != the "
                             f"gathered A")
    note = ""
    if delayed:
        poison = torch.full_like(staged, float("nan"))
        slow, _ = tg.ag_gemm_cuda(a, b, cols=n, staging=poison,
                                  producer_delay_ns=PRODUCER_DELAY_NS)
        if not (torch.equal(slow, got) and torch.equal(poison, staged)):
            raise AssertionError(f"{phase}: ag_gemm {label}: delayed "
                                 f"producers changed the result or staging")
        note = "; 1 ms-delayed producers behind NaN staging: bit-identical"
    err["ag_gemm"] = max(err["ag_gemm"], e)
    say(f"{phase}: ag_gemm {label} a {tuple(a.shape)} b {tuple(b.shape)} "
        f"{str(a.dtype)[6:]}: max_abs_err {e:.4g}, staging == gathered A"
        f"{note}")


def tp_check_rs(trs, label, a, b, err, exact=False, phase="phase 7"):
    """One GEMM-RS case against the plain version. ``exact`` (exact
    products): bit for bit, the staging holding every pushed partial, and
    again with the product tiles held back 1 ms behind NaN staging."""
    got, staging = trs.gemm_rs_cuda(a, b)
    if exact:
        want, want_staging = trs.gemm_rs_fold(trs.gemm_rs_partials(a, b),
                                              a.dtype, return_staging=True)
        poison = torch.full_like(staging, float("nan"))
        slow, _ = trs.gemm_rs_cuda(a, b, staging=poison,
                                   producer_delay_ns=PRODUCER_DELAY_NS)
        if not (torch.equal(got, want) and torch.equal(staging, want_staging)
                and torch.equal(slow, got) and torch.equal(poison, staging)):
            raise AssertionError(f"phase 7: gemm_rs {label}: the fold or "
                                 f"its staging is not the plain version's")
        say(f"phase 7: gemm_rs {label} {tuple(a.shape)} x {tuple(b.shape)}: "
            f"bit-identical fold and staging, also with 1 ms-delayed "
            f"product tiles behind NaN staging")
        return
    e = check_close(f"{phase}: gemm_rs {label}", got, trs.gemm_rs_ref(a, b),
                    a.dtype)
    err["gemm_rs"] = max(err["gemm_rs"], e)
    say(f"{phase}: gemm_rs {label} {tuple(a.shape)} x {tuple(b.shape)} "
        f"{str(a.dtype)[6:]}: max_abs_err {e:.4g}")


def tp_check_ar(tar, label, x, err):
    """Both all-reduces bit for bit their plain versions, every rank's copy
    equal, every staging slot what was pushed, and again with the
    producers held back 1 ms behind NaN staging."""
    world = x.shape[0]
    runs = {"oneshot_ar": (tar.oneshot_all_reduce_cuda,
                           tar.oneshot_all_reduce_ref(x))}
    if x.shape[1] % world == 0:
        runs["twoshot_ar"] = (tar.twoshot_all_reduce_cuda,
                              tar.twoshot_all_reduce_ref(x))
    pushed = torch.stack([torch.stack([x[s] for s in range(world) if s != d])
                          for d in range(world)])
    for name, (run, want) in runs.items():
        got, staging = run(x)
        if name == "twoshot_ar":
            _, pushed = tar.twoshot_all_reduce_ref(x, return_staging=True)
        poison = torch.full_like(staging, float("nan"))
        slow, _ = run(x, staging=poison, producer_delay_ns=PRODUCER_DELAY_NS)
        ok = (torch.equal(got, want) and torch.equal(staging, pushed)
              and torch.equal(slow, got) and torch.equal(poison, staging)
              and all(torch.equal(got[r], got[0]) for r in range(world)))
        if not ok:
            raise AssertionError(f"phase 7: {name} {label}: not the plain "
                                 f"version's bits")
        err[name] = max(err[name], 0.0)
        say(f"phase 7: {name} {label} {tuple(x.shape)} {str(x.dtype)[6:]}: "
            f"bit-identical to the plain version, every copy equal, staging "
            f"== the pushes; 1 ms-delayed producers behind NaN staging: "
            f"the same")


def oneshot_bars(tar, x, row, gen, card):
    """The one-shot all-reduce's serving path against its bars: at
    bench.py's shape the device time alone (<= 0.050 ms) and events /
    x.float().sum(0) (<= 2.0); the same figures at the ar serve's decode
    shape, without a bar; and at each, CUDA events over 50 launches back to
    back with no L2 flush between them (a run of calls' steady state).
    Prints, does not fail: a missed bar is recorded with its numbers."""
    w = x.shape[0]
    cases = (("bench", x, row),
             ("decode", randn(gen, w, 8, TP_AR[1]), None))
    for label, xs, r in cases:
        run = lambda: tar.oneshot_all_reduce(xs, world=w)
        if not torch.equal(run(), tar.oneshot_all_reduce_ref(xs)):
            raise AssertionError(f"phase 7: oneshot_ar {label}: not the "
                                 f"plain version's bits")
        if r is None:
            r = dict(ms=Timer("cuda")(run, reps=50),
                     device_ms=kernel_device_ms(run, "oneshot_ar_kernel"),
                     library_ms=Timer("cuda")(lambda: xs.float().sum(0),
                                              reps=50))
        b2b = busy_device_ms(run, n=50)
        bar = (f" (bars: device <= 0.050 ms: "
               f"{'met' if r['device_ms'] <= 0.050 else 'missed'}; events / "
               f"library <= 2.0: "
               f"{'met' if r['ms'] / r['library_ms'] <= 2.0 else 'missed'})"
               if label == "bench" else " (no bar)")
        say(f"phase 7: oneshot_ar serving path {label} {tuple(xs.shape)} "
            f"bf16: events {r['ms']:.4f} ms, device alone "
            f"{r['device_ms']:.4f} ms, 50 back to back without a flush "
            f"{b2b:.4f} ms a call, library x.float().sum(0) "
            f"{r['library_ms']:.4f} ms, events / library "
            f"{r['ms'] / r['library_ms']:.3f}{bar} [{card}]")


def phase_tp_kernels(gen, kernels, card):
    """Phase 7 (a): the four multi-rank kernels against their plain
    versions at bench.py's shapes, m = 1 and f32; (c) their times. Returns
    (max abs errors, times)."""
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import allreduce as tar
    from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    w, f32 = TP_WORLD, torch.float32
    err = dict.fromkeys(TP_KERNELS, 0.0)
    m, K, n = TP_AG
    a = randn(gen, w, m, K)
    b = randn(gen, w, K, n, scale=K ** -0.5)
    tp_check_ag(tg, "bench", a, b, err, delayed=True)
    tp_check_ag(tg, "m = 1", a[:, :1].contiguous(), b, err)
    tp_check_ag(tg, "f32", randn(gen, w, 16, 1024, dtype=f32),
                randn(gen, w, 1024, 1024, dtype=f32, scale=1024 ** -0.5),
                err, delayed=True)
    # bf16 rows that TMA cannot read (n 130): the mma.sync tile, one launch
    # a call, where the port used to raise.
    kernels.reset_counts()
    tp_check_ag(tg, "rows TMA cannot read (mma.sync tile)",
                randn(gen, 3, 40, 72), randn(gen, 3, 72, 130,
                                             scale=72 ** -0.5),
                err, delayed=True)
    if kernels.KERNELS["ag_gemm"].launches != 2:
        raise AssertionError("phase 7: ag_gemm at n 130 took "
                             f"{kernels.KERNELS['ag_gemm'].launches} "
                             f"launches for two calls")
    split = tg.AGGEMMConfig(overlap_cols=JAX_SPLIT_COLS)
    kernels.reset_counts()
    got = tg.ag_gemm_device(a, b, world=w, config=split)
    tails = kernels.KERNELS["matmul_tail_into"].launches
    e = check_close("phase 7: ag_gemm + tail", got,
                    tg.ag_gemm_ref(a, b, cols=n)[0], torch.bfloat16)
    if tails != w:
        raise AssertionError(f"phase 7: the {JAX_SPLIT_COLS}-column split "
                             f"ran matmul_tail_into {tails} times, not {w}")
    say(f"phase 7: ag_gemm at the JAX split (overlap_cols "
        f"{JAX_SPLIT_COLS}, the tail in matmul_tail_into per rank, {tails} "
        f"launches): max_abs_err {e:.4g}")
    del got

    M, k, N = TP_RS
    ar_, br_ = randn(gen, w, M, k), randn(gen, w, k, N, scale=k ** -0.5)
    tp_check_rs(trs, "bench", ar_, br_, err)
    tp_check_rs(trs, "m = 1", ar_[:, :w].contiguous(), br_, err)
    tp_check_rs(trs, "f32", randn(gen, w, 256, 512, dtype=f32),
                randn(gen, w, 512, 640, dtype=f32, scale=512 ** -0.5), err)
    tp_check_rs(trs, "exact bf16", *tp_exact(gen, w, 1024, 256, 640), err,
                exact=True)
    tp_check_rs(trs, "exact f32", *tp_exact(gen, w, 64, 96, 200, f32), err,
                exact=True)
    # Each item set of gemm_rs.cuh on exact products: the own product folded
    # with the tickets rank by rank (one expert's operands past
    # GROUPED_BYTES), fold tiles straddling segments (own rows through f32
    # scratch), rows TMA cannot read (the mma.sync tile).
    for label, shape in (("exact bf16, rank by rank", (1024, 1024, 1024)),
                         ("exact bf16, straddling tiles", (1600, 64, 256)),
                         ("exact bf16, rows TMA cannot read", (480, 33, 130))):
        tp_check_rs(trs, label, *tp_exact(gen, w, *shape), err, exact=True)

    x = randn(gen, w, *TP_AR)
    tp_check_ar(tar, "bench", x, err)
    tp_check_ar(tar, "m = 1 (two-shot: m = world)", x[:, :w].contiguous(),
                err)
    tp_check_ar(tar, "f32", randn(gen, w, 1000, 384, dtype=f32), err)
    for shape in ((w, 8, 5120), (w, 128, 5120), (w, 1024, 5120)):
        nb = math.prod(shape[1:]) * 2
        say(f"phase 7: choose_all_reduce_method at {shape} bf16 "
            f"({nb} B a rank): "
            f"{tar.choose_all_reduce_method(w, nb, shape[1]).value} (one-shot "
            f"{pm.est_oneshot_all_reduce(nb, w) * 1e6:.2f} us, two-shot "
            f"{pm.est_twoshot_all_reduce(nb, w) * 1e6:.2f} us by the model: "
            f"NVLink figures published, hop latency assumed)")

    # (c) Times: kernel (CUDA events, L2 flushed), device alone
    # (torch.profiler), plain, one library call where there is one, bound.
    timer = Timer("cuda")
    rows = {}
    gathered = a.reshape(1, w * m, K)
    t_k = timer(lambda: tg.ag_gemm_cuda(a, b, cols=n), reps=10)
    t_d = kernel_device_ms(lambda: tg.ag_gemm_cuda(a, b, cols=n),
                           "ag_gemm_kernel", n=10)
    t_p = timer(lambda: tg.ag_gemm_ref(a, b, cols=n), reps=3)
    t_l = timer(lambda: torch.matmul(gathered, b), reps=10)
    say(f"phase 7: ag_gemm (wgmma tile N = 128, TMA) at ({w}, {m}, {K}) x "
        f"({w}, {K}, {n}): kernel {t_k:.4f} ms, device alone {t_d:.4f} ms, "
        f"library {t_l:.4f} ms, kernel / library {t_k / t_l:.3f} [{card}]")
    t_b, by = bound_ms(pm.ag_gemm_flops(w, m, K, n),
                       pm.ag_gemm_bytes(w, m, K, n, 2))
    rows["ag_gemm"] = dict(ms=t_k, device_ms=t_d, plain_ms=t_p,
                           library_ms=t_l, bound_ms=t_b, bound_by=by)
    t_k = timer(lambda: trs.gemm_rs_cuda(ar_, br_), reps=10)
    t_d = kernel_device_ms(lambda: trs.gemm_rs_cuda(ar_, br_),
                           "gemm_rs_kernel", n=10)
    t_p = timer(lambda: trs.gemm_rs_ref(ar_, br_), reps=3)
    # One library call: torch.addbmm sums a[r] @ b[r] over the ranks; owner
    # d's rows are a view of it. Beside it the two-call matmul and sum.
    z = torch.empty(M, N, dtype=ar_.dtype, device="cuda")
    t_l = timer(lambda: torch.addbmm(z, ar_, br_, beta=0), reps=10)
    t_l2 = timer(lambda: torch.matmul(ar_, br_).sum(0), reps=10)
    t_b, by = bound_ms(pm.gemm_rs_flops(w, M, k, N),
                       pm.gemm_rs_bytes(w, M, k, N, 2))
    rows["gemm_rs"] = dict(ms=t_k, device_ms=t_d, plain_ms=t_p,
                           library_ms=t_l, bound_ms=t_b, bound_by=by)
    t_ld = call_device_ms(lambda: torch.addbmm(z, ar_, br_, beta=0), n=10)
    say(f"phase 7: gemm_rs prefill ({w}, {M}, {k}) x ({w}, {k}, {N}): kernel "
        f"{t_k:.4f} ms (device alone {t_d:.4f}), torch.addbmm {t_l:.4f} ms "
        f"(device alone {t_ld:.4f}), torch.matmul(a, b).sum(0) {t_l2:.4f} "
        f"ms (two calls), kernel / the faster library "
        f"{t_k / min(t_l, t_l2):.3f} [{card}]")
    ad, zd = ar_[:, :w].contiguous(), z[:w]
    t_k = timer(lambda: trs.gemm_rs_cuda(ad, br_), reps=20)
    t_d = kernel_device_ms(lambda: trs.gemm_rs_cuda(ad, br_),
                           "gemm_rs_kernel")
    t_l = timer(lambda: torch.addbmm(zd, ad, br_, beta=0), reps=20)
    t_l2 = timer(lambda: torch.matmul(ad, br_).sum(0), reps=20)
    t_bd, byd = bound_ms(pm.gemm_rs_flops(w, w, k, N),
                         pm.gemm_rs_bytes(w, w, k, N, 2))
    say(f"phase 7: gemm_rs decode ({w}, {w}, {k}) x ({w}, {k}, {N}) (m = "
        f"1): kernel {t_k:.4f} ms (device alone {t_d:.4f}), torch.addbmm "
        f"{t_l:.4f} ms, torch.matmul(a, b).sum(0) {t_l2:.4f} ms (two calls), "
        f"bound {t_bd:.4f} ms ({byd}) [{card}]")
    del z, ad, zd
    nb = x[0].numel() * x.element_size()
    t_l = timer(lambda: x.float().sum(0), reps=50)
    t_b, by = bound_ms(0, pm.all_reduce_bytes(w, nb))
    # The one-shot all-reduce is timed on the serving path (its persistent
    # staging: oneshot_all_reduce), the two-shot on its kernel entry.
    for name, run, ref, kern in (
            ("oneshot_ar", lambda x: tar.oneshot_all_reduce(x, world=w),
             tar.oneshot_all_reduce_ref, "oneshot_ar_kernel"),
            ("twoshot_ar", tar.twoshot_all_reduce_cuda,
             tar.twoshot_all_reduce_ref, "twoshot_ar_kernel")):
        rows[name] = dict(
            ms=timer(lambda: run(x), reps=50),
            device_ms=kernel_device_ms(lambda: run(x), kern),
            plain_ms=timer(lambda: ref(x), reps=10), library_ms=t_l,
            bound_ms=t_b, bound_by=by)
    oneshot_bars(tar, x, rows["oneshot_ar"], gen, card)
    for name, r in rows.items():
        say(f"phase 7: {name} times: kernel {r['ms']:.4f} ms (device alone "
            f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); one card stands in for {w}: the link is "
            f"bypassed [{card}]")
    say("phase 7: library calls: ag_gemm torch.matmul of the gathered A "
        "against b; gemm_rs torch.addbmm over the rank stack (one call; "
        "the two-call torch.matmul(a, b).sum(0) printed beside it); the "
        "all-reduces x.float().sum(0)")
    return err, rows


def tp_small_engines(Engine, ModelConfig, kernels):
    """Phase 7 (b): fp32 tiny at world 8, dist and ar tokens == xla."""
    cfg = ModelConfig.from_name("tiny")
    ids = torch.randint(0, cfg.vocab_size, (8, 8), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(5), dtype=torch.int32)
    xla = Engine(cfg, mode="xla", device="cuda", seed=3, world=TP_WORLD)
    want = xla.serve(ids, 6)
    for mode, used in (("dist", ("ag_gemm", "gemm_rs")),
                       ("ar", ("oneshot_ar",))):
        eng = Engine(cfg, mode=mode, device="cuda", params=xla.params,
                     world=TP_WORLD)
        kernels.reset_counts()
        got = eng.serve(ids, 6)
        counts = {k: kernels.KERNELS[k].launches for k in TP_KERNELS}
        if not torch.equal(got, want):
            raise AssertionError(f"phase 7: tiny world 8 {mode} tokens "
                                 f"{got.tolist()} != xla {want.tolist()}")
        if min(counts[k] for k in used) == 0:
            raise AssertionError(f"phase 7: tiny {mode}: launches {counts}")
        say(f"phase 7: tiny fp32 world {TP_WORLD} B=8 L0=8 gen 6: {mode} == "
            f"xla tokens, launches {counts}")


def tp_serve(eng, ids, kernels, expected, label):
    """One Engine.serve of the slice with the counts reset just before and
    read just after; returns (tokens, serve seconds, launches)."""
    kernels.reset_counts()
    t0 = time.perf_counter()
    tokens = eng.serve(ids, TP_GEN)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    say(f"phase 7: {label} serve B={TP_B} L0={TP_L0} gen={TP_GEN} launches "
        f"{launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"phase 7: {label} launch counts {launches} != "
                             f"{expected}")
    if tokens.shape != (TP_B, TP_GEN) or not (
            (tokens >= 0) & (tokens < eng.config.vocab_size)).all():
        raise AssertionError(f"phase 7: {label} tokens out of range")
    return tokens, t_serve, launches


def tp_ttft(eng, ids):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = eng.prefill(ids, eng.new_cache(TP_B))
    torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0


def phase_tp_slice(Engine, ModelConfig, kernels, card):
    """Phase 7 (d): Qwen3-32B at world 8, full width and depth, through
    Engine.serve in dist and in ar mode, each held against the xla golden;
    then the host all_reduce at bench.py's shape (two-shot by the model).
    Returns the path's launches."""
    from triton_distributed_tpu_torch.kernels import allreduce as tar

    cfg = ModelConfig.from_name("qwen3-32b")
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dist = Engine(cfg, mode="dist", device="cuda", seed=0, world=TP_WORLD,
                  max_length=TP_MAXLEN)
    torch.cuda.synchronize()
    say(f"phase 7: qwen3-32b world {TP_WORLD} random init "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ids = torch.randint(0, cfg.vocab_size, (TP_B, TP_L0), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7), dtype=torch.int32)
    dist.serve(ids[:, :64], 2)  # warm-up: kernel library, allocator
    base = {k: 0 for k in kernels.KERNELS}
    flash = {"flash_prefill": L, "flash_decode": L * (TP_GEN - 1)}
    forwards = TP_GEN
    launches = {}
    tokens, t_serve, got = tp_serve(dist, ids, kernels, {
        **base, **flash, "ag_gemm": 2 * L * forwards,
        "gemm_rs": 2 * L * forwards}, "dist")
    launches.update(ag_gemm=got["ag_gemm"], gemm_rs=got["gemm_rs"])
    logits, ttft = tp_ttft(dist, ids)
    xla = Engine(cfg, mode="xla", device="cuda", params=dist.params,
                 world=TP_WORLD, max_length=TP_MAXLEN)
    x_logits, x_ttft = tp_ttft(xla, ids)
    if not golden_bars("phase 7: dist prefill logits vs xla", logits,
                       x_logits):
        raise AssertionError("phase 7: dist prefill logits disagree with the "
                             "xla golden")
    del logits
    x_tokens = xla.serve(ids, TP_GEN)
    decode_s = max(t_serve - ttft, 1e-9)
    say(f"phase 7: dist greedy tokens equal to xla's: "
        f"{100 * (x_tokens == tokens).float().mean().item():.1f}% of "
        f"{TP_B}x{TP_GEN}, first tokens "
        f"{100 * (x_tokens[:, 0] == tokens[:, 0]).float().mean().item():.1f}%"
        f" (information: bf16 sums in other orders flip near-ties)")
    say(f"phase 7: dist TTFT {ttft * 1e3:.2f} ms (prefill of {TP_B}x{TP_L0} "
        f"+ argmax; xla golden {x_ttft * 1e3:.2f} ms), serve {t_serve:.3f} "
        f"s, decode {TP_B * (TP_GEN - 1) / decode_s:.1f} tokens/s ({TP_B} "
        f"rows) [{card}]")

    ar = Engine(cfg, mode="ar", device="cuda", params=dist.params,
                world=TP_WORLD, max_length=TP_MAXLEN)
    tokens, t_serve, got = tp_serve(ar, ids, kernels, {
        **base, **flash, "oneshot_ar": 2 * L * forwards}, "ar")
    launches["oneshot_ar"] = got["oneshot_ar"]
    logits, ttft = tp_ttft(ar, ids)
    if not golden_bars("phase 7: ar prefill logits vs xla", logits,
                       x_logits):
        raise AssertionError("phase 7: ar prefill logits disagree with the "
                             "xla golden")
    decode_s = max(t_serve - ttft, 1e-9)
    say(f"phase 7: ar greedy tokens equal to xla's: "
        f"{100 * (x_tokens == tokens).float().mean().item():.1f}% of "
        f"{TP_B}x{TP_GEN} (information)")
    say(f"phase 7: ar TTFT {ttft * 1e3:.2f} ms, serve {t_serve:.3f} s, "
        f"decode {TP_B * (TP_GEN - 1) / decode_s:.1f} tokens/s ({TP_B} "
        f"rows) [{card}]")
    say(f"phase 7: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
        f" GiB")
    del dist, xla, ar, logits, x_logits
    from triton_distributed_tpu_torch.runtime import symm
    symm.clear_workspaces()  # the ar prefill's 4.7 GB of staging
    free_card()

    # The host wrapper at bench.py's all-reduce shape: AUTO picks by the
    # perf model (two-shot at this size with the H100's figures).
    x = randn(torch.Generator(device="cuda").manual_seed(9), TP_WORLD,
              *TP_AR)
    method = tar.choose_all_reduce_method(
        TP_WORLD, x[0].numel() * x.element_size(), x.shape[1])
    kernels.reset_counts()
    got = tar.all_reduce(x)
    now = {k: v.launches for k, v in kernels.KERNELS.items() if v.launches}
    want = {"twoshot_ar" if method is tar.AllReduceMethod.TWO_SHOT
            else "oneshot_ar": 1}
    if now != want or not torch.equal(got, tar.twoshot_all_reduce_ref(x)[0]
                                      if "twoshot_ar" in want
                                      else tar.oneshot_all_reduce_ref(x)[0]):
        raise AssertionError(f"phase 7: all_reduce AUTO launches {now} != "
                             f"{want}, or its sum is not the plain one")
    launches["twoshot_ar"] = now.get("twoshot_ar", 0)
    say(f"phase 7: all_reduce {tuple(x.shape)} bf16 AUTO -> "
        f"{method.value}: launches {now}, bit-identical to the plain version")
    if launches["twoshot_ar"] == 0:
        raise AssertionError("phase 7: the path never launched twoshot_ar")
    return launches


# -- phase 8 -----------------------------------------------------------------

def ep_stacks(gen, cap, counts):
    """The exchange's payloads at Qwen3-30B-A3B's world-4 width: bf16
    tokens (4, 4, cap, 2,048) and int32 expert ids (4, 4, cap, 1), every
    row at or past its pair's count poisoned (NaN, -7); and the counts."""
    w = EP_WORLD
    toks = randn(gen, w, w, cap, MOE_D)
    ids = torch.randint(0, MOE_E, (w, w, cap, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    counts = torch.tensor(counts, dtype=torch.int32, device="cuda")
    past = (torch.arange(cap, device="cuda")[None, None]
            >= counts.clamp(0, cap)[..., None])
    toks[past] = float("nan")
    ids[past] = -7
    return (toks, ids), counts


def ep_below_counts_equal(got, want, rcounts, cap) -> bool:
    """Every payload's bytes below each received count equal."""
    live = (torch.arange(cap, device="cuda")[None, None]
            < rcounts.clamp(0, cap)[..., None])[..., None]
    return all(torch.equal(
        g.view(torch.uint8).reshape(*g.shape[:3], -1) * live,
        w.view(torch.uint8).reshape(*w.shape[:3], -1) * live)
        for g, w in zip(got, want))


def ep_check(tea, label, pays, counts, cap, delayed=False):
    """The kernel (no host read inside the call) against the plain version,
    bit for bit below every count, the counts transposed. ``delayed``:
    again with every producer held back 1 ms behind NaN-poisoned receive
    buffers, which must give the same bits below the counts and keep the
    poison past them (nothing past a count is written)."""
    ctx = tea.AllToAllContext(capacity=cap, hidden=MOE_D)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, rc = tea.fast_all_to_all(pays, counts, ctx=ctx, world=EP_WORLD)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want, wrc = tea.fast_all_to_all_ref(pays, counts, ctx=ctx,
                                        world=EP_WORLD)
    if not (torch.equal(rc, wrc) and torch.equal(rc, counts.T)
            and ep_below_counts_equal(got, want, rc, cap)):
        raise AssertionError(f"phase 8: ep_a2a {label}: rows below the "
                             f"counts or the counts differ")
    del want
    note = ""
    if delayed:
        recv = tuple(torch.full_like(p.view(torch.uint8), 0xFF).view(p.dtype)
                     for p in pays)
        slow, src = tea.fast_all_to_all_cuda(
            pays, counts, ctx=ctx, world=EP_WORLD, recv=recv,
            producer_delay_ns=PRODUCER_DELAY_NS)
        torch.cuda.synchronize()
        past = ~(torch.arange(cap, device="cuda")[None, None]
                 < rc.clamp(0, cap)[..., None])
        if not (torch.equal(src, rc)
                and ep_below_counts_equal(slow, got, rc, cap)
                and torch.isnan(slow[0][past]).all()
                and (slow[1].view(torch.uint8)[past] == 0xFF).all()):
            raise AssertionError(f"phase 8: ep_a2a {label}: delayed "
                                 f"producers changed the result, or a row "
                                 f"past a count was written")
        note = ("; 1 ms-delayed producers behind NaN receive buffers: "
                "bit-identical, every row past a count untouched")
    say(f"phase 8: ep_a2a {label} (4, 4, {cap}, {MOE_D}) bf16 + int32 ids, "
        f"counts {counts.tolist() if cap <= 64 else 'full/partial/zero'}: "
        f"bit-identical below every count, received counts transposed, no "
        f"host read inside the call{note}")


def phase_ep_kernels(gen, kernels, card):
    """Phase 8 (a): the exchange against its plain version at the world-4
    prefill and decode shapes, with delayed producers; phase 7's AG-GEMM
    and GEMM-RS at this slice's shapes; (b) the exchange's times. Returns
    (max abs errors, times)."""
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import ep_all_to_all as tea
    from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    pays, counts = ep_stacks(gen, EP_PREFILL_CAP, EP_COUNTS)
    ep_check(tea, "prefill", pays, counts, EP_PREFILL_CAP, delayed=True)
    del pays
    dpays, dcounts = ep_stacks(gen, EP_DECODE_CAP, EP_DECODE_COUNTS)
    ep_check(tea, "decode", dpays, dcounts, EP_DECODE_CAP, delayed=True)

    w, err = EP_WORLD, {"ag_gemm": 0.0, "gemm_rs": 0.0}
    m, K, n = EP_AG
    a, b = randn(gen, w, m, K), randn(gen, w, K, n, scale=K ** -0.5)
    tp_check_ag(tg, "qkv", a, b, err, delayed=True, phase="phase 8")
    tp_check_ag(tg, "qkv m = 1", a[:, :1].contiguous(), b, err,
                phase="phase 8")
    M, k, N = EP_RS
    a, b = randn(gen, w, M, k), randn(gen, w, k, N, scale=k ** -0.5)
    tp_check_rs(trs, "o_proj", a, b, err, phase="phase 8")
    tp_check_rs(trs, "o_proj m = 1", a[:, :w].contiguous(), b, err,
                phase="phase 8")
    del a, b
    say(f"phase 8: AG-GEMM at n_local {n}: overlap_cols "
        f"{tg._resolve_overlap_cols(tg.AGGEMMConfig().resolve(n), n)} (no "
        f"tail)")

    # (b) Times at the prefill's balanced counts (and full capacity):
    # kernel (CUDA events, L2 flushed), device alone (torch.profiler),
    # plain, the library copy (transposes of the stacks and counts), bound.
    timer = Timer("cuda")
    ctx = tea.AllToAllContext(capacity=EP_PREFILL_CAP, hidden=MOE_D)
    cap, rows = EP_PREFILL_CAP, {}
    for label, cts in (("balanced", EP_BALANCED), ("full", [[cap] * w] * w)):
        pays, counts = ep_stacks(gen, cap, cts)
        run = (lambda: tea.fast_all_to_all_cuda(pays, counts, ctx=ctx,
                                                world=w))
        row_bytes = [p[0, 0, 0].numel() * p.element_size() for p in pays]
        t_b, by = bound_ms(0, pm.ep_a2a_bytes(cts, cap, row_bytes))
        rows[label] = dict(
            ms=timer(run, reps=10),
            device_ms=kernel_device_ms(run, "ep_a2a_kernel", n=10),
            plain_ms=timer(lambda: tea.fast_all_to_all_ref(
                pays, counts, ctx=ctx, world=w), reps=3),
            library_ms=timer(lambda: (pays[0].transpose(0, 1).contiguous(),
                                      pays[1].transpose(0, 1).contiguous(),
                                      counts.T.contiguous()), reps=10),
            bound_ms=t_b, bound_by=by)
        r = rows[label]
        say(f"phase 8: ep_a2a times at the prefill shape, {label} counts "
            f"({sum(map(sum, cts))} rows): kernel {r['ms']:.4f} ms (device "
            f"alone {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms (transpose(0, 1) copies of "
            f"both stacks and the counts: moves every row, not the live "
            f"ones), bound {r['bound_ms']:.4f} ms ({r['bound_by']}); one "
            f"card stands in for {w}: the link is bypassed [{card}]")
        del pays
    run = (lambda: tea.fast_all_to_all_cuda(dpays, dcounts,
                                            ctx=tea.AllToAllContext(
                                                capacity=EP_DECODE_CAP,
                                                hidden=MOE_D), world=w))
    row_bytes = [p[0, 0, 0].numel() * p.element_size() for p in dpays]
    t_b, by = bound_ms(0, pm.ep_a2a_bytes(EP_DECODE_COUNTS, EP_DECODE_CAP,
                                          row_bytes))
    lib = lambda: (dpays[0].transpose(0, 1).contiguous(),
                   dpays[1].transpose(0, 1).contiguous(),
                   dcounts.T.contiguous())
    t_k, t_l = timer(run, reps=50), timer(lib, reps=50)
    t_d = kernel_device_ms(run, "ep_a2a_kernel")
    t_ld = call_device_ms(lib)
    say(f"phase 8: ep_a2a at the decode shape: kernel {t_k:.4f} ms, device "
        f"alone {t_d:.4f} ms, library {t_l:.4f} ms (the three transpose "
        f"copies; device alone {t_ld:.4f}), kernel / library {t_k / t_l:.3f}"
        f" (device alone {t_d / t_ld:.3f}), bound {t_b:.6f} ms ({by}) "
        f"[{card}]")
    return err, {"ep_a2a": rows["balanced"]}


def ep_small_engine(Engine, ModelConfig, kernels):
    """Phase 8 (c): fp32 tiny-moe at world 4, dist tokens == xla."""
    cfg = ModelConfig.from_name("tiny-moe", moe_capacity_factor=64.0)
    ids = torch.randint(0, cfg.vocab_size, (8, 8), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(5), dtype=torch.int32)
    xla = Engine(cfg, mode="xla", device="cuda", seed=3, world=EP_WORLD)
    dist = Engine(cfg, mode="dist", device="cuda", params=xla.params,
                  world=EP_WORLD)
    want = xla.serve(ids, 6)
    kernels.reset_counts()
    got = dist.serve(ids, 6)
    counts = {k: v.launches for k, v in kernels.KERNELS.items() if v.launches}
    if not torch.equal(got, want):
        raise AssertionError(f"phase 8: tiny-moe world 4 dist tokens "
                             f"{got.tolist()} != xla {want.tolist()}")
    if counts.get("ep_a2a") != 2 * cfg.n_layers * 6 or not counts.get(
            "grouped_gemm"):
        raise AssertionError(f"phase 8: tiny-moe dist launches {counts}")
    say(f"phase 8: tiny-moe fp32 world {EP_WORLD} B=8 L0=8 gen 6: dist == "
        f"xla tokens, launches {counts}")


class PoisonedReceives:
    """While active, every exchange receives into buffers filled with NaN
    (0xFF bytes) instead of fresh ``torch.empty`` ones; launches stay the
    wrapper's own."""

    def __init__(self, tea):
        self.tea, self.real = tea, tea.fast_all_to_all_cuda

    def __enter__(self):
        def poisoned(payloads, *args, **kw):
            pays = payloads if isinstance(payloads, tuple) else (payloads,)
            kw["recv"] = tuple(torch.full_like(p.view(torch.uint8), 0xFF)
                               .view(p.dtype) for p in pays)
            return self.real(payloads, *args, **kw)

        self.tea.fast_all_to_all_cuda = poisoned
        return self

    def __exit__(self, *exc):
        self.tea.fast_all_to_all_cuda = self.real


def phase_ep_slice(Engine, ModelConfig, kernels, MoEMLP, nn, card):
    """Phase 8 (d): Qwen3-30B-A3B at world 4, full width and depth, through
    Engine.serve in dist mode: no drops at the served factor, exact launch
    counts, the prefill logits held against the xla golden with phase 3c's
    bars and unchanged with NaN-poisoned receive buffers, TTFT, decode
    tokens/s, peak memory, and where the time goes. Returns the launches."""
    from triton_distributed_tpu_torch.kernels import ep_all_to_all as tea

    cfg = ModelConfig.from_name("qwen3-30b-a3b", moe_capacity_factor=MOE_FACTOR)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, mode="dist", device="cuda", seed=0, world=EP_WORLD,
                 max_length=L0 + MOE_GEN)
    torch.cuda.synchronize()
    say(f"phase 8: qwen3-30b-a3b world {EP_WORLD} ({L} layers, "
        f"{cfg.n_experts // EP_WORLD} experts and {cfg.n_heads // EP_WORLD}"
        f"/{cfg.n_kv_heads // EP_WORLD} heads a rank) random init "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ids = torch.randint(0, cfg.vocab_size, (B, L0), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(7), dtype=torch.int32)
    drops = eng.moe_drop_stats(ids)
    say(f"phase 8: moe_drop_stats of the prompt at moe_capacity_factor "
        f"{MOE_FACTOR}: {drops} (summed over layers and ranks)")
    if any(drops.values()):
        raise AssertionError(f"phase 8: drops at the served factor: {drops}")
    eng.serve(ids[:, :128], 2)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    tokens = eng.serve(ids, MOE_GEN)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    expected = {k: 0 for k in kernels.KERNELS}
    expected.update(ep_a2a=2 * L * MOE_GEN, grouped_gemm=2 * L * MOE_GEN,
                    ag_gemm=L * MOE_GEN, gemm_rs=L * MOE_GEN,
                    flash_prefill=L, flash_decode=L * (MOE_GEN - 1))
    say(f"phase 8: serve B={B} L0={L0} gen={MOE_GEN} launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"phase 8: launch counts {launches} != "
                             f"{expected}")
    if (tokens.shape != (B, MOE_GEN)
            or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"phase 8: tokens {tokens.shape} out of range")

    t0 = time.perf_counter()
    logits, _ = eng.prefill(ids, eng.new_cache(B))
    torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    with PoisonedReceives(tea):
        poisoned, _ = eng.prefill(ids, eng.new_cache(B))
    if not torch.equal(poisoned, logits):
        raise AssertionError("phase 8: NaN in the receive buffers changed "
                             "the prefill logits")
    say("phase 8: prefill logits with every receive buffer NaN-poisoned: "
        "bit-identical (nothing reads past a count)")
    del poisoned
    xla = Engine(cfg, mode="xla", device="cuda", params=eng.params,
                 world=EP_WORLD, max_length=L0 + MOE_GEN)
    moe_logit_gates(eng, xla, ids, logits, MoEMLP, nn, "phase 8")
    del xla, logits
    decode_s = max(t_serve - ttft, 1e-9)
    say(f"phase 8: TTFT {ttft * 1e3:.2f} ms (prefill of {B}x{L0} + argmax), "
        f"serve {t_serve:.3f} s, decode {B * (MOE_GEN - 1) / decode_s:.1f} "
        f"tokens/s ({B} rows), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
        f"GiB [{card}]")
    decode_profile(eng, ids, phase="phase 8")
    del eng
    free_card()
    return {"ep_a2a": launches["ep_a2a"]}


# -- phase 9 -----------------------------------------------------------------

def mt_inputs(gen, m, wu, wd):
    """One MoE layer's inputs at world 8: bf16 tokens (8, m, 2,048), top-8
    ids distinct per token and drawn uniformly, random weights renormalised
    to sum to 1 a token; and the rank stacks of the layer's weights."""
    x = randn(gen, MT_WORLD, m, MOE_D)
    ids = torch.rand(MT_WORLD * m, MOE_E, generator=gen, device="cuda")
    ids = ids.argsort(dim=1)[:, :MOE_K].to(torch.int32).reshape(
        MT_WORLD, m, MOE_K)
    wts = torch.rand(MT_WORLD, m, MOE_K, generator=gen, device="cuda")
    return x, ids, wts / wts.sum(-1, keepdim=True), wu, wd


def mt_golden(x, ids, wts, w_up, w_down):
    """The dense per-token f32 MoE MLP (JAX's _moe_golden,
    tests/test_moe_overlap.py:22) over the full weights: each token's 8
    experts, silu, weighted sum; computed expert by expert."""
    x, ids, wts = (t.reshape(-1, t.shape[-1]) for t in (x, ids, wts))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(MOE_E):
        tok, j = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            h = torch.nn.functional.silu(x[tok].float() @ w_up[e].float())
            out.index_add_(0, tok, wts[tok, j, None] * (h @ w_down[e].float()))
    return out


def mt_check_rs(trs, label, x, err):
    """Both reduce-scatters bit for bit their plain versions, every staging
    slot what was pushed, and again with the producers held back 1 ms
    behind NaN staging."""
    for name, run, ref in (
            ("oneshot_rs", trs.oneshot_reduce_scatter_cuda,
             trs.oneshot_reduce_scatter_ref),
            ("ring_rs", trs.ring_reduce_scatter_cuda,
             trs.ring_reduce_scatter_ref)):
        got, staging = run(x)
        want, want_staging = ref(x, return_staging=True)
        poison = torch.full_like(staging, float("nan"))
        slow, _ = run(x, staging=poison, producer_delay_ns=PRODUCER_DELAY_NS)
        if not (torch.equal(got, want) and torch.equal(staging, want_staging)
                and torch.equal(slow, got) and torch.equal(poison, staging)):
            raise AssertionError(f"phase 9: {name} {label}: not the plain "
                                 f"version's bits")
        err[name] = max(err[name], 0.0)
        say(f"phase 9: {name} {label} {tuple(x.shape)} {str(x.dtype)[6:]}: "
            f"bit-identical to the plain version, staging == the pushes; "
            f"1 ms-delayed producers behind NaN staging: the same")
        del got, staging, want, want_staging, poison, slow


def mt_check_ag(tmo, label, grids, w, err, exact=False):
    """AG-GroupGEMM against the plain version (bit for bit on exact
    products, else at bf16 tolerance), the staging == every rank's gathered
    grids, and again with the producers held back 1 ms behind NaN staging:
    bit-identical."""
    got, staging = tmo.ag_group_gemm_cuda(grids, w)
    want, want_staging = tmo.ag_group_gemm_ref(grids, w, return_staging=True)
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"phase 9: ag_group_gemm {label}: not the "
                                 f"plain version's bits")
        e = 0.0
    else:
        e = check_close(f"phase 9: ag_group_gemm {label}", got, want,
                        torch.bfloat16)
    if not torch.equal(staging, want_staging):
        raise AssertionError(f"phase 9: ag_group_gemm {label}: staging != "
                             f"the gathered grids")
    del want, want_staging
    poison = torch.full_like(staging, float("nan"))
    slow, _ = tmo.ag_group_gemm_cuda(grids, w, staging=poison,
                                     producer_delay_ns=PRODUCER_DELAY_NS)
    if not (torch.equal(slow, got) and torch.equal(poison, staging)):
        raise AssertionError(f"phase 9: ag_group_gemm {label}: delayed "
                             f"producers changed the result or staging")
    err["ag_group_gemm"] = max(err["ag_group_gemm"], e)
    say(f"phase 9: ag_group_gemm {label} grids {tuple(grids.shape)} x w "
        f"{tuple(w.shape)} bf16: "
        f"{'bit-identical' if exact else f'max_abs_err {e:.4g}'}, staging "
        f"== the gathered grids; 1 ms-delayed producers behind NaN staging: "
        f"bit-identical")


def rs_einsum(act, w_down):
    """GroupGEMM-RS in one library call: out[d][e] = sum over the ranks r
    of act[r][e] rows of segment d @ w_down[r][e]."""
    world, E, rows, f = act.shape
    return torch.einsum("redcf,refn->decn",
                        act.view(world, E, world, rows // world, f), w_down)


def mt_check_grs(tmo, label, act, w, err, exact=False):
    """GroupGEMM-RS against the plain version: on exact products the fold
    bit for bit, every slot the pushed partial, and again with the product
    tiles held back 1 ms behind NaN staging; else at bf16 tolerance."""
    got, staging = tmo.group_gemm_rs_cuda(act, w)
    if not exact:
        e = check_close(f"phase 9: group_gemm_rs {label}", got,
                        tmo.group_gemm_rs_ref(act, w), torch.bfloat16)
        err["group_gemm_rs"] = max(err["group_gemm_rs"], e)
        say(f"phase 9: group_gemm_rs {label} act {tuple(act.shape)} x w "
            f"{tuple(w.shape)} bf16: max_abs_err {e:.4g}")
        return
    want, want_staging = tmo.group_gemm_rs_ref(act, w, return_staging=True)
    ok = torch.equal(got, want) and torch.equal(staging, want_staging)
    del want, want_staging
    poison = torch.full_like(staging, float("nan"))
    slow, _ = tmo.group_gemm_rs_cuda(act, w, staging=poison,
                                     producer_delay_ns=PRODUCER_DELAY_NS)
    if not (ok and torch.equal(slow, got) and torch.equal(poison, staging)):
        raise AssertionError(f"phase 9: group_gemm_rs {label}: the fold or "
                             f"its staging is not the plain version's")
    say(f"phase 9: group_gemm_rs {label} act {tuple(act.shape)} x w "
        f"{tuple(w.shape)} bf16: bit-identical fold and staging, also with "
        f"1 ms-delayed product tiles behind NaN staging")


def phase_moe_tp(gen, kernels, card):
    """Phase 9: the MoE-TP pipeline and the reduce-scatter at world 8 on one
    card. (a) The four kernels against their plain versions at the path's
    shapes; (b) the path (``ag_moe_mlp_device`` at the prefill and decode
    shapes, the host ``reduce_scatter`` at both Qwen3-32B shapes, AUTO and
    the ring) with exact launch counts, held against the plain pipeline
    and the dense golden; (c) the kernels' times. Returns (launches, max
    abs errors, times)."""
    from triton_distributed_tpu_torch.kernels import moe_overlap as tmo
    from triton_distributed_tpu_torch.kernels import moe_utils as tmu
    from triton_distributed_tpu_torch.runtime import perf_model as pm
    from triton_distributed_tpu_torch.runtime.mesh import World
    import importlib

    trs = importlib.import_module(
        "triton_distributed_tpu_torch.kernels.reduce_scatter")
    w = MT_WORLD
    torch.cuda.reset_peak_memory_stats()
    err = dict.fromkeys(MT_KERNELS, 0.0)
    w_up = randn(gen, MOE_E, MOE_D, MOE_FF, scale=MOE_D ** -0.5)
    w_down = randn(gen, MOE_E, MOE_FF, MOE_D, scale=MOE_FF ** -0.5)
    wu, wd = World(w).split(w_up, 2), World(w).split(w_down, 1)
    fl = MOE_FF // w
    prefill = mt_inputs(gen, MT_PREFILL[0], wu, wd)
    decode = mt_inputs(gen, MT_DECODE[0], wu, wd)

    # (a) Each kernel against its plain version at the path's shapes; first
    # bf16 rows that TMA cannot read (d 33): the mma.sync tile, one launch a
    # call, where the port used to raise.
    kernels.reset_counts()
    mt_check_ag(tmo, "d 33 (rows TMA cannot read: the mma.sync tile)",
                randn(gen, 4, 2, 8, 33), randn(gen, 4, 2, 33, 96,
                                               scale=33 ** -0.5), err)
    if kernels.KERNELS["ag_group_gemm"].launches != 2:
        raise AssertionError("phase 9: ag_group_gemm at d 33 took "
                             f"{kernels.KERNELS['ag_group_gemm'].launches} "
                             f"launches for two calls")
    x_rs = {"prefill": randn(gen, w, *MT_RS_PREFILL),
            "decode": randn(gen, w, *MT_RS_DECODE)}
    for label, x in x_rs.items():
        mt_check_rs(trs, label, x, err)
    mt_check_rs(trs, "f32", randn(gen, w, *MT_RS_F32, dtype=torch.float32),
                err)
    for label, (x, ids, _, _, _), (m, cap) in (
            ("prefill", prefill, MT_PREFILL), ("decode", decode, MT_DECODE)):
        grids = tmu.route_rank_stack(x, ids, n_experts=MOE_E,
                                     capacity=cap)[0]
        mt_check_ag(tmo, label, grids, wu, err)
        ex = tmu.route_rank_stack(tp_exact(gen, w, m, MOE_D, 1)[0], ids,
                                  n_experts=MOE_E, capacity=cap)[0]
        mt_check_ag(tmo, f"{label} exact", ex, wu, err, exact=True)
        del grids, ex
        free_card()
        act = torch.nn.functional.silu(randn(gen, w, MOE_E, w * cap, fl,
                                             dtype=torch.float32)).to(
            torch.bfloat16)
        mt_check_grs(tmo, label, act, wd, err)
        mt_check_grs(tmo, f"{label} exact", tp_exact(
            gen, w, MOE_E * w * cap, fl, 1)[0].reshape(w, MOE_E, w * cap, fl),
            wd, err, exact=True)
        del act
        free_card()

    # (b) The path, counts reset just before and read just after.
    methods = {label: trs.choose_reduce_scatter_method(
        w, x[0].numel() * x.element_size()) for label, x in x_rs.items()}
    torch.cuda.synchronize()
    kernels.reset_counts()
    outs = {label: tmo.ag_moe_mlp_device(
        *inp, world=w, n_experts=MOE_E, capacity=cap)
        for label, inp, (_, cap) in (("prefill", prefill, MT_PREFILL),
                                     ("decode", decode, MT_DECODE))}
    rs_outs = {(label, method): trs.reduce_scatter(x, world=w, method=method)
               for label, x in x_rs.items() for method in ("auto", "ring")}
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    expected = {k: 0 for k in kernels.KERNELS}
    expected.update(ag_group_gemm=2, group_gemm_rs=2, ring_rs=2)
    for method in methods.values():
        expected["oneshot_rs" if method == "oneshot" else "ring_rs"] += 1
    say(f"phase 9: path launches {launches} (expected {expected}); AUTO "
        f"picks {methods}")
    if launches != expected:
        raise AssertionError(f"phase 9: launch counts {launches} != "
                             f"{expected}")
    for label, x in x_rs.items():
        nb = x[0].numel() * x.element_size()
        say(f"phase 9: reduce_scatter AUTO at {tuple(x.shape)} bf16 ({nb} B "
            f"a rank): {methods[label]} (one-shot "
            f"{pm.est_oneshot_reduce_scatter(nb, w) * 1e6:.2f} us, ring "
            f"{pm.est_ring_reduce_scatter(nb, w) * 1e6:.2f} us by the model: "
            f"NVLink figures published, hop latency assumed)")
        for method in ("auto", "ring"):
            ref = (trs.ring_reduce_scatter_ref if method == "ring"
                   or methods[label] == "ring"
                   else trs.oneshot_reduce_scatter_ref)
            if not torch.equal(rs_outs[label, method],
                               ref(x).reshape(-1, x.shape[2])):
                raise AssertionError(f"phase 9: reduce_scatter {label} "
                                     f"{method}: not the plain version's")
    say("phase 9: reduce_scatter at both shapes, AUTO and ring: "
        "bit-identical to the plain versions")
    del rs_outs
    for label, inp, (m, cap) in (("prefill", prefill, MT_PREFILL),
                                 ("decode", decode, MT_DECODE)):
        out, n_dropped = outs[label]
        if out.shape != (w, m, MOE_D) or not torch.isfinite(out).all():
            raise AssertionError(f"phase 9: {label} output {out.shape} "
                                 f"not finite")
        if n_dropped.tolist() != [0] * w:
            raise AssertionError(f"phase 9: {label} dropped "
                                 f"{n_dropped.tolist()}")
        want, want_dropped = tmo.ag_moe_mlp_ref(*inp, world=w,
                                                n_experts=MOE_E,
                                                capacity=cap)
        e = check_close(f"phase 9: ag_moe_mlp {label} vs the plain pipeline",
                        out, want, torch.bfloat16)
        if not torch.equal(want_dropped, n_dropped):
            raise AssertionError(f"phase 9: {label} drop counts differ")
        del want
        x, ids, wts = inp[:3]
        n = min(MT_GOLDEN_TOKENS // w, m)
        golden = mt_golden(x[:, :n], ids[:, :n], wts[:, :n], w_up, w_down)
        if not golden_bars(f"phase 9: ag_moe_mlp {label}, {w * n} tokens "
                           f"vs the dense f32 golden",
                           out[:, :n].reshape(-1, MOE_D), golden):
            raise AssertionError(f"phase 9: ag_moe_mlp {label} disagrees "
                                 f"with the dense golden")
        say(f"phase 9: ag_moe_mlp {label} (8 x {m} tokens, capacity {cap}, "
            f"d {MOE_D}, {MOE_E} experts top-{MOE_K}, f_local {fl}): no "
            f"drops, max_abs_err {e:.4g} vs the plain pipeline")
    del outs
    free_card()

    # (c) Times at the prefill shapes: kernel (CUDA events, L2 flushed),
    # device alone (torch.profiler), plain, one library call (or a stated
    # pair), bound (the rows the routing filled).
    timer = Timer("cuda")
    rows, x, ids = {}, prefill[0], prefill[1]
    grids, _, _, _, counts = tmu.route_rank_stack(
        x, ids, n_experts=MOE_E, capacity=MT_PREFILL[1])
    live = int(counts.sum())
    cap = MT_PREFILL[1]
    gathered = grids.transpose(0, 1).reshape(MOE_E, w * cap, MOE_D)
    up = tmo.ag_group_gemm_cuda(grids, wu)[0]
    act = torch.nn.functional.silu(up.float()).to(up.dtype)
    del up
    flops = pm.group_gemm_flops(w, live, MOE_D, fl)
    for name, run, ref, lib, nbytes in (
            ("ag_group_gemm", lambda: tmo.ag_group_gemm_cuda(grids, wu),
             lambda: tmo.ag_group_gemm_ref(grids, wu),
             lambda: torch.matmul(gathered, w_up),
             pm.ag_group_gemm_bytes(w, MOE_E, cap, MOE_D, fl, 2, rows=live)),
            ("group_gemm_rs", lambda: tmo.group_gemm_rs_cuda(act, wd),
             lambda: tmo.group_gemm_rs_ref(act, wd),
             lambda: rs_einsum(act, wd),
             pm.group_gemm_rs_bytes(w, MOE_E, cap, MOE_D, fl, 2,
                                    rows=live))):
        t_b, by = bound_ms(flops, nbytes)
        rows[name] = dict(ms=timer(run, reps=10),
                          device_ms=kernel_device_ms(run, f"{name}_kernel",
                                                     n=10),
                          plain_ms=timer(ref, reps=3),
                          library_ms=timer(lib, reps=10), bound_ms=t_b,
                          bound_by=by)
        free_card()
    r = rows["group_gemm_rs"]
    t_l2 = timer(lambda: torch.matmul(act, wd).sum(0), reps=10)
    say(f"phase 9: group_gemm_rs prefill (the wgmma items, the owner's "
        f"product folded in place): kernel {r['ms']:.4f} ms, device alone "
        f"{r['device_ms']:.4f} ms; library one call (einsum) "
        f"{r['library_ms']:.4f} ms (device alone "
        f"{call_device_ms(lambda: rs_einsum(act, wd), n=10):.4f}), two calls "
        f"(torch.matmul(act, w_down).sum(0)) {t_l2:.4f} ms; kernel / two "
        f"calls {r['ms'] / t_l2:.3f}, kernel / one call "
        f"{r['ms'] / r['library_ms']:.3f} [{card}]")
    free_card()
    r = rows["ag_group_gemm"]
    # The floor with the simulated link's staging kept: the bound's bytes
    # plus every rank's staging written once (read back from L2).
    staging_bytes = w * w * MOE_E * cap * MOE_D * 2
    floor, _ = bound_ms(0, pm.ag_group_gemm_bytes(w, MOE_E, cap, MOE_D, fl,
                                                  2) + staging_bytes)
    t_ld = call_device_ms(lambda: torch.matmul(gathered, w_up), n=10)
    say(f"phase 9: ag_group_gemm prefill (256 x 96 wgmma tile, TMA): kernel "
        f"{r['ms']:.4f} ms, device alone {r['device_ms']:.4f} ms, library "
        f"{r['library_ms']:.4f} ms (device alone {t_ld:.4f}), kernel / "
        f"library {r['ms'] / r['library_ms']:.3f} (device alone "
        f"{r['device_ms'] / t_ld:.3f}); floor with the staging kept "
        f"{floor:.4f} ms ({staging_bytes / 1e9:.3f} GB of staging written "
        f"once) [{card}]")
    full, _ = bound_ms(pm.group_gemm_flops(w, w * MOE_E * cap, MOE_D, fl),
                       pm.ag_group_gemm_bytes(w, MOE_E, cap, MOE_D, fl, 2))
    say(f"phase 9: the prefill grids hold {live} of {w * MOE_E * cap} rows "
        f"({pm.group_gemm_flops(w, live, MOE_D, fl):.4g} operations over "
        f"every rank; whole grids: "
        f"{pm.group_gemm_flops(w, w * MOE_E * cap, MOE_D, fl):.4g}, bound "
        f"{full:.4f} ms); the kernels multiply every row, the bound counts "
        f"the filled ones")
    dgrids = tmu.route_rank_stack(decode[0], decode[1], n_experts=MOE_E,
                                  capacity=MT_DECODE[1])[0]
    dact = torch.nn.functional.silu(tmo.ag_group_gemm_cuda(
        dgrids, wu)[0].float()).to(torch.bfloat16)
    dcap = MT_DECODE[1]
    dgathered = dgrids.transpose(0, 1).reshape(MOE_E, w * dcap, MOE_D)
    for name, run, nbytes, lib in (
            ("ag_group_gemm", lambda: tmo.ag_group_gemm_cuda(dgrids, wu),
             pm.ag_group_gemm_bytes(w, MOE_E, dcap, MOE_D, fl, 2),
             lambda: torch.matmul(dgathered, w_up)),
            ("group_gemm_rs", lambda: tmo.group_gemm_rs_cuda(dact, wd),
             pm.group_gemm_rs_bytes(w, MOE_E, dcap, MOE_D, fl, 2),
             lambda: rs_einsum(dact, wd))):
        t_b, by = bound_ms(pm.group_gemm_flops(w, w * MOE_E * dcap, MOE_D,
                                               fl), nbytes)
        t_k = timer(run, reps=20)
        line = (f"phase 9: {name} at the decode shape (capacity {dcap}): "
                f"kernel {t_k:.4f} ms, device alone "
                f"{kernel_device_ms(run, f'{name}_kernel'):.4f} ms, bound "
                f"{t_b:.4f} ms ({by}: whole grids, every weight shard)")
        t_l = timer(lib, reps=20)
        line += (f", library {t_l:.4f} ms ("
                 + ("torch.matmul of the gathered decode grids with the "
                    "unsharded w_up" if name == "ag_group_gemm" else
                    "one einsum") + f"), kernel / library {t_k / t_l:.3f}")
        say(f"{line} [{card}]")
    del grids, gathered, act, dgrids, dact, dgathered
    free_card()
    for label, x in x_rs.items():
        m, n = x.shape[1] // w, x.shape[2]
        nb = x[0].numel() * x.element_size()
        t_b, by = bound_ms(0, pm.reduce_scatter_bytes(w, nb))
        t_l = timer(lambda: x.view(w, w, m, n).float().sum(0), reps=10)
        for name, run, ref, kern in (
                ("oneshot_rs", trs.oneshot_reduce_scatter_cuda,
                 trs.oneshot_reduce_scatter_ref, "oneshot_rs_kernel"),
                ("ring_rs", trs.ring_reduce_scatter_cuda,
                 trs.ring_reduce_scatter_ref, "ring_rs_kernel")):
            r = dict(ms=timer(lambda: run(x), reps=10),
                     device_ms=kernel_device_ms(lambda: run(x), kern, n=10),
                     plain_ms=timer(lambda: ref(x), reps=3), library_ms=t_l,
                     bound_ms=t_b, bound_by=by)
            if label == "prefill":
                rows[name] = r
            say(f"phase 9: {name} {label} {tuple(x.shape)} times: kernel "
                f"{r['ms']:.4f} ms (device alone {r['device_ms']:.4f}), "
                f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f}"
                f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                f"[{card}]")
    for name in ("ag_group_gemm", "group_gemm_rs"):
        r = rows[name]
        say(f"phase 9: {name} prefill times: kernel {r['ms']:.4f} ms "
            f"(device alone {r['device_ms']:.4f}), plain {r['plain_ms']:.4f}"
            f" ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); one card stands in "
            f"for {w}: the link is bypassed [{card}]")
    say("phase 9: library calls: ag_group_gemm torch.matmul of the gathered "
        "grids (E, 8 cap, d) against the unsharded w_up (E, d, 768), every "
        "rank's f shard side by side; group_gemm_rs one torch.einsum("
        "'redcf,refn->decn') over act viewed (w, E, w, cap, f) (the two-call "
        "torch.matmul(act, w_down).sum(0) printed beside it); the "
        "reduce-scatters x.view(w, w, m, n).float().sum(0)")
    say(f"phase 9: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB [{card}]")
    del x_rs, prefill, decode, wu, wd, w_up, w_down
    free_card()
    return {k: launches[k] for k in MT_KERNELS}, err, rows


# -- phase 10 ----------------------------------------------------------------

def sp_check_ag(tag, label, x, err):
    """Both allgathers bit for bit the plain version in every rank's copy,
    and again with the producers held back 1 ms behind a NaN output."""
    want = tag.all_gather_ref(x)
    for name, run in (("ring_ag", tag.ring_all_gather_cuda),
                      ("a2a_ag", tag.a2a_all_gather_cuda)):
        got = run(x)
        poison = torch.full_like(got, float("nan"))
        slow = run(x, out=poison, producer_delay_ns=PRODUCER_DELAY_NS)
        if not (torch.equal(got, want) and torch.equal(slow, want)):
            raise AssertionError(f"phase 10: {name} {label}: not the plain "
                                 f"version's bits")
        err[name] = max(err[name], 0.0)
        say(f"phase 10: {name} {label} {tuple(x.shape)} bf16: every rank's "
            f"copy bit-identical to the plain version; 1 ms-delayed "
            f"producers behind a NaN output: the same")
        del got, poison, slow


def ring_self_reset(tag, gen, xs):
    """The ring allgather with no host reset: one call at the decode shape
    captured in a CUDA graph and replayed REPLAYS times on fresh inputs,
    then REPLAYS eager calls back to back alternating the decode and
    prefill shapes (the prefill results compared on the card as they come,
    so no two are held at once), every result the plain version's bits and
    every arrival cell 0 after; one call is one device operation, the
    kernel (its captured graph)."""
    from triton_distributed_tpu_torch.kernels import _signal

    dec, pre = xs["decode"], xs["prefill"]
    side = graph_replays("phase 10: ring_ag", tag.ring_all_gather_cuda,
                         dec.clone(), lambda i: randn(gen, *dec.shape),
                         tag.all_gather_ref)
    want = {"decode": tag.all_gather_ref(dec),
            "prefill": tag.all_gather_ref(pre)}
    torch.cuda.synchronize()
    same = []
    for i in range(REPLAYS):
        label = ("decode", "prefill")[i % 2]
        got = tag.ring_all_gather_cuda(xs[label])
        same.append((got == want[label]).all())
        del got
    torch.cuda.synchronize()
    bad = [i for i, ok in enumerate(same) if not bool(ok)]
    if bad:
        raise AssertionError(f"phase 10: ring_ag calls {bad} of {REPLAYS} "
                             f"back to back differ from the plain version")
    cells_at_zero("phase 10: ring_ag", _signal, tag.RING_AG.name,
                  (side, torch.cuda.current_stream().cuda_stream))
    ops = captured_ops(lambda: tag.ring_all_gather_cuda(dec))
    if len(ops) != 1 or "ring_ag_kernel" not in ops[0]:
        raise AssertionError(f"phase 10: a ring_ag call enqueued {ops}, not "
                             f"one launch")
    del want
    say(f"phase 10: ring_ag: a captured call at {tuple(dec.shape)} replayed "
        f"{REPLAYS} times on fresh inputs and {REPLAYS} eager calls back to "
        f"back (decode and prefill shapes in turns), no host reset: every "
        f"result bit-identical to the plain version, every arrival cell 0 "
        f"after; one call's captured graph: {ops}")


def sp_check_ll(tll, gen, err):
    """The LL allgather at the SP decode partial exchange's shape over
    five epochs and a restart on one NaN-poisoned staging: each call bit
    for bit the plain version, writing only its parity's half (the other
    keeps what the call before left, NaN at first); the third call with
    1 ms-delayed pushes behind a NaN output; the flags back at 0 after
    every call; then 100 calls back to back, the ticket and flags 0
    after."""
    from triton_distributed_tpu_torch.kernels import _signal
    from triton_distributed_tpu_torch.kernels.sp_attention import (
        decode_partial_feat)

    w, rows = SP_WORLD, SP_B * SP_HQ
    feat = decode_partial_feat(SP_DH)
    staging = torch.full((w, 2, w - 1, rows, feat), float("nan"),
                         device="cuda")
    mirror = staging.clone()
    for i, epoch in enumerate(SP_LL_EPOCHS):
        x = randn(gen, w, rows, feat, dtype=torch.float32)
        before = staging.clone()
        out = (torch.full((w, w * rows, feat), float("nan"), device="cuda")
               if i == 2 else None)
        got, _ = tll.ll_all_gather_cuda(
            x, staging, epoch, out=out,
            producer_delay_ns=PRODUCER_DELAY_NS if i == 2 else 0)
        want, mirror = tll.ll_all_gather_ref(x, mirror, epoch)
        p = epoch % 2
        other_kept = (torch.equal(staging[:, 1 - p].isnan(),
                                  before[:, 1 - p].isnan())
                      and torch.equal(staging[:, 1 - p].nan_to_num(),
                                      before[:, 1 - p].nan_to_num()))
        flags = _signal.flags(x.device, tll.LL_AG.name, 1)
        if not (torch.equal(got, want) and torch.equal(staging[:, p],
                                                       mirror[:, p])
                and other_kept and int(flags.abs().sum()) == 0):
            raise AssertionError(f"phase 10: ll_allgather epoch {epoch} "
                                 f"(call {i}): not the plain version's bits, "
                                 f"or the other parity or the flags moved")
    # 100 calls back to back, no host reset and no synchronize between
    # them, the epoch alternately an int and a 0-d tensor advanced on the
    # card: every result the plain version's bits, the persistent ticket
    # and the flags 0 after.
    xs = [randn(gen, w, rows, feat, dtype=torch.float32) for _ in range(2)]
    epoch_t = torch.zeros((), dtype=torch.int32, device="cuda")
    outs = []
    for i in range(LL_B2B_CALLS):
        outs.append(tll.ll_all_gather_cuda(xs[i % 2], staging,
                                           epoch_t if i % 2 else i)[0])
        epoch_t.add_(1)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream().cuda_stream
    ticket = int(_signal._ARRIVALS[(x.device, stream, tll.LL_AG.name)][0])
    flags = int(_signal.flags(x.device, tll.LL_AG.name, 1).abs().sum())
    for i, got in enumerate(outs):
        want, mirror = tll.ll_all_gather_ref(xs[i % 2], mirror, i)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 10: ll_allgather back-to-back call "
                                 f"{i}: not the plain version's bits")
    if not (torch.equal(staging, mirror) and ticket == 0 and flags == 0):
        raise AssertionError(f"phase 10: ll_allgather after {LL_B2B_CALLS} "
                             f"back-to-back calls: staging differs, or "
                             f"ticket {ticket} / flags {flags} not 0")
    err["ll_allgather"] = 0.0
    say(f"phase 10: ll_allgather ({w}, {rows}, {feat}) f32, staging "
        f"{tuple(staging.shape)} NaN-poisoned: epochs {list(SP_LL_EPOCHS)} "
        f"(a restart at 0 after 4) each bit-identical to the plain version, "
        f"the other parity untouched, the flags at 0 after every call; the "
        f"third call with 1 ms-delayed pushes behind a NaN output: the same; "
        f"{LL_B2B_CALLS} calls back to back (int and device epochs): each "
        f"bit-identical, the ticket and the flags 0 after")


def sp_decode_golden(q, k, v, kv_len):
    """f32 dense GQA decode attention over the first kv_len positions of
    the global cache (k/v (world, B, Hkv, m_kv, dh) stacked by rank)."""
    w, B, hkv, m_kv, dh = k.shape
    kg = k.permute(1, 2, 0, 3, 4).reshape(B, hkv, w * m_kv, dh)[:, :, :kv_len]
    vg = v.permute(1, 2, 0, 3, 4).reshape(B, hkv, w * m_kv, dh)[:, :, :kv_len]
    g = q.shape[1] // hkv
    qf = q.float().reshape(B, hkv, g, dh)
    s_ = torch.einsum("bhgd,bhsd->bhgs", qf, kg.float()) * dh ** -0.5
    out = torch.einsum("bhgs,bhsd->bhgd", s_.softmax(-1), vg.float())
    return out.reshape(B, q.shape[1], dh)


def sp_prefill_golden(q, k, v, heads):
    """f32 dense causal attention of ``heads`` over the global sequence,
    rank by rank (q/k/v (world, H, m, dh) stacked by rank): (len(heads),
    world m, dh)."""
    w, _, m, dh = q.shape
    kg = k[:, heads].permute(1, 0, 2, 3).reshape(len(heads), w * m, dh)
    vg = v[:, heads].permute(1, 0, 2, 3).reshape(len(heads), w * m, dh)
    out = []
    for r in range(w):
        n = (r + 1) * m
        s_ = torch.einsum("hmd,hnd->hmn", q[r, heads].float(),
                          kg[:, :n].float()) * dh ** -0.5
        mask = (r * m + torch.arange(m, device=q.device))[:, None] >= \
            torch.arange(n, device=q.device)[None, :]
        s_ = s_.masked_fill(~mask, float("-inf"))
        out.append(torch.einsum("hmn,hnd->hmd", s_.softmax(-1),
                                vg[:, :n].float()))
        del s_, mask
    return torch.cat(out, dim=1)


def phase_sp(gen, kernels, card):
    """Phase 10: sequence parallelism at world 8 on one card. (a) The
    allgathers and the LL allgather against their plain versions at the
    path's shapes; (b) the path (the host ``all_gather`` AUTO,
    ``AllGatherLayer`` with each method, ``SpGQAFlashDecodeAttention`` over
    the ring and LL at two kv_lens, ``sp_ag_attention_device``) with exact
    launch counts, held against the plain pipelines and the f32 goldens;
    (c) the prefill's lse, and its producers delayed behind NaN staging;
    (d) the four kernels' times. Returns (launches, max abs errors,
    times)."""
    import importlib

    from triton_distributed_tpu_torch.kernels import sp_attention as tsp
    from triton_distributed_tpu_torch.layers import (
        AllGatherLayer, SpGQAFlashDecodeAttention)
    from triton_distributed_tpu_torch.runtime import perf_model as pm

    tag = importlib.import_module(
        "triton_distributed_tpu_torch.kernels.allgather")
    tll = importlib.import_module(
        "triton_distributed_tpu_torch.kernels.ll_allgather")
    tlayer = importlib.import_module(
        "triton_distributed_tpu_torch.layers.allgather_layer")
    w = SP_WORLD
    torch.cuda.reset_peak_memory_stats()
    err = dict.fromkeys(SP_KERNELS, 0.0)

    # (a) The allgathers and LL against their plain versions.
    xs = {label: randn(gen, w, m, n) for label, (m, n) in SP_AG.items()}
    for label, x in xs.items():
        sp_check_ag(tag, label, x, err)
    ring_self_reset(tag, gen, xs)
    sp_check_ll(tll, gen, err)

    # (b) The path, counts reset just before and read just after.
    m_kv = SP_CTX // w
    q_dec = randn(gen, SP_B, SP_HQ, SP_DH)
    k_dec = randn(gen, w, SP_B, SP_HKV, m_kv, SP_DH)
    v_dec = randn(gen, w, SP_B, SP_HKV, m_kv, SP_DH)
    q_pre = randn(gen, w, SP_HQ, SP_M, SP_DH)
    g = SP_HQ // SP_HKV   # the caller repeats each kv head over its group
    k_pre = randn(gen, w, SP_HKV, SP_M, SP_DH).repeat_interleave(g, dim=1)
    v_pre = randn(gen, w, SP_HKV, SP_M, SP_DH).repeat_interleave(g, dim=1)
    layer = AllGatherLayer(SP_AG["decode"], torch.bfloat16, world=w)
    sp_layer = SpGQAFlashDecodeAttention(SP_HQ, SP_HKV, SP_DH, world=w)
    feat = tsp.decode_partial_feat(SP_DH)
    ll_ws = tll.make_ll_staging((SP_B * SP_HQ, feat), torch.float32,
                                world=w, name="phase10_sp_decode")
    ll_before = ll_ws.array.clone()
    methods = {label: tag.choose_all_gather_method(
        w, x[0].numel() * x.element_size()).value for label, x in xs.items()}
    nb_dec = xs["decode"][0].numel() * xs["decode"].element_size()
    auto_method = ("ll" if tlayer._ll_wins(w, nb_dec)
                   else tag.choose_all_gather_method(w, nb_dec).value)
    torch.cuda.synchronize()
    kernels.reset_counts()
    host = {label: tag.all_gather(x, world=w) for label, x in xs.items()}
    lay = {}
    for method in ("ring_1d", "all2all", "ll", "auto"):
        lay[method] = layer(xs["decode"], method=method,
                            staging=layer.staging(),
                            epoch=layer.next_epoch())[0]
    dec = {}
    for kv_len in SP_KV_LENS:
        dec[kv_len, "ring"] = sp_layer(q_dec, k_dec, v_dec, kv_len=kv_len)
        for step in range(SP_LL_STEPS):
            dec[kv_len, "ll", step], ll_ws.array = sp_layer(
                q_dec, k_dec, v_dec, kv_len=kv_len, ll_staging=ll_ws.array,
                ll_epoch=step)
    pre = tsp.sp_ag_attention_device(q_pre, k_pre, v_pre, world=w)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in kernels.KERNELS.items()}
    kernel_of = {"all2all": "a2a_ag", "ring_1d": "ring_ag",
                 "ll": "ll_allgather"}
    expected = {k: 0 for k in kernels.KERNELS}
    for method in (*methods.values(), "ring_1d", "all2all", "ll",
                   auto_method):
        expected[kernel_of[method]] += 1
    expected["ring_ag"] += len(SP_KV_LENS)
    expected["ll_allgather"] += len(SP_KV_LENS) * SP_LL_STEPS
    expected["flash_decode"] = len(SP_KV_LENS) * (1 + SP_LL_STEPS)
    expected["sp_ag_attn"] = 1
    say(f"phase 10: path launches {launches} (expected {expected}); host "
        f"all_gather AUTO picks {methods}; AllGatherLayer AUTO at the "
        f"decode activation picks {auto_method} (staging and epoch given)")
    if launches != expected:
        raise AssertionError(f"phase 10: launch counts {launches} != "
                             f"{expected}")
    for label, x in xs.items():
        nb = x[0].numel() * x.element_size()
        if not torch.equal(host[label], x.reshape(-1, x.shape[2])):
            raise AssertionError(f"phase 10: all_gather {label} wrong")
        say(f"phase 10: all_gather AUTO at {tuple(x.shape)} bf16 ({nb} B a "
            f"rank): {methods[label]} (push "
            f"{pm.est_push_all_gather(nb, w) * 1e6:.2f} us, ring "
            f"{pm.est_ring_all_gather(nb, w) * 1e6:.2f} us, LL "
            f"{pm.est_ll_all_gather(nb, w) * 1e6:.2f} us by the model: "
            f"NVLink figures published, hop latency assumed); bit-identical")
    want = tag.all_gather_ref(xs["decode"])
    for method, got in lay.items():
        if not torch.equal(got, want):
            raise AssertionError(f"phase 10: AllGatherLayer {method} wrong")
    say(f"phase 10: AllGatherLayer {SP_AG['decode']} bf16 with "
        f"{list(lay)}: every rank's copy bit-identical to the plain version")
    del host, lay, want
    # The plain pipeline on its own staging, replaying the path's epochs.
    plain_ws = ll_before
    for kv_len in SP_KV_LENS:
        ref = tsp.flash_decode_device_ref(q_dec, k_dec, v_dec, world=w,
                                          kv_len=_local_lens(kv_len, m_kv))
        golden = sp_decode_golden(q_dec, k_dec, v_dec, kv_len)
        e = check_close(f"phase 10: SP decode kv_len {kv_len} ring vs the "
                        f"plain pipeline", dec[kv_len, "ring"], ref,
                        torch.bfloat16)
        for step in range(SP_LL_STEPS):
            ref_ll, plain_ws = tsp.flash_decode_device_ref(
                q_dec, k_dec, v_dec, world=w,
                kv_len=_local_lens(kv_len, m_kv), ll_staging=plain_ws,
                ll_epoch=step)
            got = dec[kv_len, "ll", step]
            if not torch.equal(got, dec[kv_len, "ring"]):
                raise AssertionError(f"phase 10: SP decode kv_len {kv_len} "
                                     f"LL step {step} != the ring's")
            if not torch.equal(ref_ll, ref):
                raise AssertionError("phase 10: plain LL != plain ring")
        for r in (0, w - 1):
            if not golden_bars(f"phase 10: SP decode kv_len {kv_len} rank {r}"
                               f" vs the f32 dense golden",
                               dec[kv_len, "ring"][r].reshape(-1, SP_DH),
                               golden.reshape(-1, SP_DH)):
                raise AssertionError(f"phase 10: SP decode kv_len {kv_len} "
                                     f"disagrees with the golden")
        say(f"phase 10: SP decode B={SP_B} Hq={SP_HQ} Hkv={SP_HKV} over "
            f"{SP_CTX} positions (8 x {m_kv}), kv_len {kv_len} (ranks owning "
            f"nothing: {[r for r in range(w) if kv_len <= r * m_kv]}): max "
            f"abs err {e:.4g} vs the plain pipeline; {SP_LL_STEPS} LL steps "
            f"== the ring's output bit for bit")
    del dec, ll_before, plain_ws
    ref = tsp.sp_ag_attention_ref(q_pre, k_pre, v_pre)
    err["sp_ag_attn"] = check_close("phase 10: sp_ag_attention vs the plain "
                                    "version", pre, ref, torch.bfloat16)
    del ref
    free_card()
    heads = list(SP_GOLDEN_HEADS)
    golden = sp_prefill_golden(q_pre, k_pre, v_pre, heads)
    got = pre[:, heads].permute(1, 0, 2, 3).reshape(len(heads), -1, SP_DH)
    if not golden_bars(f"phase 10: sp_ag_attention heads {heads}, "
                       f"{w * SP_M} rows vs the f32 dense golden",
                       got.reshape(-1, SP_DH), golden.reshape(-1, SP_DH)):
        raise AssertionError("phase 10: sp_ag_attention disagrees with the "
                             "golden")
    del golden, got
    free_card()
    say(f"phase 10: sp_ag_attention {w} x {SP_M} tokens, {SP_HQ} heads, dh "
        f"{SP_DH}, causal bf16: max abs err {err['sp_ag_attn']:.4g} vs the "
        f"plain version (bar atol = rtol = 2e-2: the kernel rounds P to "
        f"bf16 for its products, the plain version keeps f32)")

    # (c) The lse on a smaller non-causal run; the delayed producers.
    qs, ks, vs = (t[:, :8, :SP_LSE_M].contiguous()
                  for t in (q_pre, k_pre, v_pre))
    out, lse, _, _ = tsp.sp_ag_attention_cuda(qs, ks, vs, causal=False,
                                              return_partials=True)
    want, want_lse = tsp.sp_ag_attention_ref(qs, ks, vs, causal=False,
                                             return_partials=True)
    e = check_close("phase 10: sp_ag_attention non-causal", out, want,
                    torch.bfloat16)
    e_lse = (lse - want_lse).abs().max().item()
    if not e_lse <= 1e-3:
        raise AssertionError(f"phase 10: lse max abs err {e_lse}")
    say(f"phase 10: sp_ag_attention non-causal {tuple(qs.shape)} with "
        f"return_partials: out max abs err {e:.4g}, lse {e_lse:.4g} (bar "
        f"1e-3) vs the plain version")
    del qs, ks, vs, out, lse, want, want_lse
    _, _, k_full, v_full = tsp.sp_ag_attention_cuda(q_pre, k_pre, v_pre)
    staged = (torch.equal(k_full, k_pre[None].expand(w, *k_pre.shape))
              and torch.equal(v_full, v_pre[None].expand(w, *v_pre.shape)))
    k_full.fill_(float("nan"))
    v_full.fill_(float("nan"))
    slow = tsp.sp_ag_attention_cuda(q_pre, k_pre, v_pre, k_full=k_full,
                                    v_full=v_full,
                                    producer_delay_ns=PRODUCER_DELAY_NS)[0]
    staged = staged and torch.equal(
        k_full, k_pre[None].expand(w, *k_pre.shape))
    if not (staged and torch.equal(slow, pre)):
        raise AssertionError("phase 10: sp_ag_attention staging or its "
                             "delayed run differs")
    say("phase 10: sp_ag_attention staging == every rank's K and V; with "
        "1 ms-delayed producers behind NaN staging: bit-identical")
    del k_full, v_full, slow
    free_card()

    # (d) Times: kernel (CUDA events, L2 flushed), device alone
    # (torch.profiler), plain, one library call, bound.
    timer = Timer("cuda")
    rows = {}
    x = xs["prefill"]
    nb = x[0].numel() * x.element_size()
    t_b, by = bound_ms(0, pm.all_gather_bytes(w, nb))
    lib = lambda: x.reshape(1, -1, x.shape[2]).expand(w, -1, -1).contiguous()
    t_l = timer(lib, reps=10)
    for name, run, kern in (("ring_ag", tag.ring_all_gather_cuda,
                             "ring_ag_kernel"),
                            ("a2a_ag", tag.a2a_all_gather_cuda,
                             "a2a_ag_kernel")):
        rows[name] = dict(ms=timer(lambda: run(x), reps=10),
                          device_ms=kernel_device_ms(lambda: run(x), kern,
                                                     n=10),
                          plain_ms=timer(lambda: tag.all_gather_ref(x),
                                         reps=10),
                          library_ms=t_l, bound_ms=t_b, bound_by=by)
        xd = xs["decode"]
        lib_call = lambda: xd.reshape(1, -1, xd.shape[2]).expand(
            w, -1, -1).contiguous()
        lib_d = timer(lib_call, reps=20)
        t_k = timer(lambda: run(xd), reps=20)
        t_d = kernel_device_ms(lambda: run(xd), kern)
        bar = ""
        if name == "ring_ag":
            met = (t_k / lib_d <= RING_DECODE_BAR
                   and t_d <= RING_DECODE_DEVICE_BAR_MS)
            bar = (f"; events / library {t_k / lib_d:.3f} (bar <= "
                   f"{RING_DECODE_BAR}), device bar <= "
                   f"{RING_DECODE_DEVICE_BAR_MS} ms: "
                   f"{'met' if met else 'missed'}")
        say(f"phase 10: {name} at the decode shape {tuple(xd.shape)}: kernel "
            f"{t_k:.4f} ms, device alone {t_d:.4f} ms, library {lib_d:.4f} "
            f"ms (the same copy; device alone {call_device_ms(lib_call):.4f}"
            f"), bound "
            f"{bound_ms(0, pm.all_gather_bytes(w, xd[0].numel() * 2))[0]:.4f}"
            f" ms{bar} [{card}]")
    xl = randn(gen, w, SP_B * SP_HQ, feat, dtype=torch.float32)
    stg = torch.zeros((w, 2, w - 1, SP_B * SP_HQ, feat), device="cuda")
    epoch = torch.zeros((), dtype=torch.int32, device="cuda")
    nb_l = xl[0].numel() * xl.element_size()
    t_b, by = bound_ms(0, pm.all_gather_bytes(w, nb_l))
    run_ll = lambda: tll.ll_all_gather_cuda(xl, stg, epoch)
    lib_ll = lambda: xl.reshape(1, -1, feat).expand(w, -1, -1).contiguous()
    rows["ll_allgather"] = dict(
        ms=timer(run_ll, reps=20),
        device_ms=kernel_device_ms(run_ll, "ll_allgather_kernel"),
        plain_ms=timer(lambda: tll.ll_all_gather_ref(xl, stg, 0), reps=10),
        library_ms=timer(lib_ll, reps=20), bound_ms=t_b, bound_by=by)
    cap = captured_ops(run_ll)
    ops = device_ops(run_ll)
    if (len(cap) != 1 or "ll_allgather_kernel" not in cap[0]
            or len(ops) > 10
            or any("ll_allgather_kernel" not in op for op in ops)):
        raise AssertionError(f"phase 10: an ll_allgather call enqueued "
                             f"{cap} (captured graph), 10 made {ops} "
                             f"(torch.profiler), not one launch each")
    r = rows["ll_allgather"]
    say(f"phase 10: ll_allgather ({w}, {SP_B * SP_HQ}, {feat}) f32: events "
        f"{r['ms']:.4f} ms, device alone {r['device_ms']:.4f} ms, library "
        f"{r['library_ms']:.4f} ms (device alone "
        f"{call_device_ms(lib_ll):.4f}): events / library "
        f"{r['ms'] / r['library_ms']:.3f}; back to back over 200 calls "
        f"{b2b_ms(run_ll):.4f} ms a call, library {b2b_ms(lib_ll):.4f}; "
        f"device operations of one call (its captured CUDA graph): "
        f"{len(cap)}, the kernel; of 10 calls recorded by torch.profiler: "
        f"{len(ops)}, each the kernel [{card}]")
    # The SP decode's one flash_decode launch over every rank's shard (the
    # split-KV kernel redesigned in this slice), at kv_len SP_KV_LENS[0].
    lens = _local_lens(SP_KV_LENS[0], m_kv)[:, None].expand(
        w, SP_B).reshape(-1).contiguous()
    qf = q_dec.expand(w, *q_dec.shape).reshape(w * SP_B, SP_HQ, SP_DH)
    kf = k_dec.reshape(w * SP_B, SP_HKV, m_kv, SP_DH)
    vf = v_dec.reshape(w * SP_B, SP_HKV, m_kv, SP_DH)
    run_fd = lambda: tsp.flash_decode_cuda(qf, kf, vf, kv_len=lens)
    mask = (torch.arange(m_kv, device="cuda")[None]
            < lens[:, None])[:, None, None, :]
    t_k, t_l = timer(run_fd, reps=20), timer(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qf[:, :, None], kf, vf, attn_mask=mask, enable_gqa=True),
        reps=20)
    t_d = kernel_device_ms(run_fd, "flash_decode_kernel")
    t_ld = call_device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qf[:, :, None], kf, vf, attn_mask=mask, enable_gqa=True))
    keys = int(lens.sum())
    t_b, by = bound_ms(4 * SP_HQ * SP_DH * keys,
                       2 * keys * SP_HKV * SP_DH * 2 + qf.numel() * 2
                       + w * SP_B * SP_HQ * (SP_DH + 1) * 4)
    say(f"phase 10: SP decode's flash_decode over {w} x {SP_B} rows of "
        f"{m_kv} positions ({tsp.flash_decode_splits(kf)} splits), kv_len "
        f"{SP_KV_LENS[0]}: kernel {t_k:.4f} ms, device alone {t_d:.4f} ms, "
        f"sdpa with a mask {t_l:.4f} ms (device alone {t_ld:.4f}), kernel / "
        f"sdpa {t_k / t_l:.3f} (device alone {t_d / t_ld:.3f}), bound "
        f"{t_b:.4f} ms ({by}) [{card}]")
    del qf, kf, vf, mask
    pairs = pm.sp_attention_pairs(w, SP_M, SP_M, True)
    t_b, by = bound_ms(pm.sp_attention_flops(SP_HQ, SP_DH, pairs),
                       pm.sp_attention_bytes(w, SP_HQ, SP_M, SP_M, SP_DH, 2))
    run_sp = lambda: tsp.sp_ag_attention_cuda(q_pre, k_pre, v_pre)
    qg, kg, vg = (t.permute(1, 0, 2, 3).reshape(1, SP_HQ, w * SP_M, SP_DH)
                  for t in (q_pre, k_pre, v_pre))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_d = kernel_device_ms(run_sp, "sp_ag_attn_kernel", n=3)
    if not math.isfinite(t_d):
        t_d = busy_device_ms(run_sp, n=3)
        say(f"phase 10: sp_ag_attn device time by CUDA events over 3 "
            f"back-to-back launches (the host's launch path hidden behind "
            f"the kernel): {t_d:.4f} ms [{card}]")
    rows["sp_ag_attn"] = dict(
        ms=timer(run_sp, reps=3, warmup=1),
        device_ms=t_d,
        plain_ms=timer(lambda: tsp.sp_ag_attention_ref(q_pre, k_pre, v_pre),
                       reps=1, warmup=0),
        library_ms=timer(lambda: sdpa(qg, kg, vg, is_causal=True), reps=3,
                         warmup=1),
        bound_ms=t_b, bound_by=by)
    for name in SP_KERNELS:
        r = rows[name]
        say(f"phase 10: {name} times: kernel {r['ms']:.4f} ms (device alone "
            f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); one card stands in for {w}: the link is "
            f"bypassed [{card}]")
    say(f"phase 10: library calls: the allgathers and LL x.reshape(1, -1, "
        f"n).expand({w}, -1, -1).contiguous(); sp_ag_attn "
        f"scaled_dot_product_attention(is_causal=True) over the gathered "
        f"(1, {SP_HQ}, {w * SP_M}, {SP_DH}); sp_ag_attn bound: "
        f"{pm.sp_attention_flops(SP_HQ, SP_DH, pairs):.4g} operations (the "
        f"{pairs} causal pairs a head)")
    r = rows["sp_ag_attn"]
    flops = pm.sp_attention_flops(SP_HQ, SP_DH, pairs)
    say(f"phase 10: sp_ag_attn (wgmma tile: 128 query rows, TMA, 128-key "
        f"chunks) events {r['ms']:.4f} ms, device alone "
        f"{r['device_ms']:.4f} ms ({flops / r['device_ms'] / 1e9:.1f} "
        f"TFLOP/s), sdpa is_causal {r['library_ms']:.4f} ms: events / "
        f"library {r['ms'] / r['library_ms']:.3f} (bar <= 2.0: "
        f"{'met' if r['ms'] / r['library_ms'] <= 2.0 else 'missed'}), "
        f"bound {r['bound_ms']:.4f} ms [{card}]")
    sass_count("phase 10", "sp_ag_attn_wgmma_kernel", "HGMMA")
    say(f"phase 10: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB [{card}]")
    del xs, q_dec, k_dec, v_dec, q_pre, k_pre, v_pre, qg, kg, vg, xl, stg
    free_card()
    return {k: launches[k] for k in SP_KERNELS}, err, rows


_SASS: list[str] = []


def sass_count(phase: str, kernel: str, instr: str) -> None:
    """The built library's functions whose name holds ``kernel`` issue
    ``instr`` (a SASS opcode): cuobjdump's SASS of them holds it (fails if
    it holds none; not measured without cuobjdump). The disassembly is
    made once a run."""
    from triton_distributed_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        say(f"{phase}: {kernel} SASS: not measured (no cuobjdump)")
        return
    if not _SASS:
        _SASS.append(subprocess.run(
            [tool, "-sass", str(_build.build())], capture_output=True,
            text=True, timeout=300, check=True).stdout)
    parts = [p for p in _SASS[0].split("Function : ")
             if p.split("\n", 1)[0].find(kernel) >= 0]
    count = sum(p.count(instr) for p in parts)
    say(f"{phase}: {kernel} SASS: {count} {instr} instructions in "
        f"{len(parts)} function(s)")
    if not count:
        raise AssertionError(f"{phase}: {kernel} issues no {instr}")


def _local_lens(kv_len: int, m_kv: int) -> torch.Tensor:
    """Each rank's valid length of a global kv_len (the decode layer's
    clip), for the plain pipeline."""
    r = torch.arange(SP_WORLD, device="cuda")
    return (kv_len - r * m_kv).clamp(0, m_kv).to(torch.int32)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from triton_distributed_tpu_torch import BatchEngine, Engine, ModelConfig
    from triton_distributed_tpu_torch import kernels
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels import allgather_gemm as tg
    from triton_distributed_tpu_torch.kernels import gemm_reduce_scatter as trs
    from triton_distributed_tpu_torch.kernels import moe_utils as tmu
    from triton_distributed_tpu_torch.kernels import paged_attention as tpa
    from triton_distributed_tpu_torch.kernels import sp_attention as tsp
    from triton_distributed_tpu_torch.layers import nn
    from triton_distributed_tpu_torch.layers.moe_mlp import MoEMLP
    from triton_distributed_tpu_torch.layers.nn import quantize_kv_rows

    t_start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    say(f"build: {lib_path.name} from {len(_build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(0)
    err, inputs = phase_kernels(gen, tg, tsp)
    err["paged_attention"], paged_inputs = phase_paged_kernel(
        gen, tpa, quantize_kv_rows)
    for name, e in phase_gqa8(gen, tsp, tpa).items():
        err[name] = max(err[name], e)
    served_caps = moe_caps(MoEMLP, MOE_FACTOR)
    held_caps = {**moe_caps(MoEMLP, ModelConfig.from_name(
        "qwen3-30b-a3b").moe_capacity_factor), **served_caps}
    err["grouped_gemm"] = phase_grouped_gemm(tmu, held_caps)
    free_card()
    phase_small_engines(Engine, BatchEngine, ModelConfig, kernels)
    launches, eng = phase_full_width(Engine, ModelConfig, kernels)
    for name, n in phase_serving(eng, Engine, BatchEngine, kernels).items():
        launches[name] += n
    # Qwen3-30B-A3B's ~57 GiB of weights fit beside nothing else.
    del eng
    free_card()
    moe_launches, eng = phase_moe_full_width(Engine, ModelConfig, kernels,
                                             MoEMLP, nn, tmu, held_caps)
    with CapacitySpy(tmu) as spy:
        served = phase_serving(eng, Engine, BatchEngine, kernels,
                               pools=(None,), phase="phase 3c")
    spy.check("phase 3c: BatchEngine", held_caps)
    for name, n in served.items():
        moe_launches[name] += n
    for name, n in moe_launches.items():
        launches[name] += n
    del eng
    free_card()
    say(f"phase 4: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated (phase 1's inputs)")
    times = phase_times(inputs, tg, tsp, card)
    times["paged_attention"] = paged_times(paged_inputs, tpa,
                                           tsp.paged_gather_kv, card)
    times["grouped_gemm"] = grouped_times(tmu, served_caps)
    free_card()
    overlap_launches, overlap_err, overlap_times = phase_overlap(
        gen, tg, trs, kernels, card)
    launches.update(overlap_launches)
    err.update(overlap_err)
    times.update(overlap_times)
    free_card()
    coll_launches, coll_err, coll_times = phase_collectives(gen, kernels,
                                                            card)
    launches.update(coll_launches)
    err.update(coll_err)
    times.update(coll_times)
    del inputs, paged_inputs
    free_card()
    tp_err, tp_times = phase_tp_kernels(gen, kernels, card)
    err.update(tp_err)
    times.update(tp_times)
    free_card()
    tp_small_engines(Engine, ModelConfig, kernels)
    launches.update(phase_tp_slice(Engine, ModelConfig, kernels, card))
    free_card()
    ep_err, ep_times = phase_ep_kernels(gen, kernels, card)
    for name, e in ep_err.items():
        err[name] = max(err[name], e)
    err["ep_a2a"] = 0.0  # bit-identical below every count
    times.update(ep_times)
    free_card()
    ep_small_engine(Engine, ModelConfig, kernels)
    launches.update(phase_ep_slice(Engine, ModelConfig, kernels, MoEMLP, nn,
                                   card))
    free_card()
    mt_launches, mt_err, mt_times = phase_moe_tp(gen, kernels, card)
    launches.update(mt_launches)
    err.update(mt_err)
    times.update(mt_times)
    free_card()
    sp_launches, sp_err, sp_times = phase_sp(gen, kernels, card)
    launches.update(sp_launches)
    err.update(sp_err)
    times.update(sp_times)

    record = []
    for name, kern in kernels.KERNELS.items():
        row = times[name]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            if row[key] is None and key == "library_ms":
                continue
            if not math.isfinite(row[key]):
                raise AssertionError(f"{name} {key} is not finite")
        record.append(dict(
            name=name, route=kern.route, source=kern.source,
            replaces=kern.replaces, launches=launches[name],
            max_abs_err=err[name], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
            **{k: row[k] for k in ("b2b_ms", "library_b2b_ms") if k in row}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
