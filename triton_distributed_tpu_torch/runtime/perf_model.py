"""Speeds and feeds of the card, and the roofline matmul time.

Counterpart of ``triton_distributed_tpu/runtime/perf_model.py``, the part
the port's kernels need: ``Hardware``, ``detect_hardware``,
``est_matmul`` (:330), ``hbm_gbps``, ``peak_bf16_tflops``, the all-reduce
estimates that pick a method (``est_oneshot_all_reduce`` :204,
``est_twoshot_all_reduce`` :214, ``wire_bytes_all_reduce`` :253, with the
ring terms they build on), the all-to-all's ``wire_bytes_all_to_all``
(:263) and ``est_push_all_gather`` (:160), the reduce-scatter's
``est_oneshot_reduce_scatter`` (:193) and ``wire_bytes_reduce_scatter``
(:246) with ``wire_bytes_all_gather`` (:239), the low-latency allgather's
``est_ll_all_gather`` (:170), and the bytes and operations
that the collective loopbacks and the multi-rank kernels must move or do
(the least, for their bounds). The
table holds published data-sheet numbers of the cards the port runs on. An
unknown card raises: there is no fallback row, and no TPU row at all.

Every bound counts the function's own bytes: each input read once, each
output written once. The staging slots, queues and signals through which a
loopback simulates its link are scratch the caller never sees, so they are
not counted: the bound is what any implementation of the same function
must move, however it simulates the link.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-card peaks: dense tensor-core bf16 FLOP/s and device-memory
    bytes/s; and the link between cards, for the collectives' estimates:
    ``link_bw`` bytes/s per link and direction, ``links`` links per card,
    ``hop_lat`` seconds per hop, ``ring_bisection`` whether pushes that
    cross the middle of the group share a ring's two cut links (a torus
    embedded as a ring) rather than a switch's full bisection."""

    name: str
    peak_bf16_flops: float
    hbm_bw: float
    link_bw: float = 0.0
    links: int = 1
    hop_lat: float = 0.0
    ring_bisection: bool = False


# NVIDIA H100 SXM data sheet (700 W): 989 TFLOP/s dense bf16, 3.35 TB/s
# HBM3; NVLink 4 at 900 GB/s per card through the NVSwitch, all to all:
# 450 GB/s each way (published spec, not measured: one card bypasses the
# link). No per-hop latency is published; 1 us is assumed (not measured).
H100_SXM = Hardware("H100 SXM", 989e12, 3.35e12, link_bw=450e9, links=1,
                    hop_lat=1e-6)

# torch.cuda.get_device_name spellings (lowercase prefixes) -> figures. The
# SXM part reports itself as "NVIDIA H100 80GB HBM3"; the PCIe and NVL
# parts have other peaks and are not in the table.
_HW_TABLE = {
    "nvidia h100 80gb hbm3": H100_SXM,
    "nvidia h100 sxm": H100_SXM,
}


def detect_hardware(name: str | None = None) -> Hardware:
    """The figures of the card ``name`` (default: CUDA device 0, by
    ``torch.cuda.get_device_name``). Raises ``RuntimeError`` when there is
    no card and ``KeyError`` when the card is not in the table."""
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("detect_hardware: no CUDA device is visible")
        name = torch.cuda.get_device_name(0)
    key = name.lower()
    for prefix, hw in _HW_TABLE.items():
        if key.startswith(prefix):
            return hw
    raise KeyError(f"no speeds-and-feeds row for the card {name!r} (known: "
                   f"{sorted(_HW_TABLE)})")


def peak_bf16_tflops(hw: Hardware | None = None) -> float:
    """Dense bf16 peak in TFLOP/s."""
    return (hw or detect_hardware()).peak_bf16_flops / 1e12


def hbm_gbps(hw: Hardware | None = None) -> float:
    """Device-memory bandwidth in GB/s."""
    return (hw or detect_hardware()).hbm_bw / 1e9


def est_matmul(m: int, k: int, n: int, itemsize: int = 2,
               hw: Hardware | None = None, mfu: float = 0.85) -> float:
    """Roofline matmul time in seconds: the larger of the tensor cores at
    ``mfu`` of the bf16 peak and the traffic (A and B read, C written and
    read once more) over the memory rate, as the JAX model counts it."""
    hw = hw or detect_hardware()
    flops_t = 2 * m * k * n / (hw.peak_bf16_flops * mfu)
    bytes_t = (m * k + k * n + 2 * m * n) * itemsize / hw.hbm_bw
    return max(flops_t, bytes_t)


def bound_seconds(flops: float, nbytes: float,
                  hw: Hardware | None = None) -> tuple[float, str]:
    """The least time the card could take for work of ``flops`` bf16
    operations on the tensor cores that must move ``nbytes``: the larger of
    the two times, and which one it is (``"operations"`` or ``"bytes"``)."""
    hw = hw or detect_hardware()
    t_ops = flops / hw.peak_bf16_flops
    t_bytes = nbytes / hw.hbm_bw
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def oneshot_ar_loopback_bytes(nbytes: int) -> int:
    """Least bytes of the one-shot all-reduce loopback over an x of
    ``nbytes``, at any world: x read once, the output (``world * x``)
    written once."""
    return 2 * nbytes


def a2a_loopback_bytes(counts, capacity: int, row_bytes) -> int:
    """Least bytes of the all-to-all loopback: every payload's rows below
    each slot's count (at most ``capacity``, none for a count below 1) read
    once and written once, plus the send counts read and the received
    counts written. ``counts`` the per-slot counts (host ints),
    ``row_bytes`` each payload's bytes per row."""
    rows = sum(min(max(int(c), 0), capacity) for c in counts)
    return 2 * rows * sum(row_bytes) + 2 * 4 * len(counts)


def ep_a2a_bytes(counts, capacity: int, row_bytes) -> int:
    """Least bytes of the multi-rank all-to-all (``csrc/ep_a2a.cu``): every
    payload's rows below each (src, dst) pair's count (at most
    ``capacity``, none for a count below 1) read once and written once,
    plus the counts read and the received counts written. ``counts`` the
    (world, world) counts (host ints), ``row_bytes`` each payload's bytes
    per row. The count cells are scratch that stands in for the link."""
    return a2a_loopback_bytes([int(c) for row in counts for c in row],
                              capacity, row_bytes)


def producer_consumer_bytes(nbytes: int) -> int:
    """Least bytes of the notify/wait ring over an x of ``nbytes``: x read
    once, the output (every rank's received stream) written once."""
    return 2 * nbytes


# -- the all-reduce estimates (seconds; nbytes = one rank's buffer) --------


def _push_bandwidth_term(nbytes: int, world: int, hw: Hardware) -> float:
    """Bandwidth-limited time of world - 1 concurrent direct pushes per
    card (JAX :124): the card's egress over its links, and, on a ring
    embedding, the (world / 2)^2 shard copies that cross its two cut links
    per direction."""
    egress = (world - 1) * nbytes / (hw.link_bw * hw.links)
    if not hw.ring_bisection:
        return egress
    bisection = (world / 2) ** 2 * nbytes / (2 * hw.link_bw)
    return max(egress, bisection)


def est_ring_all_gather(nbytes: int, world: int,
                        hw: Hardware | None = None) -> float:
    """Ring allgather of one ``nbytes`` shard (JAX :113): world - 1 hops of
    one shard over one link."""
    hw = hw or detect_hardware()
    return (world - 1) * (nbytes / hw.link_bw + hw.hop_lat)


def est_ring_reduce_scatter(nbytes: int, world: int,
                            hw: Hardware | None = None) -> float:
    """Ring reduce-scatter (JAX :180): world - 1 hops of one chunk
    (nbytes / world) each, plus each hop's accumulate pass through device
    memory."""
    hw = hw or detect_hardware()
    chunk = nbytes / world
    per_hop = chunk / hw.link_bw + 3 * chunk / hw.hbm_bw + hw.hop_lat
    return (world - 1) * per_hop


def est_oneshot_reduce_scatter(nbytes: int, world: int,
                               hw: Hardware | None = None) -> float:
    """One-shot reduce-scatter (JAX :193): every rank pushes its world - 1
    foreign chunks (nbytes / world each) at once, then folds world chunks
    locally."""
    hw = hw or detect_hardware()
    chunk = nbytes / world
    reduce_ = world * chunk * 2 / hw.hbm_bw
    return (_push_bandwidth_term(chunk, world, hw) + hw.hop_lat
            + reduce_ + 2 * hw.hop_lat)


def est_oneshot_all_reduce(nbytes: int, world: int,
                           hw: Hardware | None = None) -> float:
    """One-shot all-reduce (JAX :204): every rank pushes its whole buffer
    to every peer, then folds world buffers locally."""
    hw = hw or detect_hardware()
    reduce_ = world * nbytes * 2 / hw.hbm_bw
    return (_push_bandwidth_term(nbytes, world, hw) + hw.hop_lat
            + reduce_ + 2 * hw.hop_lat)


def est_twoshot_all_reduce(nbytes: int, world: int,
                           hw: Hardware | None = None) -> float:
    """Two-shot all-reduce (JAX :214): ring reduce-scatter + ring
    allgather, 2 (world - 1) hops of nbytes / world each."""
    hw = hw or detect_hardware()
    return (est_ring_reduce_scatter(nbytes, world, hw)
            + est_ring_all_gather(nbytes // max(world, 1), world, hw))


def wire_bytes_all_reduce(nbytes: int, world: int,
                          method: str = "one_shot") -> int:
    """Bytes each rank sends in an all-reduce of ``nbytes`` (JAX :253):
    one-shot pushes the whole buffer to every peer; two-shot's ring
    reduce-scatter and allgather each move (world - 1) / world of it."""
    if method in ("one_shot", "oneshot"):
        return (world - 1) * nbytes
    return 2 * (world - 1) * nbytes // world


def wire_bytes_all_gather(shard_nbytes: int, world: int) -> int:
    """Bytes each rank moves in an allgather of one ``shard_nbytes`` shard
    (JAX :239): the other world - 1 shards, once each."""
    return (world - 1) * shard_nbytes


def wire_bytes_reduce_scatter(per_dev_nbytes: int, world: int) -> int:
    """Bytes each rank sends in a reduce-scatter of its whole
    ``per_dev_nbytes`` contribution (JAX :246): world - 1 chunks of
    per_dev_nbytes / world, one-shot and ring alike."""
    return (world - 1) * per_dev_nbytes // world


def wire_bytes_all_to_all(per_dev_nbytes: int, world: int) -> int:
    """Bytes each rank sends in an all-to-all of its ``(world, cap, ...)``
    slot buffers (``per_dev_nbytes`` in all, JAX :263): every slot but its
    own."""
    return (world - 1) * per_dev_nbytes // world


def est_push_all_gather(nbytes: int, world: int,
                        hw: Hardware | None = None) -> float:
    """Direct-push (a2a) allgather of one ``nbytes`` shard (JAX :160):
    world - 1 concurrent pushes, one hop of latency, and the entry
    barrier's signal round."""
    hw = hw or detect_hardware()
    barrier = 2 * hw.hop_lat
    return _push_bandwidth_term(nbytes, world, hw) + hw.hop_lat + barrier


def est_ll_all_gather(nbytes: int, world: int,
                      hw: Hardware | None = None) -> float:
    """Low-latency allgather of one ``nbytes`` shard (JAX :170): the
    direct push without the entry barrier (the staging persists), plus the
    copy of the world - 1 staged shards into the output through device
    memory."""
    hw = hw or detect_hardware()
    staging_copy = (world - 1) * nbytes * 2 / hw.hbm_bw
    return _push_bandwidth_term(nbytes, world, hw) + hw.hop_lat + staging_copy


# -- the multi-rank kernels' own work (the whole world's, on one card) -----


def ag_gemm_flops(world: int, m: int, k: int, n: int) -> int:
    """Operations of AG-GEMM over ``world`` ranks of a (m, k), b (k, n):
    every rank's (world m, k) x (k, n) product."""
    return 2 * world * (world * m) * k * n


def ag_gemm_bytes(world: int, m: int, k: int, n: int, itemsize: int) -> int:
    """Least bytes of AG-GEMM: every rank's a and b read once, every rank's
    (world m, n) output written once (the gather's staging is scratch)."""
    return (world * m * k + world * k * n + world * world * m * n) * itemsize


def gemm_rs_flops(world: int, M: int, k: int, n: int) -> int:
    """Operations of GEMM-RS over ``world`` ranks of a (M, k), b (k, n)."""
    return 2 * world * M * k * n


def gemm_rs_bytes(world: int, M: int, k: int, n: int, itemsize: int) -> int:
    """Least bytes of GEMM-RS: every rank's a and b read once, every rank's
    (M / world, n) output written once (the pushed partials are
    scratch)."""
    return (world * M * k + world * k * n + M * n) * itemsize


def all_reduce_bytes(world: int, nbytes: int) -> int:
    """Least bytes of an all-reduce of one ``nbytes`` buffer per rank:
    every rank's buffer read once and its copy of the sum written once
    (staging and ring pushes are scratch)."""
    return 2 * world * nbytes


def group_gemm_flops(world: int, rows: int, d: int, f_local: int) -> int:
    """Operations of AG-GroupGEMM or GroupGEMM-RS over ``world`` ranks:
    every rank multiplies ``rows`` gathered grid rows (the sum over every
    source and expert; ``world * E * cap`` for whole grids, fewer where
    only the rows the routing filled are counted) by its (d, f_local)
    shard of their expert: 2 world rows d f_local, which is
    ``2 world world E cap d f_local`` for whole grids."""
    return 2 * world * rows * d * f_local


def ag_group_gemm_bytes(world: int, E: int, cap: int, d: int, f_local: int,
                        itemsize: int, rows: int | None = None) -> int:
    """Least bytes of AG-GroupGEMM: every source's (E, cap, d) grid read
    once (its ``rows`` filled rows where given: an empty slot is known to
    be zero), every rank's (E, d, f_local) weights read once, every rank's
    (E, world cap, f_local) output written once (the gather's staging is
    scratch)."""
    rows = world * E * cap if rows is None else rows
    return (rows * d + world * E * d * f_local
            + world * E * world * cap * f_local) * itemsize


def group_gemm_rs_bytes(world: int, E: int, cap: int, d: int, f_local: int,
                        itemsize: int, rows: int | None = None) -> int:
    """Least bytes of GroupGEMM-RS: every rank's (E, world cap, f_local)
    activations read once (their ``rows`` filled rows per rank where
    given), every rank's (E, f_local, d) weights read once, every rank's
    (E, cap, d) segment written once (the pushed partials are scratch)."""
    rows = world * E * cap if rows is None else rows
    return (world * rows * f_local + world * E * f_local * d
            + world * E * cap * d) * itemsize


def reduce_scatter_bytes(world: int, nbytes: int) -> int:
    """Least bytes of a reduce-scatter of one ``nbytes`` contribution per
    rank: every rank's contribution read once and its nbytes / world
    segment of the sum written once."""
    return world * nbytes + nbytes


def all_gather_bytes(world: int, shard_nbytes: int) -> int:
    """Least bytes of an allgather of one ``shard_nbytes`` shard per rank:
    every shard read once and every rank's gathered copy (world shards)
    written once, (world + world^2) shards (staging is scratch)."""
    return (world + world * world) * shard_nbytes


def sp_attention_pairs(world: int, m: int, m_kv: int, causal: bool,
                       row_offsets=None, col_offsets=None) -> int:
    """(q row, key column) pairs the SP prefill's mask keeps over every
    rank, per head: rank r's m rows at global positions ``row_offsets[r] +
    i`` (default r m) against the world m_kv gathered columns at ``col +
    j`` (default col 0). Unmasked: world m world m_kv. Causal: the pairs
    with column <= row, which is S (S + 1) / 2 for the aligned S = world m
    = world m_kv sequence."""
    n_cols = world * m_kv
    if not causal:
        return world * m * n_cols
    total = 0
    for r in range(world):
        row0 = r * m if row_offsets is None else int(row_offsets[r])
        col0 = 0 if col_offsets is None else int(col_offsets[r])
        for i in range(m):
            total += min(max(row0 + i - col0 + 1, 0), n_cols)
    return total


def sp_attention_flops(heads: int, dh: int, pairs: int) -> int:
    """Operations of the SP prefill: a multiply-add for q.k and one for p.v
    over every kept (row, column) pair of every head, 4 heads dh pairs (not
    JAX's unmasked ``cost_estimate``, sp_attention.py:225)."""
    return 4 * heads * dh * pairs


def sp_attention_bytes(world: int, heads: int, m: int, m_kv: int, dh: int,
                       itemsize: int, partials: bool = False) -> int:
    """Least bytes of the SP prefill over every rank: q, k and v read once,
    out written once (and the f32 lse when partials are returned); the
    gathered K/V staging is scratch."""
    nbytes = world * heads * (2 * m + 2 * m_kv) * dh * itemsize
    return nbytes + (4 * world * heads * m if partials else 0)
