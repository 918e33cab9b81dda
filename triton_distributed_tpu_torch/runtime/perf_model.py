"""Speeds and feeds of the card, and the roofline matmul time.

Counterpart of ``triton_distributed_tpu/runtime/perf_model.py``, the part
the one-chip kernels need: ``Hardware``, ``detect_hardware``,
``est_matmul`` (:330), ``hbm_gbps``, ``peak_bf16_tflops``, and the bytes
that the collective loopbacks must move (the least, for their bounds). The
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
    bytes/s."""

    name: str
    peak_bf16_flops: float
    hbm_bw: float


# NVIDIA H100 SXM data sheet (700 W): 989 TFLOP/s dense bf16, 3.35 TB/s
# HBM3.
H100_SXM = Hardware("H100 SXM", 989e12, 3.35e12)

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


def producer_consumer_bytes(nbytes: int) -> int:
    """Least bytes of the notify/wait ring over an x of ``nbytes``: x read
    once, the output (every rank's received stream) written once."""
    return 2 * nbytes
