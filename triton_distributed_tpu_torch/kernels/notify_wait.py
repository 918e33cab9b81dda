"""The notify/wait tutorial's producer -> consumer ring, over simulated ranks.

Counterpart of ``tutorials/01-distributed-notify-wait.py``
(``producer_consumer_kernel`` :58): every rank streams its chunks into its
right neighbour's 2-slot queue, with a per-slot arrival signal and an
ack-based flow control, while consuming its left neighbour's stream. Here
the ranks are blocks of one cooperative launch of ``csrc/notify_wait.cu``
(several a rank, each running the protocol on one stripe of every chunk,
producer and consumer warps at once), the first user of the port's device
language layer (``csrc/language.cuh``). Rank r's output is rank r - 1's
stream, the tutorial's own check (:147-148). The call allocates only its
output: the signals are a persistent per-stream buffer that the kernel
leaves at 0 (``_signal.arrivals``), and the default queue a persistent
per-(device, stream, shape) buffer.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels import _build, _signal

NOTIFY_WAIT = _build.register(
    "notify_wait", "triton_distributed_tpu_torch/csrc/notify_wait.cu",
    "tutorials/01-distributed-notify-wait.py:58")

# The tutorial's shapes (:50-55): 8 ranks, chunks of (4, 128) f32, 4 chunks
# per rank.
WORLD, CHUNK_ROWS, N_CHUNKS, COLS = 8, 4, 4, 128
# Stripes of a chunk, at most (csrc/notify_wait.cu kMaxStripes, kMinStripe):
# the kernel takes min(MAX_STRIPES, ceil(chunk bytes / MIN_STRIPE), SMs /
# world), so the signals are sized for the first two.
MAX_STRIPES, MIN_STRIPE = 16, 2048

_QUEUES: dict[tuple, torch.Tensor] = {}


def _n_chunks(x: torch.Tensor, chunk_rows: int) -> int:
    if x.dim() < 2 or x.shape[0] < 1 or chunk_rows < 1 \
            or x.shape[1] < chunk_rows or x.shape[1] % chunk_rows:
        raise ValueError(f"x {tuple(x.shape)} must be (world, n_chunks * "
                         f"{chunk_rows}, ...) with n_chunks >= 1")
    return x.shape[1] // chunk_rows


def producer_consumer_ref(x: torch.Tensor, *,
                          chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """Plain version: rank r receives rank r - 1's stream."""
    _n_chunks(x, chunk_rows)
    return torch.roll(x, 1, 0)


def producer_consumer_cuda(x: torch.Tensor, *, chunk_rows: int = CHUNK_ROWS,
                           queue: torch.Tensor | None = None,
                           producer_delay_ns: int = 0) -> torch.Tensor:
    """Launch ``csrc/notify_wait.cu`` on the current stream: ``x.shape[0]``
    ranks in one cooperative launch (a world too large for the card to hold
    at once raises). ``queue`` (default: a persistent buffer of shape
    (world, 2, chunk_rows, *x.shape[2:]) per device, stream and shape) and
    ``producer_delay_ns`` (every odd rank's producer sleeps that long before
    each push) let a test poison the slots and hold the pushes back; the
    result must not change."""
    n_chunks = _n_chunks(x, chunk_rows)
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("producer_consumer_cuda takes a contiguous CUDA "
                         "tensor")
    world = x.shape[0]
    chunk_bytes = x.numel() // (world * n_chunks) * x.element_size()
    shape = (world, 2, chunk_rows, *x.shape[2:])
    stream = _build.stream_ptr(x)
    if queue is None:
        key = (x.device, stream, shape, x.dtype)
        queue = _QUEUES.get(key)
        if queue is None:
            queue = _QUEUES[key] = torch.empty(shape, dtype=x.dtype,
                                               device=x.device)
    elif (tuple(queue.shape) != shape or queue.dtype != x.dtype
          or queue.device != x.device or not queue.is_contiguous()):
        raise ValueError(f"queue must be a contiguous {shape} {x.dtype} "
                         f"tensor on {x.device}")
    out = torch.empty_like(x)
    stripes = min(MAX_STRIPES, -(-chunk_bytes // MIN_STRIPE))
    signals = _signal.arrivals(x.device, "notify_wait",
                               3 * world * stripes + 1, stream)
    err = _build.lib().tdt_notify_wait(
        x.data_ptr(), queue.data_ptr(), out.data_ptr(), signals.data_ptr(),
        world, n_chunks, chunk_bytes, producer_delay_ns, stream)
    _build.check(err, "tdt_notify_wait")
    NOTIFY_WAIT.launches += 1
    return out


def producer_consumer(x: torch.Tensor, *,
                      chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """The tutorial's protocol over ``x`` (world, n_chunks * chunk_rows,
    ...): returns ``out`` with ``out[r]`` rank r's received stream, i.e.
    ``x[(r - 1) mod world]``. A CUDA tensor runs the kernel, a CPU tensor
    the plain version."""
    if x.is_cuda:
        return producer_consumer_cuda(x, chunk_rows=chunk_rows)
    return producer_consumer_ref(x, chunk_rows=chunk_rows)
