"""Hand-written GPU kernels: build, load, and count launches.

Each kernel wrapper (``tpu_perf_torch.ops.pallas_ring``,
``tpu_perf_torch.ops.stream_triton``) adds one to ``LAUNCHES[name]`` where
it launches its kernel and nowhere else, and each plain PyTorch version
adds one to ``PLAIN_CALLS[name]`` per call.  A run that resets both and
reads them afterwards shows which path the work really took: the card's
main path must show launches and no plain calls.
"""

from __future__ import annotations

KERNELS = ("ring_reduce_scatter", "ring_all_gather", "stream")

#: kernel launches since the last reset_counts()
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
#: calls of each kernel's plain PyTorch version since the last reset_counts()
PLAIN_CALLS: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0
