"""Hand-written GPU kernels: build, load, and count launches.

Each kernel wrapper (``tpu_perf_torch.ops.pallas_ring``,
``tpu_perf_torch.ops.stream_triton``) adds one to ``LAUNCHES[name]`` where
it launches its kernel and nowhere else, and each plain PyTorch version
adds one to ``PLAIN_CALLS[name]`` per call.  A run that resets both and
reads them afterwards shows which path the work really took: the card's
main path must show launches and no plain calls.
"""

from __future__ import annotations

KERNELS = ("direct_reduce_scatter", "direct_all_gather", "stream",
           "hbm_copy", "hbm_read", "hbm_write", "ring", "exchange", "pingpong",
           "barrier", "all_to_all", "direct_all_gather_bidir",
           "peer_reduce_scatter", "peer_all_gather", "peer_barrier",
           "peer_ring", "peer_exchange", "peer_pingpong", "peer_all_to_all",
           "peer_all_gather_bidir", "peer_barrier_copy")

#: kernel launches since the last reset_counts()
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
#: calls of each kernel's plain PyTorch version since the last reset_counts()
PLAIN_CALLS: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0
