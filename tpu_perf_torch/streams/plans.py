"""Stream plans: which step rides which lane, decided statically (copy of
``tpu_perf/streams/plans.py``).

Every plan is a pure function of the static sweep plan and K, never of a
rank, a clock or a measured value, so two processes holding the same plan
and K dispatch the same steps on the same lanes in the same order.
"""

from __future__ import annotations

from typing import Iterable, Sequence, TypeVar

T = TypeVar("T")


def wave_plan(points: Iterable[T], k: int) -> list[list[tuple[int, T]]]:
    """Partition a sweep plan into waves of at most ``k`` lanes.

    Wave ``w`` carries plan entries ``w*k .. w*k+k-1``; within a wave,
    entry ``i`` rides lane ``i``, round-robin in plan order.  Returns
    ``[[(stream_id, point), ...], ...]``."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    seq = list(points)
    return [
        [(lane, p) for lane, p in enumerate(seq[i:i + k])]
        for i in range(0, len(seq), k)
    ]


def split_slices(nbytes: int, k: int, *, itemsize: int = 1) -> list[int]:
    """Split a payload into ``k`` per-lane slice sizes (bytes): as even as
    possible on the ``itemsize`` grid, summing to at least ``nbytes`` (each
    slice rounds up to a whole element, so a split never moves fewer bytes
    than the single-channel spelling)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if nbytes < 1:
        raise ValueError(f"nbytes must be >= 1, got {nbytes}")
    if itemsize < 1:
        raise ValueError(f"itemsize must be >= 1, got {itemsize}")
    elems = max(k, -(-nbytes // itemsize))  # >= one element per lane
    base, extra = divmod(elems, k)
    return [(base + (1 if lane < extra else 0)) * itemsize
            for lane in range(k)]


def lane_schedules(schedules: Sequence[T], k: int) -> list[T]:
    """Assign one schedule to each of ``k`` lanes: lane ``i`` takes
    ``schedules[i % len(schedules)]``, so while K is at most the schedule
    count no two lanes share one; beyond that, lanes wrap."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not schedules:
        raise ValueError("no schedules to assign lanes from")
    return [schedules[i % len(schedules)] for i in range(k)]
