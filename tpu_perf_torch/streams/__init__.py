"""Multi-stream dispatch: engine, static lane plans, contention (port of
``tpu_perf/streams``).

:mod:`engine` owns how a step is dispatched and fenced on a lane (a CUDA
stream on the card), :mod:`plans` which step rides which lane (pure
functions of static config), and :mod:`contend` composes the two into the
contention race (``tpu-perf-torch contend``).
"""

from tpu_perf_torch.streams.engine import StreamEngine
from tpu_perf_torch.streams.plans import lane_schedules, split_slices, wave_plan

__all__ = [
    "StreamEngine",
    "lane_schedules",
    "split_slices",
    "wave_plan",
]
