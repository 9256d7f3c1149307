"""The multi-stream dispatch engine (port of ``tpu_perf/streams/engine.py``).

The serial harness fences every run before the next dispatch, so the host
and the card take turns.  This engine keeps up to K different steps in
flight at once, each on its own lane with its own completion fence.  On a
card a lane is a ``torch.cuda.Stream``: ``dispatch`` issues ``step(x)``
with the lane as the current stream and records the lane's event after
it.  On the
CPU a lane is a plain sequential call, and no stream object is made.

Two consumers:

* the overlapped sweep (``run --streams K``, :mod:`tpu_perf_torch.driver`):
  ordinary sweep points ride the lanes round-robin, without changing a
  single measured step;
* the contention race (``contend``, :mod:`tpu_perf_torch.streams.contend`):
  a victim raced against a concurrent load, where the overlap is the
  measurement.

The engine never decides what to dispatch (:mod:`tpu_perf_torch.streams.plans`
does), a lane holds at most one step, and ``fence_all`` drains lanes in
dispatch order.  With a tracer each launch is a ``dispatch`` span and each
wait a ``stream_fence`` span on the lane's ``s<id>.`` ID lane; both close
inside some lane's timed window, so their records are written once no lane
is in flight (:meth:`~tpu_perf_torch.spans.SpanTracer.flush`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import torch

from tpu_perf_torch.timing import fence

#: how a lane is fenced: ``block`` synchronizes the lane's event (its own
#: step, not the whole card), ``readback`` copies one element of its
#: output to the host on the lane
LANE_FENCES = ("block", "readback")


def _on(lane, fn, *args):
    """``fn(*args)`` with ``lane`` as the current stream of its card, then
    the card's previous stream back.  It does what ``torch.cuda.stream``
    does without building Python stream objects, a few times cheaper on
    the host (``tpu_perf_torch.tools.engine_overhead``)."""
    prev = torch._C._cuda_getCurrentStream(lane.device_index)
    torch.cuda.set_stream(lane)
    try:
        return fn(*args)
    finally:
        torch.cuda._set_stream_by_id(*prev)


@dataclasses.dataclass
class _InFlight:
    """One lane's outstanding dispatch."""

    stream_id: int
    label: str
    out: Any                   # the step's output
    t0: float                  # host clock at dispatch
    seq: int                   # global dispatch order (fence_all's order)
    lane: Any = None           # the lane's torch.cuda.Stream (None on CPU)
    done: Any = None           # the event recorded after the step


class StreamEngine:
    """K dispatch lanes with per-lane fences.

    ``dispatch`` issues one step on a lane and returns as soon as the host
    call does; ``fence`` blocks until that lane's step completes and
    returns the lane's wall time (dispatch to fence return, the window the
    serial path times); ``fence_all`` drains every outstanding lane in
    dispatch order.  Dispatching on an occupied lane is an error, not a
    queue.  Before its first dispatch a lane waits on the stream current
    at that dispatch, the one that made the input; the input is
    ``record_stream``'d to the lane.  The lock guards the in-flight table
    against monitoring readers (``in_flight``)."""

    def __init__(self, n_streams: int, *, fence_mode: str = "block",
                 tracer=None,
                 perf_clock: Callable[[], float] = time.perf_counter):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if fence_mode not in LANE_FENCES:
            raise ValueError(
                f"fence_mode must be one of {LANE_FENCES}, got {fence_mode!r}")
        self.n_streams = n_streams
        self.fence_mode = fence_mode
        self._clock = perf_clock
        if tracer is None:
            from tpu_perf_torch.spans import NULL_TRACER

            tracer = NULL_TRACER
        self.tracer = tracer
        self._lock = threading.Lock()
        self._inflight: dict[int, _InFlight] = {}
        self._seq = 0
        self._lanes: dict[int, torch.cuda.Stream] = {}
        self._done: dict[int, torch.cuda.Event] = {}  # a lane's event,
        # recorded after each of its steps

    def _check_lane(self, stream_id: int) -> None:
        if not 0 <= stream_id < self.n_streams:
            raise ValueError(
                f"stream_id {stream_id} out of range for {self.n_streams} "
                f"stream(s)")

    def _lane(self, stream_id: int, x: torch.Tensor):
        """The lane's stream on ``x``'s card, made at its first dispatch
        (then waiting on the current stream); None on the CPU."""
        if not x.is_cuda:
            return None
        lane = self._lanes.get(stream_id)
        if lane is None:
            lane = self._lanes[stream_id] = torch.cuda.Stream(x.device)
            lane.wait_stream(torch.cuda.current_stream(x.device))
            self._done[stream_id] = torch.cuda.Event()
        return lane

    def dispatch(self, stream_id: int, step, x, *, label: str = ""):
        """Issue ``step(x)`` on a lane; returns its (asynchronous) output.
        The dispatch time is taken just before the call, as the serial
        path's ``t0 = clock(); out = step(x); fence(out)``."""
        self._check_lane(stream_id)
        with self._lock:
            if stream_id in self._inflight:
                raise RuntimeError(
                    f"stream {stream_id} already has a step in flight "
                    f"({self._inflight[stream_id].label or 'unlabeled'}); "
                    "fence it before dispatching again")
        lane = self._lane(stream_id, x)
        done = None
        with self.tracer.stream_span(stream_id, "dispatch", defer=True,
                                     label=label):
            if lane is None:
                t0 = self._clock()
                out = step(x)
            else:
                x.record_stream(lane)
                t0 = self._clock()
                out = _on(lane, step, x)
                done = self._done[stream_id]
                done.record(lane)
        with self._lock:
            self._seq += 1
            self._inflight[stream_id] = _InFlight(
                stream_id=stream_id, label=label, out=out, t0=t0,
                seq=self._seq, lane=lane, done=done)
        return out

    def fence(self, stream_id: int) -> float:
        """Block until the lane's step completes; returns its wall time
        (dispatch to fence return) and frees the lane."""
        self._check_lane(stream_id)
        with self._lock:
            entry = self._inflight.get(stream_id)
        if entry is None:
            raise RuntimeError(f"stream {stream_id} has nothing in flight to "
                               "fence")
        with self.tracer.stream_span(stream_id, "stream_fence", defer=True,
                                     label=entry.label):
            if entry.lane is None:
                fence(entry.out, self.fence_mode)
            elif self.fence_mode == "block":
                entry.done.synchronize()
            else:
                # the copy to the host goes on the lane, behind its step
                _on(entry.lane, fence, entry.out, "readback")
        t = self._clock() - entry.t0
        with self._lock:
            del self._inflight[stream_id]
            idle = not self._inflight
        if idle:
            # after every lane's window has closed
            self.tracer.flush()
        return t

    def fence_all(self) -> dict[int, float]:
        """Drain every outstanding lane in dispatch order; returns
        ``{stream_id: wall_s}``."""
        with self._lock:
            order = sorted(self._inflight.values(), key=lambda e: e.seq)
        return {e.stream_id: self.fence(e.stream_id) for e in order}

    @property
    def in_flight(self) -> tuple[int, ...]:
        """Occupied lanes, ascending."""
        with self._lock:
            return tuple(sorted(self._inflight))
