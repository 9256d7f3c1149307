"""Profiler traces: keep one per measured window, and read device time
and idle share back from it (port of ``tpu_perf/traceparse.py``).

The JAX package reads per-execution device durations from the
``jax.profiler`` capture's device lanes.  Here the fences take their
device times from CUDA events (:mod:`tpu_perf_torch.timing`), so a trace
is evidence, not a clock: ``--profile-dir`` keeps one
``torch.profiler`` chrome trace per point's measured window
(:func:`profile_window`), and :func:`device_summary` reads back what the
card did in it:

* ``kernel_s`` — the summed durations of the kernel events;
* ``busy_s`` — the union of every device event (kernels, copies, sets),
  so overlapping work counts once;
* ``window_s`` — from the first device event's start to the last one's
  end;
* ``idle_share`` — ``1 - busy_s / window_s``: the share of that window in
  which the card ran nothing, waiting on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import tempfile
import time

import torch

#: chrome-trace categories of work the device itself ran
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceParseError(RuntimeError):
    """The trace exists but cannot be read as a profiler trace."""


class TraceUnavailableError(TraceParseError):
    """The trace holds no device event at all (a CPU run traces host
    events only)."""


#: host seconds a card's profiled window stays open after its work has
#: finished and the card is fenced, before the profiler stops
SETTLE_S = 0.01


@contextlib.contextmanager
def profile_window(trace_dir: str | None, name: str, device: torch.device):
    """Trace the enclosed window with ``torch.profiler`` (host events, and
    the card's with a CUDA ``device``) and keep it as
    ``<trace_dir>/<name>-<unique>.json``; with ``trace_dir`` None, trace
    nothing.  The unique suffix keeps two windows of one name apart.

    On a card the window is bracketed so that it loses no device event:
    the card is idle when the profiler starts, the profiler passes one
    warm-up step before the window opens, and after the window the card
    is fenced and the trace held open for :data:`SETTLE_S` before it
    stops.  A short window entered and left without these lost all its
    kernels now and then: on an H100, 1 of 400 4 KiB windows bare, with
    the warm-up step alone, and with the settle alone, 0 of 400 with
    both; 9 of 10 bare when the profiler tears its device tracing down
    after every trace (``TEARDOWN_CUPTI=1``), 0 of 10 with either
    (``python -m tpu_perf_torch.tools.fence_windows --part windows``)."""
    if trace_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    on_card = device.type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix=f"{name}-", suffix=".json",
                                dir=trace_dir)
    os.close(fd)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        prof.step()  # the warm-up step ends: the window opens
        yield path
        if on_card:
            torch.cuda.synchronize(device)
            time.sleep(SETTLE_S)


def read_events(path: str) -> list[dict]:
    """The ``traceEvents`` of a chrome trace (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt") as fh:
            data = json.load(fh)
    except (OSError, EOFError, ValueError) as e:
        raise TraceParseError(f"unreadable trace {path!r}: {e}") from e
    events = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(events, list):
        raise TraceParseError(f"trace {path!r} has no traceEvents list")
    return events


@dataclasses.dataclass(frozen=True)
class TraceSummary:
    """What the device did in one traced window (seconds)."""

    kernel_s: float
    busy_s: float
    window_s: float
    kernels: dict[str, tuple[int, float]]  # kernel name -> (count, total s)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s > 0 else 0.0


def device_summary(path: str) -> TraceSummary:
    """Kernel time, busy time, window and idle share of one kept trace.
    Raises :class:`TraceUnavailableError` when it holds no device event."""
    spans = []
    kernels: dict[str, tuple[int, float]] = {}
    for e in read_events(path):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        try:
            ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        except (KeyError, TypeError, ValueError) as exc:
            raise TraceParseError(
                f"malformed device event in {path!r}: {e!r}") from exc
        spans.append((ts, ts + dur))
        if e["cat"] == "kernel":
            count, total = kernels.get(e.get("name", ""), (0, 0.0))
            kernels[e.get("name", "")] = (count + 1, total + dur)
    if not spans:
        raise TraceUnavailableError(
            f"trace {path!r} holds no device event; device time needs a "
            "CUDA run")
    spans.sort()
    busy = 0.0
    cur_lo, cur_hi = spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return TraceSummary(
        kernel_s=sum(total for _, total in kernels.values()), busy_s=busy,
        window_s=max(hi for _, hi in spans) - spans[0][0], kernels=kernels)
