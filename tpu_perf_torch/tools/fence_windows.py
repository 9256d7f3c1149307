"""The trace fence's pairs and the profiler's windows, the old way beside
the shipped one, on the card.

Four parts, on ``pl_allreduce`` at 8 sim ranks (``--bytes`` a rank,
``-i`` executions in the lo leg, four times that in the hi leg):

* ``pairs``: ``--pairs`` (lo, hi) pairs timed four ways.  ``events``
  records CUDA events around each leg's eager launches (the trace fence
  before it captured its legs); ``graphs`` replays each leg's graph, its
  events inside it (``timing.TraceRunner``).  Each also ``_stalled``,
  with a ``--stall-ms`` host sleep before and after every host call of
  the lo leg (its launches, or its replay).  It reports each way's
  non-positive pairs and the legs' medians;
* ``gaps``: ``--pairs`` graph pairs after each of several host gaps (a
  daemon's row writing stands between its visits), each with a lead-in
  in the legs' graphs before their start events: none, one more chain
  of the leg, or the shipped device spin (``LEADS``);
* ``daemon``: ``monitor --fence trace -b 4K`` through the CLI for
  ``--visits`` visits with each lead-in, every pair recorded;
* ``windows``: ``--windows`` profiled windows of ``-r`` block-fenced
  runs each, of ``pl_allreduce`` and of ``mxu_gemm`` at m = 4096, four
  ways in turn (``WAYS``): ``bare`` (``torch.profiler.profile`` entered
  and left around the runs, the window before it was repaired),
  ``warm_settle`` (a profiler warm-up step before the window, the card
  fenced and the trace held open ``traceparse.SETTLE_S`` after it),
  ``margins`` (``SETTLE_S`` of host time on each side, no warm-up step)
  and ``shipped`` (``traceparse.profile_window``).  It reports how many
  windows of each way held fewer kernels than their runs launched, and
  how many held none.

Run on a machine with a card::

    python -m tpu_perf_torch.tools.fence_windows
        [--part pairs,gaps,daemon,windows] [--pairs 300] [--visits 1000]
        [--windows 400] [--out FILE]

The parts run in the order given and may repeat (``--part
daemon,windows,daemon`` runs the daemon before and after profiled
windows in one process).

It prints one JSON line, with the card's name and power limit; ``--out``
also writes every pair and window count there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time

OP = "pl_allreduce"


def _built(nbytes: int, iters: int):
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.timing import SLOPE_ITERS_FACTOR
    from tpu_perf_torch.world import SimWorld, resolve_device

    world = SimWorld(8, resolve_device())
    lo = build_op(OP, world, nbytes, iters)
    hi = build_op(OP, world, nbytes, iters * SLOPE_ITERS_FACTOR,
                  reuse_input=lo.example_input)
    return lo, hi


def _event_pairs(lo, hi, pairs: int, stall_s: float) -> list:
    """The old trace fence: events around each leg's eager launches."""
    import torch

    x = lo.example_input
    for _ in range(2):
        lo.step(x)
        hi.step(x)
    torch.cuda.synchronize()
    out = []
    for _ in range(pairs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        time.sleep(stall_s)
        lo.step(x)
        time.sleep(stall_s)
        ev[1].record()
        ev[2].record()
        hi.step(x)
        ev[3].record()
        torch.cuda.synchronize()
        out.append((ev[0].elapsed_time(ev[1]) * 1e-3,
                    ev[2].elapsed_time(ev[3]) * 1e-3))
    return out


def _graph_pairs(lo, hi, pairs: int, stall_s: float) -> list:
    """The shipped trace fence: one replay a leg, its events inside."""
    from tpu_perf_torch.timing import TraceRunner

    runner = TraceRunner(lo.step, hi.step, lo.example_input, lo.iters,
                         hi.iters)
    runner.warm()
    plain = runner.replay

    def replay(leg):
        if leg == "lo":
            time.sleep(stall_s)
        plain(leg)
        if leg == "lo":
            time.sleep(stall_s)

    runner.replay = replay
    try:
        return [runner.pair() for _ in range(pairs)]
    finally:
        runner.close()


#: what a leg's graph runs before its start event: nothing, one more
#: execution chain of the leg, or the shipped device spin
#: (``timing.LEAD_IN_CYCLES``)
LEADS = ("none", "step", "spin")


def _runner_class(lead: str):
    """TraceRunner (the spin), or a subclass whose legs' graphs run
    ``lead`` before their start events."""
    from tpu_perf_torch.timing import TraceRunner

    if lead == "spin":
        return TraceRunner

    class Led(TraceRunner):
        def lead_in(self, leg):
            if lead == "step":
                self.steps[leg](self.x)

    return Led


def _summary(got: list, d_iters: int) -> dict:
    slopes = [(b - a) / d_iters for a, b in got]
    los = sorted(a for a, _ in got)
    return {
        "pairs": len(got),
        "non_positive": sum(b <= a for a, b in got),
        "lo_ms_median": statistics.median(los) * 1e3,
        "lo_ms_p99": los[int(0.99 * (len(los) - 1))] * 1e3,
        "lo_ms_max": los[-1] * 1e3,
        "hi_ms_median": statistics.median(b for _, b in got) * 1e3,
        "us_an_execution_median": statistics.median(slopes) * 1e6,
    }


def measure_gaps(nbytes: int, iters: int, pairs: int,
                 gaps_ms=(0.0, 0.3, 1.0)) -> tuple[dict, dict]:
    """Graph pairs with a host gap before each (a daemon's row writing
    stands between its visits), for each lead-in."""
    lo, hi = _built(nbytes, iters)
    raw, summary = {}, {}
    for lead in LEADS:
        runner = _runner_class(lead)(lo.step, hi.step, lo.example_input,
                                     lo.iters, hi.iters)
        runner.warm()
        try:
            for gap in gaps_ms:
                got = []
                for _ in range(pairs):
                    time.sleep(gap * 1e-3)
                    got.append(runner.pair())
                name = f"{lead}_gap{gap:g}ms"
                raw[name] = got
                summary[name] = _summary(got, hi.iters - lo.iters)
        finally:
            runner.close()
    return raw, summary


def measure_daemon(iters: int, visits: int) -> tuple[dict, dict]:
    """``monitor --fence trace -b 4K`` through the CLI, each lead-in: every
    visit's pair recorded, none raised on."""
    from tpu_perf_torch import cli, driver

    raw, summary = {}, {}
    plain = driver.TraceRunner
    try:
        for lead in LEADS:
            got = []

            class Recorded(_runner_class(lead)):
                def sample(self):
                    d_lo, d_hi = self.pair()
                    got.append((d_lo, d_hi))
                    return max(d_hi - d_lo, 1e-9) / self.d_iters

            driver.TraceRunner = Recorded
            with tempfile.TemporaryDirectory(prefix="fence_daemon-") as logs:
                cli.main(["monitor", "--op", OP, "-b", "4K", "-i",
                          str(iters), "--fence", "trace", "--max-runs",
                          str(visits), "--stats-every", str(visits), "-l",
                          logs])
            raw[f"daemon_{lead}"] = got
            summary[f"daemon_{lead}"] = _summary(got, 3 * iters)
    finally:
        driver.TraceRunner = plain
    return raw, summary


def measure_pairs(nbytes: int, iters: int, pairs: int, stall_ms: float
                  ) -> tuple[dict, dict]:
    lo, hi = _built(nbytes, iters)
    raw, summary = {}, {}
    for way, fn in (("events", _event_pairs), ("graphs", _graph_pairs)):
        for stalled in (False, True):
            name = way + ("_stalled" if stalled else "")
            got = fn(lo, hi, pairs, stall_ms * 1e-3 if stalled else 0.0)
            raw[name] = got
            slopes = [(b - a) / (hi.iters - lo.iters) for a, b in got]
            summary[name] = {
                "pairs": len(got),
                "non_positive": sum(b <= a for a, b in got),
                "lo_ms_median": statistics.median(a for a, _ in got) * 1e3,
                "lo_ms_max": max(a for a, _ in got) * 1e3,
                "hi_ms_median": statistics.median(b for _, b in got) * 1e3,
                "us_an_execution_median": statistics.median(slopes) * 1e6,
            }
    return raw, summary


def _kernels_in(path: str) -> int:
    from tpu_perf_torch.traceparse import read_events

    return sum(1 for e in read_events(path)
               if e.get("ph") == "X" and e.get("cat") == "kernel")


#: the ways a window is traced: the plain profiler; its warm-up step and
#: a settle after the fence, no margin (the window before its margins);
#: margins alone; the shipped window (traceparse.profile_window)
WAYS = ("bare", "warm_settle", "margins", "shipped")


def _window(way: str, run, trace_dir: str) -> int:
    """One profiled window of ``run()``, traced the ``way`` named; its
    kernel count."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from tpu_perf_torch.traceparse import SETTLE_S, profile_window

    if way == "shipped":
        with profile_window(trace_dir, "w", torch.device("cuda")) as path:
            run()
        return _kernels_in(path)
    path = f"{trace_dir}/{way}.json"
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if way != "bare":
        torch.cuda.synchronize()
    kw = {}
    if way == "warm_settle":
        kw = dict(schedule=schedule(wait=0, warmup=1, active=1),
                  on_trace_ready=lambda p: p.export_chrome_trace(path))
    with profile(activities=acts, **kw) as prof:
        if way == "warm_settle":
            prof.step()
        elif way == "margins":
            time.sleep(SETTLE_S)
        run()
        if way != "bare":
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
    if way != "warm_settle":
        prof.export_chrome_trace(path)
    return _kernels_in(path)


def measure_windows(nbytes: int, iters: int, runs: int, windows: int
                    ) -> tuple[dict, dict]:
    """Profiled windows of ``runs`` block-fenced runs each, every way in
    turn: ``pl_allreduce`` at 8 ranks x ``nbytes`` (a short window), and
    ``mxu_gemm`` at m = 4096 on one rank (float32, ~2 ms a product)."""
    import torch

    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.timing import fence
    from tpu_perf_torch.world import SimWorld, resolve_device

    lo, _ = _built(nbytes, iters)
    gemm = build_op("mxu_gemm", SimWorld(1, resolve_device()),
                    4096 * 4096 * 4, iters)
    raw, summary = {}, {}
    # a reduce-scatter and a gather an execution; one product
    for name, built, per in ((OP, lo, 2), ("mxu_gemm", gemm, 1)):
        x = built.example_input
        fence(built.step(x))

        def run():
            for _ in range(runs):
                fence(built.step(x))

        want = per * runs * iters
        got = {w: [] for w in WAYS}
        with tempfile.TemporaryDirectory(prefix="fence_windows-") as root:
            for _ in range(windows):
                for way in WAYS:
                    got[way].append(_window(way, run, root))
        torch.cuda.synchronize()
        for w, c in got.items():
            raw[f"{name}_{w}"] = c
            summary[f"{name}_{w}"] = {
                "windows": len(c), "want_kernels": want,
                "short": sum(k < want for k in c),
                "empty": sum(k == 0 for k in c)}
    return raw, summary


def main(argv=None) -> int:
    import subprocess

    import torch

    ap = argparse.ArgumentParser(prog="fence_windows")
    ap.add_argument("--part", default="pairs,windows")
    ap.add_argument("--bytes", type=int, default=4096)
    ap.add_argument("-i", "--iters", type=int, default=5)
    ap.add_argument("-r", "--runs", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=300)
    ap.add_argument("--stall-ms", type=float, default=2.0)
    ap.add_argument("--windows", type=int, default=400)
    ap.add_argument("--visits", type=int, default=1000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from tpu_perf_torch.kernels import _build

    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    raw, result = {}, {"card": card, "op": OP, "bytes": args.bytes,
                       "iters": args.iters, "ranks": 8,
                       "stall_ms": args.stall_ms}
    # the parts run in the order given, and may repeat: a part run after
    # profiled windows in this process is keyed "<part>_after_windows"
    windowed = False
    for part in args.part.split(","):
        key = part + ("_after_windows" if windowed else "")
        if part == "pairs":
            raw[key], result[key] = measure_pairs(
                args.bytes, args.iters, args.pairs, args.stall_ms)
        elif part == "gaps":
            raw[key], result[key] = measure_gaps(args.bytes, args.iters,
                                                 args.pairs)
        elif part == "daemon":
            raw[key], result[key] = measure_daemon(args.iters, args.visits)
        elif part == "windows":
            raw[key], result[key] = measure_windows(
                args.bytes, args.iters, args.runs, args.windows)
            windowed = True
        else:
            ap.error(f"unknown part {part!r}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"result": result, "raw": raw}, fh)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
