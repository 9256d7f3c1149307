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
  ``--visits`` visits under each of ``--conditions`` (``CONDITIONS``,
  each in a process of its own, the compute processes on the card listed
  first), every pair recorded with an event after each kernel inside its
  legs' graphs: it counts non-positive pairs and lo legs above twice
  their median, per 10 000 visits, and names the two kernels each
  stalled lo leg's largest gap fell between;
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
        [--conditions a,b,c,d,e] [--windows 400] [--out FILE]

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


#: the daemon part's conditions, each run in a process of its own: (a) a
#: fresh process; (b) after the smoke's profiled windows (``--profile-dir``
#: runs of the 4 KiB and 256 MiB points, block and fused) in the same
#: process; (c) as (b), the profiler tearing its device tracing down after
#: each trace (``TEARDOWN_CUPTI=1``); (d) as (b), with the card's SM clock
#: and throttle reasons sampled beside the run; (e) the smoke's own: (b),
#: then the smoke's fused daemon (rotating every second into a ``local:``
#: sink), then the trace daemon; (f) as (a), with a busy process on every
#: host core; (g) as (a), each leg's lead-in a 1 ms spin; (h) as (a), each
#: leg's lead-in ``WORK_LEAD`` of memory-bound work instead of the spin.
#: Every condition runs the shipped fence, its lo leg behind the trace
#: gate (``timing.TraceGate``); a condition named with a trailing ``0``
#: (``a0``, ``f0``) runs it without the gate, as it was before the gate
CONDITIONS = ("a", "b", "c", "d", "e", "f", "g", "h")

#: the clock cycles of a probe spin after each leg's end event: its
#: events give the SM clock at the leg's end, as the lead-in's give it at
#: the start
PROBE_CYCLES = 20_000
#: (g)'s lead-in spin, clock cycles (about 1 ms at 1980 MHz)
LONG_LEAD_CYCLES = 2_000_000
#: (h)'s lead-in: this many adds over a 64 MiB buffer (~40 us each)
WORK_LEAD = 5

#: (d)'s sampler: the card's SM clock and active throttle reasons every
#: 50 ms, read only
CLOCK_QUERY = ("nvidia-smi",
               "--query-gpu=timestamp,clocks.sm,clocks_throttle_reasons.active",
               "--format=csv,noheader", "-lms", "50")

#: a lo leg this many times its median is stalled
STALL_FACTOR = 2.0


def _compute_apps() -> list[str]:
    """The compute processes holding a context on the card, as nvidia-smi
    lists them (a child of an earlier phase still holding one would
    time-slice the card)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def _placed_runner(lead: str = "spin", gated: bool = True):
    """A TraceRunner whose legs' graphs also record an event before the
    lead-in and after every kernel launch (``_build.check`` follows each
    launch through a wrapper), so that a stall inside a leg is placed
    between two named kernels, then a probe spin of PROBE_CYCLES after the
    end event between two more events.  ``lead`` is the lead-in: the
    shipped spin, a ``long`` spin of LONG_LEAD_CYCLES, or ``work``;
    ``gated`` False leaves the gate out of the lo leg (the fence before
    its repair).  Its pairs are recorded whole and never raise."""
    import torch

    from tpu_perf_torch.kernels import _build
    from tpu_perf_torch.timing import TraceGate, TraceRunner

    def event():
        return torch.cuda.Event(enable_timing=True, external=True)

    class Placed(TraceRunner):
        got: list = []

        def lead_in(self, leg):
            if lead == "long":
                torch.cuda._sleep(LONG_LEAD_CYCLES)
            elif lead == "work":
                for _ in range(WORK_LEAD):
                    self.scratch.add_(1.0)
            else:
                super().lead_in(leg)

        def warm(self, replays: int = 1) -> None:
            dev = self.x.device
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for step in self.steps.values():
                    step(self.x)
            torch.cuda.synchronize(dev)
            self.gate = TraceGate(dev)
            self.gate.open()
            with torch.cuda.stream(side):
                self.gate.wait()
            self.scratch = torch.zeros(16 << 20, device=dev)
            self.scratch.add_(1.0)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            pool = torch.cuda.graph_pool_handle()
            self.marks = {}
            plain = _build.check
            for leg, step in self.steps.items():
                marks = [("pre", event())]

                def check(name, err, _marks=marks):
                    plain(name, err)
                    _marks.append((name, event()))
                    _marks[-1][1].record()

                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    marks[0][1].record()
                    if gated or leg != "lo":
                        self.head(leg)
                    else:
                        self.lead_in(leg)
                    marks.append(("start", event()))
                    marks[-1][1].record()
                    _build.check = check
                    try:
                        step(self.x)
                    finally:
                        _build.check = plain
                    marks.append(("end", event()))
                    marks[-1][1].record()
                    torch.cuda._sleep(PROBE_CYCLES)
                    marks.append(("probe", event()))
                    marks[-1][1].record()
                starts = [e for name, e in marks if name == "start"]
                ends = [e for name, e in marks if name == "end"]
                self._graphs[leg] = (graph, (starts[0], ends[0]))
                self.marks[leg] = marks
            for _ in range(max(1, replays)):
                self._replay_pair()
            torch.cuda.synchronize(dev)

        def sample(self):
            d_lo, d_hi = self.pair()
            visit = {"t": time.time(), "lo": d_lo, "hi": d_hi}
            for leg in ("lo", "hi"):
                marks = self.marks[leg]
                gaps = [(f"{a[0]}>{b[0]}", a[1].elapsed_time(b[1]) * 1e-3)
                        for a, b in zip(marks, marks[1:])]
                # the lead-in, the probe after the end event, and the
                # largest gap between them
                visit[f"{leg}_lead"] = gaps[0][1]
                visit[f"{leg}_probe"] = gaps[-1][1]
                inner = gaps[1:-1]
                where, most = max(inner, key=lambda g: g[1])
                k = inner.index((where, most))
                visit[f"{leg}_gap"] = (f"{k}:{where}", most)
                if leg == "lo":
                    visit["lo_gaps"] = [g for _, g in inner]
            Placed.got.append(visit)
            return max(d_hi - d_lo, 1e-9) / self.d_iters

    return Placed


def _smoke_windows(root: str) -> None:
    """The smoke's profiled windows: ``run --op pl_allreduce --profile-dir``
    at 4 KiB and 256 MiB a rank, block and fused, -i 5 -r 3."""
    from tpu_perf_torch import cli

    for nbytes in (4096, 256 * 1024**2):
        for fence in ("block", "fused"):
            cli.main(["run", "--op", OP, "-b", str(nbytes), "-i", "5", "-r",
                      "3", "--fence", fence, "--profile-dir",
                      f"{root}/profile-{fence}-{nbytes}", "-l",
                      f"{root}/profile-logs"])


def _smoke_fused_daemon(root: str) -> None:
    """The smoke's fused daemon: 12000 visits over 4K and 16M, rotating
    every second into a ``local:`` ingest sink."""
    import os

    from tpu_perf_torch import cli

    os.environ["TPU_PERF_INGEST"] = f"local:{root}/sink"
    try:
        cli.main(["monitor", "--op", OP, "--sweep", "4K,16M", "--fence",
                  "fused", "--max-runs", "12000", "--log-refresh-sec", "1",
                  "--stats-every", "12000", "-l", f"{root}/fused-logs"])
    finally:
        os.environ.pop("TPU_PERF_INGEST")


def _visit_summary(got: list, d_iters: int) -> dict:
    """Counts per condition: non-positive pairs and lo legs above
    STALL_FACTOR times their median, each also per 10 000 visits, and
    where each stalled lo leg's largest gap fell."""
    los = sorted(v["lo"] for v in got)
    med = statistics.median(los)
    stalled = [v for v in got if v["lo"] > STALL_FACTOR * med]
    bad = [v for v in got if v["hi"] <= v["lo"]]
    where: dict[str, int] = {}
    for v in stalled:
        where[v["lo_gap"][0]] = where.get(v["lo_gap"][0], 0) + 1
    leads = sorted(v["lo_lead"] for v in got)
    per = 1e4 / max(1, len(got))
    return {
        "visits": len(got),
        "non_positive": len(bad),
        "non_positive_per_10k": len(bad) * per,
        "lo_stalled": len(stalled),
        "lo_stalled_per_10k": len(stalled) * per,
        "lo_ms_median": med * 1e3,
        "lo_ms_p99": los[int(0.99 * (len(los) - 1))] * 1e3,
        "lo_ms_max": los[-1] * 1e3,
        "lead_in_ms_median": statistics.median(leads) * 1e3,
        "lead_in_ms_max": leads[-1] * 1e3,
        "us_an_execution_median": statistics.median(
            (v["hi"] - v["lo"]) / d_iters for v in got) * 1e6,
        "stalled_lo_largest_gap_at": where,
        "probe_ms_median": statistics.median(v["lo_probe"] for v in got)
        * 1e3,
        "stalled_lo": [{"lo_ms": v["lo"] * 1e3, "hi_ms": v["hi"] * 1e3,
                        "gap": v["lo_gap"][0],
                        "gap_ms": v["lo_gap"][1] * 1e3,
                        "lead_ms": v["lo_lead"] * 1e3,
                        "probe_ms": v["lo_probe"] * 1e3,
                        "hi_lead_ms": v["hi_lead"] * 1e3,
                        "gaps_ms": [g * 1e3 for g in v["lo_gaps"]],
                        "t": v["t"]}
                       for v in stalled[:40]],
        "gaps_ms_median": [statistics.median(v["lo_gaps"][i] for v in got)
                           * 1e3 for i in range(len(got[0]["lo_gaps"]))],
    }


def daemon_child(condition: str, iters: int, visits: int, out: str) -> None:
    """One condition of the daemon part, in this (fresh) process: the
    compute processes on the card, what the condition runs first, then
    ``monitor --fence trace -b 4K`` for ``visits`` visits through the CLI,
    every pair recorded with its placed events."""
    from tpu_perf_torch import cli, driver

    result = {"condition": condition, "apps_at_start": _compute_apps()}
    placed = _placed_runner({"g": "long", "h": "work"}.get(condition[0],
                                                            "spin"),
                            gated=not condition.endswith("0"))
    with tempfile.TemporaryDirectory(prefix="fence_daemon-") as root:
        if condition[0] in "bcde":
            _smoke_windows(root)
        if condition[0] == "e":
            _smoke_fused_daemon(root)
        result["apps_before_daemon"] = _compute_apps()
        plain = driver.TraceRunner
        driver.TraceRunner = placed
        try:
            cli.main(["monitor", "--op", OP, "-b", "4K", "-i", str(iters),
                      "--fence", "trace", "--max-runs", str(visits),
                      "--stats-every", str(visits), "-l", f"{root}/trace"])
        finally:
            driver.TraceRunner = plain
    result.update(_visit_summary(placed.got, 3 * iters))
    with open(out, "w") as fh:
        json.dump(result, fh)


def _clock_summary(lines: list[str], stalled: list[dict]) -> dict:
    """(d)'s sampled SM clocks and throttle reasons: each value's count,
    and the sample at or before each stalled visit."""
    import datetime

    samples = []
    for ln in lines:
        parts = [p.strip() for p in ln.split(",")]
        if len(parts) != 3:
            continue
        try:
            t = datetime.datetime.strptime(
                parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
        except ValueError:
            continue
        samples.append((t, parts[1], parts[2]))
    clocks: dict[str, int] = {}
    reasons: dict[str, int] = {}
    for _, c, r in samples:
        clocks[c] = clocks.get(c, 0) + 1
        reasons[r] = reasons.get(r, 0) + 1
    at = []
    for v in stalled:
        before = [s for s in samples if s[0] <= v["t"]]
        at.append(before[-1][1:] if before else None)
    return {"samples": len(samples), "sm_clocks": clocks,
            "throttle_reasons": reasons, "at_stalled_visits": at}


def measure_daemon(iters: int, visits: int, conditions=CONDITIONS
                   ) -> tuple[dict, dict]:
    """``monitor --fence trace -b 4K`` through the CLI under each condition
    of CONDITIONS, each in a process of its own; ``TEARDOWN_CUPTI=1`` for
    (c), the clock sampler beside (d)."""
    import os
    import subprocess
    import sys

    raw, summary = {}, {}
    with tempfile.TemporaryDirectory(prefix="fence_conditions-") as root:
        for cond in conditions:
            out = f"{root}/{cond}.json"
            env = dict(os.environ)
            if cond[0] == "c":
                env["TEARDOWN_CUPTI"] = "1"
            burners = []
            if cond[0] == "f":
                burners = [subprocess.Popen(
                    [sys.executable, "-c", "while True: pass"])
                    for _ in range(os.cpu_count() or 1)]
            sampler = None
            if cond[0] == "d":
                sampler = subprocess.Popen(
                    CLOCK_QUERY, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL, text=True)
            try:
                child = subprocess.run(
                    [sys.executable, "-m", "tpu_perf_torch.tools.fence_windows",
                     "--part", "daemon-child", "--condition", cond,
                     "-i", str(iters), "--visits", str(visits),
                     "--out", out], env=env, capture_output=True, text=True)
            finally:
                for b in burners:
                    b.kill()
                    b.wait()
                lines = []
                if sampler is not None:
                    sampler.terminate()
                    lines = sampler.communicate()[0].splitlines()
            if child.returncode != 0:
                raise RuntimeError(f"condition {cond} exited "
                                   f"{child.returncode}:\n{child.stderr[-3000:]}")
            with open(out) as fh:
                got = json.load(fh)
            if sampler is not None:
                got["clocks"] = _clock_summary(lines, got["stalled_lo"])
            raw[f"daemon_{cond}"] = got
            summary[f"daemon_{cond}"] = {
                k: v for k, v in got.items() if k != "stalled_lo"}
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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them (the first
    visible card; this process need not hold a context on it)."""
    import os
    import subprocess

    ids = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={ids}"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fence_windows")
    ap.add_argument("--part", default="pairs,windows")
    ap.add_argument("--bytes", type=int, default=4096)
    ap.add_argument("-i", "--iters", type=int, default=5)
    ap.add_argument("-r", "--runs", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=300)
    ap.add_argument("--stall-ms", type=float, default=2.0)
    ap.add_argument("--windows", type=int, default=400)
    ap.add_argument("--visits", type=int, default=1000)
    ap.add_argument("--conditions", default=",".join(CONDITIONS))
    ap.add_argument("--condition", default="a",
                    help="the one condition a daemon-child part runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from tpu_perf_torch.kernels import _build

    _build.build_all()
    if args.part == "daemon-child":
        daemon_child(args.condition, args.iters, args.visits, args.out)
        return 0
    raw, result = {}, {"card": card_line(), "op": OP, "bytes": args.bytes,
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
            raw[key], result[key] = measure_daemon(
                args.iters, args.visits, args.conditions.split(","))
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
