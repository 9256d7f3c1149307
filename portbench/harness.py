"""Runs one cell of the benchmark and makes its result line.

The window drives the port's fused daemon visit: the objects and calls
``tpu_perf_torch.driver.Driver._run_daemon`` makes under ``--fence
fused``.  Each point of the cell is built by ``runner.build_point_pair``,
its example input (shared by the points of one shape, as the daemon
shares it) is filled with the benchmark's seeded values, and a
``timing.FusedRunner`` is warmed on it.  The window visits the points
round-robin, a visit being ``FusedRunner.chunk(1)``: one replay of the
point's graph of ``iters`` chained executions, fenced.  Everything is
timed here, on the host's clock; the runner's own event times are the
program's output and are printed only as a cross-check.

After the window every point's working buffer, which the timed path
produced at the timed sizes, is held to :mod:`portbench.reference`.
Then each buffer is filled with a fresh seeded input and the point's
graph replayed once more (one more visit, outside the window), and that
visit is held to the reference too: by the window's end an all-reduce's
ranks hold equal values, so a peer read from before the peers wrote
gives the same bits there, and only a visit from fresh values shows it.

On one card the collectives run in the port's sim world (n ranks as n
rows of one allocation); across cards one process a card joins the
port's multi-process world, and the parent combines what each rank sends
back.  The program (``tpu_perf_torch``) is imported only inside the
functions that drive it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing as mp
import os
import queue
import socket
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from portbench import arith, reference, spec

#: top-level module names no process of a run may hold: JAX and the JAX
#: package, compared whole (the port's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_perf")
#: modules that time the program from inside it
FORBIDDEN_EXACT = ("bench", "tpu_perf_torch.bench")
#: the key of the limit in a configuration, and the numbers compared:
#: the window's buffers, and the visit from fresh values after it
CHECK = "max_rel_gap"
CHECKS = (f"{CHECK}.window", f"{CHECK}.fresh")
#: seconds a parent waits for the ranks of a world of cards
WORLD_LIMIT_S = 330
#: whole rounds of visits timed in set-up to size the window
CALIBRATION_ROUNDS = 3


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules a run may not hold."""
    names = sys.modules if names is None else names
    return sorted(m for m in names
                  if m.split(".")[0] in FORBIDDEN or m in FORBIDDEN_EXACT)


def warm_runs(device: torch.device) -> int:
    """Runs ``FusedRunner.warm()`` puts a working buffer through: on a
    card its eager run and its first replay, on the CPU its eager run."""
    return 2 if device.type == "cuda" else 1


def derive_seed(seed: int, key: int) -> int:
    """A 64-bit seed for stream ``key`` of the run's ``seed``."""
    ss = np.random.SeedSequence([seed % 2**64, key])
    return int(ss.generate_state(1, np.uint64)[0])


def seeded_input(seed: int, key: int, shape: tuple,
                 device: torch.device) -> torch.Tensor:
    """Float32 values uniform in [1, 2), drawn on ``device`` in one call
    from the seed: the input the program and the reference both get."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, key))
    return torch.rand(shape, generator=g, device=device,
                      dtype=torch.float32).add_(1.0)


@dataclasses.dataclass
class Point:
    op: str
    nbytes: int
    iters: int
    key: int          # the seeded input it was filled from
    shape: tuple      # the whole world's input, (ranks, elems)
    runner: object


@dataclasses.dataclass(frozen=True)
class Visit:
    op: str
    nbytes: int
    iters: int
    wall_s: float


@dataclasses.dataclass(frozen=True)
class Run:
    """What the metric readers read: the window's visits (each wall the
    slowest rank's), the traced stretch's visits and device summary
    (averaged over the cards), and the set-up clocks."""

    ranks: int
    across_cards: bool
    window_s: float
    setup_s: float
    points_setup_s: float
    visits: list
    traced: list
    trace: arith.DeviceSummary | None


def build_points(cell: spec.Cell, world, dtype: str, seed: int) -> list:
    """Build, fill and warm every point of the cell, as the fused daemon
    does before its first visit."""
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.runner import build_point_pair
    from tpu_perf_torch.timing import FusedRunner
    from tpu_perf_torch.world import is_dist

    if cell.traffic["fence"] != "fused":
        raise ValueError(f"{cell.name}: the harness drives the fused fence, "
                         f"not {cell.traffic['fence']!r}")
    for op in cell.ops:
        if op in reference.PERIOD_TWO and cell.iters(op) % 2 == 0:
            raise ValueError(f"{cell.name}: {op} at {cell.iters(op)} "
                             f"executions a visit returns its input; give it "
                             f"an odd count")
    across = is_dist(world)
    inputs: dict[tuple, tuple] = {}
    points = []
    for op, nbytes, iters in cell.plan():
        opts = Options(fence="fused", iters=iters, dtype=dtype, num_runs=-1)
        built, fused = build_point_pair(opts, world, op, nbytes)
        if built.nbytes != nbytes:
            raise ValueError(f"{op} at {nbytes} B was built at "
                             f"{built.nbytes} B")
        x = built.example_input
        shape = (world.n, x.numel()) if across else tuple(x.shape)
        if (shape, x.dtype) not in inputs:
            key = len(inputs)
            full = seeded_input(seed, key, shape, x.device)
            x.copy_(full[world.rank] if across else full)
            del full
            inputs[shape, x.dtype] = (key, x)
        key, keep = inputs[shape, x.dtype]
        if keep is not x:
            built = dataclasses.replace(built, example_input=keep)
        runner = FusedRunner(fused, built)
        runner.warm()
        points.append(Point(op, nbytes, iters, key, shape, runner))
    return points


def _agree_max(world, value: float) -> float:
    """``value``'s maximum over the ranks (set-up and after the window
    only); a sim world's one process agrees with itself."""
    from tpu_perf_torch.world import is_dist

    if not is_dist(world):
        return value
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64, device=world.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


class _Trace:
    """``torch.profiler`` around the window's first rounds, bracketed as
    ``tpu_perf_torch.traceparse.profile_window`` brackets a window (the
    card idle at the start, one profiler warm-up step, a fence and a
    short settle at the end), kept under ``TMPDIR`` until it is read."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.device = device
        fd, self.path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(
            activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: p.export_chrome_trace(self.path))
        self._sync()
        self.prof.__enter__()
        self.prof.step()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        self._sync()
        time.sleep(0.01)
        self.prof.__exit__(None, None, None)

    def read(self) -> list[dict]:
        try:
            with open(self.path) as fh:
                data = json.load(fh)
        finally:
            os.remove(self.path)
        return data.get("traceEvents", []) if isinstance(data, dict) else data


def _visit(p: Point) -> tuple[float, float]:
    t0 = time.perf_counter()
    runs = p.runner.chunk(1)
    return time.perf_counter() - t0, runs[0]


def _window(points: list, rounds: int, traced_rounds: int, tracer):
    """``rounds`` rounds of visits, the first ``traced_rounds`` under the
    profiler; each visit's host wall, each point's first-run event times
    (the program's, for the cross-check) and the window's wall."""
    walls, events = [], [[] for _ in points]
    t_win = time.perf_counter()
    for r in range(rounds):
        span = (torch.profiler.record_function if r < traced_rounds
                else lambda _: contextlib.nullcontext())
        for i, p in enumerate(points):
            with span("portbench.visit"):
                wall, first = _visit(p)
            walls.append(wall)
            events[i].append(first)
        if tracer is not None and r == traced_rounds - 1:
            tracer.stop()
    return walls, events, time.perf_counter() - t_win


def _gaps(points: list, world, cell: spec.Cell, seed: int, keys: list,
          runs: int) -> list[float]:
    """Each point's widest gap from the reference: its working buffer
    having gone through ``runs`` runs of ``iters`` executions from the
    seeded input ``keys[i]``."""
    dev = world.device
    gaps = []
    for i, p in enumerate(points):
        x0 = seeded_input(seed, keys[i], p.shape, dev)
        rows = [world.rank] if cell.chips > 1 else list(range(p.shape[0]))
        gaps.append(reference.max_rel_gap(
            p.op, x0, p.runner.buffer, runs * p.iters, rows=rows,
            seed=derive_seed(seed, 1000 + keys[i])))
        del x0
    return gaps


#: the keys of the fresh inputs of the visits after the window
FRESH_KEY = 2000


def _check(points: list, world, cell: spec.Cell, seed: int,
           runs: int) -> tuple[list[float], list[float]]:
    """The widest gaps of the window's buffers (``runs`` runs each), then
    of one more visit of every point from a fresh seeded input; frees the
    program's state."""
    window = _gaps(points, world, cell, seed, [p.key for p in points], runs)
    across = cell.chips > 1
    fresh = [FRESH_KEY + i for i in range(len(points))]
    for p, key in zip(points, fresh):
        _agree_max(world, 0.0)  # every rank done with the last visit
        x = seeded_input(seed, key, p.shape, world.device)
        buf = p.runner.buffer
        buf.copy_((x[world.rank] if across else x).reshape(buf.shape))
        del x
        _visit(p)
    after = _gaps(points, world, cell, seed, fresh, 1)
    for p in points:
        p.runner.close()
        p.runner = None
    if world.device.type == "cuda":
        torch.cuda.empty_cache()
    return window, after


def rank_run(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str, dtype: str | None,
             entered: float | None = None) -> dict:
    """One rank's whole run: build, calibrate, the window, the check.
    Returns what the parent combines (plain values only); ``entered`` is
    when its process reached the harness (monotonic clock)."""
    entered = time.monotonic() if entered is None else entered
    from tpu_perf_torch.world import SimWorld, dist_world, resolve_device

    t_import = time.monotonic()
    cell = spec.load_cell(root, name)
    dtype = dtype or cell.config["dtype"]
    if cell.chips > 1:
        from tpu_perf_torch.parallel.multihost import initialize_distributed

        initialize_distributed(device=device)
        world = dist_world(resolve_device(device))
    else:
        world = SimWorld(cell.ranks, resolve_device(device))
    dev = world.device
    t = time.perf_counter()
    t_world = time.monotonic()
    points = build_points(cell, world, dtype, seed)
    points_setup_s = time.perf_counter() - t

    # calibration: whole rounds, timed; the window takes as many rounds as
    # fill --seconds at their median, the same number on every rank
    cal = []
    for _ in range(CALIBRATION_ROUNDS):
        t = time.perf_counter()
        for p in points:
            _visit(p)
        cal.append(time.perf_counter() - t)
    rounds = max(1, round(seconds / _agree_max(world, statistics.median(cal))))
    print(f"[portbench] rank {world.rank if cell.chips > 1 else 0} set-up: "
          f"world {t_world - t_import:.3f} s, points {points_setup_s:.3f} s, "
          f"calibration {sum(cal):.3f} s; {rounds} rounds of "
          f"{statistics.median(cal):.6f} s", file=sys.stderr)
    tracer = _Trace(dev) if trace else None
    traced_rounds = min(rounds, cell.traffic["trace_rounds"]) if trace else 0
    _agree_max(world, 0.0)  # every rank at the window's start
    start = time.monotonic()
    walls, events, window_s = _window(points, rounds, traced_rounds, tracer)
    record = {"rank": world.rank if cell.chips > 1 else 0,
              "walls": walls, "window_s": window_s, "start": start,
              "entered": entered, "imported": t_import,
              "points_setup_s": points_setup_s,
              "traced_rounds": traced_rounds,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0)}
    misses = sum(p.runner.missed() for p in points)
    for i, p in enumerate(points):
        print(f"[portbench] rank {record['rank']} {p.op} {p.nbytes} B x "
              f"{p.iters}: program's mean run {statistics.mean(events[i]):.9f}"
              f" s over {len(events[i])} visits", file=sys.stderr)
    if misses:
        print(f"[portbench] rank {record['rank']}: {misses} gate(s) opened on "
              f"their timeout", file=sys.stderr)
    if tracer is not None:
        trace_events = tracer.read()
        # the stretch starts at the first traced visit: the meeting of the
        # ranks before it is not the window's
        summary = arith.device_summary(
            trace_events, since=arith.first_span(trace_events, "portbench.visit"))
        record["trace"] = None if summary is None else {
            "busy_s": summary.busy_s, "window_s": summary.window_s,
            "kernels": summary.kernels,
            "gaps": arith.name_gaps(summary.gaps, trace_events)}

    # the check, once every rank is done with every peer's memory
    _agree_max(world, 0.0)
    t = time.perf_counter()
    record["gaps"] = _check(points, world, cell, seed,
                            warm_runs(dev) + len(cal) + rounds)
    record["reference_s"] = time.perf_counter() - t
    record["forbidden"] = forbidden_modules()
    return record


# --- a world of cards: one process a card ---------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, n: int, port: int, payload: dict, out) -> None:
    """One rank of a world of ``n`` processes: torchrun's variables, the
    run, its record (or its traceback) to the parent."""
    payload = dict(payload, entered=time.monotonic())
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        out.put((rank, rank_run(**payload), None))
    except Exception:
        out.put((rank, None, traceback.format_exc()))
    finally:
        from tpu_perf_torch.parallel.multihost import leave_world

        try:
            leave_world(barrier=False)
        except Exception:
            traceback.print_exc()


def launch_world(n: int, payload: dict, target=_worker) -> list[dict]:
    """Run ``target`` in ``n`` spawned processes on a free rendezvous
    port, once more on another when the port was taken before the world
    bound it; every rank's record, by rank.  A rank that fails ends the
    others."""
    ctx = mp.get_context("spawn")
    for attempt in (0, 1):
        port = _free_port()
        out = ctx.Queue()
        procs = [ctx.Process(target=target, args=(r, n, port, payload, out))
                 for r in range(n)]
        for p in procs:
            p.start()
        records, errors = {}, []
        deadline = time.monotonic() + WORLD_LIMIT_S
        try:
            while len(records) + len(errors) < n and not errors:
                try:
                    rank, rec, err = out.get(timeout=2)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"rank(s) {dead} exited without a "
                                      f"record")
                    elif time.monotonic() > deadline:
                        errors.append(f"no record within {WORLD_LIMIT_S} s")
                    continue
                if err is None:
                    records[rank] = rec
                else:
                    errors.append(f"rank {rank}:\n{err}")
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if not errors:
            return [records[r] for r in range(n)]
        text = "\n".join(errors)
        if attempt == 0 and ("EADDRINUSE" in text
                             or "address already in use" in text.lower()):
            print("[portbench] the rendezvous port was taken; once more on "
                  "another", file=sys.stderr, flush=True)
            continue
        raise RuntimeError(f"the world of {n} failed:\n{text}")
    raise AssertionError("unreachable")


# --- the result line --------------------------------------------------------


def _mean_trace(traces: list[dict]) -> arith.DeviceSummary:
    names = {k for t in traces for k in t["kernels"]}
    return arith.DeviceSummary(
        busy_s=statistics.mean(t["busy_s"] for t in traces),
        window_s=statistics.mean(t["window_s"] for t in traces),
        kernels={k: statistics.mean(t["kernels"].get(k, 0.0) for t in traces)
                 for k in names},
        gaps=[])


def combine(cell: spec.Cell, records: list[dict], t0: float,
            trace: bool) -> dict:
    """The result line from every rank's record: each visit's wall its
    maximum over the ranks, the window the slowest rank's, set-up from
    the process's start to the latest rank's window start."""
    plan = cell.plan()
    walls = [max(w) for w in zip(*(r["walls"] for r in records))]
    visits = [Visit(*plan[i % len(plan)], w) for i, w in enumerate(walls)]
    traced_n = records[0]["traced_rounds"] * len(plan)
    traces = [r["trace"] for r in records if r.get("trace")]
    summary = _mean_trace(traces) if len(traces) == len(records) else None
    run = Run(ranks=cell.ranks, across_cards=cell.chips > 1,
              window_s=max(r["window_s"] for r in records),
              setup_s=max(r["start"] for r in records) - t0,
              points_setup_s=max(r["points_setup_s"] for r in records),
              visits=visits, traced=visits[:traced_n], trace=summary)
    limit = cell.config["check"][CHECK]
    # each point's widest gap over the ranks, in the window and after it
    window, fresh = ([max(g) for g in zip(*(r["gaps"][k] for r in records))]
                     for k in (0, 1))
    gaps = [max(a, b) for a, b in zip(window, fresh)]
    failed = sum(gaps[i % len(plan)] > limit for i in range(len(visits)))
    for i, (op, nbytes, iters) in enumerate(plan):
        us = [v.wall_s / iters * 1e6 for v in visits[i::len(plan)]]
        print(f"[portbench] {op} {nbytes} B: visit wall an execution p50 "
              f"{arith.percentile(us, 50):.4f} p95 {arith.percentile(us, 95):.4f}"
              f" us; widest gap {window[i]!r} in the window, {fresh[i]!r} "
              f"from fresh values (limit {limit!r})", file=sys.stderr)
    # busbw over each quarter of the window's rounds, by the visits' walls:
    # how the rate spreads over shorter windows
    rounds = len(visits) // len(plan)
    quarters = [visits[len(plan) * (rounds * q // 4):
                       len(plan) * (rounds * (q + 1) // 4)] for q in range(4)]
    print("[portbench] busbw by quarter of the window: " + " ".join(
        f"{arith.window_busbw(v, run.ranks, sum(x.wall_s for x in v))!r}"
        for v in quarters if v), file=sys.stderr)
    print(f"[portbench] set-up: {max(r['entered'] for r in records) - t0:.3f}"
          f" s to the harness, {max(r['imported'] for r in records) - t0:.3f}"
          f" s to the port imported", file=sys.stderr)
    print(f"[portbench] reference took {max(r['reference_s'] for r in records):.3f}"
          f" s; {len(visits)} visits in {run.window_s:.3f} s", file=sys.stderr)
    device = {"platform": "gpu" if records[0]["kind"] != "cpu" else "cpu",
              "kind": records[0]["kind"], "count": cell.chips,
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in records)}
    line = {"correct": max(gaps) <= limit, "attempted": len(visits),
            "failed": failed,
            "metrics": spec.read_metrics(
                cell, run, "layer_metrics" if trace else "end_to_end"),
            "device": device}
    if trace and summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                             "idle_gaps": traces[0]["gaps"]}
    line["checks"] = {name: {"value": max(g), "limit": limit}
                      for name, g in zip(CHECKS, (window, fresh))}
    return line


def run(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", dtype: str | None = None,
        target=_worker) -> dict:
    """One run of ``cell``; returns its result line.  Raises when a
    process of the run holds a forbidden module once the window closed."""
    payload = dict(root=str(cell.root), name=cell.name, seed=seed,
                   seconds=seconds, trace=trace, device=device, dtype=dtype)
    if cell.chips > 1:
        records = launch_world(cell.chips, payload, target=target)
    else:
        records = [rank_run(**payload)]
    bad = sorted({m for r in records for m in r["forbidden"]}
                 | set(forbidden_modules()))
    if bad:
        raise RuntimeError(f"forbidden modules loaded: {bad}")
    line = combine(cell, records, t0, trace)
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr, flush=True)
    return line
