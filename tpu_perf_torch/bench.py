"""Headline benchmark on one card (port of ``tpu_perf/bench.py``'s
one-device set).  Prints ONE JSON line::

    {"metric": ..., "value": N, "unit": ..., "vs_peak": N, "runs_valid": N,
     "runs_dropped": N, "card": {...}, "metrics": [{...}, ...],
     "phases": {...}, "adaptive": {...}, "dispatch_overhead": {...},
     "contention": {...}}

The top-level fields are the first instrument's; ``metrics`` carries every
instrument, labelled as the JAX package labels them:

* ``hbm_stream`` and ``hbm_triad`` bus bandwidth, the better p50 of the
  384 MiB x 16 and 256 MiB x 25 plateau points (``{op}_busbw_p50@{s}MiB[1dev]``);
* ``mxu_gemm`` TFLOP/s at m = 4096 in bfloat16, from the FLOP model
  (``metrics.flops_per_iter_dtype``);

then the port's own entries: the ``pl_hbm_stream`` Triton kernel and the
plain ``hbm_stream`` at 256 MiB, and the sim-world ring all-reduce
``pl_allreduce`` at 4 MiB per rank x 8 ranks (a number about the card's
memory system under the ring schedule, not about any link).

``vs_peak`` divides each instrument by the detected card's published peak
(:func:`tpu_perf_torch.chips.card_peak`: device-memory GB/s, or the bf16
product rate); on the CPU it is null, and an unknown card raises.  The
port defends no plateau floor yet, so each instrument takes one pass.
The fence is ``trace`` on the card and ``slope`` on the CPU; a failed
device-time capture raises, it never falls back.

``phases`` is the benchmark's own compile / measure / log split and wall
(:class:`tpu_perf_torch.compilepipe.PhaseTimer`).  Each instrument's run
budget is a cap: a point stops once the CI of its running mean is within
2% at 95% confidence (:mod:`tpu_perf_torch.adaptive`), and ``adaptive``
sums what that saved.  The trace fence keeps its fixed budget (its legs
are captured once for it), so on the card only the fences that stop
early add to ``adaptive``, which is left out when nothing did.

``dispatch_overhead`` prices the host's turn-taking at 8, 512 and 4096 B
of ``hbm_stream``: one fenced dispatch a run (``host_us``), the runs on 4
lanes of the stream engine in waves (``overlapped_us``) and one replay of
a CUDA graph of every run (``fused_us``).  ``contention`` is one cell of
the interference matrix: ``allreduce`` at 256 KiB idle against raced
under an ``hbm_stream`` load, through ``contend``'s own runner, on one
rank.  Every number is labelled with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import time

from tpu_perf_torch.chips import CardSpec, card_peak, card_spec
from tpu_perf_torch.config import Options
from tpu_perf_torch.metrics import flops_per_iter_dtype, percentile
from tpu_perf_torch.runner import run_point
from tpu_perf_torch.timing import DegenerateSlopeError
from tpu_perf_torch.world import SimWorld, resolve_device

_MIB = 1024 * 1024
#: the memory plateaus: (MiB, iters) points, runs each
STREAM_POINTS, STREAM_RUNS = ((384, 16), (256, 25)), 12
#: the compute point: m, iters, runs (bfloat16)
MXU_M, MXU_ITERS, MXU_RUNS = 4096, 100, 10
#: dispatch_overhead: hbm_stream sizes, runs a size, lanes in flight
DISPATCH_SIZES, DISPATCH_RUNS, DISPATCH_LANES = (8, 512, 4096), 16, 4
#: contention: the victim's bytes, runs a side, iters a run
CONTEND_NBYTES, CONTEND_RUNS, CONTEND_ITERS = 262144, 12, 4
#: the port's own entries: the stream kernel (bytes, iters, runs) on one
#: rank, and the ring all-reduce (sim ranks, bytes per rank, iters, runs)
STREAM_POINT = (256 * _MIB, 20, 5)
ALLREDUCE_POINT = (8, 4 * _MIB, 20, 5)
#: the early stop's target and its first vote (the JAX package's): a
#: published number's interval within 2%
ADAPTIVE_CI, ADAPTIVE_MIN_RUNS = 0.02, 5


def _adaptive(runs: int):
    """The early-stop policy for a budget of ``runs``, or None when the
    budget is not above the first vote."""
    if runs <= ADAPTIVE_MIN_RUNS:
        return None
    from tpu_perf_torch.adaptive import AdaptiveConfig

    return AdaptiveConfig(ci_rel=ADAPTIVE_CI, min_runs=ADAPTIVE_MIN_RUNS,
                          max_runs=runs)


def card_label(device) -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": "not measured"}
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, _, limit = out.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def card_entry(device) -> CardSpec | None:
    """The detected card's entry of the spec table, whose peaks every
    ratio divides by; None on the CPU.  An unknown card raises."""
    if device.type != "cuda":
        return None
    import torch

    return card_spec(torch.cuda.get_device_name(device))


def instrument(metric: str, value: float, unit: str, spec: CardSpec | None,
               family: str, dtype: str, fence: str, valid: int,
               dropped: int) -> dict:
    """One instrument's entry; ``vs_peak`` is ``value`` over ``spec``'s
    peak for ``family`` and ``dtype`` (null without a card)."""
    return {
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_peak": (None if spec is None
                    else value / card_peak(spec, family, dtype)),
        "fence": fence,
        "runs_valid": valid,
        "runs_dropped": dropped,
    }


def _fence(world: SimWorld) -> str:
    return "trace" if world.device.type == "cuda" else "slope"


def _run(opts: Options, world: SimWorld, nbytes: int, phases,
         adaptive_log: list) -> object:
    """run_point with the job's phase timer and the early stop, its
    verdict kept in ``adaptive_log``."""
    point = run_point(opts, world, nbytes, phases=phases,
                      adaptive=_adaptive(opts.num_runs))
    if point.adaptive is not None:
        adaptive_log.append(point.adaptive)
    return point


def _best_of_points(world: SimWorld, points, phases,
                    adaptive_log: list) -> tuple:
    """Measure every (label, op, nbytes, iters, dtype, runs, to_value)
    point once; returns the best p50 as (value, label, fence, valid,
    dropped).  A point whose slope samples were all lost is skipped; no
    point left raises."""
    fence = _fence(world)
    candidates = []
    for label, op, nbytes, iters, dtype, runs, to_value in points:
        opts = Options(op=op, iters=iters, num_runs=runs, warmup_runs=2,
                       fence=fence, dtype=dtype, sim_ranks=world.n,
                       device=world.device.type)
        try:
            point = _run(opts, world, nbytes, phases, adaptive_log)
        except DegenerateSlopeError:
            continue
        rows = point.rows(opts.uuid, backend=world.backend)
        p50 = percentile([to_value(r) for r in rows], 50)
        taken = (point.adaptive["attempted"] if point.adaptive is not None
                 else runs)
        candidates.append((p50, label, fence, len(rows), taken - len(rows)))
    if not candidates:
        raise RuntimeError("bench: every measurement lost all its slope "
                           "samples to timing noise")
    return max(candidates, key=lambda c: c[0])


def _p50_busbw(op: str, world: SimWorld, nbytes: int, iters: int,
               runs: int, phases, adaptive_log: list) -> dict:
    fence = _fence(world)
    opts = Options(op=op, iters=iters, num_runs=runs, warmup_runs=2,
                   fence=fence, sim_ranks=world.n,
                   device=world.device.type)
    point = _run(opts, world, nbytes, phases, adaptive_log)
    rows = point.rows(opts.uuid, backend=world.backend)
    busbw = sorted(r.busbw_gbps for r in rows)[len(rows) // 2]
    return {"op": op, "backend": world.backend, "n_devices": world.n,
            "nbytes": point.nbytes, "iters": iters, "runs": runs,
            "fence": fence, "busbw_gbps_p50": busbw}


def dispatch_overhead(world: SimWorld, sizes=DISPATCH_SIZES,
                      runs=DISPATCH_RUNS, lanes=DISPATCH_LANES) -> dict:
    """Per-run wall of one ``hbm_stream`` execution three ways: the host
    loop (one block-fenced dispatch a run), the stream engine (``lanes``
    runs in flight a wave, fenced in dispatch order) and the fused loop
    (every run in one CUDA graph replay, its host wall over the runs; the
    CPU runs the chunk eagerly).  All three ride the host clock."""
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.runner import build_fused_point
    from tpu_perf_torch.streams.engine import StreamEngine
    from tpu_perf_torch.streams.plans import wave_plan
    from tpu_perf_torch.timing import FusedRunner, time_step

    points = []
    for nbytes in sizes:
        built = build_op("hbm_stream", world, nbytes, 1)
        x = built.example_input
        host = time_step(built.step, x, runs, warmup_runs=2)
        host_per = percentile(host.samples, 50)
        # the body is functional, so the lanes can share the input
        engine = StreamEngine(lanes)
        for lane in range(lanes):
            engine.dispatch(lane, built.step, x)
        engine.fence_all()  # every lane's stream made and warmed once
        t0 = time.perf_counter()
        for wave in wave_plan(range(runs), lanes):
            for lane, _ in wave:
                engine.dispatch(lane, built.step, x)
            engine.fence_all()
        over_per = (time.perf_counter() - t0) / runs
        runner = FusedRunner(build_fused_point(built, (runs,)), built)
        try:
            runner.warm()
            fused_per = runner.wall(runs) / runs
        finally:
            runner.close()
        points.append({
            "nbytes": nbytes,
            "host_us": host_per * 1e6,
            "overlapped_us": over_per * 1e6,
            "fused_us": fused_per * 1e6,
            "speedup": host_per / fused_per,
            "overlap_speedup": host_per / over_per,
        })
    return {
        "lanes": lanes,
        "points": points,
        "speedup_p50": percentile([p["speedup"] for p in points], 50),
        "overlap_speedup_p50": percentile(
            [p["overlap_speedup"] for p in points], 50),
    }


def contention(world: SimWorld, nbytes=CONTEND_NBYTES, runs=CONTEND_RUNS,
               iters=CONTEND_ITERS) -> dict:
    """One cell of the interference matrix: ``allreduce`` idle against
    raced under an ``hbm_stream`` load, through ``contend``'s runner."""
    from tpu_perf_torch.report import aggregate, interference_matrix
    from tpu_perf_torch.streams.contend import run_contend

    opts = Options(op="allreduce", buff_sz=nbytes, iters=iters,
                   num_runs=runs, load="hbm_stream", sim_ranks=world.n,
                   device=world.device.type)
    [cell] = interference_matrix(aggregate(run_contend(opts, world=world)))
    return {
        "op": "allreduce",
        "load": "hbm_stream",
        "n_devices": world.n,
        "nbytes": nbytes,
        "idle_lat_us": cell.idle.lat_us["p50"],
        "loaded_lat_us": cell.loaded.lat_us["p50"],
        "slowdown": cell.slowdown,
    }


def main(device: str | None = None) -> dict:
    from tpu_perf_torch.compilepipe import PhaseTimer

    # the benchmark's own compile / measure / log split
    phases = PhaseTimer()
    phases.start()
    adaptive_log: list[dict] = []
    dev = resolve_device(device)
    card = card_label(dev)
    spec = card_entry(dev)
    one = SimWorld(1, dev)
    instruments = []
    for op in ("hbm_stream", "hbm_triad"):
        v, label, fence, valid, dropped = _best_of_points(one, [
            (f"{op}_busbw_p50@{s}MiB[1dev]", op, s * _MIB, i, "float32",
             STREAM_RUNS, lambda r: r.busbw_gbps)
            for s, i in STREAM_POINTS], phases, adaptive_log)
        instruments.append(instrument(label, v, "GB/s", spec, "hbm",
                                      "float32", fence, valid, dropped))
    mxu_bytes = MXU_M * MXU_M * 2
    flops = flops_per_iter_dtype("mxu_gemm", mxu_bytes, "bfloat16")
    v, label, fence, valid, dropped = _best_of_points(one, [
        (f"mxu_gemm_tflops_p50@m{MXU_M}bf16[1dev]", "mxu_gemm", mxu_bytes,
         MXU_ITERS, "bfloat16", MXU_RUNS,
         lambda r: flops / (r.lat_us * 1e-6) / 1e12)], phases,
        adaptive_log)
    instruments.append(instrument(label, v, "TFLOP/s", spec, "mxu",
                                  "bfloat16", fence, valid, dropped))
    nbytes, iters, runs = STREAM_POINT
    own = [_p50_busbw(op, one, nbytes, iters, runs, phases, adaptive_log)
           for op in ("pl_hbm_stream", "hbm_stream")]
    n, nbytes, iters, runs = ALLREDUCE_POINT
    own.append(_p50_busbw("pl_allreduce", SimWorld(n, dev), nbytes, iters,
                          runs, phases, adaptive_log))
    metrics = instruments + own
    for m in metrics:
        m["card"] = card
    payload = dict(instruments[0])
    payload.pop("fence")
    payload["card"] = card
    payload["metrics"] = metrics
    payload["dispatch_overhead"] = dispatch_overhead(one)
    payload["contention"] = contention(one)
    phases.stop()
    payload["phases"] = {**phases.snapshot(),
                         "wall_s": round(phases.wall_s, 3)}
    if adaptive_log:
        # what the early stop handed back across every measurement;
        # runs_attempted is budget consumed, dropped runs included
        payload["adaptive"] = {
            "ci_rel": ADAPTIVE_CI,
            "points": len(adaptive_log),
            "runs_requested": sum(a["requested"] for a in adaptive_log),
            "runs_attempted": sum(a["attempted"] for a in adaptive_log),
            "runs_saved": sum(a["saved"] for a in adaptive_log),
        }
    print(json.dumps(payload))
    return payload
