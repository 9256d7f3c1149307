"""Headline benchmark (port of ``tpu_perf/bench.py``).  Prints ONE JSON
line::

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "vs_peak": N,
     "runs_valid": N, "runs_dropped": N, "card": ..., "metrics": [...],
     "phases": {...}, "adaptive": {...}, "dispatch_overhead": {...},
     "contention": {...}, "push_overhead": {...}, "hier_vs_flat": {...},
     "scenario_step": {...}, "auto_vs_native": {...},
     "vopt_vs_ring": {...}}

The top-level fields are the first instrument's; ``metrics`` carries every
instrument, labelled as the JAX package labels them.  As JAX's, the set
adapts to the world it runs in:

* **one card** (a process alone, or a world of one):

  - ``hbm_stream`` and ``hbm_triad`` bus bandwidth, the better p50 of the
    384 MiB x 16 and 256 MiB x 25 plateau points
    (``{op}_busbw_p50@{s}MiB[1dev]``);
  - ``mxu_gemm`` TFLOP/s at m = 4096 in bfloat16, from the FLOP model
    (``metrics.flops_per_iter_dtype``);

  then the port's own entries: the ``pl_hbm_stream`` Triton kernel and the
  plain ``hbm_stream`` at 256 MiB, and the sim-world ring all-reduce
  ``pl_allreduce`` at 4 MiB per rank x 8 ranks (a number about the card's
  memory system under the ring schedule, not about any link).  The arena
  instruments run in the sim world of 8 ranks.

* **n >= 2 cards**: under torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) bench joins the world
  (NCCL on the cards, gloo with ``--device cpu``) and leads with the
  north-star metric, ``allreduce_busbw_p50@4MiB[{n}dev]``: NCCL's
  ``all_reduce`` at 4 MiB a rank, ``iters`` 25, 8 runs, each run's time
  its maximum over the ranks; then the port's own ``pl_allreduce`` across
  the ranks at 4 MiB a rank (the peer kernels on the cards).  The arena
  instruments run over the world's ranks.  Rank 0 alone prints the line,
  and ``card`` lists every rank's card.

Degraded windows (JAX's rule): each one-card instrument measures all its
points once a pass and takes another whole pass, up to ``PASSES``, while
its best p50 is under the card's plateau floor
(:class:`tpu_perf_torch.chips.CardSpec`; the stream floor is shared by
``hbm_stream`` and ``hbm_triad``).  ``vs_baseline`` divides the value by
the card's nominal, and an instrument still under its floor when the
passes run out says so with ``below_plateau_floor: true``.  ``passes`` is
how many it took.  The n >= 2 headline has a nominal and no floor, so it
takes one pass, as JAX's does.  ``vs_peak`` divides each instrument by the
card's published peak (:func:`tpu_perf_torch.chips.card_peak`:
device-memory GB/s, the bf16 product rate, or one direction of NVLink).
On the CPU there is no card: both ratios are null and one pass is taken.
An unknown card raises.  The fence is ``trace`` on the card and ``slope``
on the CPU; a failed device-time capture raises, it never falls back.

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
rank.  Both run on each rank's own card.  The JAX package's arena
instruments follow, with its keys: ``hier_vs_flat`` (the ``hier``
allreduce on a 2 x n/2 mesh against the native one; across cards only for
n >= 4 and even), ``scenario_step`` (the tp-allreduce-burst step against
four single allreduces), ``auto_vs_native`` (every buildable allreduce
decomposition raced against the native call at 4 KiB and 256 KiB, folded
through the tuner's own ``build_selection`` and resolved back through
``LoadedSelection`` as ``--algo auto`` resolves them: the native /
selected p50 speedup), ``vopt_vs_ring`` (the doubling allgatherv against
the ring at ratios 2 and 8).  They time host walls under the block fence
(``arena_fence``), as the JAX package's instruments time theirs with
``time_step``, each run's wall its maximum over the ranks.
``push_overhead`` is the push plane's tee on the record path (host
only).  Every number is labelled with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

from tpu_perf_torch.chips import CardSpec, card_peak, card_spec
from tpu_perf_torch.config import Options
from tpu_perf_torch.metrics import flops_per_iter_dtype, percentile
from tpu_perf_torch.runner import run_point
from tpu_perf_torch.sweep import LEGACY_BW_BUF_SZ
from tpu_perf_torch.timing import DegenerateSlopeError
from tpu_perf_torch.world import SimWorld, is_dist, resolve_device

_MIB = 1024 * 1024
#: the memory plateaus: (MiB, iters) points, runs each
STREAM_POINTS, STREAM_RUNS = ((384, 16), (256, 25)), 12
#: the compute point: m, iters, runs (bfloat16)
MXU_M, MXU_ITERS, MXU_RUNS = 4096, 100, 10
#: whole passes an instrument takes at most while under its floor
PASSES = 3
#: the n >= 2 headline: bytes a rank, iters, runs (JAX's)
HEADLINE_BYTES, HEADLINE_ITERS, HEADLINE_RUNS = LEGACY_BW_BUF_SZ, 25, 8
#: dispatch_overhead: hbm_stream sizes, runs a size, lanes in flight
DISPATCH_SIZES, DISPATCH_RUNS, DISPATCH_LANES = (8, 512, 4096), 16, 4
#: contention: the victim's bytes, runs a side, iters a run
CONTEND_NBYTES, CONTEND_RUNS, CONTEND_ITERS = 262144, 12, 4
#: the port's own entries: the stream kernel (bytes, iters, runs) on one
#: rank, and the ring all-reduce (sim ranks, bytes per rank, iters, runs;
#: across cards the world's ranks)
STREAM_POINT = (256 * _MIB, 20, 5)
ALLREDUCE_POINT = (8, 4 * _MIB, 20, 5)
#: the early stop's target and its first vote (the JAX package's): a
#: published number's interval within 2%
ADAPTIVE_CI, ADAPTIVE_MIN_RUNS = 0.02, 5
#: torchrun's variables: all four present, bench joins the world
_WORLD_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


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
               dropped: int, *, nominal: float | None = None,
               floor: float | None = None, passes: int = 1) -> dict:
    """One instrument's entry: ``vs_baseline`` is ``value`` over
    ``nominal`` and ``vs_peak`` over ``spec``'s peak for ``family`` and
    ``dtype`` (each null without one); ``below_plateau_floor`` marks a
    value still under ``floor`` after its ``passes``."""
    d = {
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": None if nominal is None else value / nominal,
        "vs_peak": (None if spec is None
                    else value / card_peak(spec, family, dtype)),
        "fence": fence,
        "runs_valid": valid,
        "runs_dropped": dropped,
        "passes": passes,
    }
    if floor is not None and value < floor:
        # the passes ran out under the plateau floor: a degraded window,
        # not the card's capability
        d["below_plateau_floor"] = True
    return d


def _fence(world) -> str:
    return "trace" if world.device.type == "cuda" else "slope"


def _run(opts: Options, world, nbytes: int, phases,
         adaptive_log: list) -> object:
    """run_point with the job's phase timer and the early stop, its
    verdict kept in ``adaptive_log``."""
    point = run_point(opts, world, nbytes, phases=phases,
                      adaptive=_adaptive(opts.num_runs))
    if point.adaptive is not None:
        adaptive_log.append(point.adaptive)
    return point


def _measure(world, op: str, nbytes: int, iters: int, dtype: str,
             runs: int, phases, adaptive_log: list) -> tuple:
    """One point's rows, its fence and the runs it dropped."""
    fence = _fence(world)
    opts = Options(op=op, iters=iters, num_runs=runs, warmup_runs=2,
                   fence=fence, dtype=dtype, sim_ranks=world.n,
                   device=world.device.type)
    point = _run(opts, world, nbytes, phases, adaptive_log)
    rows = point.rows(opts.uuid, backend=world.backend)
    taken = (point.adaptive["attempted"] if point.adaptive is not None
             else runs)
    return rows, fence, taken - len(rows)


def _best_of_passes(world: SimWorld, points, floor: float | None, phases,
                    adaptive_log: list, passes: int = PASSES) -> tuple:
    """Measure every (label, op, nbytes, iters, dtype, runs, to_value)
    point a pass, taking whole passes again while the best p50 is under
    ``floor`` (JAX's degraded-window rule; no floor: one pass).  Returns
    ((value, label, fence, valid, dropped), passes taken): the best p50
    over every pass.  A point whose slope samples were all lost is
    skipped; no candidate left raises."""
    candidates = []
    taken = 0
    for taken in range(1, passes + 1):
        for label, op, nbytes, iters, dtype, runs, to_value in points:
            try:
                rows, fence, dropped = _measure(world, op, nbytes, iters,
                                                dtype, runs, phases,
                                                adaptive_log)
            except DegenerateSlopeError:
                # the worst degraded window: candidates of other passes
                # must survive it
                continue
            p50 = percentile([to_value(r) for r in rows], 50)
            candidates.append((p50, label, fence, len(rows), dropped))
        if floor is None or (candidates
                             and max(c[0] for c in candidates) >= floor):
            break
    if not candidates:
        raise RuntimeError("bench: every measurement pass lost all its "
                           "slope samples to timing noise")
    return max(candidates, key=lambda c: c[0]), taken


def _p50_busbw(op: str, world, nbytes: int, iters: int,
               runs: int, phases, adaptive_log: list) -> dict:
    rows, fence, _ = _measure(world, op, nbytes, iters, "float32", runs,
                              phases, adaptive_log)
    busbw = sorted(r.busbw_gbps for r in rows)[len(rows) // 2]
    return {"op": op, "backend": world.backend, "n_devices": world.n,
            "nbytes": rows[0].nbytes, "iters": iters, "runs": runs,
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


#: the arena instruments' sim world, sizes, runs and iterations (the JAX
#: package's sizes and budgets)
ARENA_RANKS = 8
HIER_SIZES, HIER_RUNS, HIER_ITERS = (4096, 262144), 8, 4
SCENARIO_SIZES, SCENARIO_RUNS, SCENARIO_ITERS = (4096, 65536), 8, 2
TUNE_SIZES, TUNE_RUNS, TUNE_ITERS = (4096, 262144), 8, 4
VOPT_SIZES, VOPT_RATIOS, VOPT_RUNS, VOPT_ITERS = (4096, 262144), (2, 8), 8, 4
#: push_overhead: rows written a side
PUSH_ROWS = 20000


#: the fence the arena instruments time under: host walls, as the JAX
#: package's instruments time theirs (``time_step``)
ARENA_FENCE = "block"


def _walls(samples: list[float], world) -> list[float]:
    """A point's run walls, each its maximum over the ranks of a
    multi-process world (the rows' convention)."""
    return world.max_over_ranks(samples) if is_dist(world) else samples


def _p50_wall(built, runs: int, world=None) -> float:
    from tpu_perf_torch.timing import time_step

    return percentile(_walls(time_step(built.step, built.example_input, runs,
                                       warmup_runs=2).samples, world), 50)


def _arena_world(device, n: int, world=None, mesh=None):
    """The arena instruments' world: ``world``'s ranks (a multi-process
    world, laid over ``mesh`` when given), else n sim ranks."""
    if world is None:
        return SimWorld(n, device, mesh)
    if mesh is None:
        return world
    from tpu_perf_torch.world import dist_world

    return dist_world(world.device, mesh)


def hier_vs_flat(device, sizes=HIER_SIZES, runs=HIER_RUNS,
                 iters=HIER_ITERS, n: int = ARENA_RANKS,
                 world=None) -> dict | None:
    """The hierarchical allreduce (reduce_scatter over ici, allreduce over
    dcn, all_gather over ici; :mod:`tpu_perf_torch.arena.hierarchy`)
    against the native one on a 2 x (n/2) mesh of the sim ranks, or of
    ``world``'s ranks: per-size p50 walls, flat / hier (> 1: the
    composition wins) and the modeled slow-axis traffic reduction.  None
    where the split cannot cover the ranks (fewer than 4, or odd)."""
    from tpu_perf_torch.arena.hierarchy import dcn_bound_bytes, flat_dcn_bytes
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.parallel import make_mesh

    n = world.n if world is not None else n
    if n < 4 or n % 2:
        return None
    world = _arena_world(device, n, world,
                         make_mesh((2, n // 2), ("dcn", "ici"), n=n))
    pairs = (("dcn", 2), ("ici", n // 2))
    points = []
    for nbytes in sizes:
        flat = build_op("allreduce", world, nbytes, iters)
        hier = build_op("allreduce", world, nbytes, iters, algo="hier")
        flat_t = _p50_wall(flat, runs, world)
        hier_t = _p50_wall(hier, runs, world)
        points.append({
            "nbytes": nbytes,
            "flat_us": flat_t * 1e6,
            "hier_us": hier_t * 1e6,
            "speedup": flat_t / hier_t if hier_t > 0 else 0.0,
            "dcn_reduction": (flat_dcn_bytes("allreduce", nbytes, n)
                              / dcn_bound_bytes("allreduce", nbytes, pairs)),
        })
    return {"mesh": f"2x({n // 2})", "algo": hier.algo, "points": points,
            "speedup_p50": percentile([p["speedup"] for p in points], 50)}


def scenario_step(device, sizes=SCENARIO_SIZES, runs=SCENARIO_RUNS,
                  iters=SCENARIO_ITERS, n: int = ARENA_RANKS,
                  world=None) -> dict:
    """The composition's cost: the tp-allreduce-burst step (four chained
    allreduces in one step) against four times the single allreduce's
    step at the same size; ``overhead`` burst / (L x isolated)."""
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.scenarios.compose import build_scenario_op
    from tpu_perf_torch.scenarios.spec import BUILTIN_SCENARIOS

    world = _arena_world(device, n, world)
    spec = BUILTIN_SCENARIOS["tp-allreduce-burst"]
    layers = spec.phases[0].repeat
    points = []
    for nbytes in sizes:
        burst_t = _p50_wall(build_scenario_op(spec, world, nbytes, iters),
                            runs, world)
        single_t = _p50_wall(build_op("allreduce", world, nbytes, iters),
                             runs, world)
        points.append({
            "nbytes": nbytes,
            "burst_us": burst_t * 1e6,
            "isolated_sum_us": single_t * layers * 1e6,
            "overhead": (burst_t / (single_t * layers)
                         if single_t > 0 else 0.0),
        })
    return {"scenario": spec.name, "layers": layers, "points": points,
            "overhead_p50": percentile([p["overhead"] for p in points], 50)}


def auto_vs_native(device, sizes=TUNE_SIZES, runs=TUNE_RUNS,
                   iters=TUNE_ITERS, n: int = ARENA_RANKS,
                   world=None) -> dict | None:
    """The measure->select loop priced end to end: every buildable
    allreduce decomposition raced against the native call at each size,
    the rows folded through the tuner's own ``build_selection`` (the
    verdict path `tune` runs), each size resolved back through
    ``LoadedSelection`` as ``--algo auto`` resolves it at plan time, and
    the native / selected p50 speedup (>= 1: auto never picks a slower
    measured algorithm).  ``margin`` records how decisive the crossover
    was.  None in a world of one (no collective to race)."""
    import io

    from tpu_perf_torch.arena.algorithms import algos_for_op
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.report import aggregate
    from tpu_perf_torch.schema import ResultRow, timestamp_now
    from tpu_perf_torch.timing import time_step
    from tpu_perf_torch.tuner import LoadedSelection, build_selection

    n = world.n if world is not None else n
    if n < 2:
        return None
    world = _arena_world(device, n, world)
    rows, p50s = [], {}
    for nbytes in sizes:
        for algo in ["native"] + algos_for_op("allreduce", n):
            try:
                built = build_op("allreduce", world, nbytes, iters,
                                 algo=algo)
            except (ValueError, RuntimeError):
                continue
            lats_us = [t / iters * 1e6 for t in _walls(time_step(
                built.step, built.example_input, runs,
                warmup_runs=2).samples, world)]
            p50s[(nbytes, algo)] = percentile(lats_us, 50)
            rows += [ResultRow(
                timestamp=timestamp_now(), job_id="bench-tune",
                backend=world.backend, op="allreduce", nbytes=nbytes,
                iters=iters, run_id=i + 1, n_devices=n, lat_us=lat,
                algbw_gbps=0.0, busbw_gbps=0.0, time_ms=lat * iters / 1e3,
                mode="oneshot", algo="" if algo == "native" else algo)
                for i, lat in enumerate(lats_us)]
    art = build_selection(
        aggregate(rows),
        generated=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        generated_unix=time.time(), source="bench")
    if not art.entries:
        return None
    sel = LoadedSelection(art, err=io.StringIO())
    by_key = {(e.op, e.nbytes): e for e in art.entries}
    points = []
    for nbytes in sizes:
        if (nbytes, "native") not in p50s:
            continue
        pick = sel.resolve("allreduce", nbytes, "float32", n_devices=n,
                           err=io.StringIO())
        entry = by_key.get(("allreduce", nbytes))
        native = p50s[(nbytes, "native")]
        chosen = p50s.get((nbytes, pick), native)
        points.append({
            "nbytes": nbytes,
            "selected": pick,
            "native_us": native,
            "selected_us": chosen,
            "speedup": native / chosen if chosen > 0 else 0.0,
            "margin": entry.margin if entry is not None else 0.0,
            "algos_raced": len([a for (nb, a) in p50s if nb == nbytes]),
        })
    if not points:
        return None
    return {"op": "allreduce", "n_devices": n, "points": points,
            "speedup_p50": percentile([p["speedup"] for p in points], 50)}


def vopt_vs_ring(device, sizes=VOPT_SIZES, ratios=VOPT_RATIOS,
                 runs=VOPT_RUNS, iters=VOPT_ITERS,
                 n: int = ARENA_RANKS, world=None) -> dict:
    """The doubling allgatherv (:mod:`tpu_perf_torch.arena.valgos`)
    against the per-origin ring at the hot-rank ratios: per-(size, ratio)
    p50 walls, ring / doubling (> 1: doubling wins), the modeled wire
    delta and the rounds each takes."""
    import math

    from tpu_perf_torch.arena.valgos import allgatherv_wire_elems
    from tpu_perf_torch.ops.collectives import build_op
    from tpu_perf_torch.scenarios.vops import v_counts

    world = _arena_world(device, n, world)
    n = world.n
    points = []
    for nbytes in sizes:
        for ratio in ratios:
            ring_t = _p50_wall(build_op("allgatherv", world, nbytes, iters,
                                        imbalance=ratio), runs, world)
            opt_t = _p50_wall(build_op("allgatherv", world, nbytes, iters,
                                       imbalance=ratio, algo="doubling"),
                              runs, world)
            counts = v_counts("allgatherv", nbytes, n, 4, ratio)[0]
            points.append({
                "nbytes": nbytes,
                "imbalance": ratio,
                "ring_us": ring_t * 1e6,
                "opt_us": opt_t * 1e6,
                "speedup": ring_t / opt_t if opt_t > 0 else 0.0,
                "wire_delta": (allgatherv_wire_elems("doubling", counts)
                               / allgatherv_wire_elems("ring", counts)),
            })
    return {"op": "allgatherv", "algo": "doubling", "n_devices": n,
            "rounds_ring": n - 1, "rounds_opt": math.ceil(math.log2(n)),
            "points": points,
            "speedup_p50": percentile([p["speedup"] for p in points], 50)}


def push_overhead(n: int = PUSH_ROWS) -> dict:
    """The push plane's tee on the record path: one row written ``n``
    times through a RotatingCsvLog three ways, ns a record: no tee, a
    tee into a plane whose sender is parked (the record path's own
    cost), and a tee into a running plane with a discarding sink (a
    saturating writer racing the sender for the GIL)."""
    import os
    import tempfile

    from tpu_perf_torch.driver import RotatingCsvLog
    from tpu_perf_torch.push.plane import PushPlane
    from tpu_perf_torch.schema import EXT_PREFIX, ResultRow

    row = ResultRow(
        timestamp="2026-01-01 00:00:00.000", job_id="bench-push",
        backend="torch", op="ring", nbytes=4096, iters=1, run_id=1,
        n_devices=8, lat_us=100.0, algbw_gbps=1.0, busbw_gbps=1.0,
        time_ms=0.1, mode="oneshot")

    class _Discard:
        def send(self, family, lines):
            pass

    out = {}
    with tempfile.TemporaryDirectory() as folder:
        for side, started in (("off", None), ("tee", False),
                              ("concurrent", True)):
            plane = tee = None
            if started is not None:
                plane = PushPlane([_Discard()], job_id="bench-push",
                                  spool_dir=folder, maxlen=n,
                                  start=started)
                tee = plane.tee_for(EXT_PREFIX)
            log = RotatingCsvLog(folder, f"bench-{side}", 0,
                                 refresh_sec=10**9, tee=tee,
                                 prefix=EXT_PREFIX)
            try:
                t0 = time.perf_counter()
                for _ in range(n):
                    log.write_row(row)
                wall = time.perf_counter() - t0
            finally:
                log.close()
                if plane is not None:
                    plane.close()
            if started:
                totals = plane.totals()
                out["concurrent_dropped"] = totals["dropped"]
                out["concurrent_sent"] = totals["sent"]
            out[f"{side}_ns_per_record"] = wall / n * 1e9
            for f in os.listdir(folder):
                os.remove(os.path.join(folder, f))
    out["tee_marginal_ns"] = (out["tee_ns_per_record"]
                              - out["off_ns_per_record"])
    return out


def _operating(spec: CardSpec | None, name: str, dtype: str | None = None):
    """One of ``spec``'s operating constants (the mxu ones by ``dtype``);
    None without a card or a constant."""
    if spec is None:
        return None
    value = getattr(spec, name)
    return value.get(dtype) if dtype is not None else value


def instrument_points() -> list[tuple[str, list]]:
    """JAX's three one-card instruments by name (``hbm_stream``,
    ``hbm_triad``, ``mxu_gemm``), each with its plateau points as
    :func:`_best_of_passes` takes them."""
    mxu_bytes = MXU_M * MXU_M * 2
    flops = flops_per_iter_dtype("mxu_gemm", mxu_bytes, "bfloat16")
    out = [(op, [(f"{op}_busbw_p50@{s}MiB[1dev]", op, s * _MIB, i,
                  "float32", STREAM_RUNS, lambda r: r.busbw_gbps)
                 for s, i in STREAM_POINTS])
           for op in ("hbm_stream", "hbm_triad")]
    out.append(("mxu_gemm", [
        (f"mxu_gemm_tflops_p50@m{MXU_M}bf16[1dev]", "mxu_gemm", mxu_bytes,
         MXU_ITERS, "bfloat16", MXU_RUNS,
         lambda r: flops / (r.lat_us * 1e-6) / 1e12)]))
    return out


def jax_instruments(dev, phases, adaptive_log: list) -> list[dict]:
    """JAX's three one-card instruments, each under the degraded-window
    rule against the detected card's floor and nominal."""
    spec = card_entry(dev)
    one = SimWorld(1, dev)
    instruments = []
    for name, points in instrument_points():
        if name == "mxu_gemm":
            unit, family, dtype = "TFLOP/s", "mxu", "bfloat16"
            floor = _operating(spec, "mxu_floor_tflops", dtype)
            nominal = _operating(spec, "mxu_nominal_tflops", dtype)
        else:
            unit, family, dtype = "GB/s", "hbm", "float32"
            floor = _operating(spec, "stream_floor_gbps")
            nominal = _operating(spec,
                                 name.replace("hbm_", "") + "_nominal_gbps")
        (v, label, fence, valid, dropped), passes = _best_of_passes(
            one, points, floor, phases, adaptive_log)
        instruments.append(instrument(
            label, v, unit, spec, family, dtype, fence, valid, dropped,
            nominal=nominal, floor=floor, passes=passes))
    return instruments


def one_card(dev, phases, adaptive_log: list) -> dict:
    """The one-card set: JAX's three instruments, the port's own entries,
    then the other instruments."""
    card = card_label(dev)
    one = SimWorld(1, dev)
    instruments = jax_instruments(dev, phases, adaptive_log)
    nbytes, iters, runs = STREAM_POINT
    own = [_p50_busbw(op, one, nbytes, iters, runs, phases, adaptive_log)
           for op in ("pl_hbm_stream", "hbm_stream")]
    n, nbytes, iters, runs = ALLREDUCE_POINT
    own.append(_p50_busbw("pl_allreduce", SimWorld(n, dev), nbytes, iters,
                          runs, phases, adaptive_log))
    payload = _head(instruments, own, card)
    payload["dispatch_overhead"] = dispatch_overhead(one)
    payload["contention"] = contention(one)
    payload["push_overhead"] = push_overhead()
    _arena(payload, dev)
    return payload


def headline(world, phases, adaptive_log: list) -> tuple:
    """The n >= 2 headline over ``world``'s ranks: the allreduce's p50
    busbw at HEADLINE_BYTES a rank, HEADLINE_ITERS iters, HEADLINE_RUNS
    runs (each run the slowest rank's).  Returns (busbw, fence, valid
    runs, dropped runs)."""
    rows, fence, dropped = _measure(
        world, "allreduce", HEADLINE_BYTES, HEADLINE_ITERS, "float32",
        HEADLINE_RUNS, phases, adaptive_log)
    return (percentile([r.busbw_gbps for r in rows], 50), fence, len(rows),
            dropped)


def across(world, phases, adaptive_log: list) -> dict:
    """JAX's n >= 2 set over the ``world.n`` ranks of ``world`` (a
    multi-process world: one card a rank): the allreduce headline, the
    port's ``pl_allreduce`` across the ranks, then the other instruments,
    the arena's over the ranks.  Every rank runs every instrument; each
    run's time is its maximum over the ranks, so every rank's rows, and
    each decision taken from them, are the same."""
    n, dev = world.n, world.device
    card = _cards(world)
    spec = card_entry(dev)
    busbw, fence, valid, dropped = headline(world, phases, adaptive_log)
    instruments = [instrument(
        f"allreduce_busbw_p50@{HEADLINE_BYTES // _MIB}MiB[{n}dev]", busbw,
        "GB/s", spec, "link", "float32", fence, valid, dropped,
        nominal=_operating(spec, "allreduce_nominal_gbps"))]
    _, nbytes, iters, runs = ALLREDUCE_POINT
    own = [_p50_busbw("pl_allreduce", world, nbytes, iters, runs, phases,
                      adaptive_log)]
    payload = _head(instruments, own, card)
    one = SimWorld(1, dev)
    payload["dispatch_overhead"] = dispatch_overhead(one)
    payload["contention"] = contention(one)
    payload["push_overhead"] = push_overhead()
    _arena(payload, dev, world, n)
    return payload


def _cards(world) -> list[dict]:
    """Every rank's card label, by rank."""
    import torch.distributed as dist

    label = card_label(world.device)
    labels = [None] * world.n
    dist.all_gather_object(labels, label, group=world.group)
    return labels


def _head(instruments: list[dict], own: list[dict], card) -> dict:
    """The payload's top level: the first instrument's fields, the card
    and every metric."""
    metrics = instruments + own
    for m in metrics:
        m["card"] = card
    payload = dict(instruments[0])
    payload.pop("fence")
    payload["card"] = card
    payload["metrics"] = metrics
    return payload


def _arena(payload: dict, dev, world=None, n: int = ARENA_RANKS) -> None:
    """The arena instruments, each where it applies, and their fence."""
    payload["arena_fence"] = ARENA_FENCE
    for key, fn in (("hier_vs_flat", hier_vs_flat),
                    ("scenario_step", scenario_step),
                    ("auto_vs_native", auto_vs_native),
                    ("vopt_vs_ring", vopt_vs_ring)):
        got = fn(dev, n=n, world=world)
        if got is not None:
            payload[key] = got


def _joined_world(dev):
    """This process' rank of the world torchrun's environment names
    (joined through ``initialize_distributed``: NCCL on the card, gloo on
    the CPU), or None for a process alone."""
    if not all(k in os.environ for k in _WORLD_ENV):
        return None
    from tpu_perf_torch.parallel import initialize_distributed
    from tpu_perf_torch.world import dist_world

    initialize_distributed(device=dev.type)
    return dist_world(dev)


def main(device: str | None = None) -> dict:
    from tpu_perf_torch.compilepipe import PhaseTimer

    # the benchmark's own compile / measure / log split
    phases = PhaseTimer()
    phases.start()
    adaptive_log: list[dict] = []
    dev = resolve_device(device)
    world = _joined_world(dev)
    if world is not None and world.n >= 2:
        payload = across(world, phases, adaptive_log)
    else:
        payload = one_card(world.device if world is not None else dev,
                           phases, adaptive_log)
    phases.stop()
    payload["phases"] = {**phases.snapshot(),
                         "wall_s": round(phases.wall_s, 3)}
    if adaptive_log:
        # what the early stop handed back across every measurement, retry
        # passes included; runs_attempted is budget consumed, dropped
        # runs included
        payload["adaptive"] = {
            "ci_rel": ADAPTIVE_CI,
            "points": len(adaptive_log),
            "runs_requested": sum(a["requested"] for a in adaptive_log),
            "runs_attempted": sum(a["attempted"] for a in adaptive_log),
            "runs_saved": sum(a["saved"] for a in adaptive_log),
        }
    if world is None or world.rank == 0:
        print(json.dumps(payload))
    return payload
