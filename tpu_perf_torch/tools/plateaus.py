"""The runs behind the card table's operating constants
(:mod:`tpu_perf_torch.chips`): plateau p50s in processes of their own,
and the rule that turns them into floors and nominals.

Each measuring process (``--child``) takes one pass of ``bench``'s
one-card points and prints one JSON line: every point's p50, the better
of each instrument's points (its value, as ``bench`` reports it), and the
float32 ``grid --spec mxu`` cells the smoke runs (``mxu_gemm`` at 16 MiB
and 64 MiB, ``-i 10,20``, trace fence) with the grid's chosen cell::

    python -m tpu_perf_torch.tools.plateaus --procs 5 --out p.json
    python -m tpu_perf_torch.tools.plateaus --procs 2 --neighbour
    python -m tpu_perf_torch.tools.plateaus --summary p1.json p2.json

``--procs`` runs that many processes one after another; ``--neighbour``
runs each beside a process that copies 1 GiB on the card in a loop (a
degraded window: the card time-sliced with another context).
``--summary`` reads every process' line from the files and applies the
rule (:func:`floor_of`, :func:`nominal_of`), with the card's name and power
limit as each process read them.

The allreduce nominal's basis, across the cards of one host, a process a
card::

    torchrun --nproc-per-node 4 -m tpu_perf_torch.tools.plateaus --nccl

is ``bench``'s own n >= 2 headline (:func:`tpu_perf_torch.bench.headline`:
the allreduce at 4 MiB a rank, 25 iters, 8 runs, trace fence on the
card); beside it, for comparison only, NCCL's ``all_reduce`` timed eagerly
(each run 25 back-to-back calls between CUDA events, its time the slowest
rank's, busbw by the nccl-tests convention).  Rank 0 prints both p50s.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

#: the floor's least margin under the lowest p50, and its multiple of the
#: pass-to-pass spread; the nominal's fraction of the median
FLOOR_MIN_MARGIN, FLOOR_SPREAD_FACTOR, NOMINAL_FRACTION = 0.05, 3.0, 0.9
#: rounding of a constant: GB/s to 10, TFLOP/s to 1
QUANTUM = {"GB/s": 10.0, "TFLOP/s": 1.0}
#: the float32 grid the smoke's compute phase runs
F32_SIZES, F32_ITERS, F32_RUNS = (16 << 20, 64 << 20), (10, 20), 5
#: the plateaus' names of bench's instruments where they differ
PLATEAU_NAMES = {"mxu_gemm": "mxu_bf16"}
#: NCCL's allreduce: bytes a rank, calls a run, runs
NCCL_BYTES, NCCL_ITERS, NCCL_RUNS = 4 << 20, 25, 20

#: how long the neighbour may take to start, and to stop, seconds
NEIGHBOUR_LIMIT_S = 120

_NEIGHBOUR = (
    "import os, sys, torch\n"
    "x = torch.ones(1 << 28, device='cuda'); y = torch.empty_like(x)\n"
    "torch.cuda.synchronize(); open(sys.argv[1], 'w').close()\n"
    "while not os.path.exists(sys.argv[2]):\n"
    "    for _ in range(8):\n"
    "        y.copy_(x)\n"
    "    torch.cuda.synchronize()\n")


@contextlib.contextmanager
def neighbour(limit_s: float = NEIGHBOUR_LIMIT_S):
    """A process beside the caller that copies 1 GiB on the card in a loop
    (another context time-slicing the card: a degraded window), from the
    moment it is ready until the block ends.  Raises when it ends early
    or is not ready within ``limit_s``; killed when it does not stop
    within ``limit_s``."""
    with tempfile.TemporaryDirectory() as tmp:
        ready, stop = os.path.join(tmp, "ready"), os.path.join(tmp, "stop")
        with open(os.path.join(tmp, "err"), "w+") as err:
            proc = subprocess.Popen([sys.executable, "-c", _NEIGHBOUR, ready,
                                     stop], stdout=subprocess.DEVNULL,
                                    stderr=err)
            try:
                t0 = time.perf_counter()
                while not os.path.exists(ready):
                    if (proc.poll() is not None
                            or time.perf_counter() - t0 > limit_s):
                        err.seek(0)
                        raise RuntimeError(
                            "the neighbour process never started: "
                            f"{err.read()[-2000:]}")
                    time.sleep(0.05)
                yield proc
            finally:
                open(stop, "w").close()
                try:
                    proc.wait(timeout=limit_s)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


def median(values: list[float]) -> float:
    s = sorted(values)
    return (s[(len(s) - 1) // 2] + s[len(s) // 2]) / 2


def spread(values: list[float]) -> float:
    """Pass-to-pass spread: (max - min) / median."""
    return (max(values) - min(values)) / median(values)


def floor_of(values: list[float], quantum: float) -> float:
    """The floor under ``values`` (one plateau p50 a process): the lowest
    less max(5%, 3 x spread) of it, rounded down to ``quantum``."""
    margin = max(FLOOR_MIN_MARGIN, FLOOR_SPREAD_FACTOR * spread(values))
    return math.floor(min(values) * (1 - margin) / quantum) * quantum


def nominal_of(values: list[float], quantum: float) -> float:
    """The nominal: 0.9 of the median p50, rounded to ``quantum``."""
    return round(NOMINAL_FRACTION * median(values) / quantum) * quantum


def _child(device: str) -> dict:
    """One pass of bench's one-card points and the float32 grid."""
    from tpu_perf_torch import bench
    from tpu_perf_torch.chips import card_peak
    from tpu_perf_torch.compilepipe import PhaseTimer
    from tpu_perf_torch.grid import run_grid
    from tpu_perf_torch.metrics import percentile
    from tpu_perf_torch.world import SimWorld, resolve_device

    dev = resolve_device(device)
    one = SimWorld(1, dev)
    phases, log = PhaseTimer(), []
    points, values = {}, {}
    for name, pts in bench.instrument_points():
        for label, op, nbytes, iters, dtype, runs, to_value in pts:
            rows, _, _ = bench._measure(one, op, nbytes, iters, dtype, runs,
                                        phases, log)
            points[label] = percentile([to_value(r) for r in rows], 50)
        values[PLATEAU_NAMES.get(name, name)] = max(points[p[0]]
                                                    for p in pts)
    # judged in TFLOP/s against the card's float32 peak, as grid --spec
    # mxu judges it (an unphysical cell is never chosen), under no floor
    spec = bench.card_entry(dev)
    cells = run_grid(one, "mxu_gemm", list(F32_SIZES), list(F32_ITERS),
                     dtype="float32", runs=F32_RUNS, fence=bench._fence(one),
                     spec_tflops=(None if spec is None
                                  else card_peak(spec, "mxu", "float32")),
                     floor_tflops=0.0)
    grid = {f"{c.nbytes >> 20}M x{c.iters}": c.p50 for c in cells}
    chosen = [c for c in cells if c.chosen]
    values["mxu_f32"] = chosen[0].p50 if chosen else max(grid.values())
    return {"card": bench.card_label(dev), "points": points,
            "f32_grid": grid, "f32_unit": cells[0].unit,
            "f32_chosen": (f"{chosen[0].nbytes >> 20}M x{chosen[0].iters}"
                           if chosen else None),
            "values": values}


def _measure_procs(procs: int, beside: bool, device: str) -> list[dict]:
    """``procs`` measuring processes, one after another, each beside the
    neighbour when asked."""
    out = []
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=here)
    for i in range(procs):
        with neighbour() if beside else contextlib.nullcontext():
            t0 = time.perf_counter()
            got = subprocess.run(
                [sys.executable, "-m", "tpu_perf_torch.tools.plateaus",
                 "--child", "--device", device], env=env, cwd=here,
                capture_output=True, text=True, check=True)
        line = json.loads(got.stdout.strip().splitlines()[-1])
        line.update(process=i, neighbour=beside,
                    wall_s=time.perf_counter() - t0,
                    at=time.strftime("%H:%M:%S"))
        out.append(line)
        print(json.dumps(line), flush=True)
    return out


def summary(lines: list[dict]) -> dict:
    """The rule over every healthy process' values, the neighbour
    processes' values beside the floors they are held to, and the
    allreduce nominal over every ``--nccl`` line given (bench's headline
    p50 of each world)."""
    nccl = [ln for ln in lines if "ranks" in ln]
    lines = [ln for ln in lines if "ranks" not in ln]
    healthy = [ln for ln in lines if not ln.get("neighbour")]
    units = {"hbm_stream": "GB/s", "hbm_triad": "GB/s",
             "mxu_bf16": "TFLOP/s", "mxu_f32": "TFLOP/s"}
    out = {"processes": len(healthy),
           "cards": sorted({f"{ln['card']['name']}, "
                            f"{ln['card']['power_limit']}" for ln in lines})}
    if healthy:
        for name, unit in units.items():
            # a float32 grid judged in GB/s is not a product rate
            vals = [ln["values"][name] for ln in healthy
                    if name != "mxu_f32" or ln.get("f32_unit") == unit]
            out[name] = {"unit": unit, "processes": len(vals), "p50s": vals,
                         "lowest": min(vals),
                         "median": median(vals),
                         "spread": spread(vals),
                         "floor": floor_of(vals, QUANTUM[unit]),
                         "nominal": nominal_of(vals, QUANTUM[unit])}
        # stream and triad share one floor: under the lower plateau
        out["stream_floor_gbps"] = min(out["hbm_stream"]["floor"],
                                       out["hbm_triad"]["floor"])
    if nccl:
        # the nominal from the headline's own measurement; NCCL's eager
        # timing beside it, for comparison
        vals = [ln["headline"]["busbw_gbps_p50"] for ln in nccl]
        eager = [ln["eager"]["busbw_gbps_p50"] for ln in nccl]
        out["allreduce"] = {"unit": "GB/s", "processes": len(vals),
                            "ranks": sorted({ln["ranks"] for ln in nccl}),
                            "p50s": vals, "lowest": min(vals),
                            "median": median(vals), "spread": spread(vals),
                            "nominal": nominal_of(vals, QUANTUM["GB/s"]),
                            "eager_p50s": eager,
                            "eager_median": median(eager),
                            "cards": sorted({f"{c['name']}, "
                                             f"{c['power_limit']}"
                                             for ln in nccl
                                             for c in ln["cards"]})}
    near = [ln for ln in lines if ln.get("neighbour")]
    if near:
        out["neighbour"] = [
            {k: ln["values"][k] for k in ("hbm_stream", "hbm_triad",
                                          "mxu_bf16")} for ln in near]
    return out


def _nccl(device: str) -> dict:
    """bench's n >= 2 headline over the world torchrun names, then NCCL's
    (gloo's on the CPU) all_reduce at NCCL_BYTES a rank timed eagerly:
    each run NCCL_ITERS calls, its time the slowest rank's."""
    import torch
    import torch.distributed as dist

    from tpu_perf_torch import bench
    from tpu_perf_torch.compilepipe import PhaseTimer
    from tpu_perf_torch.parallel import initialize_distributed
    from tpu_perf_torch.world import dist_world, resolve_device

    dev = resolve_device(device)
    initialize_distributed(device=dev.type)
    world = dist_world(resolve_device(device))
    dev, n, rank = world.device, world.n, world.rank
    head, fence, valid, _ = bench.headline(world, PhaseTimer(), [])
    x = torch.ones(NCCL_BYTES // 4, dtype=torch.float32, device=dev)
    for _ in range(5):
        dist.all_reduce(x)
    cuda = dev.type == "cuda"
    times = []
    for _ in range(NCCL_RUNS):
        dist.barrier()
        if cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            a.record()
        t0 = time.perf_counter()
        for _ in range(NCCL_ITERS):
            dist.all_reduce(x)
        if cuda:
            b.record()
            b.synchronize()
            t = a.elapsed_time(b) / 1e3
        else:
            t = time.perf_counter() - t0
        m = torch.tensor([t], dtype=torch.float64, device=dev)
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        times.append(m.item())
    factor = 2 * (n - 1) / n
    busbw = sorted(factor * NCCL_BYTES / (t / NCCL_ITERS) / 1e9
                   for t in times)
    labels = [None] * n
    dist.all_gather_object(labels, bench.card_label(dev))
    dist.barrier()
    dist.destroy_process_group()
    return {"ranks": n, "rank": rank,
            "headline": {"nbytes": bench.HEADLINE_BYTES,
                         "iters": bench.HEADLINE_ITERS,
                         "runs": bench.HEADLINE_RUNS, "fence": fence,
                         "runs_valid": valid, "busbw_gbps_p50": head},
            "eager": {"nbytes": NCCL_BYTES, "iters": NCCL_ITERS,
                      "runs": NCCL_RUNS, "busbw_gbps_p50": median(busbw),
                      "busbw_gbps_min": busbw[0],
                      "busbw_gbps_max": busbw[-1]},
            "cards": labels}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--procs", type=int, default=5)
    p.add_argument("--neighbour", action="store_true")
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None,
                   help="append each process' line to this file")
    p.add_argument("--summary", nargs="+", default=None, metavar="FILE")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--nccl", action="store_true")
    args = p.parse_args(argv)
    device = args.device or "cuda"
    if args.child:
        print(json.dumps(_child(device)))
        return 0
    if args.nccl:
        got = _nccl(device)
        if got["rank"] == 0:
            print(json.dumps(got))
        return 0
    if args.summary:
        lines = [json.loads(ln) for path in args.summary
                 for ln in open(path) if ln.strip()]
        print(json.dumps(summary(lines)))
        return 0
    lines = _measure_procs(args.procs, args.neighbour, device)
    if args.out:
        with open(args.out, "a") as fh:
            for ln in lines:
                fh.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
