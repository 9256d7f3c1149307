"""The fault-free health soak's spikes, read visit by visit, on the card.

Runs ``monitor --health --op pl_allreduce -b 4K`` (8 sim ranks, float32,
the detector's default thresholds: ``spike_z`` 8.0, threshold 0.5,
warm-up 30) for ``--visits`` visits under each of ``--fences``, each in a
process of its own:

* ``fused``: the shipped fused fence, each visit's one-run graph behind
  the gate (``timing.FusedRunner``, ``timing.TraceGate``);
* ``fused0``: the same graph without the gate (``timing.FUSED_GATE``
  off), as the fence was before the gate;
* ``trace``: the shipped trace fence (its lo leg behind the gate).

A name with ``+busy`` runs it with a busy process on every host core, so
that the host thread that submits the graphs is preempted more often.

Beside every visit's sample it records the host side of the visit's
graph replays: the seconds each ``CUDAGraph.replay`` call took and the
involuntary context switches of the calling thread during it
(``getrusage(RUSAGE_THREAD)``).  It reports, per fence, the health events
(kind, run, observed, baseline), each alarm's sample beside its five
neighbours on each side with its replays' host seconds and switches, and
the samples above twice the median (stalls): how many, and how many of
them had a replay call that was switched out or took more than ten times
the median call.

Run on a machine with a card::

    python -m tpu_perf_torch.tools.soak_spikes [--visits 20000]
        [--fences fused0,fused,trace] [--out FILE]

It prints one JSON line with the card's name and power limit; ``--out``
also writes every visit's sample there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

FENCES = ("fused0", "fused", "trace")
#: a sample this many times the soak's median is a stall
STALL_FACTOR = 2.0
#: a replay call this many times the median call is a slow submission
SLOW_CALL_FACTOR = 10.0
NEIGHBOURS = 5


def _child(fence: str, visits: int, out: str) -> None:
    """One fence's soak in this process: the replay calls and the health
    monitor's samples recorded visit by visit."""
    import resource

    import torch

    from tpu_perf_torch import cli, timing
    from tpu_perf_torch.health import monitor

    mode = fence.split("+")[0]
    if mode == "fused0":
        timing.FUSED_GATE = False
    calls: list[tuple[float, int]] = []
    plain_replay = torch.cuda.CUDAGraph.replay

    def replay(self):
        c0 = resource.getrusage(resource.RUSAGE_THREAD).ru_nivcsw
        t0 = time.perf_counter()
        plain_replay(self)
        t1 = time.perf_counter()
        calls.append((t1 - t0,
                      resource.getrusage(resource.RUSAGE_THREAD).ru_nivcsw
                      - c0))

    samples: list[tuple[int, float, int]] = []
    plain_observe = monitor.HealthMonitor.observe

    def observe(self, op, nbytes, iters, n_devices, run_id, t, span_id=""):
        samples.append((run_id, t, len(calls)))
        return plain_observe(self, op, nbytes, iters, n_devices, run_id, t,
                             span_id=span_id)

    torch.cuda.CUDAGraph.replay = replay
    monitor.HealthMonitor.observe = observe
    with tempfile.TemporaryDirectory(prefix="soak_spikes-") as root:
        t0 = time.perf_counter()
        rc = cli.main(["monitor", "--op", "pl_allreduce", "-b", "4K",
                       "--fence", "fused" if mode == "fused0" else mode,
                       "--health", "--max-runs", str(visits),
                       "--stats-every", str(visits), "-l", root])
        wall = time.perf_counter() - t0
        events = []
        for name in sorted(os.listdir(root)):
            if name.startswith("health-") and name.endswith(".log"):
                with open(os.path.join(root, name)) as fh:
                    events += [json.loads(ln) for ln in fh if ln.strip()]
    if rc != 0:
        raise RuntimeError(f"monitor --fence {mode} exited {rc}")
    # the replay calls of visit k: those made after visit k-1's sample
    visits_calls = []
    last = 0
    for _, _, upto in samples:
        visits_calls.append(calls[last:upto])
        last = upto
    with open(out, "w") as fh:
        json.dump({"fence": fence, "wall_s": wall, "events": events,
                   "samples": [(r, t) for r, t, _ in samples],
                   "calls": visits_calls}, fh)


def _summary(got: dict) -> dict:
    samples = got["samples"]
    calls = got["calls"]
    ts = [t for _, t in samples]
    med = statistics.median(ts)
    call_s = [c for vc in calls for c, _ in vc]
    call_med = statistics.median(call_s)

    def host(k):
        return [{"call_us": c * 1e6, "switches": n} for c, n in calls[k]]

    def slow(k):
        return any(n > 0 or c > SLOW_CALL_FACTOR * call_med
                   for c, n in calls[k])

    index = {r: k for k, (r, _) in enumerate(samples)}
    alarms = []
    for e in got["events"]:
        if e["kind"] == "recovered":
            continue
        k = index.get(e["run_id"])
        if k is None:
            continue
        lo, hi = max(0, k - NEIGHBOURS), min(len(ts), k + NEIGHBOURS + 1)
        alarms.append({
            "kind": e["kind"], "run_id": e["run_id"],
            "observed_us": e["observed"] * 1e6,
            "baseline_us": e["baseline"] * 1e6,
            "neighbours_us": [t * 1e6 for t in ts[lo:hi]],
            "host": host(k), "slow_submission": slow(k)})
    stalls = [k for k, t in enumerate(ts) if t > STALL_FACTOR * med]
    kinds: dict[str, int] = {}
    for e in got["events"]:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    return {
        "visits": len(ts), "wall_s": got["wall_s"], "events": kinds,
        "p50_us": med * 1e6,
        "p99_us": sorted(ts)[int(0.99 * (len(ts) - 1))] * 1e6,
        "max_us": max(ts) * 1e6,
        "stalls": len(stalls),
        "stalls_with_slow_submission": sum(slow(k) for k in stalls),
        "visits_with_slow_submission": sum(slow(k) for k in range(len(ts))),
        "stall_us": [ts[k] * 1e6 for k in stalls[:40]],
        "replay_call_us_p50": call_med * 1e6,
        "replay_call_us_max": max(call_s) * 1e6,
        "switched_calls": sum(n > 0 for vc in calls for _, n in vc),
        "alarms": alarms}


def card_line() -> str:
    ids = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={ids}"],
        capture_output=True, text=True, check=True).stdout.strip()


def measure(fences, visits: int) -> tuple[dict, dict]:
    raw, result = {}, {}
    with tempfile.TemporaryDirectory(prefix="soak_spikes-") as root:
        for fence in fences:
            out = f"{root}/{fence}.json"
            burners = []
            if fence.endswith("+busy"):
                burners = [subprocess.Popen(
                    [sys.executable, "-c", "while True: pass"])
                    for _ in range(os.cpu_count() or 1)]
            try:
                child = subprocess.run(
                    [sys.executable, "-m", "tpu_perf_torch.tools.soak_spikes",
                     "--child", fence, "--visits", str(visits), "--out",
                     out], capture_output=True, text=True)
            finally:
                for b in burners:
                    b.kill()
                    b.wait()
            if child.returncode != 0:
                raise RuntimeError(f"{fence} exited {child.returncode}:\n"
                                   f"{child.stderr[-3000:]}")
            with open(out) as fh:
                got = json.load(fh)
            raw[fence] = got
            result[fence] = _summary(got)
    return raw, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="soak_spikes")
    ap.add_argument("--visits", type=int, default=20000)
    ap.add_argument("--fences", default=",".join(FENCES))
    ap.add_argument("--child", default=None,
                    help="the one fence this process soaks")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from tpu_perf_torch.kernels import _build

    _build.build_all()
    if args.child:
        _child(args.child, args.visits, args.out)
        return 0
    raw, result = measure(args.fences.split(","), args.visits)
    result = {"card": card_line(), "op": "pl_allreduce", "bytes": 4096,
              "ranks": 8, **result}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"result": result, "raw": raw}, fh)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
