"""``bench``'s degraded-window rule, its n >= 2 set and the card table's
operating constants, held against the JAX package's ``bench`` and
``chips`` (``tests/test_bench.py``, ``tests/test_chips.py``) on the same
fakes.

The port's ``run_point`` and JAX's are replaced by fakes that hand both
the same sample sequences, so ``_best_of_passes`` and the payloads are
compared decision for decision: the chosen (value, label, valid,
dropped), the passes taken, the keys.  The n >= 2 set runs in gloo worlds
of 2 and 4 processes with ``run_point`` faked (JAX: its eight virtual
devices cut to 2 and 4), and once unfaked in a gloo world of 2.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu_perf.bench as jbench
import tpu_perf.runner as jrunner
import tpu_perf.timing as jtiming
from tpu_perf.runner import SweepPointResult as JPoint
from tpu_perf.timing import DegenerateSlopeError as JDegenerate
from tpu_perf.timing import RunTimes as JRunTimes

from tpu_perf_torch import bench, chips, cli
from tpu_perf_torch.compilepipe import PhaseTimer
from tpu_perf_torch.runner import SweepPointResult
from tpu_perf_torch.timing import DegenerateSlopeError, RunTimes
from tpu_perf_torch.tools import plateaus
from tpu_perf_torch.world import SimWorld

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SXM = chips.CARDS["h100-sxm"]
#: the gloo world's own limit, seconds
GLOO_TIMEOUT_S = 400


def _port_fake(samples_for, calls):
    """A port run_point whose samples come from ``samples_for(opts)``."""

    def fake(opts, world, nbytes, **kw):
        calls.append((opts.op, nbytes, opts.iters, opts.fence))
        samples = samples_for(opts)
        if samples is None:
            raise DegenerateSlopeError("every slope sample lost")
        return SweepPointResult(op=opts.op, nbytes=nbytes, iters=opts.iters,
                                n_devices=world.n,
                                times=RunTimes(samples=samples, warmup_s=0.0))
    return fake


def _jax_fake(samples_for, calls, n_devices=1):

    def fake(opts, mesh, nbytes, **kw):
        calls.append((opts.op, nbytes, opts.iters, opts.fence))
        samples = samples_for(opts)
        if samples is None:
            raise JDegenerate("every slope sample lost")
        return JPoint(op=opts.op, nbytes=nbytes, iters=opts.iters,
                      n_devices=n_devices,
                      times=JRunTimes(samples=samples, warmup_s=0.0,
                                      overhead_s=0.0))
    return fake


def _quiet_extras(monkeypatch):
    """The port's one-card set without its slow host instruments (their
    keys are held against JAX's in the sim-world tests below)."""
    monkeypatch.setattr(bench, "dispatch_overhead", lambda *a, **k: {})
    monkeypatch.setattr(bench, "contention", lambda *a, **k: {})
    monkeypatch.setattr(bench, "push_overhead", lambda *a, **k: {})
    monkeypatch.setattr(bench, "_arena", lambda *a, **k: None)


def _on_card(monkeypatch, spec):
    """bench on the CPU held to ``spec``'s constants, as on that card."""
    monkeypatch.setattr(bench, "card_entry", lambda device: spec)


# --- the one-card set: passes, markers, nominals ----------------------------


def test_healthy_passes_carry_no_marker(monkeypatch, capsys):
    _quiet_extras(monkeypatch)
    _on_card(monkeypatch, SXM)
    calls = []
    monkeypatch.setattr(bench, "run_point", _port_fake(
        lambda opts: [1e-5] * opts.num_runs, calls))
    payload = bench.main("cpu")
    assert json.loads(capsys.readouterr().out) == payload
    inst = payload["metrics"][:3]
    assert [m["metric"].split("_p50")[0] for m in inst] == [
        "hbm_stream_busbw", "hbm_triad_busbw", "mxu_gemm_tflops"]
    assert all("below_plateau_floor" not in m and m["passes"] == 1
               for m in inst)
    assert "below_plateau_floor" not in payload
    # one pass: 2 + 2 + 1 instrument points, then the 3 own entries
    assert len(calls) == 8 and calls[0][0] == "hbm_stream"


def test_exhausted_retries_take_every_pass_and_say_so(monkeypatch):
    # JAX's count: stream + triad, 2 points x 3 passes each; mxu 1 x 3
    _quiet_extras(monkeypatch)
    _on_card(monkeypatch, SXM)
    calls = []
    monkeypatch.setattr(bench, "run_point", _port_fake(
        lambda opts: [0.1] * opts.num_runs, calls))
    payload = bench.main("cpu")
    assert len(calls) - 3 == 15
    inst = payload["metrics"][:3]
    assert all(m["below_plateau_floor"] is True and m["passes"] == 3
               for m in inst)
    assert payload["below_plateau_floor"] is True
    assert 0 < payload["value"] < SXM.stream_floor_gbps


def test_exhausted_retries_count_as_jaxs(eight_devices, monkeypatch,
                                         capsys):
    # the same degraded window through both packages: the same passes
    import jax

    monkeypatch.setattr(jax, "devices", lambda: jax.local_devices()[:1])
    monkeypatch.setattr(jtiming, "trace_fence_available", lambda: False)
    for name in ("_dispatch_overhead", "_push_overhead", "_contention"):
        monkeypatch.setattr(jbench, name, lambda *a, **k: None)
    jcalls = []
    monkeypatch.setattr(jrunner, "run_point", _jax_fake(
        lambda opts: [0.1] * opts.num_runs, jcalls))
    jbench.main()
    theirs = json.loads(capsys.readouterr().out)
    _quiet_extras(monkeypatch)
    _on_card(monkeypatch, SXM)
    calls = []
    monkeypatch.setattr(bench, "run_point", _port_fake(
        lambda opts: [0.1] * opts.num_runs, calls))
    ours = bench.main("cpu")
    assert len(calls) - 3 == len(jcalls) == 15
    for o, t in zip(ours["metrics"], theirs["metrics"]):
        assert o["metric"] == t["metric"]
        assert o["below_plateau_floor"] is t["below_plateau_floor"] is True
        assert o["runs_valid"] == t["runs_valid"]
        assert set(t) <= set(o)


@pytest.mark.parametrize("kind", sorted(chips.CARDS))
def test_vs_baseline_follows_the_injected_cards_nominals(kind, monkeypatch):
    spec = chips.CARDS[kind]
    _quiet_extras(monkeypatch)
    _on_card(monkeypatch, spec)
    monkeypatch.setattr(bench, "run_point", _port_fake(
        lambda opts: [1e-5] * opts.num_runs, []))
    payload = bench.main("cpu")
    stream, triad, mxu = payload["metrics"][:3]
    for m, nominal in ((stream, spec.stream_nominal_gbps),
                       (triad, spec.triad_nominal_gbps),
                       (mxu, spec.mxu_nominal_tflops["bfloat16"])):
        assert m["vs_baseline"] == pytest.approx(m["value"] / nominal,
                                                 rel=1e-3)
    assert stream["vs_peak"] == pytest.approx(stream["value"]
                                              / spec.hbm_gbps)
    assert payload["vs_baseline"] == stream["vs_baseline"]


def test_the_cpu_takes_one_pass_and_gives_no_ratio(monkeypatch):
    _quiet_extras(monkeypatch)
    calls = []
    monkeypatch.setattr(bench, "run_point", _port_fake(
        lambda opts: [0.1] * opts.num_runs, calls))
    payload = bench.main("cpu")
    assert len(calls) == 8
    assert all(m["vs_baseline"] is None and m["vs_peak"] is None
               and m["passes"] == 1 and "below_plateau_floor" not in m
               for m in payload["metrics"][:3])


# --- _best_of_passes against JAX's, sequence for sequence ------------------

#: each case: (the samples of every call in order, None a degenerate
#: point, the floor in GB/s, points a pass); a sample of t seconds for 16
#: iterations at 4 MiB reads about 16 * 2 * 4 MiB / t busbw
_FAST, _SLOW, _MID = 1e-4, 1e-1, 1e-3
PASS_CASES = {
    "healthy": ([_FAST, _FAST], 1000.0, 2),
    "second pass recovers": ([_SLOW, _SLOW, _FAST, _SLOW], 1000.0, 2),
    "all under the floor": ([_SLOW, _MID, _MID, _SLOW, _SLOW, _SLOW],
                            1000.0, 2),
    "a degenerate pass, then healthy": ([None, None, _FAST, _FAST],
                                        1000.0, 2),
    "one point always degenerate": ([None, _SLOW, None, _MID, None, _SLOW],
                                    1000.0, 2),
    "one point a pass": ([_SLOW, _MID, _FAST], 1000.0, 1),
    "the floor met exactly late": ([_SLOW, _SLOW, _MID], 100.0, 1),
}


def _seq(values):
    it = iter(values)

    def samples_for(opts):
        t = next(it)
        return None if t is None else [t, t * 1.01, t * 0.99][:opts.num_runs]
    return samples_for


def _points(n_points):
    return [(f"hbm_stream_busbw_p50@{4 * (k + 1)}MiB[1dev]", "hbm_stream",
             4 * (k + 1) << 20, 16) for k in range(n_points)]


def _jax_best(eight_devices, monkeypatch, seq, floor, n_points):
    import jax

    monkeypatch.setattr(jax, "devices", lambda: jax.local_devices()[:1])
    calls = []
    monkeypatch.setattr(jrunner, "run_point", _jax_fake(_seq(seq), calls))
    points = [(label, dict(op=op, iters=iters), nbytes, 3,
               lambda r: r.busbw_gbps)
              for label, op, nbytes, iters in _points(n_points)]
    got = jbench._best_of_passes(points, floor, fences=["slope"])
    return got, len(calls)


def _port_best(monkeypatch, seq, floor, n_points):
    calls = []
    monkeypatch.setattr(bench, "run_point", _port_fake(_seq(seq), calls))
    points = [(label, op, nbytes, iters, "float32", 3,
               lambda r: r.busbw_gbps)
              for label, op, nbytes, iters in _points(n_points)]
    got, passes = bench._best_of_passes(SimWorld(1, CPU), points, floor,
                                        PhaseTimer(), [])
    return got, passes, len(calls)


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_best_of_passes_is_jaxs(case, eight_devices, monkeypatch):
    seq, floor, n_points = PASS_CASES[case]
    (jv, jlabel, jfence, jvalid, jdropped), jcalls = _jax_best(
        eight_devices, monkeypatch, seq, floor, n_points)
    (v, label, fence, valid, dropped), passes, calls = _port_best(
        monkeypatch, seq, floor, n_points)
    assert (v, label, valid, dropped) == pytest.approx(
        (jv, jlabel, jvalid, jdropped))
    assert fence == jfence == "slope"
    assert calls == jcalls == passes * n_points
    assert calls == len(seq)


def test_every_pass_degenerate_raises_as_jaxs(eight_devices, monkeypatch):
    seq = [None] * 6
    with pytest.raises(RuntimeError, match="slope samples"):
        _jax_best(eight_devices, monkeypatch, seq, 1000.0, 2)
    with pytest.raises(RuntimeError, match="slope samples"):
        _port_best(monkeypatch, seq, 1000.0, 2)


def test_no_floor_is_one_pass(monkeypatch):
    (v, *_), passes, calls = _port_best(monkeypatch, [_SLOW, _SLOW], None, 2)
    assert passes == 1 and calls == 2 and v > 0


# --- the n >= 2 set against JAX's -------------------------------------------


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return type(obj).__name__ in ("int", "float", "str")


def _small(mod, names, **kw):
    return {name: functools.partial(getattr(mod, name), **kw)
            for name in names}


#: the port's own keys beside JAX's
OWN_TOP = {"card", "vs_peak", "passes", "arena_fence"}
OWN_METRIC = {"card", "vs_peak", "passes"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: bench's small instruments for a gloo world (each rank's script starts
#: with it)
_SMALL = """
import sys
import tpu_perf_torch.bench as b
b.ALLREDUCE_POINT = (8, 4096, 2, 2)
for name in ("hier_vs_flat", "scenario_step", "auto_vs_native",
             "vopt_vs_ring"):
    fn = getattr(b, name)
    setattr(b, name, lambda *a, _fn=fn, **k: _fn(
        *a, **{**k, "sizes": (4096,), "runs": 2, "iters": 1}))
plain = (b.dispatch_overhead, b.contention, b.push_overhead)
b.dispatch_overhead = lambda w: plain[0](w, sizes=(8,), runs=2)
b.contention = lambda w: plain[1](w, runs=2)
b.push_overhead = lambda: plain[2](200)
"""
_RUN = """
from tpu_perf_torch import cli
sys.exit(cli.main(["bench", "--device", "cpu"]))
"""
#: bench in a gloo world at small sizes: the headline keeps its 4 MiB
_GLOO_BENCH = _SMALL + """
b.HEADLINE_ITERS, b.HEADLINE_RUNS = 2, 3
""" + _RUN
#: the same with every run_point faked (1 ms a run, as the JAX side's fake
#: gives) and held to the SXM's constants, as on that card
_GLOO_FAKED = _SMALL + """
from tpu_perf_torch import chips
from tpu_perf_torch.runner import SweepPointResult
from tpu_perf_torch.timing import RunTimes
b.run_point = lambda opts, world, nbytes, **kw: SweepPointResult(
    op=opts.op, nbytes=nbytes, iters=opts.iters, n_devices=world.n,
    times=RunTimes(samples=[1e-3] * opts.num_runs, warmup_s=0.0))
b.card_entry = lambda device: chips.CARDS["h100-sxm"]
""" + _RUN


def _gloo_world(n: int, script: str) -> list[tuple[str, str]]:
    """``script`` in every rank of a gloo world of ``n`` processes, as
    torchrun starts them; each rank's (stdout, stderr), every rank held to
    exit 0."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], cwd=REPO, env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=GLOO_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return outs


@functools.lru_cache(maxsize=None)
def _faked_world(n: int) -> dict:
    """Rank 0's line of a faked gloo world of ``n`` (one world a size,
    shared by the tests below); the other ranks print nothing."""
    outs = _gloo_world(n, _GLOO_FAKED)
    (line,) = outs[0][0].splitlines()
    assert all(out == "" for out, _ in outs[1:])
    return json.loads(line)


@pytest.mark.parametrize("n", [2, 4])
def test_the_n_rank_set_has_jaxs_labels_and_keys(n, eight_devices,
                                                 monkeypatch, capsys):
    import jax

    monkeypatch.setattr(jax, "devices", lambda: jax.local_devices()[:n])
    monkeypatch.setattr(jtiming, "trace_fence_available", lambda: False)
    monkeypatch.setattr(jrunner, "run_point", _jax_fake(
        lambda opts: [1e-3] * opts.num_runs, [], n_devices=n))
    small = dict(sizes=(4096,), runs=2, iters=1)
    for name, fn in {
            **_small(jbench, ("_hier_vs_flat", "_scenario_step",
                              "_auto_vs_native", "_vopt_vs_ring"), **small),
            "_dispatch_overhead": functools.partial(
                jbench._dispatch_overhead, sizes=(8,), runs=2),
            "_contention": functools.partial(jbench._contention, runs=2),
            "_push_overhead": functools.partial(jbench._push_overhead,
                                                n=200)}.items():
        monkeypatch.setattr(jbench, name, fn)
    jbench.main()
    theirs = json.loads(capsys.readouterr().out)
    ours = _faked_world(n)

    assert ours["metric"] == theirs["metric"] == \
        f"allreduce_busbw_p50@4MiB[{n}dev]"
    assert set(ours) - set(theirs) == OWN_TOP
    assert set(theirs) <= set(ours)
    assert ("hier_vs_flat" in ours) is ("hier_vs_flat" in theirs) is (n == 4)
    (head, own), (jhead,) = ours["metrics"], theirs["metrics"]
    assert head["metric"] == jhead["metric"]
    assert set(head) - set(jhead) == OWN_METRIC
    assert head["runs_valid"] == jhead["runs_valid"]
    assert head["value"] == pytest.approx(jhead["value"], rel=1e-3)
    assert own["op"] == "pl_allreduce" and own["n_devices"] == n
    assert ours["card"] == [{"name": "cpu", "power_limit": "not measured"}] * n
    # no floor for the headline: one pass, no marker
    assert head["passes"] == 1 and "below_plateau_floor" not in head
    assert ours["arena_fence"] == "block"
    for key in ("scenario_step", "auto_vs_native", "vopt_vs_ring",
                "hier_vs_flat", "dispatch_overhead", "push_overhead"):
        if key in theirs:
            assert _keys(ours[key]) == _keys(theirs[key]), key
    assert set(theirs["contention"]) <= set(ours["contention"])


def test_the_headline_is_held_to_the_allreduce_nominal():
    payload = _faked_world(4)
    head = payload["metrics"][0]
    assert head["vs_baseline"] == pytest.approx(
        head["value"] / SXM.allreduce_nominal_gbps)
    assert head["vs_peak"] == pytest.approx(head["value"] / SXM.nvlink_gbps)
    assert "below_plateau_floor" not in head and head["passes"] == 1
    assert payload["vs_baseline"] == head["vs_baseline"]


def test_bench_across_a_gloo_world_of_two():
    outs = _gloo_world(2, _GLOO_BENCH)
    (line,) = outs[0][0].splitlines()
    assert outs[1][0] == ""
    payload = json.loads(line)
    assert payload["metric"] == "allreduce_busbw_p50@4MiB[2dev]"
    assert payload["value"] > 0 and payload["runs_valid"] >= 1
    assert payload["metrics"][0]["fence"] == "slope"
    own = payload["metrics"][1]
    assert (own["op"], own["n_devices"], own["backend"]) == (
        "pl_allreduce", 2, "torch")
    assert len(payload["card"]) == 2
    assert {"scenario_step", "auto_vs_native", "vopt_vs_ring", "phases",
            "contention", "dispatch_overhead", "push_overhead"} <= set(payload)
    assert "hier_vs_flat" not in payload


#: slope samples lost unevenly over a gloo world of 2 (the CPU bench's
#: fence): each case's lost run indices by rank, and whether it runs
#: under the adaptive stop; every rank prints each case's samples
LOST_CASES = {
    "some runs, each rank its own": ({0: {0, 2}, 1: {1}}, False),
    "every run on one rank": ({0: set(range(8)), 1: set()}, False),
    "every run on every rank": ({0: set(range(8)), 1: set(range(8))}, False),
    "some runs, adaptive": ({0: {0, 3}, 1: {5}}, True),
}
_GLOO_LOST = """
import json
import torch
from tpu_perf_torch import runner, timing
from tpu_perf_torch.adaptive import AdaptiveConfig
from tpu_perf_torch.config import Options
from tpu_perf_torch.parallel import initialize_distributed
from tpu_perf_torch.world import dist_world
initialize_distributed(device="cpu")
world = dist_world(torch.device("cpu"))
for case, (lost, adaptive) in CASES.items():
    lost, calls = lost[world.rank], [0]
    def fake(*a, **k):
        calls[0] += 1
        return None if calls[0] - 1 in lost else 1e-3 * (1 + world.rank)
    timing.slope_sample = fake
    opts = Options(op="allreduce", iters=2, num_runs=6, warmup_runs=1,
                   fence="slope", sim_ranks=2, device="cpu")
    cfg = (AdaptiveConfig(ci_rel=1e-9, min_runs=5, max_runs=6)
           if adaptive else None)
    try:
        point = runner.run_point(opts, world, 4096, adaptive=cfg)
        got = point.times.samples
    except timing.DegenerateSlopeError:
        got = "degenerate"
    print(json.dumps([case, got]), flush=True)
"""


@functools.lru_cache(maxsize=None)
def _lost_world() -> list[dict]:
    cases = {k: ({r: sorted(v) for r, v in lost.items()}, adaptive)
             for k, (lost, adaptive) in LOST_CASES.items()}
    outs = _gloo_world(2, f"CASES = {cases!r}\n" + _GLOO_LOST)
    return [dict(json.loads(ln) for ln in out.splitlines())
            for out, _ in outs]


@pytest.mark.parametrize("case", sorted(LOST_CASES))
def test_slope_samples_lost_on_one_rank_keep_the_ranks_in_step(case):
    # a rank that dropped a lost sample alone reduced a shorter list than
    # its peers', and one that lost them all raised while they waited: the
    # world hung.  Now every rank keeps the same runs, each the slowest
    # rank's, and a run lost on every rank is dropped on every rank.
    lost, _ = LOST_CASES[case]
    ranks = _lost_world()
    assert ranks[0][case] == ranks[1][case]
    got = ranks[0][case]
    if all(set(range(6)) <= v for v in lost.values()):
        assert got == "degenerate"
        return
    kept = [i for i in range(6) if not all(i in v for v in lost.values())]
    # each kept run is the slowest rank's that has it (rank 1: 2 ms an
    # execution, rank 0: 1 ms), whole runs of 2 executions
    assert got == pytest.approx([
        2 * (2e-3 if i not in lost[1] else 1e-3) for i in kept])


# --- the card table ---------------------------------------------------------


def test_the_sxm_constants_are_measured_and_under_its_peaks():
    assert SXM.defended
    assert 0 < SXM.stream_floor_gbps < SXM.hbm_gbps
    assert 0 < SXM.stream_nominal_gbps < SXM.hbm_gbps
    assert 0 < SXM.triad_nominal_gbps < SXM.hbm_gbps
    for dtype, peak in (("bfloat16", SXM.bf16_tflops),
                        ("float32", SXM.f32_tflops)):
        assert 0 < SXM.mxu_floor_tflops[dtype] < peak
    # a nominal only where a bench instrument reads it
    assert set(SXM.mxu_nominal_tflops) == {"bfloat16"}
    assert 0 < SXM.mxu_nominal_tflops["bfloat16"] < SXM.bf16_tflops
    assert 0 < SXM.allreduce_nominal_gbps < SXM.nvlink_gbps


@pytest.mark.parametrize("kind", ["h100-pcie", "h100-nvl"])
def test_derived_entries_follow_the_measured_ratios(kind):
    spec = chips.CARDS[kind]
    assert not spec.defended
    pairs = [(spec.stream_floor_gbps, SXM.stream_floor_gbps,
              spec.hbm_gbps / SXM.hbm_gbps),
             (spec.stream_nominal_gbps, SXM.stream_nominal_gbps,
              spec.hbm_gbps / SXM.hbm_gbps),
             (spec.triad_nominal_gbps, SXM.triad_nominal_gbps,
              spec.hbm_gbps / SXM.hbm_gbps),
             (spec.allreduce_nominal_gbps, SXM.allreduce_nominal_gbps,
              spec.nvlink_gbps / SXM.nvlink_gbps)]
    for table in ("mxu_floor_tflops", "mxu_nominal_tflops"):
        assert set(getattr(spec, table)) == set(getattr(SXM, table))
        pairs.append((getattr(spec, table)["bfloat16"],
                       getattr(SXM, table)["bfloat16"],
                       spec.bf16_tflops / SXM.bf16_tflops))
    pairs.append((spec.mxu_floor_tflops["float32"],
                  SXM.mxu_floor_tflops["float32"],
                  spec.f32_tflops / SXM.f32_tflops))
    for derived, measured, ratio in pairs:
        assert derived == pytest.approx(measured * ratio, abs=0.5)
    # floors and nominals under the card's own peaks
    assert spec.stream_floor_gbps < spec.hbm_gbps
    assert spec.mxu_floor_tflops["bfloat16"] < spec.bf16_tflops


def test_the_floor_rule():
    values = [1000.0, 1010.0, 990.0, 1005.0]
    # spread 20 / 1002.5 = 2%: 3 x 2% = 6% under the lowest 990, down to
    # 10 GB/s
    assert plateaus.spread(values) == pytest.approx(20 / 1002.5)
    assert plateaus.floor_of(values, 10.0) == 930.0
    # a tight plateau still keeps 5%
    assert plateaus.floor_of([700.0, 701.0], 1.0) == 665.0
    assert plateaus.nominal_of(values, 10.0) == 900.0


def _plateau_line(stream, triad, bf16, f32, neighbour=False):
    return {"card": {"name": "NVIDIA H100 80GB HBM3",
                     "power_limit": "700.00 W"},
            "values": {"hbm_stream": stream, "hbm_triad": triad,
                       "mxu_bf16": bf16, "mxu_f32": f32},
            "f32_unit": "TFLOP/s", "neighbour": neighbour}


def _nccl_line(head, eager):
    card = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    return {"ranks": 4, "rank": 0, "cards": [card] * 4,
            "headline": {"busbw_gbps_p50": head},
            "eager": {"busbw_gbps_p50": eager}}


def test_the_summary_applies_the_rule_to_the_healthy_processes():
    lines = [_plateau_line(1270.0, 1170.0, 700.0, 51.0),
             _plateau_line(1280.0, 1175.0, 720.0, 51.2),
             _plateau_line(1275.0, 1165.0, 710.0, 51.1),
             _plateau_line(590.0, 540.0, 360.0, 25.0, neighbour=True)]
    got = plateaus.summary(lines)
    assert got["processes"] == 3
    assert got["hbm_stream"]["p50s"] == [1270.0, 1280.0, 1275.0]
    assert got["hbm_stream"]["floor"] == plateaus.floor_of(
        [1270.0, 1280.0, 1275.0], 10.0)
    assert got["stream_floor_gbps"] == min(got["hbm_stream"]["floor"],
                                           got["hbm_triad"]["floor"])
    assert got["mxu_bf16"]["nominal"] == plateaus.nominal_of(
        [700.0, 720.0, 710.0], 1.0)
    assert got["neighbour"] == [{"hbm_stream": 590.0, "hbm_triad": 540.0,
                                 "mxu_bf16": 360.0}]
    assert "allreduce" not in got


def test_the_allreduce_nominal_is_the_headlines_own():
    # the nominal divides bench's headline, so it comes from the same
    # measurement; NCCL's eager timing is only printed beside it
    got = plateaus.summary([_nccl_line(144.0, 100.0),
                            _nccl_line(146.0, 130.0),
                            _nccl_line(145.0, 20.0)])
    ar = got["allreduce"]
    assert ar["p50s"] == [144.0, 146.0, 145.0]
    assert ar["nominal"] == plateaus.nominal_of([144.0, 146.0, 145.0], 10.0)
    assert ar["eager_median"] == 100.0 and ar["ranks"] == [4]
    assert ar["cards"] == ["NVIDIA H100 80GB HBM3, 700.00 W"]
    assert "hbm_stream" not in got


def test_the_plateau_points_are_benchs_instruments():
    names = [name for name, _ in bench.instrument_points()]
    assert names == ["hbm_stream", "hbm_triad", "mxu_gemm"]
    labels = [p[0] for _, pts in bench.instrument_points() for p in pts]
    assert labels == ["hbm_stream_busbw_p50@384MiB[1dev]",
                      "hbm_stream_busbw_p50@256MiB[1dev]",
                      "hbm_triad_busbw_p50@384MiB[1dev]",
                      "hbm_triad_busbw_p50@256MiB[1dev]",
                      "mxu_gemm_tflops_p50@m4096bf16[1dev]"]


def test_chips_table_has_the_operating_columns(capsys):
    assert cli.main(["chips", "--kind", "NVIDIA H100 80GB HBM3"]) == 0
    out = capsys.readouterr().out
    header = out.splitlines()[0]
    for col in ("stream nominal", "triad nominal", "stream floor",
                "mxu nominal bf16 / f32", "mxu floor bf16 / f32",
                "allreduce nominal", "floors"):
        assert f"| {col} |" in header + " |"
    sxm = [ln for ln in out.splitlines() if ln.startswith("| h100-sxm")]
    assert sxm[0].startswith("| h100-sxm (detected) |")
    assert sxm[0].endswith("| measured |")
    assert f"| {SXM.stream_floor_gbps:g} |" in sxm[0]
    assert out.count("| derived |") == 2


# --- grid judged against the card's floors ----------------------------------


@pytest.fixture
def sxm_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("argv,dtype", [
    (["--op", "hbm_stream", "--sizes", "4K", "--spec", "hbm"], None),
    (["--op", "mxu_gemm", "--sizes", "32K", "--spec", "mxu"], "float32"),
    (["--op", "mxu_gemm", "--sizes", "32K", "--spec", "mxu", "--dtype",
      "bfloat16"], "bfloat16"),
])
def test_grid_judges_a_cell_under_the_cards_floor_degraded(argv, dtype,
                                                           sxm_card, capsys):
    floor = (f"floor {SXM.stream_floor_gbps:g} GB/s" if dtype is None
             else f"floor {SXM.mxu_floor_tflops[dtype]:g} TFLOP/s")
    rc = cli.main(["grid", *argv, "--iters", "2", "-r", "2", "--device",
                   "cpu", "--sim-ranks", "1"])
    out, err = capsys.readouterr()
    assert rc == 4
    assert floor in out and "| degraded |" in out
    assert "grid specs from card table: h100-sxm (measured floors)" in err


def test_an_explicit_floor_wins_over_the_cards(sxm_card, capsys):
    rc = cli.main(["grid", "--op", "hbm_stream", "--sizes", "4K", "--iters",
                   "2", "-r", "2", "--device", "cpu", "--sim-ranks", "1",
                   "--spec", "hbm", "--floor-gbps", "1e-9"])
    out = capsys.readouterr().out
    assert rc == 0 and "floor 1e-09 GB/s" in out and "degraded" not in out


def test_a_derived_card_says_so(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 PCIe")
    cli.main(["grid", "--op", "hbm_stream", "--sizes", "4K", "--iters", "2",
              "-r", "2", "--device", "cpu", "--sim-ranks", "1", "--spec",
              "hbm"])
    out, err = capsys.readouterr()
    pcie = chips.CARDS["h100-pcie"]
    assert f"floor {pcie.stream_floor_gbps:g} GB/s" in out
    assert "h100-pcie (derived floors)" in err


def test_the_table_entries_are_frozen_records():
    with pytest.raises(dataclasses.FrozenInstanceError):
        SXM.stream_floor_gbps = 0.0
