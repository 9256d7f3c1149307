"""The port's adaptive stop rule (``tpu_perf_torch.adaptive``) against the
JAX package's (``tpu_perf.adaptive``) on the same seeded sample streams,
and the lockstep vote across the ranks of gloo worlds.

Every comparison is exact: both packages run the same arithmetic on the
same Python floats (the t table, Welford's moments, the order-statistic
interval), so they stop at the same run with the same ``ci_rel``.  The
gloo worlds give each rank its own sample stream; every rank must still
take the same number of runs, through the controller alone and through
the driver's finite run.
"""

import json
import math
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import tpu_perf.adaptive as jad

from tpu_perf_torch import adaptive as tad
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.health.stats import Welford

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 240


@pytest.mark.parametrize("confidence", tad.SUPPORTED_CONFIDENCES)
def test_t_critical_is_jaxs_at_every_df(confidence):
    assert tad.SUPPORTED_CONFIDENCES == jad.SUPPORTED_CONFIDENCES
    for df in range(1, 400):
        assert tad.t_critical(df, confidence) == jad.t_critical(df,
                                                                 confidence)
    for bad in ((0, confidence), (5, 0.5)):
        with pytest.raises(ValueError) as ours:
            tad.t_critical(*bad)
        with pytest.raises(ValueError) as theirs:
            jad.t_critical(*bad)
        assert str(ours.value) == str(theirs.value)


def test_welford_is_jaxs():
    from tpu_perf.health.stats import Welford as JWelford

    xs = np.random.default_rng(3).lognormal(0.0, 0.4, 200).tolist()
    ours, theirs = Welford(), JWelford()
    for x in xs:
        ours.push(x)
        theirs.push(x)
        assert (ours.n, ours.mean, ours.variance()) == (
            theirs.n, theirs.mean, theirs.variance())


@pytest.mark.parametrize("kw", [
    dict(ci_rel=1.5), dict(ci_rel=0.0), dict(statistic="p90"),
    dict(confidence=0.8), dict(min_runs=1), dict(min_runs=6, max_runs=5),
])
def test_adaptive_config_checks_are_jaxs(kw):
    with pytest.raises(ValueError) as ours:
        tad.AdaptiveConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jad.AdaptiveConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def _stream(seed: int, n: int, spread: float, tail: float = 0.0):
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(np.log(1e-3), spread, n)
    if tail:
        # a heavy tail: now and then a run 5x slower
        xs = np.where(rng.random(n) < tail, xs * 5, xs)
    return xs.tolist()


def _drive(mod, cfg_kw, xs, *, chunk=0, drops=()):
    """Run a controller of ``mod`` over the stream: per run, or per chunk
    of ``chunk`` runs (the chunk's mean one observation); ``drops`` the
    runs lost to noise.  Returns the stop run, ci_rel and the summary."""
    c = mod.PointController(mod.AdaptiveConfig(**cfg_kw))
    runs = 0
    cis = []
    if chunk:
        for i in range(0, len(xs), chunk):
            part = xs[i:i + chunk]
            runs += len(part)
            c.observe_chunk(sum(part) / len(part), len(part))
            cis.append(c.ci_rel())
            if c.should_stop(runs):
                break
    else:
        for x in xs:
            runs += 1
            c.observe(None if runs in drops else x)
            cis.append(c.ci_rel())
            if c.should_stop(runs):
                break
    return runs, cis, c.summary()


@pytest.mark.parametrize("statistic", ["mean", "p50"])
@pytest.mark.parametrize("spread,tail", [(0.01, 0.0), (0.05, 0.0),
                                         (0.2, 0.0), (0.03, 0.1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_controller_stops_where_jaxs_does(statistic, spread, tail, seed):
    xs = _stream(seed, 60, spread, tail)
    kw = dict(ci_rel=0.02, min_runs=5, max_runs=50, statistic=statistic)
    ours, theirs = _drive(tad, kw, xs), _drive(jad, kw, xs)
    assert ours == theirs
    assert 5 <= ours[0] <= 50


@pytest.mark.parametrize("kw", [
    dict(ci_rel=0.5, min_runs=2, max_runs=3),     # the budget first
    dict(ci_rel=0.5, min_runs=7, max_runs=7),     # min equals max
    dict(ci_rel=1e-6, min_runs=3, max_runs=20),   # never converges
    dict(ci_rel=0.05, confidence=0.99, min_runs=4, max_runs=40),
    dict(ci_rel=0.05, confidence=0.90, min_runs=4, max_runs=40),
])
def test_the_bounds_are_jaxs(kw):
    xs = _stream(9, 60, 0.05)
    ours, theirs = _drive(tad, kw, xs), _drive(jad, kw, xs)
    assert ours == theirs
    assert kw["min_runs"] <= ours[0] <= kw["max_runs"]


def test_dropped_runs_consume_budget_as_jaxs_do():
    xs = _stream(4, 60, 0.1)
    kw = dict(ci_rel=0.03, min_runs=5, max_runs=30)
    drops = {2, 6, 7, 11}
    assert _drive(tad, kw, xs, drops=drops) == _drive(jad, kw, xs,
                                                      drops=drops)


@pytest.mark.parametrize("chunk", [5, 7])
@pytest.mark.parametrize("seed", [0, 5])
def test_chunk_observations_are_jaxs(chunk, seed):
    xs = _stream(seed, 50, 0.08)
    kw = dict(ci_rel=0.02, min_runs=5, max_runs=50)
    ours = _drive(tad, kw, xs, chunk=chunk)
    assert ours == _drive(jad, kw, xs, chunk=chunk)
    assert ours[0] % chunk == 0 or ours[0] == 50
    with pytest.raises(ValueError, match="reps must be positive"):
        tad.PointController(tad.AdaptiveConfig()).observe_chunk(1.0, 0)


def test_the_vote_is_injectable_and_unanimous():
    votes = []

    def vote(local):
        votes.append(local)
        return False  # another rank is not done yet

    c = tad.PointController(tad.AdaptiveConfig(min_runs=2, max_runs=6),
                            vote=vote)
    runs = 0
    for x in [1.0] * 10:
        runs += 1
        c.observe(x)
        if c.should_stop(runs):
            break
    # no vote before min_runs; each later round votes; the budget cannot
    # stop a rank alone either
    assert runs == 10 and votes[0] is True and len(votes) == 9
    assert c.stopped_at is None


class _Card:
    def __init__(self, free, total=80 << 30):
        self.free, self.total = free, total

    def mem_get_info(self):
        return self.free, self.total


class _JaxDevice:
    def __init__(self, free, total=80 << 30):
        self.stats = {"bytes_limit": total, "bytes_in_use": total - free}

    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize("free,point", [
    (40 << 30, 256 << 20), (40 << 30, 2 << 30), (1 << 20, 256 << 20),
    (80 << 30, 4096), (40 << 30, 0),
])
def test_hbm_depth_cap_with_an_injected_card(free, point):
    ours = tad.hbm_depth_cap(point, device=_Card(free))
    assert ours == jad.hbm_depth_cap(point, device=_JaxDevice(free))
    assert 1 <= ours <= 64


def test_hbm_depth_cap_falls_back_without_memory_figures():
    import torch

    class Broken:
        def mem_get_info(self):
            raise RuntimeError("no figures")

    assert tad.hbm_depth_cap(1 << 20, device=Broken()) == 8
    assert tad.hbm_depth_cap(1 << 20, device=_Card(1 << 30, 0)) == 8
    assert tad.hbm_depth_cap(1 << 20, device=torch.device("cpu")) == 8
    with pytest.raises(ValueError, match="point_bytes"):
        tad.hbm_depth_cap(-1)


@pytest.mark.parametrize("kw", [dict(), dict(min_points=0, max_depth=4),
                                dict(initial=3, max_depth=16)])
def test_the_precompile_tuner_follows_jaxs_depths(kw):
    ratios = [(0.0, 1.0), (5.0, 1.0), (2.5, 1.0), (0.4, 1.0), (9.0, 0.5),
              (30.0, 1.0), (1.0, 0.0), (0.2, 2.0)]
    ours, theirs = tad.PrecompileTuner(**kw), jad.PrecompileTuner(**kw)
    seq = [(ours.update(c, m), theirs.update(c, m)) for c, m in ratios]
    assert all(a == b for a, b in seq)
    assert {a for a, _ in seq} != {1}


# --- the lockstep vote across the ranks of a gloo world -----------------


_WORKER = textwrap.dedent("""
    import itertools, json, sys
    import numpy as np
    import torch.distributed as dist
    from tpu_perf_torch import adaptive
    from tpu_perf_torch.config import Options
    from tpu_perf_torch.driver import Driver
    from tpu_perf_torch.parallel import initialize_distributed

    out = sys.argv[1]
    initialize_distributed(device="cpu")
    r, n = dist.get_rank(), dist.get_world_size()
    # each rank its own stream: rank r's spread grows with r, so the ranks
    # would stop at different runs alone
    rng = np.random.default_rng(100 + r)
    xs = rng.lognormal(np.log(1e-3), 0.01 + 0.06 * r, 60).tolist()
    cfg = adaptive.AdaptiveConfig(ci_rel=0.02, min_runs=5, max_runs=50)
    alone = adaptive.PointController(cfg)
    c = adaptive.PointController(cfg, n_hosts=n)
    stops = {}
    for name, ctl in (("alone", alone), ("voted", c)):
        runs = 0
        for x in xs:
            runs += 1
            ctl.observe(x)
            if ctl.should_stop(runs):
                break
        stops[name] = runs
    # the driver's finite run, each rank's samples its own
    it = itertools.cycle(xs)
    orig = Driver._measure
    Driver._measure = lambda self, built, hi: next(it)
    opts = Options(op="allreduce", sweep="64,256", iters=1, ci_rel=0.02,
                   min_runs=5, max_runs=50, distributed=True, sim_ranks=1,
                   device="cpu")
    rows = Driver(opts).run()
    Driver._measure = orig
    taken = {str(nb): max(rw.runs_taken for rw in rows if rw.nbytes == nb)
             for nb in {rw.nbytes for rw in rows}}
    with open(f"{out}/rank{r}.json", "w") as fh:
        json.dump({"stops": stops, "taken": taken,
                   "runs": len(rows)}, fh)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n", [2, 4])
def test_every_rank_takes_the_same_runs_when_their_samples_differ(
        n, tmp_path):
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path)], cwd=REPO,
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(n)]
    alone = [g["stops"]["alone"] for g in got]
    voted = {g["stops"]["voted"] for g in got}
    # alone the ranks would stop apart; voting, together, at the slowest
    assert len(set(alone)) > 1
    assert voted == {max(alone)}
    # the driver: every rank takes the same runs at every point
    assert len({json.dumps(g["taken"], sort_keys=True) for g in got}) == 1
    assert len({g["runs"] for g in got}) == 1
    assert all(5 <= t <= 50 for t in got[0]["taken"].values())


def test_a_finite_max_runs_needs_ci_rel_and_the_daemon_keeps_its_valve():
    with pytest.raises(ValueError, match="adaptive cap and needs --ci-rel"):
        Options(max_runs=3)
    assert Options(max_runs=3, ci_rel=0.05).max_runs == 3
    assert Options(num_runs=-1, max_runs=3).max_runs == 3
    with pytest.raises(ValueError, match="needs --ci-rel"):
        Options(ci_statistic="p50")
    with pytest.raises(ValueError, match="min_runs must be >= 2"):
        Options(ci_rel=0.05, min_runs=1)


@pytest.mark.parametrize("kw,why", [
    (dict(num_runs=-1, max_runs=3), "daemon mode"),
    (dict(fence="trace"), "the trace fence"),
    (dict(streams=2), "overlapped dispatch"),
    (dict(extern_cmd="echo"), "extern mode"),
    (dict(num_runs=5, min_runs=5), "not above --min-runs"),
])
def test_the_bypasses_are_loud(kw, why, capsys):
    import io

    err = io.StringIO()
    kw = dict(dict(num_runs=20), **kw)
    d = Driver(Options(op="allreduce", ci_rel=0.05, device="cpu", **kw),
               err=err)
    assert d._adaptive_cfg is None
    assert why in err.getvalue() and "fixed budget" in err.getvalue()


def test_p50_under_fused_falls_back_to_the_mean_loudly():
    import io

    err = io.StringIO()
    d = Driver(Options(op="allreduce", ci_rel=0.05, ci_statistic="p50",
                       fence="fused", num_runs=20, device="cpu"), err=err)
    assert d._adaptive_cfg.statistic == "mean"
    assert "not available under --fence fused" in err.getvalue()
    # the vote fires a chunk at a time: ceil(budget / min_runs) chunks
    assert d._fused_plan == (5, 5, 5, 5)


@pytest.mark.parametrize("fence", ["block", "readback", "slope", "fused"])
def test_an_adaptive_run_stamps_its_rows(fence, tmp_path):
    from tpu_perf_torch import report

    opts = Options(op="allreduce", sweep="64,4K", iters=2, ci_rel=0.3,
                   min_runs=3, max_runs=12, fence=fence, device="cpu",
                   logfolder=str(tmp_path))
    d = Driver(opts)
    rows = d.run()
    for nb in {r.nbytes for r in rows}:
        pts = [r for r in rows if r.nbytes == nb]
        assert all(r.runs_requested == 12 for r in pts)
        last = max(pts, key=lambda r: r.run_id)
        assert 3 <= last.runs_taken <= 12
        if last.run_id < 12:
            assert 0 < last.ci_rel <= 0.3
    tot = d.adaptive_totals
    assert tot["points"] == 2 and tot["runs_requested"] == 24
    assert tot["runs_saved"] == 24 - tot["runs_attempted"]
    side = json.loads(next(tmp_path.glob("phase-*.json")).read_text())
    assert side["adaptive"]["points"] == 2
    savings = report.adaptive_savings(rows)
    assert [(p.op, p.runs_requested) for p in savings] == [
        ("allreduce", 12)] * 2
    assert math.isclose(sum(p.runs_requested - p.runs_attempted
                            for p in savings), tot["runs_saved"])
