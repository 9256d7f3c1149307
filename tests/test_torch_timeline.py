"""The port's ``timeline`` subcommand and its clock alignment
(``tpu_perf_torch.fleet.timeline``, ``trace.write_timeline``) against the
JAX package's on the same span files.

Span folders come from the port's own driver under injected clocks (a
chaos daemon with ``--spans`` and ``--health``, and a finite run), and
from seeded multi-rank span sets whose processes sit on clocks skewed by
numpy-drawn offsets.  Both packages' ``timeline`` print the same bytes
over them, with and without ``--no-align`` and ``--rank``, and ``--check``
exits alike: 0 on a complete join, 7 once a run span is taken away, 2 on
a file target.  The port's export of its own driver is byte-stable across
two runs under injected clocks (the JAX package's golden-file contract).
"""

import glob
import io
import json
import os

import numpy as np
import pytest

from tpu_perf import cli as jcli
from tpu_perf.fleet import timeline as jtl

from tpu_perf_torch import cli
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.faults import FaultSpec
from tpu_perf_torch.fleet import timeline as ttl
from tpu_perf_torch.trace import (
    chrome_trace_json, validate_chrome_trace, write_timeline,
)


class FakeClock:
    """Deterministic seconds clock (the driver's clock and perf_clock)."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def __call__(self):
        self.t += 1e-4
        return self.t


FAULTS = [FaultSpec(kind="spike", op="ring", nbytes=32, start=8, end=12,
                    magnitude=30.0),
          FaultSpec(kind="drop_run", op="ring", nbytes=8, start=13, end=16),
          FaultSpec(kind="hook_fail", start=18, end=20)]


def _opts(**kw):
    base = dict(op="ring,exchange", sweep="8,32", iters=1, num_runs=4,
                fence="block", synthetic_s=1e-3, fault_seed=7,
                uuid="job-fixed", spans=True, device="cpu", sim_ranks=8)
    base.update(kw)
    return Options(**base)


@pytest.fixture(scope="module")
def chaos_folder(tmp_path_factory):
    """A bounded chaos soak with spans on: spike, drop and hook_fail."""
    folder = tmp_path_factory.mktemp("chaos-spans")
    opts = _opts(op="ring", num_runs=-1, max_runs=24, logfolder=str(folder),
                 health=True, health_warmup=3, stats_every=5,
                 faults=list(FAULTS))
    Driver(opts, clock=FakeClock(), perf_clock=FakeClock(),
           err=io.StringIO()).run()
    return folder


def _both(capsys, argv):
    """(rc, stdout) of the JAX CLI and of the port's on ``argv``."""
    out = []
    for main in (jcli.main, cli.main):
        capsys.readouterr()
        rc = main(argv)
        out.append((rc, capsys.readouterr().out))
    return out


def _span(job, rank, kind, sid, t0, dur, **attrs):
    return {"record": "span", "job_id": job, "span_id": sid,
            "parent_id": None, "rank": rank, "thread": "main",
            "t_start_ns": t0, "dur_ns": dur, "kind": kind, "attrs": attrs}


def _rank_spans(job, rank, skew_ns, rng, *, windows=4, heartbeats=True):
    """One rank's spans on a clock ``skew_ns`` behind the job's: each
    heartbeat ends at a shared barrier instant (plus a few us of seeded
    jitter), its runs before it."""
    out = []
    for w in range(windows):
        rid = 10 * (w + 1)
        barrier = 10_000_000 * (w + 1)
        jitter = int(rng.integers(0, 5_000))
        out.append(_span(job, rank, "run", f"r{rid}",
                         barrier - 600_000 - skew_ns, 400_000,
                         run_id=rid, op="ring", nbytes=32))
        if heartbeats:
            out.append(_span(job, rank, "heartbeat", f"m{rid}",
                             barrier - 100_000 - skew_ns + jitter, 100_000,
                             run_id=rid, window=w))
    return out


def _write_span_log(folder, spans, *, job, rank):
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"spans-{job}-{rank}-20260801-000000.log")
    with open(path, "w") as fh:
        for s in spans:
            fh.write(json.dumps(s, sort_keys=True) + "\n")
    return path


def _skewed_world(rng, n=4, jobs=("J",), heartbeats=True):
    spans = []
    for job in jobs:
        for r in range(n):
            skew = 0 if r == 0 else int(rng.integers(-5_000_000, 5_000_000))
            spans += _rank_spans(job, r, skew, rng, heartbeats=heartbeats)
    return spans


# --- timeline over the port's soak: JAX's bytes --------------------------

@pytest.mark.parametrize("extra", [[], ["--no-align"], ["--rank", "0"],
                                   ["--check"]],
                         ids=["default", "no-align", "rank", "check"])
def test_timeline_prints_jaxs_bytes_over_the_ports_soak(chaos_folder,
                                                        capsys, extra):
    (jrc, jout), (trc, tout) = _both(capsys, ["timeline", str(chaos_folder)]
                                     + extra)
    assert (trc, tout) == (jrc, jout)
    assert trc == 0 and validate_chrome_trace(json.loads(tout)) == []


def test_timeline_writes_atomically_and_jaxs_bytes(chaos_folder, tmp_path,
                                                   capsys):
    paths = []
    for side, main in (("j", jcli.main), ("t", cli.main)):
        out = str(tmp_path / side / "timeline.json")
        assert main(["timeline", str(chaos_folder), "-o", out,
                     "--check"]) == 0
        assert not os.path.exists(out + ".tmp")
        paths.append(out)
    err = capsys.readouterr().err
    assert "join complete" in err and "tpu-perf-torch: wrote" in err
    assert open(paths[0]).read() == open(paths[1]).read()


def test_timeline_check_exits_7_on_a_broken_join_as_jax(chaos_folder,
                                                        tmp_path, capsys):
    """A run span taken out of the span log: the rows it enclosed no
    longer join, both packages exit 7 and still export the same trace."""
    folder = tmp_path / "broken"
    folder.mkdir()
    for path in glob.glob(str(chaos_folder / "*")):
        name = os.path.basename(path)
        text = open(path).read()
        if name.startswith("spans-"):
            lines = text.splitlines()
            drop = next(i for i, ln in enumerate(lines)
                        if json.loads(ln)["kind"] == "run")
            text = "\n".join(lines[:drop] + lines[drop + 1:]) + "\n"
        (folder / name).write_text(text)
    (jrc, jout), (trc, tout) = _both(capsys,
                                     ["timeline", str(folder), "--check"])
    assert jrc == trc == 7
    assert tout == jout


def test_timeline_exit_codes_are_jaxs(chaos_folder, tmp_path, capsys):
    (slog,) = glob.glob(str(chaos_folder / "spans-*.log"))
    cases = [(["timeline", slog, "--check"], 2),
             (["timeline", str(tmp_path)], 1),
             (["timeline", str(chaos_folder), "--rank", "5"], 1)]
    for argv, want in cases:
        (jrc, _), (trc, _) = _both(capsys, argv)
        assert jrc == trc == want, argv


def test_timeline_export_is_byte_stable_with_injected_clocks():
    def export_once():
        d = Driver(_opts(), clock=FakeClock(), perf_clock=FakeClock(),
                   err=io.StringIO())
        d.run()
        assert d.tracer.records
        return chrome_trace_json(d.tracer.records)

    assert export_once() == export_once()


def test_write_timeline_atomic(tmp_path):
    path = str(tmp_path / "sub" / "t.json")
    write_timeline(path, "{}\n")
    with open(path) as fh:
        assert fh.read() == "{}\n"
    assert not os.path.exists(path + ".tmp")


# --- clock alignment on seeded skews ----------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_skewed_ranks_align_to_jaxs_bytes(tmp_path, capsys, seed):
    rng = np.random.default_rng(seed)
    spans = _skewed_world(rng, n=2 + seed)
    for r in range(2 + seed):
        _write_span_log(str(tmp_path), [s for s in spans if s["rank"] == r],
                        job="J", rank=r)
    for extra in ([], ["--no-align"]):
        (jrc, jout), (trc, tout) = _both(capsys,
                                         ["timeline", str(tmp_path)] + extra)
        assert (trc, tout) == (jrc, jout) and trc == 0
    data = json.loads(tout)  # the --no-align export: skews stay
    raw = {e["pid"]: e["ts"] + e["dur"] for e in data["traceEvents"]
           if e.get("cat") == "heartbeat" and e["args"]["run_id"] == 10}
    assert len(set(raw.values())) > 1


@pytest.mark.parametrize("seed", range(6))
def test_clock_offsets_are_jaxs(seed):
    rng = np.random.default_rng(100 + seed)
    spans = _skewed_world(rng, n=3, jobs=("A", "B"),
                          heartbeats=seed % 2 == 0)
    jerr, terr = io.StringIO(), io.StringIO()
    want = jtl.clock_offsets(spans, err=jerr)
    got = ttl.clock_offsets(spans, err=terr)
    assert got == want
    assert ttl.align_spans(spans, got) == jtl.align_spans(spans, want)
    # the same notes, each under its package's own prefix
    assert terr.getvalue().replace("tpu-perf-torch:", "tpu-perf:") == \
        jerr.getvalue()
    if seed % 2:
        assert "approximate" in terr.getvalue()


def test_aligned_heartbeats_end_together():
    rng = np.random.default_rng(7)
    spans = _skewed_world(rng, n=4)
    aligned = ttl.align_spans(spans, ttl.clock_offsets(spans,
                                                       err=io.StringIO()))
    ends = {}
    for s in aligned:
        if s["kind"] == "heartbeat":
            ends.setdefault(s["attrs"]["run_id"], []).append(
                s["t_start_ns"] + s["dur_ns"])
    for run_id, e in ends.items():
        assert max(e) - min(e) < 10_000, run_id  # within the jitter


def test_jobs_never_align_across_each_other():
    rng = np.random.default_rng(3)
    spans = (_rank_spans("A", 0, 0, rng)
             + _rank_spans("B", 0, 7_000_000, rng))
    assert ttl.clock_offsets(spans, err=io.StringIO()) == {("A", 0): 0,
                                                           ("B", 0): 0}


# --- a gloo world of 2: one job, aligned on its heartbeats ------------------

_WORKER = """
import sys
from tpu_perf_torch import cli
sys.exit(cli.main(["monitor", "--distributed", "--device", "cpu", "--op",
                   "allreduce", "-b", "4K", "-i", "1", "--max-runs", "40",
                   "--stats-every", "10", "--spans", "-l", sys.argv[1]]))
"""


def test_a_gloo_worlds_ranks_share_one_job_and_align(tmp_path, capsys):
    """Every rank of a ``--distributed`` world carries rank 0's job ID
    (the reference broadcasts its run UUID), so ``timeline`` aligns the
    ranks on their heartbeat boundaries: each rank gets an offset from
    the heartbeat anchors, and ``--check`` finds every join complete."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from tpu_perf_torch.report import collect_paths, read_rows
    from tpu_perf_torch.spans import read_span_records

    repo = Path(__file__).resolve().parent.parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = tmp_path / "logs"
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(repo),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(logs)], cwd=repo, env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        f"rank {r} rc {p.returncode}:\n{err[-2000:]}"
        for r, (p, (_, err)) in enumerate(zip(procs, outs)))
    rows = read_rows(collect_paths(str(logs)))
    assert len({r.job_id for r in rows}) == 1 and len(rows) == 80
    spans = read_span_records(collect_paths(str(logs), prefix="spans",
                                            include_open=True))
    err = io.StringIO()
    offsets = ttl.clock_offsets(spans, err=err)
    assert sorted(r for _, r in offsets) == [0, 1]
    assert len({job for job, _ in offsets}) == 1
    assert err.getvalue() == ""  # heartbeat anchors, no fallback
    capsys.readouterr()
    assert cli.main(["timeline", str(logs), "--check"]) == 0
    assert "join complete" in capsys.readouterr().err
