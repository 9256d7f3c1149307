"""The port's fleet plane (``tpu_perf_torch.fleet``, ``fleet report``,
``fleet timeline``) against the JAX package's (``tpu_perf.fleet``) on the
same fleet roots.

A seeded fleet root (numpy draws each row's latency; one host carries a
planted slow point, one chaos rows, one arena rows whose winner disagrees
with its peers', one health events, a chaos ledger and degraded links; one
host is a real port driver's folder) goes through both packages:
``build_report`` under one injected clock renders the same markdown, JSON
artifact, Prometheus textfile and ``fleet-*.log`` records byte for byte;
both ``fleet report`` CLIs exit alike and write the same artifact,
textfile, records and merged selection with the clock-derived fields
dropped; the drain hook acts, fails into a ``drain_fail`` event and rate
limits alike.  The tuner's fleet half (``host_winner_table``,
``fleet_winners``, ``merge_fleet_selection``) mirrors
``tests/test_tuner.py``'s four cases; ``clock_offsets`` and
``stitch_hosts`` give JAX's output on seeded multi-host span sets, and
``fleet timeline`` prints JAX's bytes.  The streaming readers' contract
(torn lines, live tails, rotation races, quarantined files, bounded
memory) is held on the port alone.
"""

import glob
import io
import json
import os
import time

import numpy as np
import pytest

from tpu_perf import cli as jcli
from tpu_perf import fleet as jfleet
from tpu_perf.fleet import rollup as jrollup
from tpu_perf.fleet import timeline as jtimeline
from tpu_perf.schema import ResultRow as JRow

from tpu_perf_torch import cli
from tpu_perf_torch import fleet as tfleet
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.fleet import (
    DRAIN_STATE_FILE, build_report, discover_hosts, read_fleet_records,
    render_textfile, report_to_json, report_to_markdown, run_drain_hooks,
    write_fleet_records,
)
from tpu_perf_torch.fleet import rollup as trollup
from tpu_perf_torch.fleet import timeline as ttimeline
from tpu_perf_torch.fleet.collect import host_paths, stream_parsed, stream_rows
from tpu_perf_torch.schema import EXT_PREFIX, RESULT_HEADER, ResultRow
from tpu_perf_torch.trace import validate_chrome_trace
from tpu_perf_torch.tuner import load_artifact, read_artifact, write_artifact

NOW = 1_800_000_000.0


def _row(job="job-a", op="ring", nbytes=32, lat_us=1000.0, run_id=1,
         mode="daemon", dtype="float32", **kw):
    kw.setdefault("busbw_gbps", nbytes / lat_us / 1e3)
    return ResultRow(
        timestamp="2026-08-01 00:00:00.000", job_id=job, backend="torch-sim",
        op=op, nbytes=nbytes, iters=1, run_id=run_id, n_devices=8,
        lat_us=lat_us, algbw_gbps=nbytes / lat_us / 1e3,
        time_ms=lat_us / 1e3, dtype=dtype, mode=mode, **kw)


def _write_log(folder, lines, *, prefix=EXT_PREFIX, job="job-a", rank=0,
               stamp="20260801-000000", suffix=""):
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{prefix}-{job}-{rank}-{stamp}.log{suffix}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + ("\n" if lines else ""))
    return path


def _host_folder(root, host, lat_us, *, runs=30, job=None, mode="daemon"):
    folder = os.path.join(root, host)
    job = job or f"job-{host}"
    _write_log(folder, [
        _row(job=job, op="ring", nbytes=32, lat_us=lat_us, run_id=i,
             mode=mode).to_csv()
        for i in range(1, runs + 1)], job=job)
    return folder


def _fleet(root, lats, **kw):
    for host, lat in lats.items():
        _host_folder(root, host, lat, **kw)


# --- a seeded fleet root --------------------------------------------------

POINTS = (("ring", 32, 40.0), ("ring", 1024, 55.0), ("allreduce", 4096, 90.0))


def _seeded_root(root, seed, *, hosts=5, slow=3, runs=40):
    """``hosts`` synthetic host folders with numpy-drawn latencies (host
    ``slow`` three times slower at ring 1 KiB), one driver folder, and the
    other families a live fleet leaves behind."""
    rng = np.random.default_rng(seed)
    for h in range(hosts):
        host, job = f"host-{h}", f"job-{seed}-{h}"
        lines = [RESULT_HEADER]
        for op, nbytes, base in POINTS:
            factor = 3.0 if (h == slow and nbytes == 1024) else 1.0
            lats = base * factor * rng.lognormal(0.0, 0.05, runs)
            lines += [_row(job=job, op=op, nbytes=nbytes, lat_us=float(t),
                           run_id=i + 1).to_csv()
                      for i, t in enumerate(lats)]
        # an arena race: ring wins everywhere but on host-1
        for algo, base in (("", 90.0), ("ring", 60.0), ("rhd", 75.0)):
            if h == 1 and algo == "ring":
                base = 120.0
            lats = base * rng.lognormal(0.0, 0.02, 5)
            lines += [_row(job=job, op="allreduce", nbytes=4096,
                           lat_us=float(t), run_id=i + 1, mode="oneshot",
                           algo=algo).to_csv()
                      for i, t in enumerate(lats)]
        if h == 2:  # adaptive rows: the final row carries the verdict
            lines += [_row(job=job, op="ring", nbytes=64, lat_us=50.0 + i,
                           run_id=i + 1, mode="oneshot", runs_requested=50,
                           runs_taken=i + 1, ci_rel=0.2 / (i + 1)).to_csv()
                      for i in range(12)]
        if h == 4:  # a chaos soak's rows: never graded
            lines += [_row(job=job, op="ring", nbytes=32, lat_us=400.0,
                           run_id=i + 1, mode="chaos").to_csv()
                      for i in range(10)]
        _write_log(os.path.join(root, host), lines, job=job)
    folder = os.path.join(root, "host-1")
    events = [{"timestamp": "2026-08-01 00:00:01.000", "job_id": "j",
               "kind": kind, "severity": sev, "op": "ring", "nbytes": 32,
               "dtype": "float32", "run_id": rid, "window": 0,
               "observed": 2.0, "baseline": 1.0, "unit": "s"}
              for kind, sev, rid in (("regression", "critical", 9),
                                     ("spike", "warning", 4),
                                     ("recovered", "info", 12))]
    _write_log(folder, [json.dumps(e) for e in events], prefix="health",
               job="j", suffix=".open")
    folder = os.path.join(root, "host-4")
    _write_log(folder, [json.dumps({"record": "meta", "seed": 7}),
                        json.dumps({"record": "fault", "kind": "spike",
                                    "run_id": 3})], prefix="chaos", job="c")
    folder = os.path.join(root, "host-2")
    _write_log(folder, [json.dumps({
        "record": "verdict", "op": f"link:({i})>({i + 1})",
        "verdict": "slow" if i % 3 else "dead",
        "rel": float(rng.uniform(0.3, 3.0)), "rank": i % 2,
        "axis": "x"}) for i in range(25)], prefix="linkmap", job="l")
    # one host is a real port driver's folder: rows, spans, phase sidecar
    Driver(Options(op="ring", sweep="8,32", iters=1, num_runs=6,
                   fence="block", synthetic_s=1e-3, fault_seed=seed,
                   spans=True, stats_every=3, device="cpu", sim_ranks=8,
                   logfolder=os.path.join(root, "host-drv")),
           err=io.StringIO()).run()
    return root


def _both_reports(root, **kw):
    jcfg = kw.pop("jcfg", None)
    tcfg = kw.pop("tcfg", None)
    j = jfleet.build_report(root, now=NOW, err=io.StringIO(), config=jcfg,
                            **kw)
    t = build_report(root, now=NOW, err=io.StringIO(), config=tcfg, **kw)
    return j, t


@pytest.mark.parametrize("seed", range(3))
def test_the_report_renders_jaxs_bytes(tmp_path, seed):
    root = _seeded_root(str(tmp_path), seed)
    j, t = _both_reports(root)
    # host-3's planted point, and host-1's degraded ring arena curve
    assert t.sick_hosts == j.sick_hosts == ["host-1", "host-3"]
    assert report_to_markdown(t) == jfleet.report_to_markdown(j)
    assert report_to_json(t) == jfleet.report_to_json(j)
    assert render_textfile(t) == jfleet.render_textfile(j)
    recs = [r.to_json() for r in tfleet.fleet_records(t, job_id="fj")]
    assert recs == [r.to_json() for r in jfleet.fleet_records(j,
                                                              job_id="fj")]
    assert [d.host for d in t.tune_disagreements] == ["host-1"]


@pytest.mark.parametrize("knobs", [
    dict(mad_z=3.0, rel_threshold=0.1, min_hosts=2),
    dict(min_hosts=6),
    dict(stale_after=1.0),
], ids=["tight", "too-few-hosts", "all-stale"])
def test_grading_knobs_are_jaxs(tmp_path, knobs):
    root = _seeded_root(str(tmp_path), 11)
    j, t = _both_reports(root, jcfg=jrollup.FleetGradeConfig(**knobs),
                         tcfg=trollup.FleetGradeConfig(**knobs))
    assert report_to_markdown(t) == jfleet.report_to_markdown(j)
    assert report_to_json(t) == jfleet.report_to_json(j)


def test_a_baseline_shift_is_jaxs(tmp_path):
    root = _seeded_root(str(tmp_path / "cur"), 5)
    base = json.loads(report_to_json(build_report(root, now=NOW,
                                                  err=io.StringIO())))
    for point in base["fleet"]:
        point["fleet_lat_p50_us"] /= 2.0  # the fleet was twice as fast
    path = str(tmp_path / "base.json")
    with open(path, "w") as fh:
        json.dump(base, fh)
    baseline = trollup.load_baseline_artifact(path)
    assert baseline == jrollup.load_baseline_artifact(path)
    j, t = _both_reports(root, baseline=baseline)
    assert len(t.shifts) == len(j.shifts) > 0
    assert report_to_markdown(t) == jfleet.report_to_markdown(j)
    assert render_textfile(t) == jfleet.render_textfile(j)


# --- the CLIs on one root -------------------------------------------------

def _drop(data, *keys):
    if isinstance(data, dict):
        return {k: _drop(v, *keys) for k, v in data.items() if k not in keys}
    if isinstance(data, list):
        return [_drop(v, *keys) for v in data]
    return data


def _cli_side(main, root, out, extra=()):
    os.makedirs(out, exist_ok=True)
    argv = ["fleet", "report", root, "--format", "json",
            "-o", f"{out}/art.json", "--textfile", f"{out}/fleet.prom",
            "-l", f"{out}/logs", "--tune-out", f"{out}/sel.json", *extra]
    return main(argv)


def _fleet_logs(folder):
    return [_drop(r, "job_id", "age_s")
            for r in read_fleet_records(sorted(glob.glob(
                f"{folder}/fleet-*.log")))]


def test_both_fleet_reports_write_the_same_artifacts(tmp_path, capsys):
    root = _seeded_root(str(tmp_path / "root"), 2)
    outs = {}
    for side, main in (("jax", jcli.main), ("torch", cli.main)):
        capsys.readouterr()
        rc = _cli_side(main, root, str(tmp_path / side))
        outs[side] = (rc, json.loads(capsys.readouterr().out))
    (jrc, jout), (trc, tout) = outs["jax"], outs["torch"]
    assert trc == jrc == 9  # host-1 and host-3 graded sick
    assert _drop(tout, "generated", "age_s") == \
        _drop(jout, "generated", "age_s")
    arts = [json.load(open(tmp_path / s / "art.json")) for s in outs]
    assert _drop(arts[1], "generated", "age_s") == \
        _drop(arts[0], "generated", "age_s")
    proms = [[ln for ln in open(tmp_path / s / "fleet.prom").read()
              .splitlines() if "last_report_timestamp_seconds " not in ln]
             for s in outs]
    assert proms[1] == proms[0]
    assert _fleet_logs(tmp_path / "torch" / "logs") == \
        _fleet_logs(tmp_path / "jax" / "logs")
    sels = [_drop(json.load(open(tmp_path / s / "sel.json")), "generated",
                  "generated_unix", "device_kind", "chip") for s in outs]
    assert sels[1] == sels[0] and sels[1]["entries"]


def test_the_merged_artifact_takes_the_ports_card_table(tmp_path):
    root = _seeded_root(str(tmp_path), 4)
    hosts = build_report(root, now=NOW, err=io.StringIO()).hosts
    art = trollup.merge_fleet_selection(
        hosts, generated="g", generated_unix=1.0,
        device_kind="NVIDIA H100 80GB HBM3", source="fleet:x")
    assert art.fingerprint["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert art.fingerprint["chip"] == "h100-sxm"
    none = trollup.merge_fleet_selection(hosts, generated="g",
                                         generated_unix=1.0)
    assert none.fingerprint["chip"] == "" == none.fingerprint["device_kind"]


@pytest.mark.parametrize("argv,want", [
    (["--min-hosts", "1"], 2),
    (["--mad-z", "0"], 2),
    (["--baseline", "/nonexistent/base.json"], 2),
    (["--fail-on-stale"], 9),
    ([], 0),
], ids=["min-hosts", "mad-z", "baseline", "stale", "stale-alone"])
def test_the_exit_codes_are_jaxs(tmp_path, capsys, argv, want):
    root = str(tmp_path)
    _fleet(root, {"host-a": 1000.0, "host-b": 1001.0, "host-c": 1002.0})
    old = time.time() - 7200  # every host stale: exit 9 only when asked
    for p in glob.glob(os.path.join(root, "host-*", "*")):
        os.utime(p, (old, old))
    rcs = [main(["fleet", "report", root, *argv])
           for main in (jcli.main, cli.main)]
    assert rcs == [want, want]
    assert jcli.main(["fleet", "report", str(tmp_path / "none")]) == \
        cli.main(["fleet", "report", str(tmp_path / "none")]) == 1


# --- the drain hook -------------------------------------------------------

def _drain_roots(tmp_path):
    roots = []
    for side in ("jax", "torch"):
        root = str(tmp_path / side / "root")
        _fleet(root, {"host-a": 1000.0, "host-b": 1010.0,
                      "host-c": 3000.0, "host-d": 995.0})
        roots.append(root)
    return roots


def _drain_records(folder):
    return [_drop(r, "job_id", "age_s") for r in _fleet_logs(folder)
            if r["record"] == "drain"]


def test_the_drain_hook_acts_and_rate_limits_as_jax(tmp_path, capsys):
    roots = _drain_roots(tmp_path)
    calls = str(tmp_path / "calls")
    hook = f"echo >> {calls}"
    for n in (1, 2):  # the second pass falls inside --drain-interval
        recs = []
        for (side, main), root in zip((("jax", jcli.main),
                                       ("torch", cli.main)), roots):
            logs = str(tmp_path / side / f"logs{n}")
            assert main(["fleet", "report", root, "--drain-hook", hook,
                         "-l", logs]) == 9
            recs.append(_drain_records(logs))
        assert recs[1] == recs[0]
        assert recs[1] == [{"record": "drain", "host": "host-c",
                            "action": "invoked" if n == 1 else "rate-limited",
                            "rc": 0 if n == 1 else None, "error": ""}]
    # each package ran the hook once, with the host as its argument
    assert open(calls).read().split() == ["host-c", "host-c"]
    err = capsys.readouterr().err
    assert "rate-limited" in err and "drain hook invoked for host-c" in err
    states = [json.load(open(os.path.join(r, DRAIN_STATE_FILE)))
              for r in roots]
    assert list(states[1]) == list(states[0]) == ["host-c"]


def test_a_failing_hook_raises_one_critical_drain_fail(tmp_path, capsys):
    roots = _drain_roots(tmp_path)
    events = []
    for (side, main), root in zip((("jax", jcli.main), ("torch", cli.main)),
                                  roots):
        logs = str(tmp_path / side / "logs")
        assert main(["fleet", "report", root, "--drain-hook", "false",
                     "-l", logs]) == 9
        assert [(r["action"], r["rc"]) for r in _drain_records(logs)] == \
            [("failed", 1)]
        events.append([_drop(json.loads(ln), "timestamp", "job_id")
                       for p in sorted(glob.glob(f"{logs}/health-*.log"))
                       for ln in open(p)])
        spans = [json.loads(ln) for p in glob.glob(f"{logs}/spans-*.log")
                 for ln in open(p)]
        assert [s["kind"] for s in spans] == ["drain_hook"]
        assert spans[0]["attrs"]["error"] is True
    assert events[1] == events[0]
    assert [(e["kind"], e["severity"], e["op"]) for e in events[1]] == \
        [("drain_fail", "critical", "drain:host-c")]
    assert "drain hook FAILED for host-c" in capsys.readouterr().err


def test_a_healthy_fleet_never_drains(tmp_path):
    root = str(tmp_path)
    _fleet(root, {"host-a": 1000.0, "host-b": 1000.0, "host-c": 1001.0})
    calls = str(tmp_path / "calls")
    assert cli.main(["fleet", "report", root, "--drain-hook",
                     f"echo >> {calls}"]) == 0
    assert not os.path.exists(calls)
    assert not os.path.exists(os.path.join(root, DRAIN_STATE_FILE))


def test_run_drain_hooks_exports_the_host_and_survives_a_bad_runner(
        tmp_path):
    seen = []

    def runner(argv, env, **_kw):
        seen.append((argv[-1], env["TPU_PERF_SICK_HOST"]))
        if env["TPU_PERF_SICK_HOST"] == "host-b":
            raise OSError("cannot exec")

        class Done:
            returncode, stdout, stderr = 0, "drained\n", ""
        return Done()

    err = io.StringIO()
    out = run_drain_hooks(str(tmp_path), ["host-b", "host-a", "host-a"],
                          "drain", now=100.0, err=err, runner=runner)
    assert [(d.host, d.action) for d in out] == [("host-a", "invoked"),
                                                ("host-b", "failed")]
    assert seen == [("drain host-a", "host-a"), ("drain host-b", "host-b")]
    assert "drain hook [host-a] drained" in err.getvalue()
    later = run_drain_hooks(str(tmp_path), ["host-a"], "drain", now=200.0,
                            err=io.StringIO(), runner=runner)
    assert [d.action for d in later] == ["rate-limited"]


# --- the tuner's fleet half (tests/test_tuner.py's four cases) -------------

def _mk_rows(op, algo, lat_us, nbytes=1024, mode="oneshot", n=3):
    return [_row(op=op, algo="" if algo == "native" else algo,
                 nbytes=nbytes, lat_us=lat_us, busbw_gbps=1000.0 / lat_us,
                 mode=mode, run_id=i + 1) for i in range(n)]


def _arena_rows(winners):
    rows = []
    for nbytes, (native_lat, ring_lat) in winners.items():
        rows += _mk_rows("allreduce", "native", native_lat, nbytes=nbytes)
        rows += _mk_rows("allreduce", "ring", ring_lat, nbytes=nbytes)
        rows += _mk_rows("allreduce", "bruck",
                         max(native_lat, ring_lat) * 2, nbytes=nbytes)
    return rows


def _host_roll(host, rows, mod=trollup):
    roll = mod.HostRollup(host, f"/x/{host}")
    for r in rows:
        roll.fold_row(r if mod is trollup else JRow.from_csv(r.to_csv()))
    return roll


def _rolls(spec, mod=trollup):
    return {h: _host_roll(h, _arena_rows(w), mod) for h, w in spec.items()}


def test_host_winner_table_derives_from_decorated_points():
    rows = (_arena_rows({1 << 10: (9.0, 5.0)})
            + _mk_rows("allreduce", "ring", 1.0, nbytes=64, mode="chaos"))
    table = trollup.host_winner_table(_host_roll("h0", rows))
    (key,) = table
    assert key == ("allreduce", 1 << 10, "float32", 0, 1, "")
    row = table[key]
    assert row["winner"] == "ring"
    assert row["margin"] == pytest.approx(9.0 / 5.0)
    assert row["native_p50_us"] == pytest.approx(9.0)
    assert set(row["algos"]) == {"native", "ring", "bruck"}
    assert table == jrollup.host_winner_table(_host_roll("h0", rows, jrollup))


def test_fleet_winners_majority_and_disagreement():
    spec = {"host-a": {1024: (9.0, 5.0)}, "host-b": {1024: (9.0, 5.0)},
            "host-c": {1024: (9.0, 50.0)}}
    majority, disagreements = trollup.fleet_winners(_rolls(spec))
    (m,) = majority
    assert m["winner"] == "ring" and m["votes"] == 2 and m["hosts"] == 3
    (d,) = disagreements
    assert d.host == "host-c"
    assert d.local_winner == "native" and d.fleet_winner == "ring"
    assert d.to_record().data["record"] == "tune_disagreement"
    assert "host-c" in d.describe()
    jmaj, jdis = jrollup.fleet_winners(_rolls(spec, jrollup))
    assert majority == jmaj
    assert [d.to_record().to_json() for d in disagreements] == \
        [d.to_record().to_json() for d in jdis]


def test_merge_fleet_selection_is_auto_food(tmp_path):
    spec = {"host-a": {1024: (9.0, 5.0)}, "host-b": {1024: (9.0, 5.0)}}
    merged = trollup.merge_fleet_selection(
        _rolls(spec), generated="g", generated_unix=1.0, source="fleet:/x")
    (e,) = merged.entries
    assert e.winner == "ring" and e.samples == 6
    assert merged.fingerprint["hosts"] == 2
    path = str(tmp_path / "fleet-sel.json")
    write_artifact(merged, path)
    sel = load_artifact(path, n_devices=8)
    assert sel.resolve("allreduce", 1024, "float32", margin_min=1.02,
                       n_devices=8) == "ring"
    jmerged = jrollup.merge_fleet_selection(
        _rolls(spec, jrollup), generated="g", generated_unix=1.0,
        source="fleet:/x")
    assert json.loads(merged.to_json()) == json.loads(jmerged.to_json())


def test_fleet_report_surfaces_disagreements(tmp_path, capsys):
    root = tmp_path / "fleet"
    for host, winners in (("host-a", {1024: (9.0, 5.0)}),
                          ("host-b", {1024: (9.0, 5.0)}),
                          ("host-c", {1024: (9.0, 50.0)})):
        folder = root / host
        folder.mkdir(parents=True)
        with open(folder / "tpu-j-0.log", "w") as fh:
            fh.write(RESULT_HEADER + "\n")
            for r in _arena_rows(winners):
                fh.write(r.to_csv() + "\n")
    art = str(tmp_path / "fleet-sel.json")
    logdir = str(tmp_path / "rollup")
    rc = cli.main(["fleet", "report", str(root), "--stale-after", "1e18",
                   "--tune-out", art, "-l", logdir])
    out = capsys.readouterr().out
    assert rc == 9
    assert "Crossover winners" in out and "Crossover disagreements" in out
    assert "host-c" in out.split("Crossover disagreements")[1]
    merged = read_artifact(art)
    assert [(e.nbytes, e.winner) for e in merged.entries] == [(1024, "ring")]
    (path,) = glob.glob(os.path.join(logdir, "fleet-*.log"))
    (td,) = [r for r in read_fleet_records([path])
             if r["record"] == "tune_disagreement"]
    assert td["host"] == "host-c" and td["fleet_winner"] == "ring"


# --- clock alignment and stitching ----------------------------------------

def _span(job, rank, kind, sid, t0, dur, **attrs):
    return {"record": "span", "job_id": job, "span_id": sid,
            "parent_id": None, "rank": rank, "thread": "main",
            "t_start_ns": t0, "dur_ns": dur, "kind": kind, "attrs": attrs}


def _rank_spans(job, rank, skew_ns, rng=None, windows=2):
    out = []
    for w in range(windows):
        rid, barrier = 20 * (w + 1), 10_000_000 * (w + 1)
        jitter = int(rng.integers(0, 3_000)) if rng is not None else 0
        out.append(_span(job, rank, "run", f"r{rid}",
                         barrier - 500_000 - skew_ns, 400_000,
                         run_id=rid, op="ring", nbytes=32))
        out.append(_span(job, rank, "heartbeat", f"m{rid}",
                         barrier - 100_000 - skew_ns + jitter, 100_000,
                         run_id=rid, window=w))
    return out


def _seeded_hosts(seed):
    """Host -> spans: a job of 4 ranks over two hosts, and a job of its
    own on each of two more, every process on a numpy-drawn clock."""
    rng = np.random.default_rng(seed)
    skew = lambda: int(rng.integers(-4_000_000, 4_000_000))  # noqa: E731
    return {
        "host-a": _rank_spans("J", 0, 0, rng, 4)
        + _rank_spans("J", 1, skew(), rng, 4),
        "host-b": _rank_spans("J", 2, skew(), rng, 4)
        + _rank_spans("J", 3, skew(), rng, 4),
        "host-c": _rank_spans("C", 0, skew(), rng, 3),
        "host-d": [s for s in _rank_spans("D", 0, skew(), rng, 3)
                   + _rank_spans("D", 1, skew(), rng, 3)
                   if s["kind"] == "run"],
    }


@pytest.mark.parametrize("seed", range(4))
def test_stitch_hosts_is_jaxs(seed):
    hosts = _seeded_hosts(seed)
    for align in (True, False):
        jerr, terr = io.StringIO(), io.StringIO()
        assert ttimeline.stitch_hosts(hosts, align=align, err=terr) == \
            jtimeline.stitch_hosts(hosts, align=align, err=jerr)
        assert terr.getvalue().replace("tpu-perf-torch:", "tpu-perf:") == \
            jerr.getvalue()


@pytest.mark.parametrize("seed", range(4))
def test_clock_offsets_are_jaxs(seed):
    flat = [s for spans in _seeded_hosts(seed).values() for s in spans]
    got = ttimeline.clock_offsets(flat, err=io.StringIO())
    assert got == jtimeline.clock_offsets(flat, err=io.StringIO())
    assert set(got) == {("J", r) for r in range(4)} | {("C", 0), ("D", 0),
                                                        ("D", 1)}


def test_stitch_aligns_one_job_across_host_folders():
    hosts = {"host-a": _rank_spans("J", 0, 0),
             "host-b": _rank_spans("J", 1, 4_000_000)}
    spans, names = ttimeline.stitch_hosts(hosts, err=io.StringIO())
    ends = {s["rank"]: s["t_start_ns"] + s["dur_ns"] for s in spans
            if s["kind"] == "heartbeat" and s["attrs"]["run_id"] == 20}
    assert ends[0] == ends[1]
    assert sorted(names.values()) == ["host-a/rank 0", "host-b/rank 1"]


def _write_span_log(folder, spans, *, job, rank):
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"spans-{job}-{rank}-20260801-000000.log")
    with open(path, "w") as fh:
        for s in spans:
            fh.write(json.dumps(s, sort_keys=True) + "\n")
    return path


@pytest.mark.parametrize("seed", range(2))
def test_fleet_timeline_prints_jaxs_bytes(tmp_path, capsys, seed):
    root = str(tmp_path)
    for host, spans in _seeded_hosts(seed).items():
        for (job, rank) in sorted({(s["job_id"], s["rank"]) for s in spans}):
            _write_span_log(os.path.join(root, host),
                            [s for s in spans
                             if (s["job_id"], s["rank"]) == (job, rank)],
                            job=job, rank=rank)
    for extra in ([], ["--no-align"]):
        outs = []
        for main in (jcli.main, cli.main):
            capsys.readouterr()
            outs.append((main(["fleet", "timeline", root, *extra]),
                         capsys.readouterr().out))
        assert outs[1] == outs[0] and outs[1][0] == 0
    data = json.loads(outs[1][1])
    assert validate_chrome_trace(data) == []


def test_fleet_timeline_checks_driver_folders_as_jax(tmp_path, capsys):
    root = tmp_path / "fleet"
    for host in ("host-a", "host-b"):
        Driver(Options(op="ring", sweep="8", iters=1, num_runs=8,
                       fence="block", synthetic_s=1e-3, fault_seed=7,
                       uuid=f"job-{host}", spans=True, stats_every=4,
                       logfolder=str(root / host), device="cpu",
                       sim_ranks=8), err=io.StringIO()).run()
    outs = []
    for side, main in (("j", jcli.main), ("t", cli.main)):
        path = str(tmp_path / f"{side}.json")
        capsys.readouterr()
        rc = main(["fleet", "timeline", str(root), "--check", "-o", path])
        outs.append((rc, open(path).read(),
                     capsys.readouterr().err.count("join complete")))
    assert outs[1] == outs[0]
    assert outs[1][0] == 0 and outs[1][2] == 2
    data = json.loads(outs[1][1])
    assert {"heartbeat", "run"} <= {e.get("cat") for e in data["traceEvents"]}


def test_fleet_timeline_skips_a_corrupt_host(tmp_path, capsys):
    root = str(tmp_path)
    _write_span_log(os.path.join(root, "host-a"), _rank_spans("A", 0, 0),
                    job="A", rank=0)
    bad = os.path.join(root, "host-b", "spans-B-0-20260801-000000.log")
    os.makedirs(os.path.dirname(bad))
    with open(bad, "w") as fh:
        fh.write("{corrupt\n" + json.dumps(
            _span("B", 0, "run", "r1", 0, 10, run_id=1)) + "\n")
    out_path = str(tmp_path / "stitched.json")
    assert cli.main(["fleet", "timeline", root, "-o", out_path]) == 0
    err = capsys.readouterr().err
    assert "host-b" in err and "host skipped" in err
    procs = {e["args"]["name"] for e in json.load(open(out_path))[
        "traceEvents"] if e.get("ph") == "M" and e["name"] == "process_name"}
    assert procs == {"host-a/rank 0"}
    assert cli.main(["fleet", "timeline", str(tmp_path / "nowhere")]) == 1


# --- the streaming readers (the port alone) -------------------------------

def test_stream_rows_skips_header_and_torn_final_line(tmp_path, capsys):
    p = _write_log(str(tmp_path), [RESULT_HEADER, _row().to_csv(),
                                   _row(run_id=2).to_csv(), "torn,li"])
    err = io.StringIO()
    rows = list(stream_rows([p], err=err))
    assert [r.run_id for r in rows] == [1, 2]
    assert "torn final line" in err.getvalue()


def test_stream_rows_mid_file_corruption_raises(tmp_path):
    p = _write_log(str(tmp_path), [_row().to_csv(), "garbage",
                                   _row(run_id=2).to_csv()])
    with pytest.raises(ValueError):
        list(stream_rows([p], err=io.StringIO()))


def test_stream_reads_live_open_tail_and_rotation_races(tmp_path):
    live = _write_log(str(tmp_path), [_row().to_csv()], suffix=".open")
    assert host_paths(str(tmp_path), EXT_PREFIX) == [live]
    assert [r.run_id for r in stream_rows([live])] == [1]
    os.rename(live, live[: -len(".open")])
    err = io.StringIO()
    assert [r.run_id for r in stream_rows([live], err=err)] == [1]
    assert "rotated mid-read" in err.getvalue()
    os.remove(live[: -len(".open")])
    err = io.StringIO()
    assert list(stream_rows([live], err=err)) == []
    assert "vanished mid-read" in err.getvalue()


def test_quarantined_files_never_collected(tmp_path):
    folder = str(tmp_path / "host-a")
    _write_log(folder, [_row().to_csv()])
    _write_log(folder, [_row(lat_us=9e9).to_csv()], stamp="20260801-000001",
               suffix=".quarantined")
    rep = build_report(str(tmp_path), err=io.StringIO())
    assert rep.hosts["host-a"].rows == 1


def test_stream_parsed_is_a_generator_not_a_list(tmp_path):
    p = _write_log(str(tmp_path), [_row().to_csv()])
    it = stream_parsed([p], lambda ln: ln)
    assert iter(it) is it and not isinstance(it, list)


def test_discovery_and_the_rollup_folder(tmp_path):
    root = str(tmp_path)
    _fleet(root, {"host-a": 1000.0, "host-b": 1000.0, "host-c": 1000.0})
    (tmp_path / "empty").mkdir()
    rep = build_report(root, err=io.StringIO())
    write_fleet_records(os.path.join(root, "rollups"), rep,
                        job_id="fleet-job")
    assert sorted(discover_hosts(root)) == ["host-a", "host-b", "host-c"]
    single = _host_folder(str(tmp_path / "solo"), "only", 1000.0)
    assert list(discover_hosts(single)) == ["only"]


def test_fleet_records_roundtrip_and_ingest_routing(tmp_path):
    from tpu_perf_torch.ingest.pipeline import (
        LocalDirBackend, run_all_ingest_passes,
    )

    root = str(tmp_path / "fleet")
    _fleet(root, {"host-a": 1000.0, "host-b": 1000.0, "host-c": 3000.0})
    rep = build_report(root, err=io.StringIO())
    outdir = str(tmp_path / "rollup")
    write_fleet_records(outdir, rep, job_id="fleet-job")
    (path,) = glob.glob(os.path.join(outdir, "fleet-*.log"))
    recs = read_fleet_records([path])
    kinds = [r["record"] for r in recs]
    assert kinds.count("meta") == 1 and kinds.count("host") == 3
    assert next(r for r in recs if r["record"] == "meta")["sick_hosts"] == \
        ["host-c"]
    sink = str(tmp_path / "sink")
    assert run_all_ingest_passes(outdir, backend=LocalDirBackend(sink)) == 1
    assert glob.glob(os.path.join(sink, "fleet-*.log"))


def test_staleness_and_fleet_textfile(tmp_path):
    root = str(tmp_path)
    _fleet(root, {"host-a": 1000.0, "host-b": 1000.0})
    old = time.time() - 7200
    for p in glob.glob(os.path.join(root, "host-b", "*")):
        os.utime(p, (old, old))
    rep = build_report(root, err=io.StringIO())
    assert rep.stale_hosts == ["host-b"]
    text = render_textfile(rep)
    assert 'tpu_perf_fleet_host_stale{host="host-b"} 1' in text
    assert "tpu_perf_fleet_stale_hosts 1" in text
    assert "STALE" in report_to_markdown(rep)


def test_large_folder_streams_with_bounded_memory(tmp_path):
    import tracemalloc

    folder = str(tmp_path / "host-big")
    os.makedirs(folder)
    template = _row(lat_us=1000.0, run_id=1).to_csv()
    prefix, _, tail = template.partition(",ring,32,1,1,")
    n = 60_000
    with open(os.path.join(folder, "tpu-job-big-0-20260801-000000.log"),
              "w") as fh:
        fh.writelines(f"{prefix},ring,32,1,{i},{tail}\n"
                      for i in range(1, n + 1))
    tracemalloc.start()
    rep = build_report(folder, err=io.StringIO())
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    (roll,) = rep.hosts.values()
    assert roll.points[("ring", 32, "float32", "daemon")].runs == n
    assert peak < 8 * 1024 * 1024, f"peak {peak / 1e6:.1f} MB"


def test_a_corrupt_host_family_is_a_problem_not_a_crash(tmp_path):
    root = str(tmp_path)
    _fleet(root, {"host-a": 1000.0, "host-b": 1000.0, "host-c": 1000.0})
    _write_log(os.path.join(root, "host-b"), ["{bad", "{}"],
               prefix="health", job="h")
    j, t = _both_reports(root)
    assert t.hosts["host-b"].problems and t.hosts["host-a"].rows == 30
    assert report_to_json(t) == jfleet.report_to_json(j)


def test_the_file_commands_never_start_cuda(tmp_path, monkeypatch, capsys):
    """``fleet report`` (``--tune-out`` included), ``fleet timeline``,
    ``timeline`` and ``lint`` read files only: a collector host may have
    no card, so none of them may initialise CUDA, and none takes
    ``--device``."""
    import torch

    def refuse(*_a, **_k):
        raise AssertionError("a file-reading command initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(torch.cuda, "init", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    root = _seeded_root(str(tmp_path / "root"), 1)
    sel = str(tmp_path / "sel.json")
    assert cli.main(["fleet", "report", root, "--tune-out", sel]) == 9
    assert isinstance(read_artifact(sel).fingerprint["device_kind"], str)
    assert cli.main(["fleet", "timeline", root, "--check"]) == 0
    assert cli.main(["timeline", os.path.join(root, "host-drv")]) == 0
    assert cli.main(["lint"]) == 0
    for argv in (["fleet", "report", root], ["fleet", "timeline", root],
                 ["timeline", root], ["lint"]):
        with pytest.raises(SystemExit):
            cli.main(argv + ["--device", "cpu"])
