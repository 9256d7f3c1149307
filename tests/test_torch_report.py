"""The port's report against ``tpu_perf.report``, on the CPU: the same
rotated files go through both, and the curve points, JSON, CSV and
markdown must be equal.  The pivots keep different backends (the JAX
package's ``jax``, the port's ``torch`` and ``torch-sim``), so the JAX
side of ``compare`` and ``compare_pallas`` gets a copy of the rows with
``backend`` rewritten to ``jax``.  Everything compared is exact: both
sides summarize the same floats with the same code."""

import dataclasses
import json
import os

import pytest

import tpu_perf.cli as jax_cli
import tpu_perf.report as jreport
import tpu_perf.schema as jschema

from tpu_perf_torch import cli, report
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.schema import EXT_PREFIX, ResultRow


def _fake_clock(step):
    now = [1_000_000.0]

    def clock():
        now[0] += step
        return now[0]

    return clock


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Rotated logs of a few port runs (a clock that moves 10 minutes a
    call rotates the 15-minute logs every other row), plus an MPI
    baseline file for the backend pivot."""
    folder = tmp_path_factory.mktemp("logs")
    for op, sweep, ranks in (("pl_allreduce", "64,256", 8),
                             ("allreduce", "64,256", 8),
                             ("pl_hbm_copy", "64,1K", 1),
                             ("hbm_stream", "64,1K", 1),
                             ("pl_barrier", "64", 8)):
        opts = Options(op=op, sweep=sweep, iters=2, num_runs=3,
                       logfolder=str(folder), device="cpu", sim_ranks=ranks)
        Driver(opts, clock=_fake_clock(600)).run()
    mpi = [ResultRow(timestamp="2026-01-01 00:00:00.000", job_id="m",
                     backend="mpi", op="allreduce", nbytes=nbytes, iters=2,
                     run_id=i, n_devices=2, lat_us=10.0 * i + nbytes / 64,
                     algbw_gbps=1.0 + i, busbw_gbps=2.0 + i,
                     time_ms=0.02 * i)
           for nbytes in (64, 4096) for i in (1, 2, 3)]
    (folder / f"{EXT_PREFIX}-mpi-0-20260101-000000.log").write_text(
        "".join(r.to_csv() + "\n" for r in mpi))
    assert len(list(folder.glob("tpu-*.log"))) > 6
    return str(folder)


def _jax_points(paths, backend=None):
    rows = jreport.read_rows(paths)
    if backend is not None:
        rows = [dataclasses.replace(r, backend=backend)
                if r.backend.startswith("torch") else r for r in rows]
    return jreport.aggregate(rows)


def test_collect_paths_and_rows_match(logs):
    paths = report.collect_paths(logs)
    assert paths == jreport.collect_paths(logs)
    ours = report.read_rows(paths)
    assert [r.to_csv() for r in ours] == \
        [r.to_csv() for r in jreport.read_rows(paths)]
    assert report.collect_paths(os.path.join(logs, "tpu-*.log")) == paths
    assert report.collect_paths(paths[0]) == [paths[0]]


def test_aggregate_matches_jax(logs):
    paths = report.collect_paths(logs)
    ours = report.aggregate(report.read_rows(paths))
    ref = jreport.aggregate(jreport.read_rows(paths))
    assert [dataclasses.asdict(p) for p in ours] == \
        [dataclasses.asdict(p) for p in ref]
    # the streaming reader gives the buffered path's points exactly
    assert report.stream_aggregate(paths) == ours
    assert [dataclasses.asdict(p) for p in report.stream_aggregate(paths)] \
        == [dataclasses.asdict(p) for p in jreport.stream_aggregate(paths)]
    assert {p.backend for p in ours} == {"torch", "torch-sim", "mpi"}


@pytest.mark.parametrize("render", ["to_markdown", "to_json", "to_csv"])
def test_renderings_match_jax(logs, render):
    paths = report.collect_paths(logs)
    ours = getattr(report, render)(report.stream_aggregate(paths))
    ref = getattr(jreport, render)(jreport.stream_aggregate(paths))
    assert ours == ref
    if render == "to_json":
        assert {p["op"] for p in json.loads(ours)} >= {"pl_allreduce",
                                                       "allreduce"}


def test_compare_matches_jax_with_the_backend_renamed(logs):
    paths = report.collect_paths(logs)
    cmp = report.compare(report.stream_aggregate(paths))
    ref = jreport.compare(_jax_points(paths, backend="jax"))
    assert len(cmp) == len(ref)
    for c, r in zip(cmp, ref):
        assert (c.op, c.nbytes, c.dtype) == (r.op, r.nbytes, r.dtype)
        assert (c.busbw_ratio, c.latency_ratio) == (r.busbw_ratio,
                                                    r.latency_ratio)
    ours = report.compare_to_markdown(cmp)
    assert ours.replace("torch", "jax") == jreport.compare_to_markdown(ref)
    paired = [c for c in cmp if c.torch is not None and c.mpi is not None]
    assert [(c.op, c.nbytes) for c in paired] == [("allreduce", 64)]


def test_compare_pallas_matches_jax_with_the_backend_renamed(logs):
    paths = report.collect_paths(logs)
    ours = report.compare_pallas(report.stream_aggregate(paths))
    ref = jreport.compare_pallas(_jax_points(paths, backend="jax"))
    assert report.compare_pallas_to_markdown(ours) == \
        jreport.compare_pallas_to_markdown(ref)
    pairs = {(c.op, c.pallas_op, c.nbytes) for c in ours
             if c.xla is not None and c.pallas is not None}
    assert {("allreduce", "pl_allreduce", 256),
            ("hbm_stream", "pl_hbm_copy", 1024)} <= pairs
    assert report.PALLAS_COUNTERPARTS == jreport.PALLAS_COUNTERPARTS
    # without the rename the JAX pivot sees no accelerator rows at all
    assert not [c for c in jreport.compare_pallas(_jax_points(paths))
                if c.pallas is not None]


def test_legacy_views_match_jax(logs):
    paths = report.collect_paths(logs, prefix="tcp")
    assert paths == jreport.collect_paths(logs, prefix="tcp")
    ours = report.aggregate_legacy(report.read_legacy_rows(paths))
    ref = jreport.aggregate_legacy(jreport.read_legacy_rows(paths))
    assert [dataclasses.asdict(p) for p in ours] == \
        [dataclasses.asdict(p) for p in ref]
    assert report.legacy_to_markdown(ours) == jreport.legacy_to_markdown(ref)


def test_diff_matches_jax(logs, tmp_path):
    paths = report.collect_paths(logs)
    base_json = tmp_path / "base.json"
    base_json.write_text(report.to_json(report.stream_aggregate(paths)))
    # the new artifact: one point 20% slower, one missing
    rows = report.read_rows(paths)
    slow = [dataclasses.replace(r, busbw_gbps=r.busbw_gbps * 0.8)
            if (r.op, r.nbytes) == ("pl_allreduce", 256) else r
            for r in rows if r.op != "pl_barrier"]
    new_log = tmp_path / "new" / f"{EXT_PREFIX}-x-0-20260101-000000.log"
    new_log.parent.mkdir()
    new_log.write_text("".join(r.to_csv() + "\n" for r in slow))
    ours = report.diff_points(report.points_from_artifact(str(base_json)),
                              report.points_from_artifact(str(new_log.parent)))
    ref = jreport.diff_points(jreport.points_from_artifact(str(base_json)),
                              jreport.points_from_artifact(str(new_log.parent)))
    assert report.diff_to_markdown(ours) == jreport.diff_to_markdown(ref)
    verdicts = {(d.op, d.nbytes): d.verdict for d in ours}
    assert verdicts[("pl_allreduce", 256)] == "regressed"
    assert verdicts[("pl_barrier", 4)] == "base-only"
    assert set(verdicts.values()) == {"ok", "regressed", "base-only"}


@pytest.mark.parametrize("fmt", ["markdown", "json", "csv"])
def test_report_cli_matches_the_jax_cli(logs, fmt, capsys):
    assert cli.main(["report", logs, "--format", fmt]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main(["report", logs, "--format", fmt]) == 0
    assert ours == capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--compare-pallas"], ["--compare"],
                                   ["--legacy"]])
def test_report_cli_views(logs, flags, capsys):
    assert cli.main(["report", logs, *flags]) == 0
    out = capsys.readouterr().out
    assert out.startswith("| ")
    if flags == ["--compare-pallas"]:
        assert "| allreduce | pl_allreduce | 256 " in out


def test_report_cli_diff_gate(logs, tmp_path, capsys):
    base = tmp_path / "base.json"
    assert cli.main(["report", logs, "--format", "json"]) == 0
    base.write_text(capsys.readouterr().out)
    assert cli.main(["report", logs, "--diff", str(base)]) == 0
    assert "regressed" not in capsys.readouterr().out
    other = tmp_path / "other"
    other.mkdir()
    assert cli.main(["report", str(other), "--diff", str(base)]) == 1


@pytest.mark.parametrize("flags", [["--compare", "--compare-pallas"],
                                   ["--compare", "--format", "json"],
                                   ["--legacy", "--compare"],
                                   ["--diff", "x", "--compare"]])
def test_report_cli_refuses_exclusive_views(logs, flags, capsys):
    assert cli.main(["report", logs, *flags]) == 2
    assert "error" in capsys.readouterr().err


def test_report_cli_without_rows(tmp_path, capsys):
    assert cli.main(["report", str(tmp_path)]) == 1
    assert "no result files" in capsys.readouterr().err


def test_stream_rows_skips_a_torn_final_line_only(tmp_path, capsys):
    good = ResultRow(timestamp="t", job_id="j", backend="torch", op="ring",
                     nbytes=8, iters=1, run_id=1, n_devices=1, lat_us=1.0,
                     algbw_gbps=1.0, busbw_gbps=1.0, time_ms=0.001)
    torn = tmp_path / "tpu-a-0-1.log"
    torn.write_text(jschema.RESULT_HEADER + "\n" + good.to_csv() + "\n"
                    + good.to_csv()[:20])
    assert len(list(report.stream_rows([str(torn)]))) == 1
    assert "torn final line" in capsys.readouterr().err
    bad = tmp_path / "tpu-b-0-1.log"
    bad.write_text("garbage\n" + good.to_csv() + "\n")
    with pytest.raises(ValueError):
        list(report.stream_rows([str(bad)]))
    gone = str(tmp_path / "tpu-gone-0-1.log")
    assert list(report.stream_rows([gone])) == []
