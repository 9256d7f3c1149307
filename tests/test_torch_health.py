"""The port's health subsystem (``tpu_perf_torch.health``) against the JAX
package's (``tpu_perf.health``) on the same seeded sample streams.

Both packages run the same arithmetic on the same Python floats, so every
comparison is exact: the estimators' values, each detector's findings run
by run, the monitor's events (timestamps masked), the textfile's bytes,
and the ``health`` subcommand's output over one folder of logs.  The
JSONL families (health, chaos, spans) ride the port's ingest pass.
"""

import dataclasses
import io
import json

import numpy as np
import pytest

import tpu_perf.health as jh
from tpu_perf import cli as jcli
from tpu_perf.health import events as jev
from tpu_perf.health import exporter as jexp

import tpu_perf_torch.health as th
from tpu_perf_torch import cli
from tpu_perf_torch.health import events as tev
from tpu_perf_torch.health import exporter as texp
from tpu_perf_torch.ingest.pipeline import LocalDirBackend, run_all_ingest_passes

SEEDS = (0, 1, 7)


def _stream(seed: int, n: int = 400, *, shape: str = "clean") -> list[float]:
    """A seeded latency stream around 1 ms with relative noise; ``shape``
    plants a step (x2 from half way), a spike (x30 at three eighths), a
    flatline (60 samples from half way pinned) or lognormal tails."""
    rng = np.random.default_rng(seed)
    x = 1e-3 * (1.0 + 1e-3 * rng.standard_normal(n))
    half = n // 2
    if shape == "step":
        x[half:] *= 2.0
    elif shape == "spike":
        x[n * 3 // 8] *= 30.0
    elif shape == "flatline":
        x[half:half + 60] = x[half]
    elif shape == "tails":
        x *= np.exp(0.1 * rng.standard_normal(n))
    return [float(v) for v in x]


SHAPES = ("clean", "step", "spike", "flatline", "tails")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("q", (0.5, 0.99))
def test_p2_quantile_is_jaxs(seed, q):
    a, b = jh.P2Quantile(q), th.P2Quantile(q)
    for v in _stream(seed, shape="tails"):
        a.push(v)
        b.push(v)
        assert a.value() == b.value()


@pytest.mark.parametrize("seed", SEEDS)
def test_ewma_and_point_baseline_are_jaxs(seed):
    a, b = jh.PointBaseline(warmup=20), th.PointBaseline(warmup=20)
    ea, eb = jh.EWMA(0.2), th.EWMA(0.2)
    for i, v in enumerate(_stream(seed, shape="flatline")):
        longrun = i % 7 != 0
        a.update(v, longrun=longrun)
        b.update(v, longrun=longrun)
        ea.push(v)
        eb.push(v)
        assert (a.n, a.ready, a.flat_run, a.ewma.value, a.p50.value(),
                a.p99.value(), a.welford.mean, a.welford.std()) == (
            b.n, b.ready, b.flat_run, b.ewma.value, b.p50.value(),
            b.p99.value(), b.welford.mean, b.welford.std())
        assert ea.value == eb.value


@pytest.mark.parametrize("kw", [
    dict(alpha=0.0), dict(q=1.0), dict(warmup=0)])
def test_estimator_checks_are_jaxs(kw):
    for mod in (jh, th):
        with pytest.raises(ValueError):
            if "alpha" in kw:
                mod.EWMA(kw["alpha"])
            elif "q" in kw:
                mod.P2Quantile(kw["q"])
            else:
                mod.PointBaseline(**kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_point_detector_findings_are_jaxs_run_by_run(seed, shape):
    cfg = dict(threshold=0.5, warmup=30)
    a = jh.PointDetector(jh.HealthConfig(**cfg))
    b = th.PointDetector(th.HealthConfig(**cfg))
    fired = 0
    for v in _stream(seed, shape=shape):
        fa = [dataclasses.astuple(f) for f in a.observe(v)]
        fb = [dataclasses.astuple(f) for f in b.observe(v)]
        assert fa == fb
        fired += len(fa)
    assert (a.regressed, a.flatlined) == (b.regressed, b.flatlined)
    if shape in ("step", "spike", "flatline"):
        assert fired  # the planted fault was judged, by both alike


@pytest.mark.parametrize("dropped,total", [(0, 10), (3, 10), (5, 10),
                                           (10, 10), (0, 0)])
def test_capture_loss_finding_is_jaxs(dropped, total):
    a = jh.capture_loss_finding(dropped, total, jh.HealthConfig())
    b = th.capture_loss_finding(dropped, total, th.HealthConfig())
    assert (a is None) == (b is None)
    if a is not None:
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


def _feed(mod, textfile=None):
    """One monitor fed the same seeded visits of two points, with drops,
    a hook failure and heartbeats; returns (monitor, events, stderr)."""
    err = io.StringIO()
    mon = mod.HealthMonitor(
        mod.HealthConfig(threshold=0.5, warmup=20), job_id="job",
        dtype="float32", rank=0, stats_every=25, textfile=textfile, err=err,
        phase_source=lambda: {"compile_s": 1.5, "measure_s": 2.25,
                              "log_s": 0.125},
        adaptive_source=lambda: {"runs_saved": 7, "last_ci_rel": 0.0375})
    streams = {8: _stream(3, 300, shape="spike"),
               32: _stream(4, 300, shape="step")}
    events = []
    for run_id in range(1, 401):
        nbytes = 8 if run_id % 2 else 32
        t = streams[nbytes][(run_id - 1) // 2 % 300]
        if 101 <= run_id <= 140 and nbytes == 8:
            mon.observe_drop("ring", run_id)
        else:
            events += mon.observe("ring", nbytes, 1, 8, run_id, t,
                                  span_id=f"r{run_id}")
        if run_id == 170:
            events += mon.observe_hook_fail(run_id, span_id="r170")
        if run_id % 25 == 0:
            events += mon.heartbeat(run_id)
    mon.close()
    return mon, events, err.getvalue()


def _masked(text: str) -> str:
    data = json.loads(text)
    for e in data:
        e["timestamp"] = "ts"
    return json.dumps(data, sort_keys=True)


def test_the_monitor_emits_jaxs_events():
    ja, ea, erra = _feed(jh)
    tb, eb, errb = _feed(th)
    kinds = {e.kind for e in ea}
    assert {"spike", "regression", "capture_loss", "hook_fail"} <= kinds
    assert _masked(jev.events_to_json(ea)) == _masked(tev.events_to_json(eb))
    assert (jev.events_to_markdown(jev.summarize_events(ea))
            == tev.events_to_markdown(tev.summarize_events(eb)))
    assert ja.events_total == tb.events_total
    # the console lines differ by the package's prefix alone
    assert erra.replace("[tpu-perf health]", "") == \
        errb.replace("[tpu-perf-torch health]", "")


def test_the_monitor_textfile_is_jaxs(tmp_path):
    _feed(jh, textfile=str(tmp_path / "jax.prom"))
    _feed(th, textfile=str(tmp_path / "torch.prom"))
    a = (tmp_path / "jax.prom").read_bytes()
    assert a == (tmp_path / "torch.prom").read_bytes()
    assert b"tpu_perf_health_lat_p50_us" in a
    assert b"tpu_perf_adaptive_runs_saved_total 7" in a


@pytest.mark.parametrize("severity", ["info", "warning", "critical"])
def test_render_textfile_is_byte_identical(severity):
    def gauges(mod):
        return [mod.PointGauges(op=op, nbytes=nb, dtype="float32",
                                samples=100 + nb, lat_p50_us=12.5 * nb,
                                lat_p99_us=19.75 * nb, busbw_gbps=1.0 / nb,
                                severity=severity)
                for op, nb in (("ring", 8), ("pl_allreduce", 4096),
                               ('odd"op\\', 3))]

    args = ({"ring": 0.25, "pl_allreduce": 0.0}, {"spike": 2, "flatline": 1},
            {"compile_s": 0.5, "measure_s": 12.0, "log_s": 0.03125},
            {"runs_saved": 3, "last_ci_rel": 0.01})
    assert (jexp.render_textfile(gauges(jexp), *args)
            == texp.render_textfile(gauges(texp), *args))


def test_push_gauges_wait_for_the_push_plane():
    with pytest.raises(NotImplementedError, match="3b"):
        texp.render_textfile([], {}, {}, push={"sent": 1})


def test_health_subcommand_output_is_jaxs(tmp_path, capsys):
    """`health` and `health --format json` over one folder of events print
    the same text through either package."""
    _, events, _ = _feed(th)
    folder = tmp_path / "logs"
    folder.mkdir()
    (folder / "health-job-0-20260101-000000.log").write_text(
        "".join(e.to_json() + "\n" for e in events[:5]))
    (folder / "health-job-0-20260101-000100.log.open").write_text(
        "".join(e.to_json() + "\n" for e in events[5:]))
    for fmt in ("markdown", "json"):
        assert jcli.main(["health", str(folder), "--format", fmt]) == 0
        want = capsys.readouterr().out
        assert cli.main(["health", str(folder), "--format", fmt]) == 0
        assert capsys.readouterr().out == want
    assert cli.main(["health", str(tmp_path / "none")]) == 1
    assert "no health logs" in capsys.readouterr().err


def test_events_round_trip_through_either_package():
    _, events, _ = _feed(th)
    for e in events:
        assert dataclasses.asdict(jev.HealthEvent.from_json(e.to_json())) \
            == dataclasses.asdict(e)


def test_the_jsonl_families_ride_the_ingest_pass(tmp_path):
    """Finished health/chaos/spans files go to the sink whatever their
    count (the lazy families skip no newest file); an active .open file
    stays; the CSV families keep their newest-N skip."""
    logs, sink = tmp_path / "logs", tmp_path / "sink"
    logs.mkdir()
    names = [f"{p}-job-0-2026010{i}-000000.log"
             for p in ("health", "chaos", "spans", "tcp", "tpu")
             for i in (1, 2)]
    for n in names:
        (logs / n).write_text('{"record": "x"}\n')
    (logs / "spans-job-0-20260103-000000.log.open").write_text("{}\n")
    n = run_all_ingest_passes(str(logs), skip_newest=1,
                              backend=LocalDirBackend(str(sink)))
    assert n == 8
    left = sorted(p.name for p in logs.iterdir())
    assert left == ["spans-job-0-20260103-000000.log.open",
                    "tcp-job-0-20260102-000000.log",
                    "tpu-job-0-20260102-000000.log"]
    assert len(list(sink.iterdir())) == 8
