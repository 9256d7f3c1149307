"""The port's monitoring daemon (``monitor``, ``run -r -1``) against the
JAX package's, on the CPU: its rows, its log rotation and the ingest hook
that each rotation fires.  Rows are compared field by field on what does
not depend on timing (op, size, iterations, run id, ranks, mode), exactly.
"""

import os
import sys

import pytest

import tpu_perf.config as jconfig
import tpu_perf.driver as jdriver
import tpu_perf.schema as jschema
from tpu_perf.parallel import make_mesh

from tpu_perf_torch import cli
from tpu_perf_torch import ingest as tingest
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver, RotatingCsvLog


class _Clock:
    """A fake wall clock that moves ``step`` seconds a call."""

    def __init__(self, step):
        self.now, self.step = 1_000_000.0, step

    def __call__(self):
        self.now += self.step
        return self.now


def _rows(folder, prefix="tpu"):
    rows = []
    for name in sorted(os.listdir(folder)):
        if name.startswith(prefix + "-"):
            text = (folder / name).read_text().splitlines()
            parse = (jschema.ResultRow if prefix == "tpu"
                     else jschema.LegacyRow).from_csv
            rows += [parse(ln) for ln in text if ln.strip()]
    return rows


def _key(r):
    return (r.op, r.nbytes, r.iters, r.run_id, r.n_devices, r.mode)


@pytest.mark.parametrize("fence", ["block", "fused", "slope"])
def test_daemon_rows_rotate_and_fire_one_ingest_per_rotation(tmp_path, fence):
    calls = []
    opts = Options(op="pl_allreduce", sweep="64,256", iters=2, num_runs=-1,
                   max_runs=9, fence=fence, log_refresh_sec=1,
                   logfolder=str(tmp_path), device="cpu")
    # the fake clock moves 0.3 s a call: the logs rotate every few runs
    drv = Driver(opts, clock=_Clock(0.3), on_rotate=lambda: calls.append(1))
    assert drv.run() == []  # a daemon keeps its rows in the logs only
    rows = _rows(tmp_path)
    assert [r.run_id for r in rows] == list(range(1, 10))
    assert [r.nbytes for r in rows] == [64, 256] * 4 + [64]
    assert {r.mode for r in rows} == {"daemon"}
    assert len(_rows(tmp_path, "tcp")) == 9
    tcp = [n for n in os.listdir(tmp_path) if n.startswith("tcp-")]
    assert len(calls) == len(tcp) - 1 >= 2  # one pass per rotation


def test_a_failing_hook_never_stops_the_daemon(tmp_path, capsys):
    def hook():
        raise RuntimeError("sink down")

    opts = Options(op="hbm_stream", buff_sz=64, iters=1, num_runs=-1,
                   max_runs=8, log_refresh_sec=1, logfolder=str(tmp_path),
                   device="cpu", sim_ranks=1)
    drv = Driver(opts, clock=_Clock(0.4), on_rotate=hook)
    drv.run()
    assert drv.log.hook_failures >= 2
    assert "ingest hook failed: sink down" in capsys.readouterr().err
    assert [r.run_id for r in _rows(tmp_path)] == list(range(1, 9))


def test_rotation_never_fires_on_the_first_open(tmp_path):
    fired = []
    log = RotatingCsvLog(str(tmp_path), "u", 0, refresh_sec=10,
                         clock=_Clock(1), on_rotate=lambda: fired.append(1))
    assert log.maybe_rotate() is False and fired == []
    assert [log.maybe_rotate() for _ in range(10)].count(True) == 1
    assert fired == [1]
    log.close()


def test_daemon_rows_match_the_jax_daemon(tmp_path, eight_devices):
    kw = dict(op="allreduce", sweep="64,256", iters=2, num_runs=-1)
    ours = tmp_path / "port"
    Driver(Options(**kw, max_runs=5, logfolder=str(ours),
                   device="cpu")).run()
    ref = tmp_path / "jax"
    jdriver.Driver(jconfig.Options(**kw, logfolder=str(ref)), make_mesh(),
                   max_runs=5).run()
    port, jax_rows = _rows(ours), _rows(ref)
    assert [_key(r) for r in port] == [_key(r) for r in jax_rows]
    assert [r.to_csv().count(",") for r in port] == \
        [r.to_csv().count(",") for r in jax_rows]
    assert [(r.buffer_size, r.num_buffers, r.run_id)
            for r in _rows(ours, "tcp")] == \
        [(r.buffer_size, r.num_buffers, r.run_id) for r in _rows(ref, "tcp")]


class _FakeIngest:
    made = []

    def __init__(self, cmd):
        self.cmd, self.calls, self.finished = cmd, 0, False
        _FakeIngest.made.append(self)

    def __call__(self):
        self.calls += 1

    def finish(self):
        self.finished = True


@pytest.mark.parametrize("argv", [["monitor"], ["run", "-r", "-1"]])
def test_monitor_is_wired_to_the_ingest_subprocess(tmp_path, monkeypatch,
                                                    capsys, argv):
    monkeypatch.setattr(tingest, "SubprocessIngest", _FakeIngest)
    _FakeIngest.made.clear()
    assert cli.main(argv + ["--op", "pl_all_to_all", "--sweep", "64,128",
                            "-i", "1", "--fence", "fused", "--max-runs", "4",
                            "--device", "cpu", "-l", str(tmp_path)]) == 0
    assert capsys.readouterr().out == ""
    (hook,) = _FakeIngest.made
    assert hook.cmd == [sys.executable, "-m", "tpu_perf_torch", "ingest",
                        "-d", str(tmp_path), "-f", "1"]
    assert hook.finished  # an in-flight pass is drained at exit
    rows = _rows(tmp_path)
    assert [(r.run_id, r.nbytes, r.mode) for r in rows] == [
        (1, 64, "daemon"), (2, 128, "daemon"), (3, 64, "daemon"),
        (4, 128, "daemon")]


def test_a_bad_combination_fails_before_run_one(tmp_path):
    opts = Options(op="pl_allreduce", sweep="64,128", dtype="int32",
                   num_runs=-1, max_runs=3, logfolder=str(tmp_path),
                   device="cpu")
    with pytest.raises(ValueError, match="float dtype"):
        Driver(opts).run()
    assert not any(p.stat().st_size for p in tmp_path.iterdir())


def test_points_of_one_spec_share_one_example_buffer(monkeypatch):
    # pl_all_gather at 4 and 8 B gathered over 8 ranks: one element a rank
    seen = []
    measure = Driver._measure

    def spy(self, built, built_hi):
        seen.append((built.nbytes, id(built.example_input)))
        return measure(self, built, built_hi)

    monkeypatch.setattr(Driver, "_measure", spy)
    Driver(Options(op="pl_all_gather", sweep="4,8", iters=1, num_runs=-1,
                   max_runs=4, device="cpu")).run()
    assert [nb for nb, _ in seen] == [32, 32, 32, 32]
    assert len({buf for _, buf in seen}) == 1


def test_daemon_heartbeats_and_ignores_profile_dir(tmp_path, capsys):
    opts = Options(op="ring", buff_sz=64, iters=1, num_runs=-1, max_runs=4,
                   stats_every=2, profile_dir=str(tmp_path / "p"),
                   device="cpu")
    Driver(opts).run()
    err = capsys.readouterr().err
    assert "--profile-dir is ignored in daemon mode" in err
    assert "run 2:" in err and "run 4:" in err
    assert not (tmp_path / "p").exists()


@pytest.mark.parametrize("kw", [dict(num_runs=0), dict(num_runs=-2)])
def test_run_count_errors_are_the_jax_packages(kw):
    with pytest.raises(ValueError) as ours:
        Options(**kw)
    with pytest.raises(ValueError) as ref:
        jconfig.Options(**kw)
    assert str(ours.value) == str(ref.value)


def test_max_runs_is_the_daemons_valve_only(capsys):
    assert Options(num_runs=-1).infinite and not Options().infinite
    with pytest.raises(ValueError, match="max_runs must be >= 1"):
        Options(num_runs=-1, max_runs=0)
    with pytest.raises(ValueError, match="stop-after-N"):
        Options(max_runs=3)
    assert cli.main(["run", "--max-runs", "3", "--device", "cpu"]) == 2
    assert "adaptive cap" in capsys.readouterr().err
