"""The port's ingest pipeline against ``tpu_perf.ingest``, on the CPU: the
same folder gives the same eligible files, the same ``LocalDirBackend``
output and the same quarantine and requeue in both packages.  Files are
compared by name and bytes, exactly."""

import os
import shutil
import subprocess
import sys

import pytest

import tpu_perf.ingest.pipeline as jpipe

from tpu_perf_torch import cli
from tpu_perf_torch.ingest import pipeline as pipe

UUID = "5abcb98a-985f-42a8-ae90-78124ed5dcc4"


def _folder(root):
    """Three rotated files of each family, with distinct mtimes, and files
    the scan must never pick up."""
    root.mkdir()
    for i in range(3):
        for prefix in ("tcp", "tpu"):
            path = root / f"{prefix}-{UUID}-0-2026010{i}-000000.log"
            path.write_text(f"{prefix} rows {i}\n")
            os.utime(path, (1_000_000 + 10 * i, 1_000_000 + 10 * i))
    (root / "tpu-perf.prom").write_text("not a log\n")
    (root / "tcp-old.log.quarantined").write_text("poison\n")
    (root / "phase-x-0.json").write_text("{}\n")
    return root


def _listing(folder):
    return {p.name: p.read_text() for p in sorted(folder.iterdir())
            if p.is_file()}


@pytest.mark.parametrize("prefix", ["tcp", "tpu"])
@pytest.mark.parametrize("skip", [0, 1, 2, 5])
def test_eligible_files_match_jax(tmp_path, prefix, skip):
    folder = _folder(tmp_path / "logs")
    ours = pipe.eligible_files(str(folder), skip, prefix=prefix)
    assert ours == jpipe.eligible_files(str(folder), skip, prefix=prefix)
    assert len(ours) == max(0, 3 - skip)
    assert ours == sorted(ours)  # oldest first: the names sort by time here


def test_eligible_files_refuses_a_negative_skip(tmp_path):
    for mod in (pipe, jpipe):
        with pytest.raises(ValueError, match="skip_newest"):
            mod.eligible_files(str(tmp_path), -1)
        assert mod.eligible_files(str(tmp_path / "none"), 0) == []


@pytest.mark.parametrize("skip", [0, 1])
def test_local_dir_backend_output_matches_jax(tmp_path, skip):
    ours, ref = _folder(tmp_path / "a"), tmp_path / "b"
    shutil.copytree(ours, ref)
    for d in (ours, ref):  # copytree keeps mtimes; make sure of it
        for p in d.iterdir():
            os.utime(p, (os.stat(ours / p.name).st_mtime,) * 2)
    n = pipe.run_all_ingest_passes(
        str(ours), skip_newest=skip,
        backend=pipe.LocalDirBackend(str(tmp_path / "sink_a")))
    m = jpipe.run_all_ingest_passes(
        str(ref), skip_newest=skip,
        backend=jpipe.LocalDirBackend(str(tmp_path / "sink_b")))
    assert n == m == 2 * (3 - skip)
    assert _listing(tmp_path / "sink_a") == _listing(tmp_path / "sink_b")
    assert _listing(ours) == _listing(ref)  # ingested files were deleted


class _Flaky(pipe.IngestBackend):
    """Fails every file whose name holds ``poison``."""

    def __init__(self):
        self.seen = []

    def ingest(self, path):
        self.seen.append(os.path.basename(path))
        if "poison" in path:
            raise OSError(f"rejected {os.path.basename(path)}")


def _poisoned(root):
    folder = _folder(root)
    bad = folder / "tcp-poison-0-20251231-000000.log"
    bad.write_text("bad row\n")
    os.utime(bad, (999_000, 999_000))
    return folder


def test_quarantine_and_requeue_match_jax(tmp_path):
    results = []
    for mod, name in ((pipe, "a"), (jpipe, "b")):
        folder = _poisoned(tmp_path / name)
        errors = 0
        for i in range(pipe.MAX_INGEST_FAILURES):
            # the poison file fails every pass; a fresh file in each pass
            # proves the backend alive, so the failures count
            fresh = folder / f"tcp-fresh{i}-0-20260201-000000.log"
            fresh.write_text("ok\n")
            try:
                mod.run_ingest_pass(str(folder), skip_newest=0,
                                    backend=_Flaky(), prefix="tcp")
            except OSError:
                errors += 1
        quarantined = [os.path.basename(p)
                       for p in mod.list_quarantined(str(folder))]
        restored = mod.requeue_quarantined(str(folder))
        results.append((errors, quarantined, restored, _listing(folder)))
    assert results[0] == results[1]
    errors, quarantined, restored, left = results[0]
    assert errors == pipe.MAX_INGEST_FAILURES - 1
    assert "tcp-poison-0-20251231-000000.log.quarantined" in quarantined
    assert sorted(restored) == ["tcp-old.log",
                               "tcp-poison-0-20251231-000000.log"]
    assert pipe.FAILURE_STATE_FILE not in left


def test_an_outage_quarantines_nothing(tmp_path):
    folder = _folder(tmp_path / "logs")

    class Down(pipe.IngestBackend):
        def ingest(self, path):
            raise OSError("backend down")

    for _ in range(pipe.MAX_INGEST_FAILURES + 1):
        with pytest.raises(OSError):
            pipe.run_ingest_pass(str(folder), skip_newest=0, backend=Down())
    assert [os.path.basename(p) for p in pipe.list_quarantined(str(folder))] \
        == ["tcp-old.log.quarantined"]


def test_backend_from_env_matches_jax(monkeypatch, tmp_path):
    for spec, kind in (("none", "NullBackend"), ("", "NullBackend"),
                       (f"local:{tmp_path}", "LocalDirBackend")):
        monkeypatch.setenv("TPU_PERF_INGEST", spec)
        assert type(pipe.build_backend_from_env()).__name__ == kind
        assert type(jpipe.build_backend_from_env()).__name__ == kind
    monkeypatch.delenv("TPU_PERF_INGEST")
    assert isinstance(pipe.build_backend_from_env(), pipe.NullBackend)
    for spec in ("local:", "bogus:x", "kusto:"):
        monkeypatch.setenv("TPU_PERF_INGEST", spec)
        with pytest.raises(ValueError):
            pipe.build_backend_from_env()
        with pytest.raises(ValueError):
            jpipe.build_backend_from_env()
    # the Kusto client is a lazy import, and nothing is installed for it
    monkeypatch.setenv("TPU_PERF_INGEST", "kusto:https://ingest.example")
    with pytest.raises(RuntimeError, match="azure-kusto-ingest"):
        pipe.build_backend_from_env()


def test_ingest_command_runs_the_port(monkeypatch):
    monkeypatch.delenv("TPU_PERF_INGEST_CMD", raising=False)
    assert pipe.ingest_command("/logs", 1) == [
        sys.executable, "-m", "tpu_perf_torch", "ingest", "-d", "/logs",
        "-f", "1"]
    monkeypatch.setenv("TPU_PERF_INGEST_CMD", "numactl -N 1 true")
    assert pipe.ingest_command("/logs", 1) == ["/bin/sh", "-c",
                                               "numactl -N 1 true"]


class _Proc:
    def __init__(self, rc=None):
        self.rc = rc

    def poll(self):
        return self.rc

    def wait(self, timeout=None):
        return 0 if self.rc is None else self.rc


def test_subprocess_ingest_skips_while_a_pass_runs(capsys):
    spawned = []

    def popen(cmd):
        spawned.append(cmd)
        return _Proc()

    hook = pipe.SubprocessIngest(["ingest"], popen=popen)
    hook()
    hook()  # the first pass is still running: nothing spawns
    assert len(spawned) == 1
    assert "still running" in capsys.readouterr().err
    hook._proc.rc = 3
    hook()  # the failed pass is reported, the next one spawns
    assert len(spawned) == 2
    assert "exited 3" in capsys.readouterr().err
    hook.finish()
    assert hook._proc is None


def test_ingest_cli_moves_rotated_files(tmp_path, monkeypatch, capsys):
    folder = _folder(tmp_path / "logs")
    monkeypatch.setenv("TPU_PERF_INGEST", f"local:{tmp_path / 'sink'}")
    assert cli.main(["ingest", "-d", str(folder), "-f", "1"]) == 0
    assert "ingested 4 files" in capsys.readouterr().err
    assert len(list((tmp_path / "sink").iterdir())) == 4
    assert cli.main(["ingest", "-d", str(folder), "--list-quarantined"]) == 0
    assert "tcp-old.log.quarantined" in capsys.readouterr().out
    assert cli.main(["ingest", "-d", str(folder), "--list-quarantined",
                     "--requeue"]) == 2
    assert "exclusive" in capsys.readouterr().err
    assert cli.main(["ingest", "-d", str(folder), "--requeue", "-f", "0"]) == 0
    assert "requeued 1" in capsys.readouterr().err
    assert sorted(p.name for p in folder.iterdir()) == ["phase-x-0.json",
                                                       "tpu-perf.prom"]


def test_the_ingest_process_loads_no_torch():
    # each rotation spawns `python -m tpu_perf_torch ingest`: it stays light
    probe = ("import sys, tpu_perf_torch.cli, tpu_perf_torch.ingest; "
             "print('torch' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], cwd=repo,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
