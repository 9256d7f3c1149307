"""``run --backend mpi`` in the port against ``tpu_perf.mpi_launch``, on the
CPU: the same command lines (the binary's path and the ingest command
aside), the same refusals, and the repo's C baseline built by the port
into its own build directory (never into ``backends/mpi/``), whose rows
both packages' schemas parse and whose ``exchange`` and ``pingpong``
rows ``report --compare`` pairs with the port's on the same
``(op, nbytes)`` key.  Everything compared is exact."""

import dataclasses
import os
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import tpu_perf.config as jconfig
import tpu_perf.mpi_launch as jmpi
import tpu_perf.schema as jschema

from tpu_perf_torch import cli, mpi_launch, report
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.ingest import ingest_command
from tpu_perf_torch.schema import LegacyRow, ResultRow

REPO = Path(__file__).resolve().parent.parent

#: options both packages take, spelled alike
PLANS = [
    dict(op="exchange", nonblocking=True, buff_sz=65536, iters=40,
         num_runs=3),
    dict(op="pingpong", buff_sz=4096, iters=50, num_runs=2),
    dict(op="pingpong_unidir", uni_dir=True, buff_sz=456131, iters=10,
         num_runs=-1, ppn=10, n_group1=1),
    dict(op="pingpong", nonblocking=True, buff_sz=64, ppn=2),
    dict(op="allreduce", buff_sz=4096, ppn=3),
    dict(op="barrier", sweep="8:1K"),
    dict(op="hbm_stream", sweep="4K,64K", num_runs=4),
    dict(op="all_to_all", buff_sz=1 << 20, logfolder="/mnt/tcp-logs"),
]


def _both(kw, tmp_path):
    """The same Options in both packages; a group-1 file where -n needs
    one."""
    kw = dict(kw)
    if kw["op"] in ("pingpong", "pingpong_unidir", "exchange"):
        path = tmp_path / "group1"
        path.write_text("host1\n")
        kw["group1_file"] = str(path)
    return Options(**kw), jconfig.Options(**kw)


@pytest.mark.parametrize("hosts", [None, "host0,host1"])
@pytest.mark.parametrize("kw", PLANS)
def test_plan_command_matches_jax_but_the_binary(kw, hosts, tmp_path):
    ours, ref = _both(kw, tmp_path)
    assert mpi_launch.mpi_sizes_for(ours) == jmpi.mpi_sizes_for(ref)
    for nbytes in mpi_launch.mpi_sizes_for(ours):
        got = mpi_launch.plan_command(ours, nbytes, hosts=hosts)
        want = jmpi.plan_command(ref, nbytes, hosts=hosts)
        name = "mpi_perf" if hosts else "mpi_perf_shim"
        i = want.index(str(jmpi.backend_dir() / name))
        assert got[i] == str(mpi_launch.BUILD_DIR / name)
        assert got[:i] + got[i + 1:] == want[:i] + want[i + 1:]
        assert mpi_launch.driver_argv(ours, nbytes) == \
            jmpi.driver_argv(ref, nbytes)


@pytest.mark.parametrize("kw,hosts", [
    (dict(op="ring"), None), (dict(op="pingpong"), "h0,h1"),
    (dict(op="allreduce"), ","), (dict(op="allreduce", sweep="8,64",
                                       num_runs=-1), None),
])
def test_plan_refusals_match_jax(kw, hosts):
    def ours():
        opts = Options(**kw)
        for nb in mpi_launch.mpi_sizes_for(opts):
            mpi_launch.plan_command(opts, nb, hosts=hosts)

    def ref():
        opts = jconfig.Options(**kw)
        for nb in jmpi.mpi_sizes_for(opts):
            jmpi.plan_command(opts, nb, hosts=hosts)

    with pytest.raises(ValueError) as got:
        ours()
    with pytest.raises(ValueError) as want:
        ref()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,message", [
    (dict(dtype="bfloat16"), "--dtype bfloat16 is"),
    (dict(extern_cmd="srv {role}"), "-d/--extern-cmd (print-only"),
])
def test_run_refusals_keep_the_jax_messages(kw, message):
    with pytest.raises(ValueError) as got:
        mpi_launch.run_mpi_backend(Options(**kw), dry_run=True)
    with pytest.raises(ValueError) as want:
        jmpi.run_mpi_backend(jconfig.Options(**kw), dry_run=True)
    assert message in str(got.value) and message in str(want.value)
    # the backend each package names as the one that takes the flag
    assert str(got.value) == str(want.value).replace("jax-", "torch-")


def test_window_and_profile_dir_are_noted_and_ignored(capsys):
    opts = Options(op="exchange", nonblocking=True, window=8,
                   profile_dir="/nonexistent")
    assert mpi_launch.run_mpi_backend(opts, dry_run=True) == 0
    captured = capsys.readouterr()
    assert "--window ignored for --backend mpi" in captured.err
    assert "--profile-dir is torch-backend only" in captured.err
    (line,) = captured.out.splitlines()
    assert shlex.split(line)[0] == str(mpi_launch.BUILD_DIR / "mpi_perf_shim")


def test_dry_run_prints_one_mpirun_line_and_launches_nothing(
        monkeypatch, capsys, tmp_path):
    def no_launch(*a, **k):
        raise AssertionError("a dry run launched a process")

    monkeypatch.setattr(subprocess, "run", no_launch)
    group = tmp_path / "group1"
    group.write_text("h1\n")
    assert cli.main(["run", "--backend", "mpi", "--hosts", "h0,h1",
                     "--dry-run", "-x", "-f", str(group)]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    argv = shlex.split(line)
    assert argv[:7] == ["mpirun", "-np", "2", "--host", "h0,h1", "--map-by",
                        "ppr:1:node"]
    assert argv[7] == str(mpi_launch.BUILD_DIR / "mpi_perf")


@pytest.mark.parametrize("flag", [["--dry-run"], ["--hosts", "h0,h1"]])
def test_launcher_flags_need_the_mpi_backend(flag, capsys):
    assert cli.main(["run", *flag, "--device", "cpu"]) == 2
    assert "applies to --backend mpi" in capsys.readouterr().err


def test_the_mpi_path_touches_no_card():
    # the C baseline on the host: no torch import, no device resolution,
    # so it runs where no card is visible
    probe = ("import sys; from tpu_perf_torch import cli; "
             "rc = cli.main(['run', '--backend', 'mpi', '--dry-run', '-x']);"
             " print(rc, 'torch' in sys.modules)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "0 False"


def test_the_ingest_command_skips_ppn_newest_files(monkeypatch, tmp_path):
    seen = []

    def fake_run(cmd, env=None, **kw):
        seen.append(env["TPU_PERF_INGEST_CMD"])
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.delenv("TPU_PERF_INGEST_CMD", raising=False)
    monkeypatch.setattr(mpi_launch, "ensure_built", lambda *a, **k: None)
    monkeypatch.setattr(subprocess, "run", fake_run)
    opts = Options(op="exchange", nonblocking=True, ppn=2,
                   logfolder=str(tmp_path))
    assert mpi_launch.run_mpi_backend(opts) == 0
    assert seen == [shlex.join(ingest_command(str(tmp_path), 2))]
    assert seen[0].split()[-4:] == ["-d", str(tmp_path), "-f", "2"]


# --- the shim, built by the port ------------------------------------------


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("gcc") is None and shutil.which("cc") is None:
        pytest.skip("no C compiler")
    build = tmp_path_factory.mktemp("_build")
    return mpi_launch.ensure_built("mpi_perf_shim", build)


def _shim_run(shim, tmp_path, np, args):
    group = tmp_path / "group1"
    group.write_text("shimhost1\n")
    return subprocess.run([str(shim), "-np", str(np), "--", "-f", str(group),
                           *args], capture_output=True, text=True,
                          timeout=120)


def test_the_shim_is_built_outside_backends_mpi(shim):
    assert shim.parent != mpi_launch.backend_dir()
    assert shim.name == "mpi_perf_shim" and os.access(shim, os.X_OK)
    # a second call finds it current and builds nothing
    mtime = shim.stat().st_mtime_ns
    assert mpi_launch.ensure_built("mpi_perf_shim", shim.parent) == shim
    assert shim.stat().st_mtime_ns == mtime
    assert not list(shim.parent.glob("*.tmp"))


def test_concurrent_builds_leave_one_whole_binary(tmp_path):
    if shutil.which("gcc") is None and shutil.which("cc") is None:
        pytest.skip("no C compiler")
    probe = ("import sys; from pathlib import Path; "
             "from tpu_perf_torch import mpi_launch; "
             "print(mpi_launch.ensure_built('mpi_perf_shim', "
             "Path(sys.argv[1])))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", probe, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert {o.strip() for o, _ in outs} == {str(tmp_path / "mpi_perf_shim")}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        ".lock", "mpi_perf_shim"]
    res = _shim_run(tmp_path / "mpi_perf_shim", tmp_path, 2,
                    ["-i", "5", "-b", "1024", "-r", "1"])
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("flags,op,factor", [
    (["-x"], "exchange", 1), ([], "pingpong", 2),
])
def test_shim_rows_parse_in_both_schemas(shim, tmp_path, flags, op, factor):
    logs = tmp_path / "logs"
    logs.mkdir()
    res = _shim_run(shim, tmp_path, 2, ["-i", "40", "-b", "65536", "-r", "3",
                                        "-p", "1", "-l", str(logs), *flags])
    assert res.returncode == 0, res.stderr
    (ext,) = logs.glob("tpu-*.log")
    (legacy,) = logs.glob("tcp-*.log")
    for line in ext.read_text().splitlines():
        ours, ref = ResultRow.from_csv(line), jschema.ResultRow.from_csv(line)
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
        assert (ours.backend, ours.op, ours.nbytes, ours.iters) == \
            ("mpi", op, 65536, 40)
        # the round trip's one-way convention: lat is half the per-iter
        assert ours.lat_us == pytest.approx(
            ours.time_ms * 1e3 / 40 / factor, rel=1e-2)
    for line in legacy.read_text().splitlines():
        ours, ref = LegacyRow.from_csv(line), jschema.LegacyRow.from_csv(line)
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
        assert (ours.buffer_size, ours.num_buffers, ours.num_flows) == \
            (65536, 40, 1)


def test_report_compare_pairs_the_port_with_the_shim(shim, tmp_path,
                                                    capsys):
    # the windowed exchange and pingpong of the port beside the shim's
    # rows in one folder: one curve key each, both backends filled
    logs = tmp_path / "logs"
    logs.mkdir()
    for flags in (["-x"], []):
        res = _shim_run(shim, tmp_path, 2, ["-i", "40", "-b", "65536", "-r",
                                            "3", "-l", str(logs), *flags])
        assert res.returncode == 0, res.stderr
    for kw in (dict(op="exchange", nonblocking=True, window=4),
               dict(op="pingpong")):
        Driver(Options(**kw, buff_sz=65536, iters=10, num_runs=3, ppn=1,
                       sim_ranks=2, device="cpu",
                       logfolder=str(logs))).run()
    points = report.stream_aggregate(report.collect_paths(str(logs)))
    pairs = {(c.op, c.nbytes): c for c in report.compare(points)}
    assert set(pairs) == {("exchange", 65536), ("pingpong", 65536)}
    for c in pairs.values():
        assert (c.torch.backend, c.mpi.backend) == ("torch-sim", "mpi")
        assert c.torch.runs == c.mpi.runs == 3
        assert c.busbw_ratio and c.latency_ratio
    rows = [ResultRow.from_csv(ln) for f in logs.glob("tpu-*.log")
            for ln in f.read_text().splitlines()]
    # the same message count on both sides: 10 iterations x window 4
    assert {(r.backend, r.iters) for r in rows if r.op == "exchange"} == {
        ("mpi", 40), ("torch-sim", 40)}
    assert cli.main(["report", str(logs), "--compare"]) == 0
    table = capsys.readouterr().out
    assert "| exchange | 64K | float32 |" in table
    assert "| pingpong | 64K | float32 |" in table


def test_run_backend_mpi_end_to_end(shim, tmp_path, monkeypatch):
    # through the CLI, into the port's build directory (here a temporary
    # one): backend=mpi rows in the log folder
    monkeypatch.setattr(mpi_launch, "BUILD_DIR", shim.parent)
    logs = tmp_path / "logs"
    assert cli.main(["run", "--backend", "mpi", "-x", "-b", "65536", "-i",
                     "40", "-r", "3", "-l", str(logs)]) == 0
    rows = [ResultRow.from_csv(ln) for f in logs.glob("tpu-*.log")
            for ln in f.read_text().splitlines()]
    assert [(r.backend, r.op, r.nbytes, r.run_id) for r in rows] == [
        ("mpi", "exchange", 65536, i) for i in (1, 2, 3)]
