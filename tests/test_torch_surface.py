"""The rest of the reference's ``run`` surface in the port, against the JAX
package on the CPU: the windowed ``-x`` (``--window``), op families
(``--op a,b,c``) in the finite run and the daemon, ``-p``, ``-f`` /
``-n``, ``-d`` (the print-only external launcher) and the JSON heartbeat.

Tolerances: every output compared here moves bytes, so it is held
exactly; row fields that do not depend on timing (op, size, iterations,
run id, ranks, mode, flows) are held exactly too.
"""

import io
import json
import os

import jax
import numpy as np
import pytest
import torch

import tpu_perf.config as jconfig
import tpu_perf.driver as jdriver
import tpu_perf.extern_launch as jextern
import tpu_perf.runner as jrunner
import tpu_perf.schema as jschema
import tpu_perf.topology as jtopology
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh

from tpu_perf_torch import cli, extern_launch, kernels, topology
from tpu_perf_torch import ingest as tingest
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.ops.collectives import build_op, known_ops, to_tensor
from tpu_perf_torch.ops.pallas_ring import PALLAS_OPS
from tpu_perf_torch.runner import ops_for_options
from tpu_perf_torch.schema import LegacyRow, ResultRow
from tpu_perf_torch.world import SimWorld, from_world, to_world

CPU = torch.device("cpu")


def _rows(folder, prefix="tpu"):
    parse = (ResultRow if prefix == "tpu" else LegacyRow).from_csv
    rows = []
    for name in sorted(os.listdir(folder)):
        if name.startswith(prefix + "-"):
            text = (folder / name).read_text().splitlines()
            rows += [parse(ln) for ln in text if ln.strip()]
    return rows


def _raises_alike(ours, ref):
    """Both calls raise ValueError with the same message, or neither
    raises; returns what ours returned."""
    try:
        got = ours()
    except ValueError as e:
        with pytest.raises(ValueError) as want:
            ref()
        assert str(e) == str(want.value)
        return None
    ref()
    return got


# --- the windowed exchange ----------------------------------------------


@pytest.mark.parametrize("iters", [3, 4])
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("op", ["exchange", "ppermute"])
def test_windowed_exchange_matches_jax(op, window, n, iters, eight_devices):
    mesh = make_mesh(devices=jax.devices()[:n])
    jb = jax_build_op(op, mesh, 100, iters, window=window)
    x = np.asarray(jax.device_get(jb.example_input)).astype(np.float64)
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    pb = build_op(op, SimWorld(n, CPU), 100, iters, window=window)
    xt = to_tensor(to_world(x, n), "float32", CPU)
    # the fill and the layout are the JAX package's, element for element
    assert torch.equal(xt, pb.example_input)
    got = from_world(pb.step(xt))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (pb.nbytes, pb.iters, pb.n_devices) == \
        (jb.nbytes, jb.iters, jb.n_devices)
    assert pb.iters == iters * window


def test_windowed_layout_keeps_each_window_on_its_rank():
    # the (W, n*elems) global layout: rank d holds columns d*elems.. of
    # every window; the sim world's (n, W, elems) row d is that block
    g = np.arange(3 * 4 * 5).reshape(3, 20)
    rows = to_world(g, 4)
    assert rows.shape == (4, 3, 5)
    for d in range(4):
        np.testing.assert_array_equal(rows[d], g[:, d * 5:(d + 1) * 5])
    np.testing.assert_array_equal(from_world(torch.from_numpy(rows)), g)


def test_window_at_odd_iters_is_no_identity():
    # an exchange is its own inverse: at even iters a wrong layout could
    # look right, so one execution must move every window's rows
    pb = build_op("exchange", SimWorld(4, CPU), 16, 1, window=3)
    x = pb.example_input.clone()
    out = pb.step(x)
    assert not torch.equal(out, x)
    perm = dict(topology.pair_permutation(4))
    for src, dst in perm.items():
        assert torch.equal(out[dst], x[src])


@pytest.mark.parametrize("op", sorted(set(known_ops())
                                      - {"exchange", "ppermute"}))
def test_window_is_refused_for_every_other_op(op, eight_devices):
    world = SimWorld(8, CPU)
    with pytest.raises(ValueError) as ours:
        build_op(op, world, 64, 1, window=2)
    with pytest.raises(ValueError) as ref:
        jax_build_op(op, make_mesh(), 64, 1, window=2)
    assert str(ours.value) == str(ref.value)
    want = ("window does not apply to pallas ops" if op in PALLAS_OPS
            else f"window only applies to exchange/ppermute, got {op!r}")
    assert str(ours.value) == want


@pytest.mark.parametrize("kw", [
    dict(window=2), dict(window=2, op="pl_allreduce"),
    dict(window=2, uni_dir=True), dict(window=0), dict(window=0, op="exchange"),
    dict(window=2, nonblocking=True), dict(window=2, op="ppermute"),
])
def test_window_options_match_jax(kw):
    _raises_alike(lambda: Options(**kw), lambda: jconfig.Options(**kw))


def test_windowed_run_rows_and_output_match_jax(tmp_path, eight_devices):
    # run -x --window 4 --sim-ranks 8: exchange rows with the per-message
    # nbytes and iters*4 messages, the output the JAX package's
    assert cli.main(["run", "-x", "--window", "4", "--sim-ranks", "8",
                     "-b", "256", "-i", "3", "-r", "2", "--device", "cpu",
                     "-l", str(tmp_path)]) == 0
    rows = _rows(tmp_path)
    assert [(r.op, r.nbytes, r.iters, r.run_id, r.n_devices)
            for r in rows] == [("exchange", 256, 12, 1, 8),
                               ("exchange", 256, 12, 2, 8)]
    assert {(r.buffer_size, r.num_buffers)
            for r in _rows(tmp_path, "tcp")} == {(256, 12)}
    jb = jax_build_op("exchange", make_mesh(), 256, 3, window=4)
    want = np.asarray(jax.device_get(jb.step(jb.example_input)))
    pb = build_op("exchange", SimWorld(8, CPU), 256, 3, window=4)
    np.testing.assert_array_equal(from_world(pb.step(pb.example_input)),
                                  want)


@pytest.mark.parametrize("argv", [
    ["--op", "pl_allreduce"], ["--op", "pl_exchange", "-x"], ["--op",
                                                              "pingpong"],
    ["-u"],
])
def test_cli_refuses_the_window_off_the_windowed_kernel(argv, capsys):
    assert cli.main(["run", "--window", "2", "--device", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert ("window > 1 requires the windowed kernel" in err
            or "window does not apply to pallas ops" in err)


@pytest.mark.parametrize("fence", ["block", "slope", "fused"])
def test_windowed_row_times_count_every_message(fence):
    # every fence's run time covers iters executions of W buffers, and the
    # row divides it by iters*W messages
    drv = Driver(Options(op="exchange", window=4, nonblocking=True,
                         buff_sz=64, iters=2, num_runs=2, fence=fence,
                         device="cpu", sim_ranks=2))
    rows = drv.run()
    assert {(r.nbytes, r.iters) for r in rows} == {(64, 8)}
    for r in rows:
        assert r.lat_us == pytest.approx(r.time_ms * 1e3 / 8, rel=1e-3)


# --- op families ----------------------------------------------------------


FAMILIES = [
    dict(op="allreduce,pl_ring"),
    dict(op=" pl_allreduce , allreduce ,"),
    dict(op="exchange", nonblocking=True),
    dict(op="pingpong", uni_dir=True),
    dict(op="pingpong", nonblocking=True),
    dict(op=","),
    dict(op="nope,allreduce"),
    dict(op="allreduce,pl_ring", extern_cmd="x {role}"),
    dict(op="pingpong", extern_cmd="x {role}"),
    dict(op="pl_barrier,barrier,hbm_stream"),
]


@pytest.mark.parametrize("kw", FAMILIES)
def test_ops_for_options_matches_jax(kw):
    try:
        want = jrunner.ops_for_options(jconfig.Options(**kw))
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            ops_for_options(Options(**kw))
        # the known-op list differs by the ops not ported yet; the rest of
        # the message is the JAX package's
        assert str(ours.value).split("; known")[0] == \
            str(e).split("; known")[0]
        return
    assert ops_for_options(Options(**kw)) == want


@pytest.mark.parametrize("op", ["seg_allreduce,allreduce", "allgatherv,ring"])
def test_a_family_naming_an_op_not_yet_ported_is_refused(op):
    # the v-ops are ported now: a family naming one is JAX's family, and
    # only an unknown name is refused
    assert ops_for_options(Options(op=op)) == \
        jrunner.ops_for_options(jconfig.Options(op=op))
    with pytest.raises(ValueError, match="unknown op"):
        ops_for_options(Options(op=op + ",not_an_op"))


def test_finite_family_runs_op_major_in_the_jax_order(tmp_path,
                                                      eight_devices):
    kw = dict(op="allreduce,exchange", sweep="64,256", iters=2, num_runs=2)
    rows = Driver(Options(**kw, device="cpu")).run()
    ref = jdriver.Driver(jconfig.Options(**kw), make_mesh()).run()
    assert [(r.op, r.nbytes, r.run_id) for r in rows] == \
        [(r.op, r.nbytes, r.run_id) for r in ref]
    assert [r.op for r in rows[::2]] == ["allreduce"] * 2 + ["exchange"] * 2


def test_daemon_family_round_robins_in_the_jax_order(tmp_path,
                                                     eight_devices):
    kw = dict(op="allreduce,pl_barrier,ring", sweep="64,256", iters=1,
              num_runs=-1)
    ours, ref = tmp_path / "port", tmp_path / "jax"
    Driver(Options(**kw, max_runs=11, logfolder=str(ours),
                   device="cpu")).run()
    jdriver.Driver(jconfig.Options(**kw, logfolder=str(ref)), make_mesh(),
                   max_runs=11).run()
    key = [(r.op, r.nbytes, r.run_id, r.mode) for r in _rows(ours)]
    assert key == [(r.op, r.nbytes, r.run_id, r.mode)
                   for r in _rows(ref)]
    # five points (the barrier is one), every one visited in turn
    assert [k[:2] for k in key[:5]] == [
        ("allreduce", 64), ("allreduce", 256), ("pl_barrier", 4),
        ("ring", 64), ("ring", 256)]


@pytest.mark.parametrize("fence", ["block", "fused"])
def test_monitor_family_visits_every_point(tmp_path, fence, capsys):
    family = "pl_allreduce,pl_hbm_copy,pl_barrier,allreduce"
    assert cli.main(["monitor", "--op", family, "--sweep", "64,256", "-i",
                     "1", "--fence", fence, "--max-runs", "23",
                     "--device", "cpu", "-l", str(tmp_path)]) == 0
    rows = _rows(tmp_path)
    counts = {}
    for r in rows:
        counts[(r.op, r.nbytes)] = counts.get((r.op, r.nbytes), 0) + 1
    assert len(counts) == 7
    assert max(counts.values()) - min(counts.values()) <= 1
    assert sorted(r.run_id for r in rows) == list(range(1, 24))
    assert "daemon: 7 points" in capsys.readouterr().err


def test_monitor_family_with_an_unknown_op_fails_before_any_kernel(
        tmp_path, capsys):
    kernels.reset_counts()
    assert cli.main(["monitor", "--op", "pl_allreduce,nope", "--max-runs",
                     "3", "--device", "cpu", "-l", str(tmp_path)]) == 2
    assert "unknown op(s) ['nope']" in capsys.readouterr().err
    assert not any(kernels.PLAIN_CALLS.values())
    assert not any(kernels.LAUNCHES.values())
    assert not any(p.stat().st_size for p in tmp_path.iterdir())


def test_fused_family_daemon_never_captures_during_a_visit(monkeypatch):
    # each point's runner is warmed once before run 1; a visit only
    # replays (on the CPU: runs its one-run program)
    from tpu_perf_torch import timing

    warms = []
    warm = timing.FusedRunner.warm

    def spy(self):
        warms.append(self.built.name)
        return warm(self)

    monkeypatch.setattr(timing.FusedRunner, "warm", spy)
    Driver(Options(op="pl_allreduce,pl_ring", sweep="64,256", iters=1,
                   num_runs=-1, max_runs=12, fence="fused",
                   device="cpu")).run()
    assert warms == ["pl_allreduce"] * 2 + ["pl_ring"] * 2


# --- -p, -f / -n -----------------------------------------------------------


def test_ppn_fills_num_flows_and_the_ingest_skip(tmp_path, monkeypatch):
    made = []

    class Fake:
        def __init__(self, cmd):
            made.append(cmd)

        def __call__(self):
            pass

        def finish(self):
            pass

    monkeypatch.setattr(tingest, "SubprocessIngest", Fake)
    assert cli.main(["run", "--op", "ring", "-b", "64", "-i", "1", "-r", "2",
                     "-p", "3", "--device", "cpu", "-l", str(tmp_path)]) == 0
    assert made == [tingest.ingest_command(str(tmp_path), 3)]
    assert made[0][-2:] == ["-f", "3"]
    assert {r.num_flows for r in _rows(tmp_path, "tcp")} == {3}


@pytest.mark.parametrize("world,group1,ppn", [
    (8, 4, 1), (8, 2, 2), (8, 3, 1), (7, 3, 1), (8, 8, 1), (2, 1, 1),
    (4, 1, 2), (4, 2, 2),
])
def test_validate_groups_matches_jax(world, group1, ppn):
    _raises_alike(lambda: topology.validate_groups(world, group1, ppn),
                  lambda: jtopology.validate_groups(world, group1, ppn))


@pytest.mark.parametrize("n_group1,hosts,ppn", [
    (4, 4, 1), (3, 4, 1), (0, 4, 1), (0, 2, 2), (2, 2, 2), (0, 3, 1),
])
def test_group_file_checks_match_jax(tmp_path, n_group1, hosts, ppn,
                                     eight_devices):
    path = tmp_path / "group1"
    path.write_text("".join(f"host{i}\n" for i in range(hosts)) + "\n")
    kw = dict(group1_file=str(path), n_group1=n_group1, ppn=ppn, op="ring",
              buff_sz=64, iters=1)
    _raises_alike(lambda: Driver(Options(**kw, device="cpu")),
                  lambda: jdriver.Driver(jconfig.Options(**kw), make_mesh()))


@pytest.mark.parametrize("kw", [
    dict(n_group1=3), dict(n_group1=-1), dict(ppn=0), dict(ppn=-2),
    dict(op="extern"), dict(heartbeat_format="xml"),
])
def test_flag_errors_are_the_jax_packages(kw):
    _raises_alike(lambda: Options(**kw), lambda: jconfig.Options(**kw))


def test_cli_group_file_with_a_wrong_count_exits_before_any_kernel(
        tmp_path, capsys):
    path = tmp_path / "group1"
    path.write_text("a\nb\nc\nd\n")
    kernels.reset_counts()
    base = ["run", "--op", "pl_ring", "-b", "64", "-i", "1", "-f", str(path),
            "--device", "cpu"]
    assert cli.main(base + ["-n", "3"]) == 2
    assert "-n 3 but" in capsys.readouterr().err
    assert not any(kernels.PLAIN_CALLS.values())
    assert cli.main(base + ["-n", "4", "-p", "1"]) == 0
    assert kernels.PLAIN_CALLS["ring"] == 2  # warm-up and one run


# --- -d, the print-only external launcher -------------------------------


@pytest.mark.parametrize("rank,n", [(0, 1), (3, 1), (0, 2), (1, 2), (0, 8),
                                    (5, 8), (7, 8), (0, 3)])
def test_pair_for_rank_matches_jax(rank, n):
    _raises_alike(lambda: extern_launch.pair_for_rank(rank, n),
                  lambda: jextern.pair_for_rank(rank, n))
    if n != 3:
        assert extern_launch.pair_for_rank(rank, n) == \
            jextern.pair_for_rank(rank, n)


@pytest.mark.parametrize("template", [
    extern_launch.DEFAULT_TEMPLATE, "dotnet app.dll {role} {ip} {port}",
    "x {nope}", "x {0}",
])
@pytest.mark.parametrize("group", [0, 1])
def test_render_extern_command_matches_jax(template, group):
    kw = dict(group=group, rank=3, peer_rank=7, my_ip="10.0.0.1",
              peer_ip="10.0.0.2", ppn=2, buff_sz=4096, iters=10)
    got = _raises_alike(
        lambda: extern_launch.render_extern_command(template, **kw),
        lambda: jextern.render_extern_command(template, **kw))
    if got is not None:
        assert got == jextern.render_extern_command(template, **kw)
    assert extern_launch.DEFAULT_TEMPLATE == jextern.DEFAULT_TEMPLATE
    assert extern_launch.DEF_PORT == jextern.DEF_PORT


def test_extern_prints_its_command_and_still_writes_rows(tmp_path, capsys):
    kernels.reset_counts()
    assert cli.main(["run", "-d", "-b", "4096", "-r", "3", "-p", "2",
                     "--device", "cpu", "-l", str(tmp_path)]) == 0
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("extern-bench")]
    ip = lines[0].split()[2]
    assert lines == [f"extern-bench server {ip} 40000 2 4096 10"] * 3
    rows = _rows(tmp_path)
    assert [(r.op, r.nbytes, r.run_id, r.busbw_gbps) for r in rows] == [
        ("extern", 4096, i, 0.0) for i in (1, 2, 3)]
    assert {r.num_flows for r in _rows(tmp_path, "tcp")} == {2}
    assert not any(kernels.PLAIN_CALLS.values())


def test_extern_refuses_a_family():
    with pytest.raises(ValueError, match="extern mode runs a single op"):
        Driver(Options(op="ring,exchange", extern_cmd="x",
                       device="cpu")).run()


# --- the JSON heartbeat -----------------------------------------------------


def _heartbeats(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


@pytest.mark.parametrize("kw", [
    dict(op="allreduce,ring", sweep="64,256", num_runs=3, stats_every=2),
    dict(op="allreduce,ring", sweep="64,256", num_runs=-1, stats_every=3),
    dict(op="exchange", nonblocking=True, window=4, buff_sz=64, num_runs=-1,
         stats_every=2),
])
def test_json_heartbeat_keys_and_points_match_jax(kw, eight_devices):
    kw = dict(kw, iters=1, heartbeat_format="json")
    max_runs = 9 if kw["num_runs"] == -1 else None
    ours, ref = io.StringIO(), io.StringIO()
    Driver(Options(**kw, max_runs=max_runs, device="cpu"), err=ours).run()
    jdriver.Driver(jconfig.Options(**kw), make_mesh(), err=ref,
                   max_runs=max_runs).run()
    got, want = _heartbeats(ours.getvalue()), _heartbeats(ref.getvalue())
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert set(g) <= set(w)
        assert {"event", "run", "window", "samples", "dropped", "points",
                "phase", "total_ms", "min_ms", "max_ms", "avg_ms",
                "p50_ms"} == set(g)
        # the harness' phases so far, JAX's three keys
        assert set(g["phase"]) == set(w["phase"])
        for k in ("event", "run", "window", "samples", "dropped", "points"):
            assert g[k] == w[k], k
        assert g["window"] == jschema.window_index(g["run"], kw["stats_every"])
    if kw["num_runs"] == -1:
        # a daemon's window holds every visit of its boundary
        assert all(sum(g["points"].values()) == g["samples"] for g in got)


def test_json_heartbeat_counts_dropped_slope_samples(monkeypatch):
    from tpu_perf_torch import driver as tdriver

    monkeypatch.setattr(tdriver, "slope_sample", lambda *a, **k: None)
    err = io.StringIO()
    Driver(Options(op="ring", buff_sz=64, iters=1, num_runs=-1, max_runs=4,
                   stats_every=2, fence="slope", heartbeat_format="json",
                   device="cpu"), err=err).run()
    beats = _heartbeats(err.getvalue())
    assert [(b["run"], b["samples"], b["dropped"], b["points"])
            for b in beats] == [(2, 0, 2, {}), (4, 0, 4, {})]
