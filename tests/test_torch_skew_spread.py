"""The arrival-spread axis (``--skew-spread``) against the JAX package's.

The injector's axis helpers draw every rank's arrival from a seeded hash
(the last rank exactly the spread late), so both packages draw the same
arrivals; the driver sums the axis' arrivals and any ``skew`` fault's rank
by rank before it takes the worst (``Driver._entry_skew``).  A synthetic
soak through either CLI then writes the same row payloads, the same
ledger and the same straggler-cost table.  The Options refuse what JAX's
refuse, and a one-process job with real timing warns that no peer waits
for the stagger.  A gloo world of 2 runs the axis with real timing.
"""

import io
import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import pytest

import tpu_perf.faults.injector as jinj
from tpu_perf import cli as jcli
from tpu_perf import config as jconfig
from tpu_perf.driver import Driver as JDriver
from tpu_perf.faults.spec import FaultSpec as JFaultSpec
from tpu_perf.report import aggregate as jaggregate
from tpu_perf.report import straggler_cost as jstraggler
from tpu_perf.report import straggler_to_markdown as jstraggler_md
from tpu_perf.schema import ResultRow as JRow
from tpu_perf.sweep import parse_skew_spread as jparse

import tpu_perf_torch.faults.injector as tinj
from tpu_perf_torch import cli
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.faults.spec import FaultSpec
from tpu_perf_torch.report import aggregate, straggler_cost, \
    straggler_to_markdown
from tpu_perf_torch.sweep import parse_skew_spread

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("spread", [0, 250, 1000])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_the_axis_arrivals_are_jaxs(seed, spread, world):
    for run_id in (1, 2, 37):
        for op, nbytes in (("allreduce", 4096), ("ring", 32)):
            assert tinj.axis_arrivals_us(
                seed, op, nbytes, spread, run_id, world=range(world)) == \
                jinj.axis_arrivals_us(seed, op, nbytes, spread, run_id,
                                      world=range(world))
            for rank in range(world):
                assert tinj.axis_skew(seed, op, nbytes, spread, run_id,
                                      rank=rank, n_ranks=world) == \
                    jinj.axis_skew(seed, op, nbytes, spread, run_id,
                                   rank=rank, n_ranks=world)


def _fake(driver_mod, injector, *, seed, n_hosts, rank):
    return types.SimpleNamespace(
        opts=types.SimpleNamespace(fault_seed=seed), n_hosts=n_hosts,
        rank=rank, injector=injector)


@pytest.mark.parametrize("synthetic", [None, 0.001])
@pytest.mark.parametrize("fault_rank", [None, 1, 7])
def test_the_entry_skew_merges_the_axis_and_the_faults_as_jax(
        synthetic, fault_rank):
    built = types.SimpleNamespace(name="ring", nbytes=32)
    for n_hosts in (1, 2, 4):
        for rank in range(n_hosts):
            kw = dict(kind="skew", op="ring", magnitude=500.0,
                      rank=fault_rank)
            ours = tinj.FaultInjector([FaultSpec(**kw)], seed=7, rank=rank,
                                      synthetic_s=synthetic,
                                      err=io.StringIO())
            theirs = jinj.FaultInjector([JFaultSpec(**kw)], seed=7,
                                        rank=rank, synthetic_s=synthetic,
                                        err=io.StringIO())
            for run_id in (1, 5, 9):
                for spread in (0, 1000):
                    got = Driver._entry_skew(
                        _fake(None, ours, seed=7, n_hosts=n_hosts,
                              rank=rank), built, run_id, spread)
                    want = JDriver._entry_skew(
                        _fake(None, theirs, seed=7, n_hosts=n_hosts,
                              rank=rank), built, run_id, spread)
                    assert got == want, (n_hosts, rank, run_id, spread)


@pytest.mark.parametrize("spec", ["0,250us,1ms", "500", "0, 2s",
                                  "1ms,0"])
def test_the_spread_list_parses_as_jaxs(spec):
    assert parse_skew_spread(spec) == jparse(spec)


@pytest.mark.parametrize("kw", [
    dict(skew_spread=(-1,)),
    dict(skew_spread=(0, 500), fence="fused"),
    dict(skew_spread=(0, 500), fence="trace"),
    dict(skew_spread=(500,), extern_cmd="echo"),
])
def test_the_spread_options_refuse_as_jaxs(kw):
    with pytest.raises(ValueError) as ours:
        Options(op="allreduce", **kw)
    with pytest.raises(ValueError) as theirs:
        jconfig.Options(op="allreduce", **kw)
    assert type(ours.value) is type(theirs.value)


def test_a_spread_under_streams_is_refused():
    with pytest.raises(ValueError, match="run the skew axis serially"):
        Options(op="allreduce,ring", skew_spread=(0, 500), streams=2)


FLAGS = ["--synthetic", "0.001", "--seed", "7", "--op", "ring", "--sweep",
         "8,32", "-i", "1", "--stats-every", "20", "--health-warmup", "20",
         "--max-runs", "160", "--skew-spread", "0,1ms"]


def _rows(folder, row):
    out = []
    for p in sorted(folder.glob("tpu-*.log")):
        out += [row.from_csv(ln) for ln in p.read_text().splitlines()]
    return out


@pytest.fixture(scope="module")
def twin(eight_devices, tmp_path_factory):
    root = tmp_path_factory.mktemp("skew")
    assert jcli.main(["chaos", *FLAGS, "-l", str(root / "jax")]) == 0
    assert cli.main(["chaos", *FLAGS, "-l", str(root / "torch"),
                     "--device", "cpu", "--sim-ranks", "8"]) == 0
    return root


def test_a_synthetic_spread_soak_writes_jaxs_rows_and_ledger(twin):
    from tpu_perf_torch.schema import ResultRow

    ours = _rows(twin / "torch", ResultRow)
    theirs = _rows(twin / "jax", JRow)
    assert {r.skew_us for r in ours} == {0, 1000}

    def payload(rows):
        return [(r.op, r.nbytes, r.run_id, r.time_ms, r.skew_us, r.mode)
                for r in rows]

    assert payload(ours) == payload(theirs)
    ledger = {k: "".join(p.read_text() for p in sorted(
        (twin / k).glob("chaos-*.log"))) for k in ("jax", "torch")}
    assert ledger["torch"] and ledger["torch"] == ledger["jax"]


def test_the_straggler_cost_table_is_jaxs(twin):
    from tpu_perf_torch.schema import ResultRow

    ours = _rows(twin / "torch", ResultRow)
    theirs = _rows(twin / "jax", JRow)
    # the same rows under each package's backend name
    ours_points = aggregate(ours)
    theirs_points = jaggregate([
        JRow.from_csv(r.to_csv().replace("torch-sim", "jax"))
        for r in ours])
    got = straggler_cost(ours_points)
    want = jstraggler(theirs_points)
    assert len(got) == len(want) == 2
    assert [(c.op, c.nbytes, c.skew_us) for c in got] == \
        [(c.op, c.nbytes, c.skew_us) for c in want]
    assert all(c.slowdown > 1.0 for c in got)
    assert straggler_to_markdown(got) == jstraggler_md(want)
    # and on JAX's own soak the same table as ours on ours
    assert [c.slowdown for c in jstraggler(jaggregate(theirs))] == \
        [c.slowdown for c in got]


def test_a_spread_on_one_process_warns_that_no_peer_waits(capsys):
    err = io.StringIO()
    Driver(Options(op="allreduce", buff_sz=64, iters=1, num_runs=2,
                   skew_spread=(0, 100), device="cpu", sim_ranks=2),
           err=err).run()
    assert "no peer process exists" in err.getvalue()


_WORKER_ENV = dict(OMP_NUM_THREADS="1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_spread_across_two_processes_writes_the_spread_rows(tmp_path):
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   **_WORKER_ENV)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_perf_torch", "run",
             "--distributed", "--device", "cpu", "--op", "allreduce",
             "-b", "4K", "-i", "2", "-r", "3", "--skew-spread", "0,2ms",
             "-l", str(tmp_path / f"r{r}")], cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "no peer process exists" not in err
    for r in range(2):
        rows = _rows(tmp_path / f"r{r}", JRow)
        assert sorted((x.skew_us, x.run_id) for x in rows) == [
            (0, 1), (0, 2), (0, 3), (2000, 1), (2000, 2), (2000, 3)]
        assert all(x.n_devices == 2 for x in rows)
    # every run's time is its maximum over the ranks: both ranks agree
    a, b = (_rows(tmp_path / f"r{r}", JRow) for r in range(2))
    assert [x.time_ms for x in a] == [x.time_ms for x in b]
    assert json.dumps(sorted({x.skew_us for x in a})) == "[0, 2000]"
