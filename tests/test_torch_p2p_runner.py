"""The reference's own point-to-point run in the port, against the JAX
package on the CPU: kernel selection by ``-u`` / ``-x``
(``op_for_options``), the halved round trip of the ping-pong rows, the
one-point sweep of the fixed-payload ops, and the CLI's default run."""

import pytest

import tpu_perf.cli as jax_cli
import tpu_perf.config as jconfig
import tpu_perf.metrics as jmetrics
import tpu_perf.runner as jrunner
import tpu_perf.schema as jschema
import tpu_perf.timing as jtiming

from tpu_perf_torch import cli, metrics as tmetrics, runner as trunner
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.timing import RunTimes
from tpu_perf_torch.world import SimWorld

import torch

CPU = torch.device("cpu")


@pytest.mark.parametrize("nonblocking", [False, True])
@pytest.mark.parametrize("uni_dir", [False, True])
@pytest.mark.parametrize("op", ["pingpong", "ring", "pl_pingpong"])
def test_op_for_options_matches_jax(op, uni_dir, nonblocking):
    flags = dict(op=op, uni_dir=uni_dir, nonblocking=nonblocking)
    if uni_dir and nonblocking:
        with pytest.raises(ValueError) as ours:
            Options(**flags)
        with pytest.raises(ValueError) as theirs:
            jconfig.Options(**flags)
        assert str(ours.value) == str(theirs.value)
        return
    assert (trunner.op_for_options(Options(**flags))
            == jrunner.op_for_options(jconfig.Options(**flags)))


@pytest.mark.parametrize("iters", [1, 10])
@pytest.mark.parametrize("op", ["pingpong", "pl_pingpong", "exchange",
                                "pingpong_unidir", "barrier", "pl_barrier"])
def test_rows_report_what_jax_rows_report(op, iters):
    # the same run times give the same lat_us / algbw / busbw: half the
    # round trip for pingpong and pl_pingpong, nothing halved elsewhere,
    # bandwidth columns zeroed for the barriers
    samples = [3.7e-4, 1.25e-3]
    ours = trunner.SweepPointResult(
        op=op, nbytes=456132, iters=iters, n_devices=8,
        times=RunTimes(samples=samples, warmup_s=0.0)).rows("j", "torch-sim")
    theirs = jrunner.SweepPointResult(
        op=op, nbytes=456132, iters=iters, n_devices=8,
        times=jtiming.RunTimes(samples=samples, warmup_s=0.0,
                               overhead_s=0.0)).rows("j")
    for a, b in zip(ours, theirs, strict=True):
        assert (a.lat_us, a.algbw_gbps, a.busbw_gbps, a.time_ms) \
            == (b.lat_us, b.algbw_gbps, b.busbw_gbps, b.time_ms)
    if op in ("pingpong", "pl_pingpong"):
        assert ours[0].lat_us == pytest.approx(samples[0] / iters / 2 * 1e6)


@pytest.mark.parametrize("round_trip", [False, True])
def test_latency_us_matches_jax(round_trip):
    for seconds, iters in ((1e-3, 10), (0.37, 3), (5e-6, 1)):
        assert (tmetrics.latency_us(seconds, iters, round_trip=round_trip)
                == jmetrics.latency_us(seconds, iters, round_trip=round_trip))


@pytest.mark.parametrize("sweep", [None, "4K:256M", "8,64K,4M", "13"])
@pytest.mark.parametrize("op", ["barrier", "pl_barrier", "pingpong",
                                "pl_ring"])
def test_sizes_for_collapses_the_fixed_payload_ops(op, sweep):
    for dtype in ("float32", "bfloat16"):
        ours = trunner.sizes_for(Options(op=op, sweep=sweep, dtype=dtype))
        theirs = jrunner.sizes_for(jconfig.Options(op=op, sweep=sweep,
                                                   dtype=dtype))
        assert ours == theirs
        if op in trunner.FIXED_PAYLOAD_OPS:
            assert len(ours) == 1
    # op overrides the options' own selection
    assert trunner.sizes_for(Options(sweep="4K:1M"), "pl_barrier") == [4096]


def test_run_sweep_of_pl_barrier_is_one_point():
    opts = Options(op="pl_barrier", sweep="4K:64K", iters=2, device="cpu")
    points = list(trunner.run_sweep(opts, SimWorld(4, CPU)))
    assert [(p.op, p.nbytes) for p in points] == [("pl_barrier", 4)]


def test_run_sweep_runs_the_selected_kernel():
    opts = Options(sweep="4K:8K", iters=1, device="cpu", nonblocking=True)
    points = list(trunner.run_sweep(opts, SimWorld(4, CPU)))
    assert [(p.op, p.nbytes) for p in points] == [("exchange", 4096),
                                                 ("exchange", 8192)]


@pytest.mark.parametrize("flags,op", [({}, "pingpong"),
                                      ({"uni_dir": True}, "pingpong_unidir"),
                                      ({"nonblocking": True}, "exchange")])
def test_driver_runs_the_selected_kernel(flags, op):
    opts = Options(buff_sz=64, iters=2, num_runs=2, device="cpu", **flags)
    rows = Driver(opts).run()
    assert [(r.op, r.nbytes, r.run_id) for r in rows] == [(op, 64, 1),
                                                         (op, 64, 2)]


# --- the CLI's default run ----------------------------------------------


def _csv_rows(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert lines[0] == jschema.RESULT_HEADER
    return [jschema.ResultRow.from_csv(ln) for ln in lines[1:]]


@pytest.mark.parametrize("flags,op", [([], "pingpong"),
                                      (["-u"], "pingpong_unidir"),
                                      (["-u", "1"], "pingpong_unidir"),
                                      (["-x"], "exchange"),
                                      (["-u", "0", "-x"], "exchange")])
def test_default_run_writes_the_reference_kernels_rows(flags, op, capsys):
    assert cli.main(["run", "--device", "cpu", *flags]) == 0
    rows = _csv_rows(capsys.readouterr().out)
    assert [(r.op, r.nbytes, r.n_devices, r.iters, r.backend) for r in rows] \
        == [(op, 456132, 8, 10, "torch-sim")]
    assert rows[0].lat_us > 0 and rows[0].busbw_gbps > 0


def test_unidir_and_nonblocking_together_fail_as_in_jax(capsys):
    assert cli.main(["run", "--device", "cpu", "-u", "-x"]) == 2
    err = capsys.readouterr().err
    assert "uni_dir and nonblocking are mutually exclusive" in err


@pytest.mark.parametrize("flags", [[], ["-u"], ["-x"],
                                   ["--op", "pl_pingpong"],
                                   ["--op", "pl_barrier", "--sweep", "4K:16K"]])
def test_cli_rows_match_the_jax_cli(flags, eight_devices, capsys):
    # one small point per run: the JAX side runs its kernels under the
    # interpreter on the 8 virtual devices
    argv = ["run", "-b", "4K", "-i", "1", "-r", "2", *flags]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    port = _csv_rows(capsys.readouterr().out)
    assert jax_cli.main(argv) == 0
    ref = _csv_rows(capsys.readouterr().out)
    assert [(r.op, r.nbytes, r.n_devices, r.iters, r.run_id) for r in port] \
        == [(r.op, r.nbytes, r.n_devices, r.iters, r.run_id) for r in ref]
