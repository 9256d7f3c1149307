"""The port's run slice as a whole against the JAX package, on the CPU:
the library ops against their XLA bodies, the CLI's rows against the JAX
CLI's, and the copied schema / metrics / sweep / config tables against
their originals.

Tolerances: float32 rtol 1e-6 (the sums differ only in association order
over at most 8 ranks); bfloat16 rtol 8e-3, one bfloat16 unit in the last
place, because torch sums the ranks in float32 and rounds once while XLA
may round the partial sums."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import tpu_perf.cli as jax_cli
import tpu_perf.config as jconfig
import tpu_perf.metrics as jmetrics
import tpu_perf.schema as jschema
import tpu_perf.sweep as jsweep
import tpu_perf.timing as jtiming
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.parallel import make_mesh

import tpu_perf_torch.metrics as tmetrics
import tpu_perf_torch.schema as tschema
import tpu_perf_torch.sweep as tsweep
from tpu_perf_torch import cli, config as tconfig, timing as ttiming
from tpu_perf_torch.config import Options
from tpu_perf_torch.driver import Driver
from tpu_perf_torch.ops.collectives import build_op, to_tensor
from tpu_perf_torch.runner import run_point, run_sweep
from tpu_perf_torch.selftest import run_selftest
from tpu_perf_torch.world import SimWorld, from_world, to_world

CPU = torch.device("cpu")
RTOL = {"float32": 1e-6, "bfloat16": 8e-3, "int32": 0, "uint8": 0}

SLICE_OPS = ["pl_allreduce", "pl_reduce_scatter", "pl_all_gather",
             "allreduce", "hbm_stream", "pl_hbm_stream"]


def _compare_with_xla(op, n, nbytes, iters, dtype):
    mesh = make_mesh(devices=jax.devices()[:n])
    jb = jax_build_op(op, mesh, nbytes, iters, dtype=dtype)
    x = np.asarray(jax.device_get(jb.example_input)).astype(np.float64)
    want = np.asarray(jax.device_get(jb.step(jb.example_input))).astype(np.float64)
    pb = build_op(op, SimWorld(n, CPU), nbytes, iters, dtype=dtype)
    xt = to_tensor(to_world(x, n), dtype, CPU)
    assert torch.equal(xt, pb.example_input)
    got = from_world(pb.step(xt)).astype(np.float64)
    assert (pb.nbytes, pb.n_devices) == (jb.nbytes, jb.n_devices)
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("n", [5, 8])
def test_allreduce_matches_xla_psum(n, iters, dtype, eight_devices):
    _compare_with_xla("allreduce", n, 4 * 33, iters, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "uint8"])
def test_hbm_stream_matches_xla_body(dtype, eight_devices):
    _compare_with_xla("hbm_stream", 8, 4 * 33, 3, dtype)


# --- the CLI: rows that tpu_perf.schema parses, on the JAX curve keys ---


def _csv_rows(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    assert lines[0] == jschema.RESULT_HEADER
    return [jschema.ResultRow.from_csv(ln) for ln in lines[1:]]


@pytest.mark.parametrize("op", SLICE_OPS)
def test_cli_rows_parse_and_match_the_jax_cli(op, eight_devices, capsys):
    # one small point: the JAX side runs its kernels under the interpreter
    flags = ["run", "--op", op, "-b", "4K", "-i", "1", "-r", "2"]
    assert cli.main(flags + ["--device", "cpu"]) == 0
    port = _csv_rows(capsys.readouterr().out)
    assert jax_cli.main(flags) == 0
    ref = _csv_rows(capsys.readouterr().out)
    assert [(r.op, r.nbytes, r.n_devices, r.iters, r.run_id) for r in port] \
        == [(r.op, r.nbytes, r.n_devices, r.iters, r.run_id) for r in ref]
    for r in port:
        assert r.backend == "torch-sim"
        assert r.lat_us > 0 and r.busbw_gbps > 0 and r.dtype == "float32"


def test_cli_writes_both_log_families(tmp_path, capsys):
    assert cli.main(["run", "--op", "pl_allreduce", "-b", "4K", "-i", "2",
                     "-r", "3", "-l", str(tmp_path), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""  # a logfolder without --csv
    # the two log families, and beside them the run's phase sidecar
    names = sorted(n for n in os.listdir(tmp_path) if n.endswith(".log"))
    assert [n.split("-")[0] for n in names] == ["tcp", "tpu"]
    assert [n.split("-")[0] for n in os.listdir(tmp_path)
            if not n.endswith(".log")] == ["phase"]
    tcp = (tmp_path / names[0]).read_text().splitlines()
    tpu = (tmp_path / names[1]).read_text().splitlines()
    legacy = [jschema.LegacyRow.from_csv(ln) for ln in tcp]
    rows = [jschema.ResultRow.from_csv(ln) for ln in tpu]
    assert [r.run_id for r in rows] == [1, 2, 3] == [r.run_id for r in legacy]
    assert {r.buffer_size for r in legacy} == {4096}
    assert {r.num_buffers for r in legacy} == {2}
    assert len({r.job_id for r in rows} | {r.job_id for r in legacy}) == 1


def test_driver_rotates_logs_on_the_refresh_period(tmp_path):
    now = [1_000_000.0]

    def clock():
        now[0] += 600  # every call moves the fake clock 10 minutes on
        return now[0]

    opts = Options(op="hbm_stream", buff_sz=64, iters=1, num_runs=4,
                   logfolder=str(tmp_path), device="cpu",
                   log_refresh_sec=900)
    Driver(opts, clock=clock).run()
    tpu = [n for n in os.listdir(tmp_path) if n.startswith("tpu-")]
    assert len(tpu) > 1
    rows = [ln for n in tpu for ln in (tmp_path / n).read_text().splitlines()]
    assert len(rows) == 4


@pytest.mark.parametrize("fence", ["block", "readback", "slope"])
def test_cpu_fences_time_the_plain_versions(fence):
    opts = Options(op="pl_allreduce", buff_sz=256, iters=2, num_runs=2,
                   fence=fence, device="cpu")
    point = run_point(opts, SimWorld(8, CPU), 256)
    rows = point.rows("job", backend="torch-sim")
    assert len(rows) == 2 and all(r.time_ms > 0 for r in rows)


def test_trace_fence_needs_a_card():
    opts = Options(op="hbm_stream", buff_sz=64, fence="trace", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        run_point(opts, SimWorld(2, CPU), 64)


@pytest.mark.parametrize("fence", ["fused", "auto"])
def test_unported_fences_say_so(fence, capsys):
    # both fences are ported now: the options take them and a CPU run
    # writes rows, with no "not yet ported" anywhere
    assert Options(fence=fence).fence == fence
    assert cli.main(["run", "--fence", fence, "--device", "cpu", "-b", "64",
                     "-r", "2"]) == 0
    out, err = capsys.readouterr()
    assert "not yet ported" not in err
    assert len(_csv_rows(out)) == 2


def test_run_sweep_covers_the_sweep_with_one_rank_world():
    opts = Options(op="pl_hbm_stream", sweep="8:64", iters=1, device="cpu",
                   sim_ranks=1)
    points = list(run_sweep(opts, SimWorld(1, CPU)))
    assert [p.nbytes for p in points] == [8, 16, 32, 64]
    assert SimWorld(1, CPU).backend == "torch"


@pytest.mark.parametrize("dtype,n,iters", [("float32", 8, 3), ("float32", 5, 1),
                                           ("bfloat16", 8, 2), ("int32", 5, 3)])
def test_selftest_models_pass_on_the_cpu(dtype, n, iters):
    results = run_selftest(SimWorld(n, CPU), dtype=dtype, iters=iters)
    assert not [r for r in results if r.status == "fail"], results
    assert sum(r.status == "ok" for r in results) >= 3


def test_selftest_cli_and_ops_listing(capsys):
    # at 5 ranks the six pair ops (even rank counts only) skip, and so
    # does hier_allreduce (one axis)
    assert cli.main(["selftest", "--device", "cpu", "--sim-ranks", "5"]) == 0
    assert "26 ok, 7 skipped, 0 failed" in capsys.readouterr().out
    assert cli.main(["ops"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert "pl_allreduce" in listed and "pl_all_to_all" in listed


def _small_bench(monkeypatch):
    """bench's sizes patched small (they are module constants)."""
    import tpu_perf_torch.bench as bench

    monkeypatch.setattr(bench, "STREAM_POINTS", ((1, 2), (1, 3)))
    monkeypatch.setattr(bench, "STREAM_RUNS", 3)
    monkeypatch.setattr(bench, "MXU_M", 128)
    monkeypatch.setattr(bench, "MXU_ITERS", 2)
    monkeypatch.setattr(bench, "MXU_RUNS", 3)
    monkeypatch.setattr(bench, "DISPATCH_RUNS", 4)
    monkeypatch.setattr(bench, "CONTEND_RUNS", 3)
    monkeypatch.setattr(bench, "STREAM_POINT", (4096, 2, 2))
    monkeypatch.setattr(bench, "ALLREDUCE_POINT", (8, 4096, 2, 2))
    return bench


#: bench's JAX one-device labels at the patched sizes: (label, peak
#: family, dtype)
BENCH_SET = (("hbm_stream_busbw_p50@1MiB[1dev]", "hbm", "float32"),
             ("hbm_triad_busbw_p50@1MiB[1dev]", "hbm", "float32"),
             ("mxu_gemm_tflops_p50@m128bf16[1dev]", "mxu", "bfloat16"))


def test_bench_prints_one_labelled_json_line(monkeypatch, capsys):
    _small_bench(monkeypatch)
    assert cli.main(["bench", "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    payload = json.loads(line)
    # the JAX package's one-device set first, then the port's own entries
    assert payload["metric"] == "hbm_stream_busbw_p50@1MiB[1dev]"
    assert [m.get("metric") for m in payload["metrics"][:3]] == \
        [label for label, _, _ in BENCH_SET]
    assert [m.get("op") for m in payload["metrics"][3:]] == [
        "pl_hbm_stream", "hbm_stream", "pl_allreduce"]
    assert all(m["card"] == {"name": "cpu", "power_limit": "not measured"}
               for m in payload["metrics"])
    assert payload["metrics"][5]["backend"] == "torch-sim"
    # on the CPU no ratio is given
    assert payload["vs_peak"] is None
    assert all(m["vs_peak"] is None for m in payload["metrics"][:3])
    d = payload["dispatch_overhead"]
    assert d["lanes"] == 4 and [p["nbytes"] for p in d["points"]] == \
        [8, 512, 4096]
    assert all(p["host_us"] > 0 and p["overlapped_us"] > 0
               and p["fused_us"] > 0 for p in d["points"])
    c = payload["contention"]
    assert (c["op"], c["load"], c["nbytes"], c["n_devices"]) == \
        ("allreduce", "hbm_stream", 262144, 1)
    assert c["slowdown"] == pytest.approx(c["loaded_lat_us"]
                                          / c["idle_lat_us"])


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL"])
def test_bench_divides_by_the_detected_cards_peak(name, monkeypatch):
    # the bench fault: every ratio was taken against the H100 SXM's
    # 3350 GB/s whatever card was present
    from tpu_perf_torch import chips

    bench = _small_bench(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    spec = bench.card_entry(torch.device("cuda", 0))
    assert spec is chips.card_spec(name)
    assert bench.instrument("m", 1000.0, "GB/s", spec, "hbm", "float32",
                            "trace", 1, 0)["vs_peak"] == 1000.0 / spec.hbm_gbps
    assert bench.instrument("m", 500.0, "TFLOP/s", spec, "mxu", "bfloat16",
                            "trace", 1, 0)["vs_peak"] == \
        500.0 / spec.bf16_tflops
    # a whole bench against that entry (run on the CPU): each of the JAX
    # set's ratios divides by the card's own peak for its family
    monkeypatch.setattr(bench, "card_entry", lambda device: spec)
    payload = bench.main("cpu")
    for m, (label, family, dtype) in zip(payload["metrics"], BENCH_SET):
        peak = spec.hbm_gbps if family == "hbm" else spec.bf16_tflops
        assert m["metric"] == label
        assert m["vs_peak"] == pytest.approx(m["value"] / peak, rel=1e-3)
    assert payload["vs_peak"] == payload["metrics"][0]["vs_peak"]


def test_bench_gives_no_ratio_on_the_cpu_and_raises_on_an_unknown_card(
        monkeypatch):
    from tpu_perf_torch import chips

    bench = _small_bench(monkeypatch)
    assert bench.card_entry(CPU) is None
    assert bench.instrument("m", 1.0, "GB/s", None, "hbm", "float32",
                            "slope", 1, 0)["vs_peak"] is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(chips.UnknownCardError, match="not in the spec table"):
        bench.card_entry(torch.device("cuda", 0))


# --- the copied tables stay the JAX package's ---


def _row_variants():
    base = dict(timestamp="2026-01-01 00:00:00.000", job_id="j",
                backend="torch-sim", op="pl_allreduce", nbytes=4096, iters=10,
                run_id=1, n_devices=8, lat_us=12.3456, algbw_gbps=1.23456789,
                busbw_gbps=2.3456789, time_ms=0.1234)
    return [base, {**base, "dtype": "bfloat16", "ci_rel": 0.0123},
            {**base, "span_id": "s1"}, {**base, "algo": "ring"},
            {**base, "skew_us": 250}, {**base, "imbalance": 4},
            {**base, "stream": 2}, {**base, "load": "hbm_stream"}]


@pytest.mark.parametrize("fields", _row_variants())
def test_result_rows_render_byte_identical(fields):
    line = tschema.ResultRow(**fields).to_csv()
    assert line == jschema.ResultRow(**fields).to_csv()
    assert tschema.ResultRow.from_csv(line).to_csv() == line


def test_schema_headers_and_legacy_rows_match():
    assert tschema.RESULT_HEADER == jschema.RESULT_HEADER
    assert tschema.LEGACY_HEADER == jschema.LEGACY_HEADER
    assert (tschema.LEGACY_PREFIX, tschema.EXT_PREFIX) == (
        jschema.LEGACY_PREFIX, jschema.EXT_PREFIX)
    f = dict(timestamp="t", job_id="j", rank=0, vm_count=1, local_ip="1.2.3.4",
             remote_ip="1.2.3.4", num_flows=1, buffer_size=64, num_buffers=10,
             time_taken_ms=1.23456, run_id=3)
    assert tschema.LegacyRow(**f).to_csv() == jschema.LegacyRow(**f).to_csv()


def test_bus_factors_match():
    for op in tmetrics.KNOWN_OPS:
        for n in range(1, 9):
            # the JAX package reaches some ops' factors through an alias
            assert (tmetrics._BUS_FACTORS[op](n)
                    == jmetrics._BUS_FACTORS[jmetrics.metric_op(op)](n))
    samples = [3.0, 1.0, 2.0, 5.0, 4.5]
    assert tmetrics.summarize(samples) == jmetrics.summarize(samples)
    assert (tmetrics.bus_bandwidth_gbps("pl_allreduce", 4096, 1e-5, 8)
            == jmetrics.bus_bandwidth_gbps("pl_allreduce", 4096, 1e-5, 8))


@pytest.mark.parametrize("spec", ["8:1G", "4K:256M", "4M", "8,64K,4M", "13"])
@pytest.mark.parametrize("align", [1, 2, 4])
def test_parse_sweep_matches(spec, align):
    assert tsweep.parse_sweep(spec, align=align) == jsweep.parse_sweep(spec, align=align)


def test_config_defaults_match():
    assert tconfig.DEF_ITERS == jconfig.DEF_ITERS
    assert tsweep.DEF_BUF_SZ == jsweep.DEF_BUF_SZ
    assert tconfig.SUPPORTED_DTYPES == jconfig.SUPPORTED_DTYPES
    assert tconfig.FENCE_MODES == jtiming.FENCE_MODES
    assert ttiming.SLOPE_ITERS_FACTOR == jtiming.SLOPE_ITERS_FACTOR
    t, j = Options(), jconfig.Options()
    assert (t.op, t.iters, t.buff_sz, t.num_runs, t.fence, t.dtype,
            t.warmup_runs, t.uni_dir, t.nonblocking) \
        == (j.op, j.iters, j.buff_sz, j.num_runs, j.fence, j.dtype,
            j.warmup_runs, j.uni_dir, j.nonblocking)


@pytest.mark.parametrize("bad", [dict(iters=0), dict(buff_sz=-1),
                                 dict(num_runs=0), dict(fence="nope"),
                                 dict(dtype="float64")])
def test_config_validation_messages_match(bad):
    with pytest.raises(ValueError) as ours:
        Options(**bad)
    with pytest.raises(ValueError) as theirs:
        jconfig.Options(**bad)
    assert str(ours.value) == str(theirs.value)


def test_world_layout_round_trip():
    g = np.arange(24, dtype=np.float32)
    rows = to_world(g, 4)
    assert rows.shape == (4, 6) and rows[1, 0] == 6
    assert np.array_equal(from_world(torch.from_numpy(rows)), g)
    with pytest.raises(ValueError):
        to_world(g, 5)
    bf = from_world(torch.ones(2, 3, dtype=torch.bfloat16))
    assert bf.dtype == np.float32 and bf.shape == (6,)

