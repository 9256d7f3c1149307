"""The port's compute instruments against the JAX package, on the CPU:
``mxu_gemm`` and ``overlap_ring`` (the ops, their sizing, the orthogonal
matrix, the FLOP model and the selftest models), the report's derived
TFLOP/s column, the grid's compute family and the card table's peaks.

Tolerances: the sizing, the matrix and the FLOP model are exact.  The
ops: float32 ``|port - jax| <= 1e-5 * (1 + |jax|)`` (both sides round the
same operations to float32; the port folds the wrap-add into one
``addmm``, so its multiply-add rounds once where XLA rounds twice, and
the products may sum in other orders); bfloat16 ``8e-3 * (1 + |jax|)``,
one bfloat16 unit in the last place.  The ring part of ``overlap_ring``
moves bytes and is held exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tpu_perf.grid as jgrid
import tpu_perf.metrics as jmetrics
import tpu_perf.report as jreport
import tpu_perf.schema as jschema
import tpu_perf.selftest as jselftest
from tpu_perf.ops import build_op as jax_build_op
from tpu_perf.ops import collectives as jcoll
from tpu_perf.parallel import make_mesh

from tpu_perf_torch import chips, cli, grid, metrics, report, selftest
from tpu_perf_torch.ops import collectives as coll
from tpu_perf_torch.ops.collectives import build_op, to_tensor
from tpu_perf_torch.schema import ResultRow
from tpu_perf_torch.world import SimWorld, from_world, to_world

CPU = torch.device("cpu")
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
COMPUTE_OPS = ("mxu_gemm", "overlap_ring")


def _nbytes(op: str, m: int, itemsize: int) -> int:
    # mxu_gemm: the m x m operand; overlap_ring: a ring payload whose
    # compute block has side m, and which is no multiple of 128 elements
    return m * m * itemsize if op == "mxu_gemm" else (m * m + 37) * itemsize


def _held(got, want, dtype, r=0):
    """The port's output against the JAX op's, both (n, elems): the first
    ``r`` elements of a rank (overlap_ring's ring part) exactly, the rest
    within TOL."""
    np.testing.assert_array_equal(got[:, :r], want[:, :r])
    err = np.abs(got[:, r:] - want[:, r:])
    bound = TOL[dtype] * (1 + np.abs(want[:, r:]))
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", COMPUTE_OPS)
def test_compute_op_matches_jax(op, dtype, n, m, iters, eight_devices):
    isz = coll.DTYPES[dtype].itemsize
    nbytes = _nbytes(op, m, isz)
    mesh = make_mesh(devices=jax.devices()[:n])
    jb = jax_build_op(op, mesh, nbytes, iters, dtype=dtype)
    x = np.asarray(jax.device_get(jb.example_input)).astype(np.float64)
    want = np.asarray(jax.device_get(jb.step(jb.example_input))).astype(
        np.float64).reshape(n, -1)
    pb = build_op(op, SimWorld(n, CPU), nbytes, iters, dtype=dtype)
    xt = to_tensor(to_world(x, n), dtype, CPU)
    assert torch.equal(xt, pb.example_input)
    assert (pb.nbytes, pb.n_devices, pb.iters) == (jb.nbytes, jb.n_devices,
                                                   iters)
    got = from_world(pb.step(xt)).astype(np.float64).reshape(n, -1)
    r = 0 if op == "mxu_gemm" else coll._overlap_split(got.shape[1])[0]
    _held(got, want, dtype, r)


def test_one_iteration_is_no_identity():
    # the product changes every element, and the ring part moves: a step
    # that skipped either would show at one iteration
    for op in COMPUTE_OPS:
        pb = build_op(op, SimWorld(4, CPU), _nbytes(op, 128, 4), 1)
        x = pb.example_input
        out = pb.step(x)
        assert out.shape == x.shape and not torch.isclose(out, x).all()


@pytest.mark.parametrize("op", COMPUTE_OPS)
def test_payload_elems_matches_jax(op):
    for itemsize in (2, 4):
        for nbytes in (1, 64, 4095, 65536, 65537, 1 << 20, 3 << 20, 1 << 24,
                       (1 << 26) + 6, 1 << 28, 1 << 30):
            for n in (1, 8):
                assert (coll.payload_elems(op, nbytes, n, itemsize)
                        == jcoll.payload_elems(op, nbytes, n, itemsize))


def test_sizing_constants_and_split_match_jax():
    assert (coll._GEMM_MIN_M, coll._GEMM_MAX_M, coll._OVERLAP_MAX_M) == \
        (jcoll._GEMM_MIN_M, jcoll._GEMM_MAX_M, jcoll._OVERLAP_MAX_M)
    for elems in (1, 100, 16383, 16384, 1 << 20, 1 << 26):
        assert coll._gemm_m(elems) == jcoll._gemm_m(elems)
        assert coll._gemm_m(elems, 2048) == jcoll._gemm_m(elems, 2048)
    for nbytes in (4, 4096, 1 << 20, 1 << 28):
        total, _ = coll.payload_elems("overlap_ring", nbytes, 8, 4)
        assert coll._overlap_split(total) == jcoll._overlap_split(total)
    with pytest.raises(ValueError, match="not an overlap_ring payload"):
        coll._overlap_split(100)


@pytest.mark.parametrize("m", [128, 256, 384])
def test_ortho_is_the_jax_matrix_bit_for_bit(m):
    ours = coll._ortho(m)
    assert np.array_equal(ours, jcoll._ortho(m))
    assert np.array_equal(selftest._ortho(m), ours)
    assert np.allclose(ours @ ours.T, np.eye(m), atol=1e-12)


def test_float_only_ops_hold_both_compute_ops():
    for op in COMPUTE_OPS:
        assert op in coll.FLOAT_ONLY_OPS and op in jcoll.FLOAT_ONLY_OPS
        with pytest.raises(ValueError, match="needs a float dtype"):
            build_op(op, SimWorld(1, CPU), 4096, 1, dtype="int32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32", "uint8", "float64"])
def test_flops_per_iter_matches_jax(dtype):
    assert metrics.DTYPE_ITEMSIZE == jmetrics.DTYPE_ITEMSIZE
    for op in ("mxu_gemm", "hbm_stream", "pl_allreduce"):
        for nbytes in (128 * 128 * 2, 4096 * 4096 * 2, 4096 * 4096 * 4, 7):
            assert (metrics.flops_per_iter_dtype(op, nbytes, dtype)
                    == jmetrics.flops_per_iter_dtype(op, nbytes, dtype))
    assert metrics.flops_per_iter("mxu_gemm", 4096 * 4096 * 2, 2) == \
        2.0 * 4096 ** 3


@pytest.mark.parametrize("op", COMPUTE_OPS)
def test_selftest_models_match_jax(op):
    n, m = 8, 128
    elems = m * m + (0 if op == "mxu_gemm" else 1000)
    x = np.random.default_rng(11).standard_normal((n, elems))
    np.testing.assert_array_equal(selftest.EXPECTATIONS[op](x),
                                  jselftest.EXPECTATIONS[op](x))
    assert selftest._MATMUL_OPS == jselftest._MATMUL_OPS
    assert selftest._MATMUL_RTOL_CPU == jselftest._MATMUL_RTOL_CPU
    assert selftest._MATMUL_RTOL_CARD == jselftest._MATMUL_RTOL_TPU


@pytest.mark.parametrize("dtype,iters", [("float32", 3), ("bfloat16", 1)])
def test_selftest_passes_the_compute_ops(dtype, iters):
    results = selftest.run_selftest(SimWorld(8, CPU), ops=list(COMPUTE_OPS),
                                    nbytes=65536, dtype=dtype, iters=iters)
    assert [r.status for r in results] == ["ok", "ok"], results


# --- the report's TFLOP/s column ----------------------------------------


def _compute_rows():
    rows = []
    for op, nbytes, dtype in (("mxu_gemm", 4096 * 4096 * 2, "bfloat16"),
                              ("mxu_gemm", 1024 * 1024 * 4, "float32"),
                              ("hbm_stream", 4096, "float32")):
        for run_id, lat in enumerate((170.0, 173.5, 180.25), start=1):
            rows.append(ResultRow(
                timestamp="2026-01-01 00:00:00.000", job_id="j",
                backend="torch", op=op, nbytes=nbytes, iters=5,
                run_id=run_id, n_devices=1, lat_us=lat + nbytes % 7,
                algbw_gbps=1.5, busbw_gbps=4.5, time_ms=lat * 5e-3,
                dtype=dtype))
    return rows


def _as_jax(rows):
    return [jschema.ResultRow.from_csv(r.to_csv()) for r in rows]


def test_report_tflops_matches_jax(tmp_path):
    rows = _compute_rows()
    ours, theirs = report.aggregate(rows), jreport.aggregate(_as_jax(rows))
    assert [p.tflops for p in ours] == [p.tflops for p in theirs]
    assert sum(p.tflops is not None for p in ours) == 2
    # the streamed aggregate derives the same column
    path = tmp_path / "tpu-j-0-20260101-000000.log"
    path.write_text("".join(r.to_csv() + "\n" for r in rows))
    streamed = report.stream_aggregate([str(path)])
    assert [p.tflops for p in streamed] == [p.tflops for p in ours]
    assert report.to_markdown(ours) == jreport.to_markdown(theirs)


def test_report_tflops_degrades_on_a_non_positive_latency():
    rows = _compute_rows()[:3]
    rows[1] = dataclasses.replace(rows[1], lat_us=0.0)
    (ours,) = report.aggregate(rows)
    (theirs,) = jreport.aggregate(_as_jax(rows))
    assert ours.tflops is None and theirs.tflops is None
    assert ours.busbw_gbps == theirs.busbw_gbps


# --- the grid's compute family and the card's peaks ---------------------


@pytest.mark.parametrize("name,bf16,f32", [
    ("NVIDIA H100 80GB HBM3", 989.0, 67.0),
    ("NVIDIA H100 PCIe", 756.0, 51.0),
    ("NVIDIA H100 NVL", 835.0, 60.0),
])
def test_card_peak_by_family_and_dtype(name, bf16, f32):
    spec = chips.card_spec(name)
    assert chips.card_peak(spec, "mxu", "bfloat16") == bf16
    assert chips.card_peak(spec, "mxu", "float16") == bf16
    assert chips.card_peak(spec, "mxu", "float32") == f32
    assert chips.card_peak(spec, "hbm", "uint8") == spec.hbm_gbps
    with pytest.raises(ValueError, match="no compute peak"):
        chips.card_peak(spec, "mxu", "int32")
    with pytest.raises(ValueError, match="unknown peak family"):
        chips.card_peak(spec, "ici", "float32")


def test_run_grid_judges_compute_cells_in_tflops():
    cells = grid.run_grid(SimWorld(1, CPU), "mxu_gemm", [128 * 128 * 4],
                          [1, 2], runs=3, fence="block", spec_tflops=1e6)
    assert [c.unit for c in cells] == ["TFLOP/s"] * 2
    assert all(c.verdict == "ok" and c.p50 > 0 for c in cells)
    assert sum(c.chosen for c in cells) == 1
    flops = metrics.flops_per_iter("mxu_gemm", 128 * 128 * 4, 4)
    assert cells[0].p50 == pytest.approx(
        flops / (cells[0].lat_p50_us * 1e-6) / 1e12, rel=0.5)
    low = grid.run_grid(SimWorld(1, CPU), "mxu_gemm", [128 * 128 * 4], [1],
                        runs=2, fence="block", spec_tflops=1e-9)
    assert low[0].verdict == "unphysical"
    assert "TFLOP/s p25/p50/p75 (TFLOP/s)" in grid.grid_to_markdown(cells)


@pytest.mark.parametrize("kw,match", [
    (dict(spec_tflops=1.0, spec_gbps=1.0), "ONE metric"),
    (dict(floor_tflops=1.0), "no FLOP model"),
])
def test_run_grid_refuses_mixed_compute_grids(kw, match):
    ops = "mxu_gemm" if "spec_gbps" in kw else "mxu_gemm,hbm_stream"
    with pytest.raises(ValueError, match=match):
        grid.run_grid(SimWorld(1, CPU), ops, [4096], [1], **kw)
    with pytest.raises(ValueError, match=match):
        jgrid.run_grid(make_mesh(devices=jax.devices()[:1]), ops, [4096],
                       [1], **kw)


def _patched_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_spec_mxu_takes_the_detected_cards_peak(name, dtype,
                                                     monkeypatch, capsys):
    _patched_card(monkeypatch, name)
    spec = chips.card_spec(name)
    peak = chips.card_peak(spec, "mxu", dtype)
    rc = cli.main(["grid", "--op", "mxu_gemm", "--sizes", "32K", "--iters",
                   "1", "-r", "2", "--fence", "block", "--spec", "mxu",
                   "--dtype", dtype, "--device", "cpu", "--sim-ranks", "1"])
    out = capsys.readouterr().out
    # the card's floor comes with its peak: the CPU's product rate is far
    # under it, so the cell is degraded and no operating point is chosen
    assert rc == 4
    assert f"TFLOP/s spec ceiling {peak:g} TFLOP/s ({name}, card table, " \
        f"{dtype}); floor {spec.mxu_floor_tflops[dtype]:g} TFLOP/s" in out
    # 32K asks for m = 128: the m x m operand in the dtype
    size = "64K" if dtype == "float32" else "32K"
    assert f"| mxu_gemm | {size} | {dtype} |" in out
    assert "| degraded |" in out and "chosen" not in out


def test_grid_spec_mxu_on_an_unknown_card_raises(monkeypatch, capsys):
    _patched_card(monkeypatch, "NVIDIA A100-SXM4-80GB")
    rc = cli.main(["grid", "--op", "mxu_gemm", "--sizes", "32K", "--iters",
                   "1", "--spec", "mxu", "--device", "cpu"])
    assert rc == 2
    assert "not in the spec table" in capsys.readouterr().err


def test_grid_spec_tflops_needs_no_card(capsys):
    rc = cli.main(["grid", "--op", "mxu_gemm", "--sizes", "32K,64K",
                   "--iters", "1", "-r", "2", "--fence", "block",
                   "--spec-tflops", "67", "--device", "cpu",
                   "--sim-ranks", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "67 TFLOP/s (--spec-tflops)" in out


# --- the run path ------------------------------------------------------


def test_cli_runs_the_compute_family_rows_the_jax_schema_parses(capsys):
    assert cli.main(["run", "--op", "mxu_gemm,overlap_ring", "-b", "64K",
                     "-i", "3", "-r", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()[1:]
    rows = [jschema.ResultRow.from_csv(ln) for ln in lines]
    assert [(r.op, r.nbytes, r.n_devices, r.backend) for r in rows] == \
        [("mxu_gemm", 65536, 8, "torch-sim")] * 2 \
        + [("overlap_ring", 65536, 8, "torch-sim")] * 2
    # overlap_ring's busbw counts the ring payload only, mxu_gemm's three
    # matrices (the CSV keeps six significant digits)
    assert rows[0].busbw_gbps == pytest.approx(3 * rows[0].algbw_gbps,
                                               rel=1e-5)
    assert rows[2].busbw_gbps == pytest.approx(rows[2].algbw_gbps, rel=1e-5)


def test_overlap_ring_under_the_fused_fence(capsys):
    assert cli.main(["run", "--op", "overlap_ring", "-b", "4K", "-i", "2",
                     "-r", "3", "--fence", "fused", "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.splitlines()[1:]
    assert len(rows) == 3


def test_gemm_operands_are_rounded_to_the_dtype():
    q, alpha, bias = coll._gemm_operands(128, "bfloat16", CPU)
    assert q.dtype == torch.bfloat16 and alpha == 1.0
    assert bias.is_contiguous() and bias.shape == (128,)
    assert bias[0].item() == torch.tensor(1e-7, dtype=torch.bfloat16).item()
    q32, alpha32, _ = coll._gemm_operands(128, "float32", CPU)
    assert alpha32 == float(np.float32(1.0000001))
    assert np.array_equal(q32.numpy(), coll._ortho(128).astype(np.float32))
