"""The port's card table and operating-point grid, on the CPU: the Hopper
spec table, the grid's verdicts and table against the JAX package's on
the same synthetic cells, and ``grid`` / ``chips`` end to end through the
CLI with rows that the JAX schema parses."""

import itertools
import os

import pytest
import torch

import tpu_perf.grid as jgrid
import tpu_perf.schema as jschema

from tpu_perf_torch import chips, cli
from tpu_perf_torch import grid as tgrid
from tpu_perf_torch.world import NoDeviceError, SimWorld

CPU = torch.device("cpu")

# --- the card table -----------------------------------------------------


@pytest.mark.parametrize("name,kind,hbm", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm", 3350.0),
    ("NVIDIA H100 PCIe", "h100-pcie", 2000.0),
    ("NVIDIA H100 NVL", "h100-nvl", 3900.0),
])
def test_each_h100_name_resolves_to_its_own_entry(name, kind, hbm):
    spec = chips.card_spec(name)
    assert (spec.kind, spec.hbm_gbps, spec.device_name) == (kind, hbm, name)
    assert chips.resolve_card(f"  {name.lower()} ") is spec


def test_published_peaks():
    table = {k: (c.hbm_gbps, c.bf16_tflops, c.f32_tflops)
             for k, c in chips.CARDS.items()}
    assert table == {"h100-sxm": (3350.0, 989.0, 67.0),
                     "h100-pcie": (2000.0, 756.0, 51.0),
                     "h100-nvl": (3900.0, 835.0, 60.0)}


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H200",
                                  "TPU v5 lite", ""])
def test_an_unknown_card_raises_and_names_the_flag(name):
    assert chips.resolve_card(name) is None
    with pytest.raises(chips.UnknownCardError, match="--spec-gbps"):
        chips.card_spec(name)


def test_no_card_raises_rather_than_guessing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chips.detected_name() is None
    with pytest.raises(chips.UnknownCardError, match="--spec-gbps"):
        chips.card_spec()


def test_no_entry_has_a_floor():
    # the JAX floors are v5e ratios, TPU figures: no entry carries one.
    # The SXM's floors were measured on the card; the other entries' are
    # the SXM's floor-to-peak ratios times their own peaks
    import tpu_perf.chips as jchips

    v5e = jchips.V5E
    sxm = chips.CARDS["h100-sxm"]
    assert sxm.defended
    for spec in chips.CARDS.values():
        assert spec.defended is (spec is sxm)
        assert spec.stream_floor_gbps / spec.hbm_gbps != pytest.approx(
            v5e.stream_floor_gbps / v5e.hbm_gbps, rel=0.01)
        assert spec.stream_floor_gbps / spec.hbm_gbps == pytest.approx(
            sxm.stream_floor_gbps / sxm.hbm_gbps, abs=0.5 / spec.hbm_gbps)


# --- verdicts and table against the JAX package -------------------------


@pytest.mark.parametrize("spec,floor", [(None, None), (100.0, None),
                                        (None, 50.0), (100.0, 50.0)])
def test_judge_matches_jax(spec, floor):
    for p50, p75 in itertools.product([10.0, 50.0, 75.0, 100.0, 130.0],
                                      [None, 60.0, 99.0, 101.0, 140.0]):
        assert (tgrid.judge(p50, spec, floor, p75=p75)
                == jgrid.judge(p50, spec, floor, p75=p75))


def _cells():
    # two ops: stable vs wide cells, an unphysical and a failed one, a
    # p50 tie, a cell under the 0.8 best-p50 fraction, a noted cell
    rows = [
        ("hbm_read", 256 << 20, 8, 2800.0, 2900.0, 2950.0, "ok", ""),
        ("hbm_read", 256 << 20, 32, 2890.0, 2900.0, 2910.0, "ok", ""),
        ("hbm_read", 1 << 30, 8, 2000.0, 2010.0, 2020.0, "ok", ""),
        ("hbm_read", 1 << 30, 32, 3300.0, 3400.0, 3500.0, "unphysical",
         "max>spec (slope artifact)"),
        ("pl_hbm_copy", 256 << 20, 8, 2700.0, 2800.0, 2810.0, "ok", ""),
        ("pl_hbm_copy", 256 << 20, 32, 2790.0, 2800.0, 2810.0, "ok", ""),
        ("pl_hbm_copy", 1 << 30, 8, 0.0, 0.0, 0.0, "failed",
         "RuntimeError: boom"),
        ("pl_hbm_write", 4096, 8, 1.0, 2.0, 3.0, "unphysical",
         "p75>spec (jitter-widened)"),
    ]
    out = []
    for op, nbytes, iters, p25, p50, p75, verdict, note in rows:
        fields = dict(op=op, nbytes=nbytes, dtype="float32", iters=iters,
                      n_devices=1, runs=8, drops=0, p25=p25, p50=p50,
                      p75=p75, vmax=p75 + 1.0, lat_p50_us=12.5,
                      verdict=verdict, note=note)
        out.append((tgrid.GridCell(**fields), jgrid.GridCell(**fields)))
    return out


@pytest.mark.parametrize("fence", ["slope", "trace", "block"])
def test_mark_chosen_and_table_match_jax(fence):
    ours = tgrid.mark_chosen([t for t, _ in _cells()])
    theirs = jgrid.mark_chosen([j for _, j in _cells()])
    assert [c.chosen for c in ours] == [c.chosen for c in theirs]
    assert sum(c.chosen for c in ours) == 2
    assert (tgrid.grid_to_markdown(ours, fence=fence)
            == jgrid.grid_to_markdown(theirs, fence=fence))


def test_stability_constants_are_the_jax_ones():
    assert tgrid._STABILITY_FLOOR == jgrid._STABILITY_FLOOR
    assert tgrid._CHOSEN_P50_FRACTION == jgrid._CHOSEN_P50_FRACTION


def test_caption_says_when_no_cell_can_be_degraded():
    text = tgrid.grid_caption(3350.0, None, "NVIDIA H100 80GB HBM3, card table")
    assert "3350 GB/s" in text and "no cell is judged degraded" in text
    assert "degraded" not in tgrid.grid_caption(3350.0, 2500.0, "--spec-gbps")


# --- run_grid and the CLI -----------------------------------------------


def test_run_grid_records_a_failing_cell_and_keeps_going():
    world = SimWorld(1, CPU)
    cells = tgrid.run_grid(world, ["hbm_write", "allreduce"], [4096], [2],
                           dtype="int32", runs=2, fence="block",
                           spec_gbps=1e9)
    by_op = {c.op: c for c in cells}
    assert by_op["hbm_write"].verdict == "ok" and by_op["hbm_write"].chosen
    assert by_op["allreduce"].verdict == "failed"
    assert "float dtype" in by_op["allreduce"].note


@pytest.mark.parametrize("ops,err", [
    ("nope", ValueError), ("allgatherv", ValueError),
    ("", ValueError), ("pl_barrier", ValueError),
])
def test_run_grid_refuses_bad_op_lists_up_front(ops, err):
    with pytest.raises(err):
        tgrid.run_grid(SimWorld(1, CPU), ops, [4096], [1])


def test_grid_cli_writes_rows_the_jax_schema_parses(tmp_path, capsys):
    rc = cli.main(["grid", "--op", "hbm_stream", "--sizes", "4K",
                   "--iters", "2,4", "-r", "3", "--device", "cpu",
                   "--sim-ranks", "1", "--spec-gbps", "1e9",
                   "-l", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "floor none: no cell is judged degraded" in out
    assert out.count("| hbm_stream | 4K |") == 2 and "chosen" in out
    (name,) = os.listdir(tmp_path)
    assert name.startswith("tpu-")
    rows = [jschema.ResultRow.from_csv(ln)
            for ln in (tmp_path / name).read_text().splitlines()]
    assert len(rows) == 6 and len({r.job_id for r in rows}) == 1
    assert {(r.op, r.nbytes, r.backend, r.n_devices) for r in rows} == {
        ("hbm_stream", 4096, "torch", 1)}
    assert sorted({r.iters for r in rows}) == [2, 4]


def test_grid_cli_exits_4_when_an_op_has_no_ok_cell(capsys):
    rc = cli.main(["grid", "--op", "pl_hbm_copy", "--sizes", "4K",
                   "--iters", "1", "-r", "2", "--device", "cpu",
                   "--sim-ranks", "1", "--spec-gbps", "1e-9"])
    assert rc == 4
    assert "no ok operating point for pl_hbm_copy" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [["--spec", "mxu"], ["--spec-tflops", "1"],
                                   ["--floor-tflops", "1"]])
def test_compute_grids_are_not_yet_ported(extra, monkeypatch, capsys):
    # compute grids are ported now: a bandwidth op in one is refused for
    # having no FLOP model, never as "not yet ported"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    rc = cli.main(["grid", "--op", "hbm_stream", "--sizes", "4K", "--iters",
                   "1", "--device", "cpu"] + extra)
    assert rc == 2
    err = capsys.readouterr().err
    assert "not yet ported" not in err and "no FLOP model" in err


def test_spec_hbm_without_a_card_names_the_flag(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["grid", "--op", "hbm_stream", "--sizes", "4K", "--iters",
                   "1", "--device", "cpu", "--spec", "hbm"])
    assert rc == 2
    assert "--spec-gbps" in capsys.readouterr().err


def test_grid_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError, match="--device cpu"):
        cli.main(["grid", "--op", "hbm_stream", "--sizes", "4K", "--iters",
                  "1", "--spec-gbps", "1e9"])


def test_chips_cli_marks_the_resolved_card(capsys):
    assert cli.main(["chips", "--kind", "NVIDIA H100 NVL"]) == 0
    out = capsys.readouterr().out
    assert "| h100-nvl (detected) | NVIDIA H100 NVL | 3900 |" in out
    # one measured entry, the others derived from it
    assert out.count("| measured |") == 1
    assert out.count("| derived |") == len(chips.CARDS) - 1
    assert cli.main(["chips", "--kind", "NVIDIA A100-SXM4-80GB"]) == 0
    assert "is not in the table" in capsys.readouterr().out


def test_chips_cli_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["chips"]) == 0
    out = capsys.readouterr().out
    assert "no CUDA device is visible" in out and "(detected)" not in out
