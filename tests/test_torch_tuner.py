"""The port's crossover auto-tuner (``tpu_perf_torch.tuner``, ``tune``,
``tune --check``, ``--algo auto``) against the JAX package's on the CPU.

The same rows give the same selection artifact in both packages (the
JSON byte for byte once ``generated``, ``generated_unix``, the card's
name and the rows' source are set aside): crafted rows, and a JAX arena
log made on its 8 CPU devices (its rows' backend relabelled, the one
column that names the package).  ``LoadedSelection.resolve`` and ``--algo
auto``'s planned algorithms agree with JAX's at every point, the stale,
foreign, low-margin and unbuildable fallbacks included; ``tune --check``
exits 0, 10, 2 and 1 where JAX's does; the artifact rides the ``tune-*``
family into the ingest pass; and ``bench``'s ``auto_vs_native`` carries
JAX's keys.  Every comparison is exact: a plan is a static lookup.
"""

import dataclasses
import glob
import io
import json
import os

import pytest
import torch

from tpu_perf import tuner as jtuner
from tpu_perf.config import Options as JOptions
from tpu_perf.report import aggregate as jaggregate
from tpu_perf.schema import ResultRow as JRow

from tpu_perf_torch import cli
from tpu_perf_torch.config import Options
from tpu_perf_torch.report import aggregate
from tpu_perf_torch.schema import RESULT_HEADER, ResultRow, timestamp_now
from tpu_perf_torch.tuner import (
    TUNER_SCHEMA_VERSION, LoadedSelection, SelectionArtifact, SelectionEntry,
    TuneRecord, build_selection, check_drift, current_device_kind,
    load_artifact, read_artifact, write_artifact,
)

CPU = torch.device("cpu")


def _row(row=ResultRow, backend="torch-sim", **kw):
    base = dict(timestamp=timestamp_now(), job_id="j", backend=backend,
                op="allreduce", nbytes=1024, iters=4, run_id=1, n_devices=8,
                lat_us=10.0, algbw_gbps=1.0, busbw_gbps=1.75, time_ms=0.04)
    base.update(kw)
    return row(**base)


def _mk_rows(op, algo, lat_us, nbytes=1024, n=3, row=ResultRow,
             backend="torch-sim", **kw):
    return [_row(row, backend, op=op, algo="" if algo == "native" else algo,
                 nbytes=nbytes, lat_us=lat_us, busbw_gbps=1000.0 / lat_us,
                 run_id=i + 1, **kw) for i in range(n)]


def _arena_rows(winners, **kw):
    """A crafted arena race: per nbytes -> (native_lat, ring_lat), three
    runs each of native, ring and a slower bruck (JAX's test fixture)."""
    rows = []
    for nbytes, (native_lat, ring_lat) in winners.items():
        rows += _mk_rows("allreduce", "native", native_lat, nbytes, **kw)
        rows += _mk_rows("allreduce", "ring", ring_lat, nbytes, **kw)
        rows += _mk_rows("allreduce", "bruck",
                         max(native_lat, ring_lat) * 2, nbytes, **kw)
    return rows


def _both(winners, **kw):
    """The port's and JAX's artifacts from the same crafted rows."""
    kw.setdefault("generated", "2026-01-01T00:00:00Z")
    kw.setdefault("generated_unix", 1000.0)
    ours = build_selection(aggregate(_arena_rows(winners)), **kw)
    theirs = jtuner.build_selection(jaggregate(_arena_rows(
        winners, row=JRow, backend="jax")), **kw)
    return ours, theirs


def _build(winners, **kw):
    return _both(winners, **kw)[0]


# --- the artifact -----------------------------------------------------------


@pytest.mark.parametrize("winners,kw", [
    ({64: (5.0, 9.0), 1 << 20: (100.0, 50.0)}, {}),
    ({1 << 10: (5.05, 5.0)}, {"source": "unit"}),
    ({4096: (9.0, 5.0), 1 << 16: (9.0, 9.0)}, {"device_kind": ""}),
], ids=["two-sizes", "low-margin", "tie"])
def test_the_artifact_is_jaxs(winners, kw):
    ours, theirs = _both(winners, **kw)
    assert ours.to_json() == theirs.to_json()
    assert SelectionArtifact.from_json(theirs.to_json()) == ours
    assert [r.data for r in ours.to_records("j")] == \
        [r.data for r in theirs.to_records("j")]


def test_build_selection_entries_and_margins():
    art = _build({64: (5.0, 9.0), 1 << 20: (100.0, 50.0)})
    assert art.version == TUNER_SCHEMA_VERSION
    assert [(e.nbytes, e.winner) for e in art.entries] == \
        [(64, "native"), (1 << 20, "ring")]
    small, large = art.entries
    assert small.margin == pytest.approx(9.0 / 5.0)
    assert large.margin == pytest.approx(2.0) and large.runner_up == "native"
    assert large.native_vs_best == pytest.approx(2.0)
    assert small.samples == 3 and small.n_devices == 8
    assert set(small.algos) == {"native", "ring", "bruck"}
    assert art.fingerprint == {"tuner_schema": TUNER_SCHEMA_VERSION,
                               "device_kind": "", "chip": "",
                               "n_devices": 8}
    card = _build({64: (5.0, 9.0)}, device_kind="NVIDIA H100 80GB HBM3")
    assert card.fingerprint["chip"] == "h100-sxm"


def test_artifact_json_roundtrip_and_atomic_write(tmp_path):
    art = _build({64: (5.0, 9.0)}, device_kind="cpu", source="unit")
    path = str(tmp_path / "sel.json")
    write_artifact(art, path)
    assert not os.path.exists(path + ".tmp")
    assert read_artifact(path) == art
    write_artifact(read_artifact(path), str(tmp_path / "sel2.json"))
    assert open(path).read() == open(str(tmp_path / "sel2.json")).read()
    # either package reads the other's bytes
    assert jtuner.read_artifact(path).to_json() == art.to_json()


def test_versions_and_garbage_are_refused_loudly(tmp_path):
    data = json.loads(_build({64: (5.0, 9.0)}).to_json())
    data["version"] = TUNER_SCHEMA_VERSION + 1
    for text in (json.dumps(data), "[]"):
        with pytest.raises(ValueError, match="version"):
            SelectionArtifact.from_json(text)
    with pytest.raises(ValueError, match="does not exist"):
        load_artifact(str(tmp_path / "nope.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("not json {")
    with pytest.raises(ValueError, match="not a JSON"):
        load_artifact(str(bad))


def test_a_one_sided_slot_reads_low_confidence():
    art = build_selection(aggregate(_mk_rows("all_gather", "ring", 5.0,
                                             nbytes=256)),
                          generated="g", generated_unix=1.0)
    (e,) = art.entries
    assert (e.winner, e.margin, e.runner_up) == ("ring", 0.0, "")
    assert LoadedSelection(art).resolve("all_gather", 256, "float32",
                                        margin_min=1.0) == "native"


def test_the_card_name_is_the_fingerprint(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert current_device_kind() == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert current_device_kind() == "NVIDIA H100 80GB HBM3"


# --- resolve: the ladder, against JAX's --------------------------------------


def _loaded(art_pair, **kw):
    ours, theirs = art_pair
    jerr, err = io.StringIO(), io.StringIO()
    return (LoadedSelection(ours, err=err, **kw), err,
            jtuner.LoadedSelection(theirs, err=jerr, **kw), jerr)


GRID = ([("allreduce", 1 << s, "float32", {}) for s in range(3, 24)]
        + [("allreduce", 1 << 10, "bfloat16", {}),
           ("allreduce", 1 << 10, "float32", {"skew_us": 500}),
           ("allreduce", 1 << 10, "float32", {"imbalance": 8}),
           ("allreduce", 1 << 10, "float32", {"load": "hbm_stream"}),
           ("all_gather", 4096, "float32", {})])


@pytest.mark.parametrize("kw", [
    {}, {"n_devices": 8, "device_kind": "cpu"},
    {"max_age_sec": 60.0, "now": 2000.0},
    {"max_age_sec": 60.0, "now": 1030.0},
    {"device_kind": "TPU v5e"}, {"n_devices": 4},
], ids=["plain", "matched", "stale", "fresh", "foreign-kind",
        "foreign-count"])
@pytest.mark.parametrize("margin", [1.0, 1.02, 2.0])
def test_resolve_is_jaxs_at_every_point(kw, margin):
    pair = _both({1 << 10: (5.05, 5.0), 1 << 16: (9.0, 5.0),
                  1 << 20: (100.0, 50.0)}, device_kind="cpu")
    ours, err, theirs, jerr = _loaded(pair, **kw)
    assert (ours.stale, ours.foreign) == (theirs.stale, theirs.foreign)
    for op, nbytes, dtype, point in GRID:
        assert ours.resolve(op, nbytes, dtype, margin_min=margin,
                            n_devices=8, err=err, **point) == \
            theirs.resolve(op, nbytes, dtype, margin_min=margin,
                           n_devices=8, err=jerr, **point)
    assert err.getvalue() == jerr.getvalue().replace(
        "[tpu-perf]", "[tpu-perf-torch]").replace("`tpu-perf ",
                                                  "`tpu-perf-torch ")


def test_the_ladders_rungs():
    art = _build({1 << 10: (5.0, 9.0), 1 << 20: (100.0, 50.0)})
    sel = LoadedSelection(art)
    kw = dict(margin_min=1.0, n_devices=8)
    assert [sel.resolve("allreduce", nb, "float32", **kw)
            for nb in (1 << 10, 1 << 20, 8 << 10, 256 << 10, 32 << 10)] == \
        ["native", "ring", "native", "ring", "native"]
    err = io.StringIO()
    assert sel.resolve("all_gather", 1 << 10, "float32", err=err,
                       margin_min=1.0) == "native"
    before = err.getvalue()
    assert "no measured entry" in before
    sel.resolve("all_gather", 1 << 10, "float32", err=err, margin_min=1.0)
    assert err.getvalue() == before  # one note a cause
    low = LoadedSelection(_build({1 << 10: (5.05, 5.0)}))
    err = io.StringIO()
    assert low.resolve("allreduce", 1 << 10, "float32", margin_min=1.02,
                       err=err) == "native"
    assert "margin" in err.getvalue()
    assert low.resolve("allreduce", 1 << 10, "float32",
                       margin_min=1.0) == "ring"
    stale = _build({1 << 10: (9.0, 5.0)}, generated_unix=1000.0)
    err = io.StringIO()
    assert LoadedSelection(stale, max_age_sec=60.0, now=2000.0,
                           err=err).stale and "stale" in err.getvalue()
    assert not LoadedSelection(stale, max_age_sec=0.0).stale
    foreign = _build({1 << 10: (9.0, 5.0)}, device_kind="NVIDIA H100 PCIe")
    assert LoadedSelection(foreign,
                           device_kind="NVIDIA H100 80GB HBM3").foreign
    assert not LoadedSelection(foreign, device_kind="").foreign


def test_resolve_is_pure_and_lockstep_across_ranks(tmp_path):
    path = str(tmp_path / "sel.json")
    write_artifact(_build({1 << 10: (5.0, 9.0), 1 << 20: (100.0, 50.0)},
                          device_kind="cpu"), path)
    plans = []
    for _ in range(2):
        sel = load_artifact(path, n_devices=8, device_kind="cpu",
                            err=io.StringIO())
        plans.append([sel.resolve(op, nb, dt, margin_min=1.02, n_devices=8,
                                  err=io.StringIO(), **kw)
                      for op, nb, dt, kw in GRID])
    assert plans[0] == plans[1]
    assert "ring" in plans[0] and "native" in plans[0]


# --- --algo auto's planned algorithms, against JAX's ------------------------


def _entry(op, winner, *, nbytes=1024, mesh="flat", imbalance=1, margin=1.8,
           runner_up="native"):
    return dict(op=op, nbytes=nbytes, dtype="float32", skew_us=0,
                imbalance=imbalance, load="", winner=winner,
                winner_p50_us=5.0, runner_up=runner_up, runner_up_p50_us=9.0,
                margin=margin, native_p50_us=9.0, native_vs_best=1.8,
                n_devices=8, mesh=mesh, samples=3,
                algos=(winner, "native"))


def _selections(entries, **kw):
    fp = {"tuner_schema": TUNER_SCHEMA_VERSION, "device_kind": "", "chip": "",
          "n_devices": 8}
    ours = SelectionArtifact(version=TUNER_SCHEMA_VERSION, generated="g",
                             generated_unix=1.0, fingerprint=fp,
                             entries=tuple(SelectionEntry(**e)
                                           for e in entries))
    theirs = jtuner.SelectionArtifact(
        version=TUNER_SCHEMA_VERSION, generated="g", generated_unix=1.0,
        fingerprint=fp, entries=tuple(jtuner.SelectionEntry(**e)
                                      for e in entries))
    return (LoadedSelection(ours, **kw),
            jtuner.LoadedSelection(theirs, **kw))


AUTO_ENTRIES = [
    _entry("allreduce", "ring"), _entry("allreduce", "rhd", nbytes=1 << 20),
    _entry("all_gather", "bruck"), _entry("all_to_all", "nope"),
    _entry("reduce_scatter", "ring", margin=1.01),
    _entry("allreduce", "hier", mesh="2x(4)", nbytes=4096),
    _entry("all_gather", "hier-ring", mesh="2x(4)", nbytes=4096),
    _entry("allgatherv", "doubling", imbalance=8),
    _entry("reduce_scatter_v", "sortring", imbalance=8),
    _entry("allgatherv", "vhier", imbalance=8, mesh="2x(4)", nbytes=4096),
    _entry("scenario[tp-allreduce-burst]", "ring"),
    _entry("scenario[moe-dispatch-combine]", "rhd"),
]


@pytest.mark.parametrize("n,mesh_axes", [
    (8, (("x", 8),)), (6, (("x", 6),)), (8, (("dcn", 2), ("ici", 4)))],
    ids=["flat8", "flat6", "2x4"])
@pytest.mark.parametrize("op", ["allreduce", "all_gather", "all_to_all",
                                "reduce_scatter", "allgatherv",
                                "reduce_scatter_v", "scenario"])
@pytest.mark.parametrize("margin", [1.0, 1.02])
def test_auto_plans_jaxs_algorithm_at_every_point(op, n, mesh_axes, margin):
    from tpu_perf.runner import algos_for_options as jalgos
    from tpu_perf.scenarios.spec import resolve_scenarios as jresolve

    from tpu_perf_torch.runner import algos_for_options
    from tpu_perf_torch.scenarios.spec import resolve_scenarios

    names = ("tp-allreduce-burst", "moe-dispatch-combine")
    kw = dict(op=op, algo="auto", algo_artifact="x.json",
              tune_margin=margin)
    opts = Options(scenario=resolve_scenarios(names) if op == "scenario"
                   else (), **kw)
    jopts = JOptions(scenario=jresolve(names) if op == "scenario" else (),
                     **kw)
    ours, theirs = _selections(AUTO_ENTRIES)
    err, jerr = io.StringIO(), io.StringIO()
    for nbytes in (256, 1024, 4096, 1 << 20):
        for imb in (1, 8):
            got = algos_for_options(opts, op, n, err=err,
                                    mesh_axes=mesh_axes, nbytes=nbytes,
                                    imbalance=imb, selection=ours)
            want = jalgos(jopts, op, n, err=jerr, mesh_axes=mesh_axes,
                          nbytes=nbytes, imbalance=imb, selection=theirs)
            assert got == want, (nbytes, imb)


def test_auto_needs_a_selection_and_a_point():
    from tpu_perf_torch.runner import algos_for_options

    opts = Options(op="allreduce", algo="auto", algo_artifact="x.json")
    with pytest.raises(ValueError, match="selection"):
        algos_for_options(opts, "allreduce", 8, nbytes=1024)
    with pytest.raises(ValueError, match="per sweep point"):
        algos_for_options(opts, "allreduce", 8,
                          selection=LoadedSelection(_build({1024: (9, 5)})))


def test_an_unbuildable_winner_falls_back_loudly():
    from tpu_perf_torch.runner import algos_for_options

    ours, _ = _selections([_entry("allreduce", "hier-ring", mesh="2x(4)")])
    err = io.StringIO()
    opts = Options(op="allreduce", algo="auto", algo_artifact="x.json",
                   tune_margin=1.0)
    assert algos_for_options(opts, "allreduce", 8, err=err,
                             mesh_axes=(("x", 8),), nbytes=1024,
                             selection=ours) == ["native"]
    assert "hier-ring" in err.getvalue()


@pytest.mark.parametrize("kw,match", [
    (dict(algo="auto"), "--algo-artifact PATH"),
    (dict(algo="ring", algo_artifact="a.json"), "only with --algo auto"),
    (dict(algo="auto", algo_artifact="a.json", load="hbm_stream"),
     "names its algorithms"),
    (dict(tune_margin=0.9), "tune_margin"),
    (dict(tune_max_age=-1.0), "tune_max_age"),
])
def test_the_tuner_options_refuse_as_jaxs(kw, match):
    with pytest.raises(ValueError, match=match):
        Options(**kw)
    with pytest.raises(ValueError, match=match):
        JOptions(**kw)


# --- the loop end to end on the CPU ------------------------------------------


def _algo_by_point(folder):
    from tpu_perf_torch.report import collect_paths, read_rows

    out = {}
    for r in read_rows(collect_paths(str(folder))):
        out.setdefault((r.op, r.nbytes, r.imbalance), set()).add(
            r.algo or "native")
    return out


@pytest.mark.parametrize("argv", [
    ["--op", "allreduce,all_gather", "--sweep", "256,4096"],
    ["--op", "allgatherv,reduce_scatter_v", "--imbalance", "1,8", "--sweep",
     "256,4096"],
    ["--op", "allreduce", "--mesh", "2x4", "--axes", "dcn,ici", "--sweep",
     "256,4096"],
], ids=["collectives", "v-ops", "hier"])
def test_arena_then_tune_then_auto(tmp_path, capsys, argv):
    common = argv + ["-i", "1", "-r", "3", "--device", "cpu"]
    assert cli.main(["run", "--algo", "all", "-l", str(tmp_path / "arena"),
                     *common]) == 0
    art = str(tmp_path / "sel.json")
    assert cli.main(["tune", "-d", str(tmp_path / "arena"), "-o", art]) == 0
    winners = {(e.op, e.nbytes, e.imbalance): e.winner
               for e in read_artifact(art).entries}
    assert winners
    assert cli.main(["run", "--algo", "auto", "--algo-artifact", art,
                     "--tune-margin", "1.0", "-l", str(tmp_path / "auto"),
                     *common]) == 0
    got = _algo_by_point(tmp_path / "auto")
    assert got == {k: {w} for k, w in winners.items()}
    assert cli.main(["tune", "-d", str(tmp_path / "arena"), "--check",
                     art]) == 0


def test_a_chaos_ledger_is_the_same_under_auto(tmp_path):
    from tpu_perf_torch.driver import Driver
    from tpu_perf_torch.faults import FaultSpec

    art = str(tmp_path / "sel.json")
    write_artifact(_build({1 << 10: (9.0, 5.0)}), art)
    ledgers = []
    for sub, algo, artifact in (("a", "native", None), ("b", "auto", art)):
        folder = tmp_path / sub
        opts = Options(op="ring", sweep="8,32", iters=1, num_runs=-1,
                       algo=algo, algo_artifact=artifact, synthetic_s=0.001,
                       fault_seed=7, faults=[FaultSpec(
                           kind="spike", op="ring", nbytes=32, start=3,
                           end=5, magnitude=10.0)],
                       logfolder=str(folder), stats_every=5, max_runs=20,
                       device="cpu", sim_ranks=8)
        Driver(opts, err=io.StringIO()).run()
        ledgers.append(b"".join(open(p, "rb").read() for p in sorted(
            glob.glob(str(folder / "chaos-*.log")))))
    assert ledgers[0] == ledgers[1] and ledgers[0]


def test_a_jax_arena_log_tunes_to_jaxs_artifact(tmp_path, capsys,
                                                eight_devices):
    """JAX's arena on its 8 CPU devices writes the rows; both packages
    tune them (the port's copy relabelled to its backend, the one column
    naming the package) into the same artifact, bar the clock, the card
    and the rows' source."""
    from tpu_perf.cli import main as jmain

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    common = ["--algo", "all", "-i", "1", "-r", "3", "-l", str(jdir)]
    assert jmain(["run", "--op", "allreduce", "--sweep", "256,4096",
                  *common]) == 0
    assert jmain(["run", "--op", "allgatherv", "--imbalance", "8", "-b",
                  "4096", *common]) == 0
    tdir.mkdir()
    for p in jdir.glob("tpu-*.log"):
        rows = [JRow.from_csv(ln) for ln in p.read_text().splitlines()
                if ln.strip() and not ln.startswith("timestamp")]
        (tdir / p.name).write_text("".join(
            dataclasses.replace(r, backend="torch-sim").to_csv() + "\n"
            for r in rows))
    capsys.readouterr()
    arts = []
    for main, folder in ((jmain, jdir), (cli.main, tdir)):
        out = str(tmp_path / f"{folder.name}.json")
        assert main(["tune", "-d", str(folder), "-o", out]) == 0
        data = json.loads(open(out).read())
        for key in ("generated", "generated_unix", "source"):
            data.pop(key)
        data["fingerprint"].pop("device_kind")
        arts.append(data)
    assert arts[0] == arts[1] and arts[0]["entries"]
    assert capsys.readouterr().out.count("| op | size |") == 2


# --- the drift gate and the tune family ------------------------------------


def _write_rows(folder, rows):
    folder.mkdir(exist_ok=True)
    with open(folder / "tpu-j-0.log", "w") as fh:
        fh.write(RESULT_HEADER + "\n")
        for r in rows:
            fh.write(r.to_csv() + "\n")


def _twin_rows(folder, make):
    """The same crafted rows for each package: the port's (backend
    torch-sim) in ``folder``, JAX's (backend jax) beside it."""
    _write_rows(folder, make())
    jfolder = folder.with_name(folder.name + "-jax")
    _write_rows(jfolder, make(row=JRow, backend="jax"))
    return folder, jfolder


def test_check_drift_is_jaxs():
    published = _both({1 << 10: (5.0, 9.0), 1 << 20: (100.0, 50.0)})
    fresh = _both({1 << 10: (9.0, 5.0), 1 << 20: (100.0, 50.0)})
    for margin in (1.0, 1.02, 2.0):
        got = check_drift(published[0], fresh[0], margin_min=margin)
        want = jtuner.check_drift(published[1], fresh[1], margin_min=margin)
        assert [dataclasses.asdict(f) for f in got] == \
            [dataclasses.asdict(f) for f in want]
        assert [f.describe() for f in got] == [f.describe() for f in want]
    (f,) = check_drift(published[0], fresh[0], margin_min=1.02)
    assert (f.published, f.fresh_winner) == ("native", "ring")
    assert check_drift(published[0], published[0]) == []


def test_tune_check_exits_0_10_2_and_1_as_jaxs(tmp_path, capsys):
    from tpu_perf.cli import main as jmain

    goods = _twin_rows(tmp_path / "good",
                       lambda **kw: _arena_rows({1 << 10: (5.0, 9.0)}, **kw))
    bads = _twin_rows(tmp_path / "bad",
                      lambda **kw: _arena_rows({1 << 10: (15.0, 9.0)}, **kw))
    nones = _twin_rows(tmp_path / "none", lambda **kw: _mk_rows(
        "allreduce", "native", 5.0, **kw))
    art = str(tmp_path / "sel.json")
    assert cli.main(["tune", "-d", str(goods[0]), "-o", art]) == 0
    # JAX's package gates the port's artifact on its own rows alike
    for main, good, bad, none in zip((cli.main, jmain), goods, bads, nones):
        assert main(["tune", "-d", str(good), "--check", art]) == 0
        assert main(["tune", "-d", str(bad), "--check", art]) == 10
        assert main(["tune", "-d", str(bad), "--check", art, "--margin",
                     "2.0"]) == 0
        assert main(["tune", "-d", str(good), "--check",
                     str(tmp_path / "missing.json")]) == 2
        assert main(["tune", "-d", str(none), "--check", art]) == 1
        assert main(["tune", "-d", str(tmp_path / "nothing")]) == 1
    err = capsys.readouterr().err
    assert "crossover drift" in err and "no arena verdicts" in err


def test_tune_runs_without_a_card(tmp_path, monkeypatch, capsys):
    # tune touches no device: on a host without a card it still folds
    # rows, with an empty card name in the fingerprint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_rows(tmp_path / "rows", _arena_rows({1 << 10: (9.0, 5.0)}))
    art = str(tmp_path / "sel.json")
    assert cli.main(["tune", "-d", str(tmp_path / "rows"), "-o", art]) == 0
    assert read_artifact(art).fingerprint["device_kind"] == ""
    assert cli.main(["tune", "-d", str(tmp_path / "rows"), "--check",
                     art]) == 0


def test_tune_records_ride_the_ingest_pass(tmp_path, capsys):
    from tpu_perf_torch.ingest.pipeline import (
        LocalDirBackend, run_all_ingest_passes,
    )

    _write_rows(tmp_path / "rows", _arena_rows({1 << 10: (9.0, 5.0)}))
    logdir, art = tmp_path / "logs", str(tmp_path / "sel.json")
    assert cli.main(["tune", "-d", str(tmp_path / "rows"), "-o", art, "-l",
                     str(logdir)]) == 0
    (path,) = glob.glob(str(logdir / "tune-*.log"))
    recs = [TuneRecord.from_json(ln).data for ln in open(path) if ln.strip()]
    kinds = [r["record"] for r in recs]
    assert kinds.count("tune_fingerprint") == 1
    assert kinds.count("tune_entry") == len(read_artifact(art).entries)
    entry = next(r for r in recs if r["record"] == "tune_entry")
    assert entry["winner"] == "ring" and entry["nbytes"] == 1 << 10
    assert [{k: v for k, v in r.items() if k != "job_id"} for r in recs] == \
        [{k: v for k, v in r.data.items() if k != "job_id"}
         for r in read_artifact(art).to_records("x")]
    sink = str(tmp_path / "sink")
    assert run_all_ingest_passes(str(logdir),
                                 backend=LocalDirBackend(sink)) == 1
    assert glob.glob(os.path.join(sink, "tune-*.log"))


def test_tune_pushes_its_records(tmp_path, capsys):
    import http.server
    import threading

    got = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            got.append((self.path, body.decode()))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        _write_rows(tmp_path / "rows", _arena_rows({1 << 10: (9.0, 5.0)}))
        url = f"http://127.0.0.1:{server.server_address[1]}"
        assert cli.main(["tune", "-d", str(tmp_path / "rows"), "-o",
                         str(tmp_path / "sel.json"), "--push", url]) == 0
        assert cli.main(["linkmap", "--mesh", "2x2", "--synthetic", "0.001",
                         "--push", url]) == 0
    finally:
        server.shutdown()
    paths = [p for p, _ in got]
    assert paths == ["/v1/TuneSelectionTPU", "/v1/LinkMapTPU"]
    assert got[0][1].count("tune_entry") == 1


def test_bench_auto_vs_native_has_jaxs_keys(eight_devices):
    import tpu_perf.bench as jbench

    from tpu_perf_torch import bench

    def keys(obj):
        if isinstance(obj, dict):
            return {k: keys(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [keys(v) for v in obj[:1]]
        return type(obj).__name__ in ("int", "float", "str")

    ours = bench.auto_vs_native(CPU, sizes=(4096,), runs=2, iters=1)
    theirs = jbench._auto_vs_native(sizes=(4096,), runs=2, iters=1)
    assert keys(ours) == keys(theirs)
    (point,) = ours["points"]
    assert point["speedup"] >= 1.0 or point["selected"] == "native"
    assert point["algos_raced"] == 5
    assert bench.auto_vs_native(CPU, n=1) is None
