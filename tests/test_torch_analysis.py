"""The port's invariant analyzer (``tpu_perf_torch.analysis``, ``lint``)
against the JAX package's (``tpu_perf.analysis``), and over the port's own
tree.

Every test of the JAX package's ``tests/test_analysis.py`` runs twice: as
written, and with its analyzer, manifest loader and CLI swapped for the
port's.  Both runs must pass, and every ``lint_tree`` result the port's run
records (its findings, fingerprints, pragma waivers and pragma sites) must
equal the JAX run's on the same snippet.  The live-tree cases lint each
package's own tree with its own manifest, and both come out clean.

Beside them: the shipped port tree lints clean against its empty baseline
with JAX's pragma sites carried over, and one mutation of the port's own
tree for each of R1-R6 (a copy under ``tmp_path``) makes its rule fire,
the R3 case a family declared without a route.
"""

import importlib.util
import inspect
import json
import os
import shutil
from pathlib import Path

import pytest

import tpu_perf.analysis as janalysis
from tpu_perf.analysis import engine as jengine

from tpu_perf_torch import analysis as tanalysis
from tpu_perf_torch import cli
from tpu_perf_torch.analysis import (
    default_manifest_path, default_root, lint_tree, load_manifest,
)
from tpu_perf_torch.analysis import engine as tengine

REPO = Path(__file__).resolve().parent.parent

_SPEC = importlib.util.spec_from_file_location(
    "_jax_test_analysis", REPO / "tests" / "test_analysis.py")
JT = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(JT)
CASES = sorted(name for name, fn in vars(JT).items()
               if name.startswith("test_") and inspect.isfunction(fn))

#: the JAX test module's analyzer-facing names, and the port's for each
PORT = {
    "lint_tree": tanalysis.lint_tree,
    "load_manifest": tanalysis.load_manifest,
    "default_manifest_path": tanalysis.default_manifest_path,
    "default_root": tanalysis.default_root,
    "render_baseline": tanalysis.render_baseline,
    "all_rules": tengine.all_rules,
    "resolve_rules": tengine.resolve_rules,
    "main": cli.main,
}
JAX = {"lint_tree": janalysis.lint_tree, "all_rules": jengine.all_rules}


def _record(real, log):
    def lint(*args, **kw):
        res = real(*args, **kw)
        log.append(res)
        return res
    return lint


def _view(res) -> dict:
    """What a lint result says, less its root (each run has its own
    tmp tree)."""
    return {
        "findings": [f.to_dict() for f in res.findings],
        "suppressed": res.suppressed,
        "pragmas": [p.to_dict() for p in res.pragmas],
        "files": res.files,
        "stale": res.baseline_stale,
        "rules": [r.id for r in res.rules],
    }


def _run_case(name, side, tmp_path, capsys, monkeypatch):
    fn = getattr(JT, name)
    log: list = []
    names = PORT if side == "torch" else JAX
    for attr, value in names.items():
        monkeypatch.setattr(JT, attr, value)
    monkeypatch.setattr(
        JT, "lint_tree", _record(names["lint_tree"] if side == "torch"
                                 else janalysis.lint_tree, log))
    params = inspect.signature(fn).parameters
    kwargs = {}
    if "tmp_path" in params:
        path = tmp_path / side
        path.mkdir()
        kwargs["tmp_path"] = path
    if "capsys" in params:
        kwargs["capsys"] = capsys
    capsys.readouterr()
    fn(**kwargs)
    left = capsys.readouterr()
    monkeypatch.undo()
    return log, left


@pytest.mark.parametrize("name", CASES)
def test_the_jax_rule_case_holds_on_the_port(name, tmp_path, capsys,
                                              monkeypatch):
    jlog, jleft = _run_case(name, "jax", tmp_path, capsys, monkeypatch)
    tlog, tleft = _run_case(name, "torch", tmp_path, capsys, monkeypatch)
    assert len(tlog) == len(jlog)
    for j, t in zip(jlog, tlog):
        if j.root == janalysis.default_root():
            # the live tree: each package's own, both clean
            assert j.unbaselined == [] and t.unbaselined == []
            assert t.root == default_root()
            continue
        assert _view(t) == _view(j)
    norm = lambda s, side: s.replace(str(tmp_path / side), "<root>")  # noqa
    assert norm(tleft.out, "torch") == norm(jleft.out, "jax")


# --- the port's own tree --------------------------------------------------

def _shipped():
    manifest = load_manifest(default_manifest_path(), default_root())
    base = os.path.join(os.path.dirname(default_manifest_path()),
                        "baseline.json")
    return manifest, base


def test_the_shipped_port_tree_lints_clean():
    manifest, base = _shipped()
    with open(base) as fh:
        assert json.load(fh)["findings"] == []
    res = lint_tree(default_root(), manifest, baseline_path=base)
    assert res.unbaselined == [], "\n".join(f.render() for f in res.findings)
    kinds = [p.kind for p in res.pragmas]
    assert kinds.count("allow-clock") == 2 and kinds.count("guarded-by") == 9
    assert {p.path for p in res.pragmas} == {
        "tpu_perf_torch/spans.py", "tpu_perf_torch/streams/engine.py",
        "tpu_perf_torch/compilepipe.py"}
    assert all(f.startswith("tpu_perf_torch/") for f in res.files)
    assert "tpu_perf_torch/analysis/rules.py" in res.files


def test_the_manifest_names_the_ports_zones_and_collectives():
    manifest, _ = _shipped()
    assert manifest.deterministic_zones == tuple(
        f"tpu_perf_torch/{z}" for z in ("faults/", "spans.py", "adaptive.py",
                                        "arena/", "scenarios/", "streams/",
                                        "tuner/"))
    assert {"all_reduce", "all_gather_into_tensor", "all_gather_object",
            "reduce_scatter_tensor", "all_to_all_single", "broadcast",
            "batch_isend_irecv", "barrier", "should_stop",
            "allreduce_times", "vote_all"} <= manifest.collectives
    assert manifest.family_contract["schema"] == "tpu_perf_torch/schema.py"
    assert default_root() == str(REPO)


def test_cli_lint_on_the_shipped_tree(capsys):
    assert cli.main(["lint"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert cli.main(["lint", "--format", "json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["summary"]["unbaselined"] == 0
    assert data["summary"]["suppressed"] == 1
    assert cli.main(["lint", "--list-rules"]) == 0
    assert "R6 (zone-coverage)" in capsys.readouterr().out


def _tree_copy(tmp_path) -> Path:
    root = tmp_path / "tree"
    shutil.copytree(REPO / "tpu_perf_torch", root / "tpu_perf_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__",
                                                  "*.so", "csrc"))
    return root


def _mutate(root: Path, rel: str, old: str, new: str) -> None:
    path = root / rel
    text = path.read_text()
    assert old in text, (rel, old)
    path.write_text(text.replace(old, new, 1))


def _lint_copy(root: Path):
    manifest = load_manifest(
        str(root / "tpu_perf_torch" / "analysis" / "manifest.json"),
        str(root))
    return lint_tree(str(root), manifest)


MUTATIONS = {
    "R1": ("tpu_perf_torch/faults/injector.py", "import random\n",
           "import random\nimport time\n_SEEDED_AT = time.time()\n"),
    "R2": ("tpu_perf_torch/adaptive.py", "elif self.n_hosts > 1:",
           "elif self.rank == 0:"),
    "R3": ("tpu_perf_torch/schema.py",
           'FLEET_PREFIX = "fleet"',
           'FLEET_PREFIX = "fleet"\nPROBE_PREFIX = "probe"'),
    "R4": ("tpu_perf_torch/schema.py", '    load: str = ""\n',
           '    load: str = ""\n    extra: str = ""\n'),
    "R5": ("tpu_perf_torch/compilepipe.py",
           "        with self._cond:\n            return self._depth",
           "        return self._depth"),
}


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_a_mutation_of_the_port_tree_fires_its_rule(tmp_path, rule):
    root = _tree_copy(tmp_path)
    assert _lint_copy(root).findings == []
    _mutate(root, *MUTATIONS[rule])
    if rule == "R3":  # swept, but given no ingest route nor push choice
        _mutate(root, "tpu_perf_torch/schema.py",
                "SPANS_PREFIX, FLEET_PREFIX, TUNE_PREFIX)",
                "SPANS_PREFIX, FLEET_PREFIX, TUNE_PREFIX, PROBE_PREFIX)")
    res = _lint_copy(root)
    assert res.findings and {f.rule for f in res.findings} == {rule}, \
        "\n".join(f.render() for f in res.findings)
    if rule == "R3":
        text = "\n".join(f.message for f in res.findings)
        assert "PROBE_PREFIX has no startswith() routing branch" in text
        assert "PROBE_PREFIX is missing from lazy_families" in text
        assert "PROBE_PREFIX is neither routed in PUSH_ROUTES" in text
    assert cli.main(["lint", str(root)]) == 8


def test_a_renamed_zone_fires_r6(tmp_path):
    root = _tree_copy(tmp_path)
    shutil.move(root / "tpu_perf_torch" / "tuner",
                root / "tpu_perf_torch" / "selection")
    res = _lint_copy(root)
    r6 = [f for f in res.findings if f.rule == "R6"]
    assert len(r6) == 1 and "tpu_perf_torch/tuner/" in r6[0].message
    assert r6[0].path == "tpu_perf_torch/analysis/manifest.json"


def test_the_gather_sites_world_size_is_not_rank_tainted(tmp_path):
    """The peer buffers' handle exchange gathers under ``if n > 1``, ``n``
    the world size: bound apart from the rank, R2 sees no taint; bound in
    one tuple with the rank, it would."""
    root = _tree_copy(tmp_path)
    _mutate(root, "tpu_perf_torch/ops/pallas_ring.py",
            "        n = world.n\n        rank, dev = world.rank, world.device",
            "        n, rank, dev = world.n, world.rank, world.device")
    res = _lint_copy(root)
    assert [(f.rule, f.path) for f in res.findings] == [
        ("R2", "tpu_perf_torch/ops/pallas_ring.py")]
    assert "all_gather_object" in res.findings[0].message


def test_an_ingest_route_without_its_table_is_caught(tmp_path):
    root = _tree_copy(tmp_path)
    _mutate(root, "tpu_perf_torch/ingest/pipeline.py",
            "        self._props_fleet = IngestionProperties(\n"
            "            database=database, table=table_fleet,\n"
            "            data_format=DataFormat.JSON)\n",
            "        self._props_fleet = self._props_spans\n")
    res = _lint_copy(root)
    assert [f.rule for f in res.findings] == ["R3"]
    assert "IngestionProperties table route(s)" in res.findings[0].message


def test_cli_lint_configuration_errors_exit_2(tmp_path, capsys):
    bad = tmp_path / "m.json"
    bad.write_text(json.dumps({"version": 1, "zone": ["x"]}))
    assert cli.main(["lint", "--manifest", str(bad)]) == 2
    assert "unknown key" in capsys.readouterr().err
    assert cli.main(["lint", "--rule", "nonsense"]) == 2
    assert cli.main(["lint", "--baseline", str(tmp_path / "no.json")]) == 2
