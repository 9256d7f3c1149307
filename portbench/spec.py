"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration and traffic files, and the reader of each of its metrics.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, so a cell is added by adding files and
entries: ``configs/<file>.json`` (named by the configuration's ``file``),
``traffic/<traffic>.json``, ``end_to_end/<metric>.py`` and
``layer_metrics/<metric>.py``, each reader a module with ``read(run)``
that returns a number, or None when it finds nothing to read.  A metric
split by the end-to-end metric it moves (``idle_share.cards``) is read by
its own file where there is one, else by the reader of its kind, the
name before the first dot (``idle_share.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

#: the benchmark's folder under a checkout's root
FOLDER = "portbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names."""

    root: Path
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def ops(self) -> list[str]:
        return self.traffic.get("ops", self.config["ops"])

    @property
    def ranks(self) -> int:
        """Sim ranks on one card, or one rank a card across cards."""
        return self.config["ranks"] if self.chips == 1 else self.chips

    def iters(self, op: str) -> int:
        """Executions a visit of ``op``'s points: the traffic's
        ``iters``, or its ``op_iters`` entry for the op."""
        return self.traffic.get("op_iters", {}).get(op,
                                                    self.traffic["iters"])

    def plan(self) -> list[tuple[str, int, int]]:
        """The cell's points, ``(op, nbytes, iters)``, op-major: the order
        the window visits them in, round after round."""
        return [(op, p["nbytes"], self.iters(op)) for op in self.ops
                for p in self.traffic["points"]]


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: str | Path, name: str) -> Cell:
    """The cell ``name`` of the benchmark at ``root`` (a checkout's root,
    which holds ``BENCHMARK.json``); a KeyError names what is missing."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / FOLDER / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["chips"] != w["chips"]:
        raise ValueError(f"{name}: traffic {w['traffic']!r} is for "
                         f"{traffic['chips']} chips, the cell asks {w['chips']}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(root=root, name=name, chips=w["chips"], config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def reader(root: Path, kind: str, metric: str):
    """The ``read`` function of ``<root>/portbench/<kind>/<metric>.py``,
    or of the file named by the metric's kind (its name before the first
    dot) where the metric has no file of its own."""
    folder = root / FOLDER / kind
    path = folder / f"{metric}.py"
    if not path.exists():
        path = folder / f"{metric.split('.')[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for {metric!r} in {folder}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, run, kind: str) -> dict:
    """Each of the cell's ``end_to_end`` or ``layer_metrics`` metrics read
    from ``run``, ``{name: {"value", "unit"}}``; a metric whose reader
    finds nothing is left out."""
    entries = cell.end_to_end if kind == "end_to_end" else cell.per_layer
    out = {}
    for m in entries:
        value = reader(cell.root, kind, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
