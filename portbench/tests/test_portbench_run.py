"""Whole runs on the CPU at tiny sizes, through the harness with the
program's plain versions: cells found by name, a cell added from files
alone, the control and each fault a cell can have coming out not
correct, and the no-JAX rule."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import REPO
from portbench import harness, spec

SEED = 2**31 + 977
CELLS = ("nccl8-sim-large", "stream-large", "nccl4-nvlink-mid")
LIMIT = 1e-05


def run(root, cell, *, trace=False, dtype=None, target=harness._worker,
        seed=SEED):
    return harness.run(spec.load_cell(root, cell), seed=seed, seconds=0.2,
                       trace=trace, t0=time.monotonic(), device="cpu",
                       dtype=dtype, target=target)


def test_every_cell_is_found_by_name():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for name in CELLS:
        cell = spec.load_cell(REPO, name)
        assert cell.plan() and cell.config["dtype"] == "float32"
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert all(m["moves"] in {e["name"] for e in cell.end_to_end}
                   for m in cell.per_layer)
    assert spec.load_cell(REPO, "nccl4-nvlink-mid").ranks == 4
    assert spec.load_cell(REPO, "nccl8-sim-large").ranks == 8
    assert sum(w["chips"] == 4 for w in bench["workloads"]) == 1


def test_a_cell_added_from_files_alone(root):
    folder = root / "portbench"
    config = json.loads((folder / "configs" / "stream-h100.json").read_text())
    config["ops"] = ["pl_hbm_copy", "pl_hbm_stream"]
    (folder / "configs" / "copy-only.json").write_text(json.dumps(config))
    (folder / "traffic" / "copy-mix.json").write_text(json.dumps(
        {"chips": 1, "fence": "fused", "points": [{"nbytes": 16384}],
         "iters": 3, "trace_rounds": 2}))
    (folder / "layer_metrics" / "traced_visits.py").write_text(
        "def read(run):\n    return len(run.traced) or None\n")
    (folder / "end_to_end" / "visits_per_s.py").write_text(
        "def read(run):\n    return len(run.visits) / run.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "copy-only", "source": "x",
                             "file": "portbench/configs/copy-only.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "copy-cell", "config": "copy-only",
                               "traffic": "copy-mix", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "visits_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["copy-cell"]})
    bench["per_layer"].append({"name": "traced_visits", "unit": "visits",
                               "better": "higher", "source": "host_clock",
                               "layer": "timing", "moves": "visits_per_s",
                               "workloads": ["copy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run(root, "copy-cell")
    assert line["correct"] and set(line["metrics"]) == {"visits_per_s",
                                                        "setup_s"}
    traced = run(root, "copy-cell", trace=True)
    assert traced["metrics"]["traced_visits"]["value"] == 4
    # the cells already there read as before
    assert set(run(root, "stream-large")["metrics"]) == {"busbw_GBps",
                                                         "setup_s"}


def test_an_even_count_of_all_to_alls_is_refused(root):
    path = root / "portbench" / "traffic" / "nccl8-sim-large.json"
    traffic = json.loads(path.read_text())
    traffic["op_iters"] = {"pl_all_to_all": 10}
    path.write_text(json.dumps(traffic))
    with pytest.raises(ValueError, match="odd"):
        run(root, "nccl8-sim-large")


@pytest.mark.parametrize("cell", ["nccl8-sim-large", "stream-large"])
def test_sound_runs_pass_and_the_lower_precision_control_fails(root, cell):
    line = run(root, cell)
    assert line["correct"] and line["failed"] == 0
    assert line["checks"] == {
        "max_rel_gap.window": {"value": 0.0, "limit": LIMIT},
        "max_rel_gap.fresh": {"value": 0.0, "limit": LIMIT}}
    assert list(line)[-1] == "checks"
    assert line["device"]["count"] == 1 and line["attempted"] > 0
    control = run(root, cell, dtype="bfloat16")
    assert not control["correct"]
    assert max(c["value"] for c in control["checks"].values()) > 1e-3


def _state_unchanged(monkeypatch):
    from tpu_perf_torch import runner

    monkeypatch.setattr(runner, "build_fused_step",
                        lambda built, reps: lambda x, on_run=None: x)


def _half_the_ranks(monkeypatch):
    # the reduce over the first half of the ranks, its mean taken over them
    from tpu_perf_torch.ops import pallas_ring

    real = pallas_ring.direct_reduce_scatter

    def half(x, *, scale=1.0, tiles=1):
        kept = x.clone()
        kept[x.shape[0] // 2:] = 0
        return real(kept, scale=scale * 2, tiles=tiles)

    monkeypatch.setattr(pallas_ring, "direct_reduce_scatter", half)


def _half_the_buffer(monkeypatch):
    from tpu_perf_torch.ops import pallas_ring

    real = pallas_ring.stream

    def half(x):
        y = x.clone()
        h = x.shape[-1] // 2
        y[..., :h] = real(x[..., :h].contiguous())
        return y

    monkeypatch.setattr(pallas_ring, "stream", half)


def _altered(name):
    def plant(monkeypatch):
        from tpu_perf_torch.ops import pallas_ring

        real = getattr(pallas_ring, name)

        def altered(x, *args):
            y = real(x, *args)
            y.view(-1)[0] += 1.0
            return y

        monkeypatch.setattr(pallas_ring, name, altered)
    return plant


def _no_op(name):
    def plant(monkeypatch):
        from tpu_perf_torch.ops import pallas_ring

        monkeypatch.setattr(pallas_ring, name, lambda x: x.clone())
    return plant


def _stale_peers(monkeypatch):
    """A reduce whose barrier is gone at a visit's start: the first
    execution of every visit reads each peer's row as that peer held it
    at the previous visit's last execution, and its own row as it is."""
    from tpu_perf_torch import runner
    from tpu_perf_torch.ops import pallas_ring

    real_reduce = pallas_ring.direct_reduce_scatter
    real_fused = runner.build_fused_step
    last, start = {}, [False]

    def fused(built, reps):
        program = real_fused(built, reps)

        def visit(x, on_run=None):
            start[0] = True
            return program(x, on_run=on_run)
        return visit

    def reduce(x, *, scale=1.0, tiles=1):
        key = (tuple(x.shape), tiles)
        seen = x
        if start[0] and key in last:
            n = x.shape[0]
            d = torch.arange(n)
            seen = last[key].clone().view(n, n, -1)
            seen[d, d] = x.view(n, n, -1)[d, d]
            seen = seen.view_as(x)
        start[0] = False
        last[key] = x.clone()
        return real_reduce(seen, scale=scale, tiles=tiles)

    monkeypatch.setattr(runner, "build_fused_step", fused)
    monkeypatch.setattr(pallas_ring, "direct_reduce_scatter", reduce)


@pytest.mark.parametrize("cell,fault", [
    ("nccl8-sim-large", _state_unchanged),
    ("nccl8-sim-large", _half_the_ranks),
    ("nccl8-sim-large", _altered("all_to_all")),
    ("nccl8-sim-large", _no_op("all_to_all")),
    ("stream-large", _state_unchanged),
    ("stream-large", _half_the_buffer),
    ("stream-large", _altered("hbm_copy")),
    ("stream-large", _altered("hbm_write")),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = run(root, cell)
    assert not line["correct"] and line["failed"] > 0


def test_stale_peers_show_only_from_fresh_values(root, monkeypatch):
    # by the window's end the ranks hold equal values, so a read from
    # before the peers wrote gives the same bits: only the visit from
    # fresh values after the window sees the fault
    _stale_peers(monkeypatch)
    line = run(root, "nccl8-sim-large")
    assert not line["correct"] and line["failed"] > 0
    assert line["checks"]["max_rel_gap.window"]["value"] <= LIMIT
    assert line["checks"]["max_rel_gap.fresh"]["value"] > 1e-2


def _no_exchange_worker(rank, n, port, payload, out):
    """A rank whose all-reduce reduces its own chunks: the exchange
    between the cards left out."""
    from tpu_perf_torch.ops import pallas_ring

    pallas_ring._all_to_all_cpu = lambda world, x, chunk: x.view(world.n,
                                                                  chunk)
    harness._worker(rank, n, port, payload, out)


def test_a_world_of_cards_on_gloo(root):
    line = run(root, "nccl4-nvlink-mid")
    assert line["correct"] and line["device"]["count"] == 4
    assert set(line["metrics"]) == {"busbw_GBps.cards", "setup_s"}
    assert line["checks"]["max_rel_gap.fresh"]["value"] == 0.0
    assert not run(root, "nccl4-nvlink-mid", target=_no_exchange_worker)[
        "correct"]
    assert not run(root, "nccl4-nvlink-mid", dtype="bfloat16")["correct"]


def test_a_forbidden_module_refuses_the_run(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="forbidden"):
        run(root, "stream-large")
    assert harness.forbidden_modules(["tpu_perf_torch", "tpu_perf.x",
                                      "jaxlib", "bench", "benchmarks",
                                      "tpu_perf_torch.bench"]) == [
        "bench", "jaxlib", "tpu_perf.x", "tpu_perf_torch.bench"]


NO_JAX = """
import sys, time
sys.path.insert(0, {repo!r})
from portbench import harness, spec
line = harness.run(spec.load_cell({root!r}, {cell!r}), seed=5, seconds=0.1,
                   trace=True, t0=time.monotonic(), device="cpu")
assert line["correct"], line
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", ["nccl8-sim-large", "stream-large"])
def test_the_harness_loads_no_jax(root, cell):
    out = subprocess.run(
        [sys.executable, "-c", NO_JAX.format(repo=str(REPO), root=str(root),
                                            cell=cell)],
        capture_output=True, text=True, timeout=300, check=True)
    top = set(out.stdout.split())
    assert "tpu_perf_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "tpu_perf", "bench"}


def test_run_py_needs_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
         "stream-large", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.card
def test_a_short_stream_large_on_the_card(card, tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
         "stream-large", "--seed", str(SEED), "--seconds", "2", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["busbw_GBps"]["value"] > 0
