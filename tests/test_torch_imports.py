"""The port stands alone: no module of ``tpu_perf_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package, its entry points refuse
to run without a card unless asked for the CPU, and its CUDA sources are
the ones its build module names."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_perf_torch import bench, cli, kernels
from tpu_perf_torch.kernels import _build
from tpu_perf_torch.world import NoDeviceError, SimWorld, resolve_device

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import tpu_perf_torch
names = [m.name for m in pkgutil.walk_packages(tpu_perf_torch.__path__,
                                               "tpu_perf_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "tpu_perf" or m.startswith("tpu_perf."))
print(len(names), bad)
"""


def test_no_module_of_the_port_imports_jax_or_tpu_perf():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15  # every module was imported, not just the root
    assert bad == "[]"


def _imported_roots(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in (REPO / "tpu_perf_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_names_no_jax_import(path):
    # static twin of the probe above: catches an import hidden inside a
    # function the probe never calls
    assert not {"jax", "tpu_perf", "jaxlib"} & set(_imported_roots(REPO / path))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("argv", [
    ["run", "--op", "pl_allreduce", "-b", "64"],
    ["run", "--op", "hbm_stream", "--device", "cuda"],
    ["selftest"],
    ["bench"],
])
def test_entry_points_without_a_card_raise(no_card, argv):
    with pytest.raises(NoDeviceError, match="--device cpu"):
        cli.main(argv)


def test_only_an_explicit_cpu_request_runs_on_the_cpu(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(NoDeviceError):
        resolve_device(None)
    with pytest.raises(NoDeviceError):
        bench.main()
    assert SimWorld(8, resolve_device("cpu")).backend == "torch-sim"


def test_build_module_names_every_cuda_source_and_its_c_entry():
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(_build._ENTRIES)
    for name, (symbol, argtypes) in _build._ENTRIES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
        assert m, symbol
        assert len(m.group(1).split(",")) == len(argtypes)
        assert "cudaGetLastError()" in text
    assert set(kernels.KERNELS) == set(_build._ENTRIES) | {"stream"}


def test_build_outputs_are_ignored_by_git():
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "tpu_perf_torch/_build/" in ignored
    assert _build.BUILD_DIR == REPO / "tpu_perf_torch" / "_build"


def test_launch_errors_raise():
    _build.check("ring_all_gather", 0)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check("ring_all_gather", 9)
