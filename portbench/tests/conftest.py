"""The benchmark's own tests: on the CPU, the reference, the arithmetic,
the readers and a whole run at tiny sizes with the program's plain
versions; the ``card`` marker's tests run a short cell on an NVIDIA card
and skip elsewhere.

    python -m pytest portbench/tests -q          # CPU, ~1 min
    python -m pytest portbench/tests -q -m card  # on a card
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: each cell's sizes a rank at what a CPU test holds (its executions a
#: visit stay the traffic file's)
TINY = {"nccl8-sim-large": [8192, 32768],
        "stream-large": [8192, 65536],
        "nccl4-nvlink-mid": [8192, 32768]}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips where none is visible)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")


def tiny_root(dest: Path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and its folder, no
    tests) whose traffic files hold :data:`TINY`'s sizes."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "_cache",
                                                  "__pycache__"))
    for name, points in TINY.items():
        path = dest / "portbench" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic["points"] = [{"nbytes": b} for b in points]
        path.write_text(json.dumps(traffic))
    return dest


@pytest.fixture
def root(tmp_path) -> Path:
    return tiny_root(tmp_path)
