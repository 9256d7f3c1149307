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


#: the modules of the fences, report and daemon slice, of the run surface
#: (the group topology, the external launcher, the C baseline), of the
#: compute instruments, the stream engine, contend and bench, of the
#: multi-rank world (the meshes and the multi-process world), the peer
#: kernels' design tool, and the tool of the trace fence's pairs and the
#: profiler's windows
SLICE_MODULES = ("tpu_perf_torch.report", "tpu_perf_torch.traceparse",
                 "tpu_perf_torch.ingest", "tpu_perf_torch.ingest.pipeline",
                 "tpu_perf_torch.timing", "tpu_perf_torch.driver",
                 "tpu_perf_torch.topology", "tpu_perf_torch.extern_launch",
                 "tpu_perf_torch.mpi_launch", "tpu_perf_torch.streams",
                 "tpu_perf_torch.streams.engine",
                 "tpu_perf_torch.streams.plans",
                 "tpu_perf_torch.streams.contend", "tpu_perf_torch.bench",
                 "tpu_perf_torch.grid", "tpu_perf_torch.selftest",
                 "tpu_perf_torch.parallel", "tpu_perf_torch.parallel.mesh",
                 "tpu_perf_torch.parallel.multihost",
                 "tpu_perf_torch.tools.peer_designs",
                 "tpu_perf_torch.tools.fence_windows",
                 "tpu_perf_torch.adaptive", "tpu_perf_torch.health",
                 "tpu_perf_torch.health.stats",
                 "tpu_perf_torch.compilepipe", "tpu_perf_torch.spans",
                 "tpu_perf_torch.health.detect",
                 "tpu_perf_torch.health.events",
                 "tpu_perf_torch.health.exporter",
                 "tpu_perf_torch.health.monitor", "tpu_perf_torch.trace",
                 "tpu_perf_torch.trace.export", "tpu_perf_torch.faults",
                 "tpu_perf_torch.faults.spec",
                 "tpu_perf_torch.faults.injector",
                 "tpu_perf_torch.faults.conformance")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_the_slice_modules_import_no_jax_or_tpu_perf(module):
    probe = (f"import sys, {module}; print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_perf')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    path = REPO / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = REPO / module.replace(".", "/") / "__init__.py"
    assert not {"jax", "tpu_perf", "jaxlib"} & set(_imported_roots(path))


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
    # a synthetic soak still builds and warms its points on the card
    ["chaos", "--synthetic", "0.001", "--max-runs", "2", "--op", "ring",
     "-b", "64"],
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
    for (name, symbol), argtypes in _build._EXTRA_ENTRIES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
        assert m and len(m.group(1).split(",")) == len(argtypes), symbol
    # every counted kernel but the Triton stream is built from a source of
    # the build module (ring and exchange share the row-shift source), and
    # every source builds a counted kernel
    source_of = {"ring": "p2p_shift", "exchange": "p2p_shift",
                 "direct_reduce_scatter": "reduce_scatter",
                 "direct_all_gather": "all_gather",
                 "direct_all_gather_bidir": "all_gather",
                 "peer_reduce_scatter": "peer_collectives",
                 "peer_all_gather": "peer_collectives",
                 "peer_barrier": "peer_collectives",
                 **dict.fromkeys(
                     ("peer_ring", "peer_exchange", "peer_pingpong",
                      "peer_all_to_all", "peer_all_gather_bidir",
                      "peer_barrier_copy"), "peer_collectives")}
    cuda_kernels = set(kernels.KERNELS) - {"stream"}
    assert ({source_of.get(k, k) for k in cuda_kernels}
            == set(_build._ENTRIES) - set(_build.HELPERS))
    # the timing layer's helpers count no launches and port no TPU kernel
    assert not set(_build.HELPERS) & set(kernels.KERNELS)


def test_row_copy_tiles_are_the_sources():
    # the tile edges the tests and chip_smoke.py probe are the kernels' own
    from tpu_perf_torch.ops import pallas_ring as tpr

    cuh = (_build.CSRC / "row_copy.cuh").read_text()
    threads = int(re.search(r"kThreads = (\d+);", cuh).group(1))
    unroll = int(re.search(r"kUnroll = (\d+);", cuh).group(1))
    assert threads * unroll * 16 == tpr.ROW_COPY_TILE_BYTES
    # the row-copy sources and the gather take their tiles through the
    # shared header
    for name in ("p2p_shift", "hbm_copy", "all_gather"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "row_copy.cuh"' in text
        assert "row_copy::for_each_tile(" in text


def test_row_copy_designs_edit_the_shipped_sources(tmp_path):
    # each design is an edited copy of the shipped sources; an edit whose
    # text the sources no longer hold exactly once raises
    from tpu_perf_torch.tools import row_copy_designs as rcd

    path, _ = rcd.write_design(tmp_path, "p2p_shift.cu",
                               [(rcd.DRAW, rcd.STATIC_DEAL + rcd.DRAW)])
    assert path.read_text() == (_build.CSRC / "p2p_shift.cu").read_text()
    assert rcd.STATIC_DEAL in (tmp_path / "row_copy.cuh").read_text()
    with pytest.raises(RuntimeError, match="not once"):
        rcd.write_design(tmp_path, "p2p_shift.cu", [("no such text", "")])


def test_gather_designs_edit_the_shipped_sources(tmp_path):
    # the destination-major design is the shipped source; the fan-out and
    # plain-store designs are edits of it that must still apply
    from tpu_perf_torch.tools import gather_designs

    found = gather_designs.designs(tmp_path, fanouts="2x4,1x8",
                                   tma="16384x4")
    assert len(found) == 7
    shipped = (_build.CSRC / "all_gather.cu").read_text()
    assert (tmp_path / "dest_major_2x4" / "all_gather.cu").read_text() == shipped
    fan = (tmp_path / "fan_out_2x4" / "all_gather.cu").read_text()
    assert "for (int d = 0; d < n; ++d)" in fan and "u / " not in fan
    assert "__stcs(" in fan
    plain = (tmp_path / "fan_out_2x4_plain" / "all_gather.cu").read_text()
    assert "o[i] = v[r][k];" in plain and "__stcs(" not in plain
    plain = (tmp_path / "dest_major_2x4_plain" / "all_gather.cu").read_text()
    assert "copy_tile<false>(" in plain and "copy_tile<true>(" not in plain
    unroll = (tmp_path / "fan_out_1x8" / "row_copy.cuh").read_text()
    assert "kUnroll = 1;" in unroll and "kCtasPerSm = 8;" in unroll


def test_build_outputs_are_ignored_by_git():
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "tpu_perf_torch/_build/" in ignored
    assert _build.BUILD_DIR == REPO / "tpu_perf_torch" / "_build"


def test_launch_errors_raise():
    _build.check("direct_all_gather", 0)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.check("direct_all_gather", 9)


def test_peer_kernels_take_their_tiles_in_order():
    # the peer copy, the peer reduce-scatter and the peer gather (push and
    # pull) draw their tiles through the shared header; the reduce's tile
    # is the one the checks probe
    from tpu_perf_torch.ops import pallas_ring as tpr

    text = (_build.CSRC / "peer_collectives.cu").read_text()
    assert '#include "row_copy.cuh"' in text
    assert text.count("row_copy::for_each_tile(") == 3
    units = int(re.search(r"kReduceUnits = (\d+);", text).group(1))
    cuh = (_build.CSRC / "row_copy.cuh").read_text()
    threads = int(re.search(r"kThreads = (\d+);", cuh).group(1))
    assert threads * units * 16 == tpr.PEER_REDUCE_TILE_BYTES
    # each takes the counters' pointer in its C entries
    for symbol in ("peer_reduce_scatter", "peer_copy", "peer_gather_push",
                   "peer_gather_pull"):
        m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
        assert "counters" in m.group(1), symbol


def test_peer_designs_edit_the_shipped_sources(tmp_path):
    # every design of the peer kernels is an edit of the shipped sources
    # that must still apply
    from tpu_perf_torch.tools import peer_designs

    found = peer_designs.designs(tmp_path, "1x4,2x2", "4096x2")
    assert sorted(found) == ["reduce loads cs", "reduce loads nc",
                             "reduce plain stores",
                             "reduce tma span 4096 stages 2",
                             "reduce units 1 ctas/sm 4",
                             "reduce units 2 ctas/sm 2"]
    # the shipped design is the shipped sources
    path, _ = found["reduce units 1 ctas/sm 4"]
    for name in (path.name, "row_copy.cuh"):
        assert ((path.parent / name).read_text()
                == (_build.CSRC / name).read_text())
    path, _ = found["reduce plain stores"]
    assert peer_designs.PLAIN_STORE in path.read_text()
    assert peer_designs.STREAMING_STORE not in path.read_text()
    path, defines = found["reduce tma span 4096 stages 2"]
    assert "cp.async.bulk" in path.read_text()
    assert defines == ["PEER_TMA_SPAN=4096", "PEER_TMA_STAGES=2"]


def test_peer_barrier_designs_edit_the_shipped_sources(tmp_path):
    # every barrier variant is an edit of the shipped source that must
    # still apply; the shipped one is the source itself, and the gpu
    # scope, a yardstick, never ships
    from tpu_perf_torch.tools import peer_designs

    found = peer_designs.barrier_designs(tmp_path)
    assert sorted(found) == sorted(f"barrier {name}"
                                   for name in peer_designs.BARRIER_DESIGNS)
    shipped = (_build.CSRC / "peer_collectives.cu").read_text()
    texts = {name: path.read_text() for name, (path, _) in found.items()}
    assert texts["barrier shipped"] == shipped
    assert len(set(texts.values())) == len(texts)
    for name, text in texts.items():
        gpu = "gpu scope" in name
        for sys_asm in (peer_designs.SIGNAL_SYS, peer_designs.WAIT_SYS):
            assert (sys_asm in text) != gpu
            assert (sys_asm.replace(".sys", ".gpu") in text) == gpu
    assert ".gpu.global" not in shipped


def test_peer_step_designs_edit_the_shipped_sources(tmp_path):
    # each push step's other last execution is an edit of pallas_ring.py
    # that must still apply: allreduce's last pull goes and its step
    # copies; the gather's step stops copying and its last execution
    # pulls
    from tpu_perf_torch.ops import pallas_ring
    from tpu_perf_torch.tools import peer_designs

    shipped = Path(pallas_ring.__file__).read_text()
    found = peer_designs.step_designs(tmp_path)
    assert sorted(found) == sorted(peer_designs.STEP_DESIGNS)
    texts = {op: path.read_text() for op, path in found.items()}
    for op, text in texts.items():
        compile(text, str(found[op]), "exec")
    copies = shipped.count("execution, torch.clone)")
    assert texts["pl_allreduce"].count("execution, torch.clone)") == copies + 1
    assert texts["pl_all_gather"].count("execution, torch.clone)") == copies - 1
    assert peer_designs.ALLREDUCE_LAST_PULL in shipped
    assert peer_designs.ALLREDUCE_LAST_PULL not in texts["pl_allreduce"]
    assert peer_designs.GATHER_LAST_PULL not in shipped
    assert peer_designs.GATHER_LAST_PULL in texts["pl_all_gather"]
