"""Build the CUDA C++ kernels with nvcc and load them with ctypes.

Each ``tpu_perf_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on its own into ``tpu_perf_torch/_build/lib<name>.so``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

The build happens at first use in a process (or up front through
:func:`build_all`, which starts one nvcc per source, all at once) and is
skipped while the library is newer than its source.  No PyTorch header is
included, so a build takes seconds, not minutes.  The C entry points take
raw pointers and the CUDA stream as ``void*`` and return
``cudaGetLastError()`` after the launch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry point and its argument types, per source
_ENTRIES = {
    # (x, out, stage, n, chunk, step, dtype_code, stream)
    "ring_reduce_scatter": ("ring_reduce_scatter_step",
                            [_P, _P, _P, _I, _L, _I, _I, _P]),
    # (src, out, n, chunk_bytes, src_row_bytes, src_own_bytes, step, stream)
    "ring_all_gather": ("ring_all_gather_step",
                        [_P, _P, _I, _L, _L, _L, _I, _P]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels build on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(exist_ok=True)
    # build under a private name, then rename: a concurrent loader never
    # sees a half-written library
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))


def build_all() -> float:
    """Build every stale CUDA source, one nvcc per source, all started
    together; returns the wall seconds spent."""
    t0 = time.perf_counter()
    jobs = [(name, *_start(name)) for name in _ENTRIES if _stale(name)]
    for name, proc, tmp in jobs:
        _finish(name, proc, tmp)
    return time.perf_counter() - t0


def entry(name: str):
    """The C entry point of kernel source ``name`` (built if stale)."""
    fn = _loaded.get(name)
    if fn is None:
        if _stale(name):
            _finish(name, *_start(name))
        symbol, argtypes = _ENTRIES[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
