"""Build the CUDA C++ kernels with nvcc and load them with ctypes.

Each ``tpu_perf_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on its own (with the shared ``csrc/*.cuh`` headers) into
``tpu_perf_torch/_build/lib<name>.so``::

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
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C entry point and its argument types, per source
_ENTRIES = {
    # (x, out, n, chunk, dtype_code, scale, tiles, stream)
    "reduce_scatter": ("direct_reduce_scatter",
                       [_P, _P, _I, _L, _I, _F, _I, _P]),
    # (src, out, counters, n, chunk_bytes, src_row_bytes, src_own_bytes,
    # stream)
    "all_gather": ("direct_all_gather", [_P, _P, _P, _I, _L, _L, _L, _P]),
    # (src, dst, counters, n, row_bytes, stream)
    "hbm_copy": ("hbm_copy_rows", [_P, _P, _P, _I, _L, _P]),
    # (src, n, row_bytes, stream)
    "hbm_read": ("hbm_read_rows", [_P, _I, _L, _P]),
    # (src, dst, n, row_bytes, block_bytes, stream)
    "hbm_write": ("hbm_write_rows", [_P, _P, _I, _L, _L, _P]),
    # (src, out, counters, n, row_bytes, shift, stream)
    "p2p_shift": ("p2p_shift_rows", [_P, _P, _P, _I, _L, _I, _P]),
    # (x, out, stage, counters, n, row_bytes, stream)
    "pingpong": ("pingpong_rows", [_P, _P, _P, _P, _I, _L, _P]),
    # (src, out, n, ctas, warps, row_bytes, stream)
    "barrier": ("barrier_rows", [_P, _P, _I, _I, _I, _L, _P]),
    # (src, out, n, chunk_bytes, stream)
    "all_to_all": ("all_to_all_rows", [_P, _P, _I, _L, _P]),
    # (table, out, counters, n, rank, chunk, dtype_code, scale, tiles, vec,
    # stream)
    "peer_collectives": ("peer_reduce_scatter",
                         [_P, _P, _P, _I, _I, _L, _I, _F, _I, _I, _P]),
    # the trace fence's gate (timing.TraceRunner), no TPU kernel's port:
    # (flag, seen, missed, timeout_ns, stream)
    "trace_gate": ("trace_gate", [_P, _P, _P, _L, _P]),
}
#: sources that build no counted kernel: the timing layer's helpers (the
#: trace fence's gate), which port no TPU kernel
HELPERS = ("trace_gate",)
#: further C entry points of a source, beside its kernel's: (source,
#: symbol) -> argument types
_EXTRA_ENTRIES = {
    # an empty kernel's launch, the yardstick for the barrier's latency
    ("barrier", "empty_launch"): [_P],
    # (ctas, warps, &clusters): how many barrier clusters the card holds
    ("barrier", "barrier_max_active_clusters"): [_I, _I,
                                                 ctypes.POINTER(ctypes.c_int)],
    # the bidirectional gather: (src, out, counters, n, chunk_bytes, stream)
    ("all_gather", "direct_all_gather_bidir"): [_P, _P, _P, _I, _L, _P],
    # the peer kernels' gathers, copy and barrier: (own, table, counters,
    # n, rank, chunk_bytes, halves, word, stream), (table, out, counters, n,
    # rank, chunk_bytes, halves, word, stream), (src, dst, counters,
    # nbytes, word, stream) and (pad table, generation, n, rank, set, src,
    # dst, nbytes, stream)
    ("peer_collectives", "peer_gather_push"): [_P, _P, _P, _I, _I, _L, _I,
                                               _I, _P],
    ("peer_collectives", "peer_gather_pull"): [_P, _P, _P, _I, _I, _L, _I,
                                               _I, _P],
    ("peer_collectives", "peer_copy"): [_P, _P, _P, _L, _I, _P],
    ("peer_collectives", "peer_barrier"): [_P, _P, _I, _I, _I, _P, _P, _L,
                                           _P],
    # the all-to-all's push: (own, table, counters, n, rank, chunk_bytes,
    # word, stream)
    ("peer_collectives", "peer_all_to_all_push"): [_P, _P, _P, _I, _I, _L,
                                                   _I, _P],
    # (&ctas): the barrier CTAs the card holds at once
    ("peer_collectives", "peer_barrier_capacity"): [ctypes.POINTER(_I)],
    # a rank's symmetric allocation and its IPC handle: (bytes, &ptr),
    # (ptr), (ptr, handle[64]), (handle[64], &ptr), (ptr)
    ("peer_collectives", "peer_alloc"): [_L, ctypes.POINTER(_P)],
    ("peer_collectives", "peer_free"): [_P],
    ("peer_collectives", "peer_ipc_handle"): [_P, _P],
    ("peer_collectives", "peer_ipc_open"): [_P, ctypes.POINTER(_P)],
    ("peer_collectives", "peer_ipc_close"): [_P],
}

_loaded: dict[tuple[str, str], ctypes._CFuncPtr] = {}
#: nvcc builds this process has run (a process that finds every library
#: fresh, in a ``--compile-cache`` directory say, runs none)
BUILDS = 0


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
    # a source is stale when it or any shared header is newer than its
    # library
    lib = _lib_path(name)
    if not lib.exists():
        return True
    inputs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(exist_ok=True)
    # build under a private name (this process and thread's: the compile
    # pipeline's worker builds beside the main thread), then rename: a
    # concurrent loader never sees a half-written library
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.{threading.get_ident()}.so"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> None:
    global BUILDS
    out, _ = proc.communicate()
    BUILDS += 1
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


def compile_sources(names) -> int:
    """Build the stale sources of ``names``, one nvcc each, all started
    together, loading nothing: host work alone (the compile pipeline's
    worker calls it while the main thread may be capturing a CUDA graph).
    Returns how many it built."""
    jobs = [(name, *_start(name)) for name in dict.fromkeys(names)
            if _stale(name)]
    for name, proc, tmp in jobs:
        _finish(name, proc, tmp)
    return len(jobs)


def entry(name: str, symbol: str | None = None):
    """The C entry point of kernel source ``name`` (built if stale): its
    kernel's, or the named one of ``_EXTRA_ENTRIES``."""
    key = (name, symbol or _ENTRIES[name][0])
    fn = _loaded.get(key)
    if fn is None:
        if _stale(name):
            _finish(name, *_start(name))
        argtypes = (_ENTRIES[name][1] if key[1] == _ENTRIES[name][0]
                    else _EXTRA_ENTRIES[key])
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), key[1])
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[key] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
