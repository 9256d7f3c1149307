"""Drive the repo's C baseline (``backends/mpi``) from this package's CLI
(port of ``tpu_perf/mpi_launch.py``).

``run --backend mpi`` builds the C driver and runs the same command line
the profile scripts render: the reference's operator surface
(mpi_perf.c:273-339 flags, launched as in run-hbv3.sh:22-28), so one
command fills a log folder with ``backend=mpi`` rows that ``report
--compare`` pairs with this package's ``torch`` / ``torch-sim`` rows.

Two launchers:

* ``--hosts h0,h1`` -> the real-cluster ``mpirun`` line (``mpirun -np
  hosts*ppn --host ... --map-by ppr:<ppn>:node mpi_perf ...``), the
  binary built with ``mpicc``;
* no hosts -> the pthread shim (``mpi_perf_shim -np N -- ...``), which
  needs no MPI installation: the single-machine baseline.

``--dry-run`` prints the exact command(s) and launches nothing.

Both binaries are built into ``tpu_perf_torch/_build/mpi/`` (never into
``backends/mpi/``, whose Makefile targets other builds use), from the
Makefile's sources and flags, under a file lock, through a temporary name
and an atomic rename, so concurrent builders never see half a binary.

This is the reference's own baseline on the host: nothing here touches
the card, and the module imports no ``torch``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import math
import os
import pathlib
import shlex
import shutil
import subprocess
import sys
import tempfile

from tpu_perf_torch.config import Options
from tpu_perf_torch.sweep import parse_sweep

#: op name -> extra argv for the C driver: the reference's three pairwise
#: kernels (tpu_mpi_perf.c kernel_bidir/oneway/windowed) and the
#: collective mode (-o), whose ops carry this package's op names so the
#: report's curve keys line up
_PAIRWISE_OPS = {
    "pingpong": [],            # blocking bidirectional (default kernel)
    "pingpong_unidir": ["-u", "1"],
    "exchange": ["-x", "1"],
}
_COLLECTIVE_OPS = (
    "allreduce", "all_gather", "reduce_scatter", "all_to_all",
    "broadcast", "barrier",
    # local per-rank memory stream: the host-DRAM counterpart of the
    # card's hbm_stream, pairable through report --compare
    "hbm_stream",
)

#: content of the generated group-1 hostfile for the shim, whose ranks
#: report the hostnames shimhost0 / shimhost1 (shim_main.c)
_SHIM_GROUP1 = "shimhost1\n"

#: where the binaries are built (gitignored)
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build" / "mpi"

#: target -> (sources, headers, compiler flags beyond the Makefile's
#: CFLAGS, link flags), backends/mpi/Makefile's `shim` and `mpi_perf`
_TARGETS = {
    "mpi_perf_shim": (("tpu_mpi_perf.c", "mpi_shim.c", "shim_main.c"),
                      ("mpi_shim.h",),
                      ["-DTPU_PERF_USE_SHIM", "-DTPU_PERF_SHIM_LAUNCHER"],
                      ["-lpthread"]),
    "mpi_perf": (("tpu_mpi_perf.c",), (), [], []),
}
#: the Makefile's CFLAGS
_CFLAGS = ["-O2", "-Wall", "-Wextra"]


def backend_dir() -> pathlib.Path:
    """``backends/mpi`` of the working tree: the C sources."""
    return pathlib.Path(__file__).resolve().parent.parent / "backends" / "mpi"


def _op_argv(op: str) -> list[str]:
    if op in _PAIRWISE_OPS:
        return list(_PAIRWISE_OPS[op])
    if op in _COLLECTIVE_OPS:
        return ["-o", op]
    raise ValueError(
        f"op {op!r} has no mpi-backend kernel; supported: "
        f"{', '.join(sorted(_PAIRWISE_OPS))} (pairwise), "
        f"{', '.join(_COLLECTIVE_OPS)} (collectives)"
    )


def mpi_sizes_for(opts: Options) -> list[int]:
    """The sweep (or single buff_sz) for the C backend, float32-aligned
    like this package's rows so both land on the same curve keys; barrier
    is fixed-payload and collapses to one point."""
    sizes = parse_sweep(opts.sweep, align=4) if opts.sweep else [opts.buff_sz]
    if opts.op == "barrier":
        sizes = sizes[:1]
    if opts.infinite and len(sizes) > 1:
        raise ValueError(
            "--backend mpi daemon mode (-r -1) monitors a single size; "
            "a sweep would block forever on its first point"
        )
    return sizes


def driver_argv(opts: Options, nbytes: int) -> list[str]:
    """The C driver's flags for one measurement point (mpi_perf.c:273-339
    letters; -o is this backend's documented addition)."""
    argv = _op_argv(opts.op)
    if opts.uni_dir and not argv and opts.op not in _COLLECTIVE_OPS:
        argv = ["-u", "1"]
    if opts.nonblocking and not argv and opts.op not in _COLLECTIVE_OPS:
        argv = ["-x", "1"]
    argv += ["-i", str(opts.iters), "-b", str(nbytes),
             "-r", str(opts.num_runs), "-p", str(opts.ppn)]
    if opts.group1_file:
        argv += ["-f", opts.group1_file]
    if opts.n_group1:
        argv += ["-n", str(opts.n_group1)]
    if opts.logfolder:
        argv += ["-l", opts.logfolder]
    return argv


def _shim_group_file() -> str:
    """A stable generated group-1 file for the shim (constant content, so
    concurrent writers agree).  Per-uid name so a shared temp dir cannot
    collide; O_NOFOLLOW so a planted symlink cannot redirect the write."""
    path = os.path.join(tempfile.gettempdir(),
                        f"tpu-perf-shim-group1-{os.getuid()}")
    try:
        fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC
                     | os.O_NOFOLLOW, 0o644)
    except OSError as e:
        raise ValueError(f"cannot write shim group file {path}: {e}") from e
    with os.fdopen(fd, "w") as fh:
        fh.write(_SHIM_GROUP1)
    return path


def plan_command(opts: Options, nbytes: int, *,
                 hosts: str | None = None) -> list[str]:
    """The exact argv for one mpi-backend measurement point.

    mpirun when ``hosts`` is set (np = hosts * ppn; the pairwise kernels
    need -f, as run-mpi-monitor.sh:53-56; a ``--mesh`` must name that
    many ranks); the shim otherwise (its -f is generated for the shim's
    shimhost names), at the two shim hosts' flows, 2 * ppn ranks, or for
    a collective the ranks a ``--mesh`` names (``--mesh 1`` runs
    ``hbm_stream`` on one uncontended rank)."""
    coll = opts.op in _COLLECTIVE_OPS
    if hosts:
        if not coll and not opts.group1_file:
            raise ValueError(
                "--backend mpi with --hosts needs -f/--group1-file (the "
                "group-1 hostnames; mpi_perf.c:405-419)"
            )
        n_hosts = len([h for h in hosts.split(",") if h])
        if n_hosts < 1:
            raise ValueError(f"--hosts {hosts!r} names no hosts")
        np = n_hosts * opts.ppn
        if opts.mesh_shape and math.prod(opts.mesh_shape) != np:
            # the world size comes from the host topology here; a --mesh
            # that disagrees would run another collective than asked for
            raise ValueError(
                f"--mesh {'x'.join(map(str, opts.mesh_shape))} conflicts "
                f"with --hosts x ppn = {np} ranks; drop --mesh or adjust -p"
            )
        env_args = ["-x", "TPU_PERF_INGEST_CMD"] if opts.logfolder else []
        return [
            "mpirun", "-np", str(np), "--host", hosts,
            "--map-by", f"ppr:{opts.ppn}:node", *env_args,
            str(BUILD_DIR / "mpi_perf"), *driver_argv(opts, nbytes),
        ]
    if not coll and not opts.group1_file:
        opts = dataclasses.replace(opts, group1_file=_shim_group_file())
    if not coll:
        np = 2 * opts.ppn
    elif opts.mesh_shape and (math.prod(opts.mesh_shape) > 1
                              or opts.op == "hbm_stream"):
        np = math.prod(opts.mesh_shape)
    else:
        np = max(2, 2 * opts.ppn)
    return [str(BUILD_DIR / "mpi_perf_shim"), "-np", str(np), "--",
            *driver_argv(opts, nbytes)]


def _compiler(target: str) -> str:
    if target == "mpi_perf":
        cc = os.environ.get("MPICC") or shutil.which("mpicc")
        if not cc:
            raise ValueError(
                "building the mpirun binary needs mpicc on PATH; use the "
                "shim (drop --hosts) where MPI is not installed")
        return cc
    cc = (os.environ.get("CC") or shutil.which("gcc") or shutil.which("cc"))
    if not cc:
        raise ValueError("building the shim needs a C compiler (gcc or cc)")
    return cc


@contextlib.contextmanager
def _locked(path: pathlib.Path):
    with open(path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def ensure_built(target: str, build_dir: pathlib.Path | None = None
                 ) -> pathlib.Path:
    """Build ``target`` (``mpi_perf_shim`` or ``mpi_perf``) into
    ``build_dir`` (default :data:`BUILD_DIR`) unless it is newer than its
    sources; returns its path.  One builder at a time holds the
    directory's lock; the compiler writes a private name that is renamed
    into place."""
    build_dir = build_dir or BUILD_DIR
    sources, headers, defines, libs = _TARGETS[target]
    src = backend_dir()
    inputs = [src / f for f in (*sources, *headers)]
    missing = [str(p) for p in inputs if not p.exists()]
    if missing:
        raise ValueError(
            f"mpi backend sources not found ({', '.join(missing)}); "
            "--backend mpi needs a working-tree checkout (backends/mpi)")
    binary = build_dir / target
    build_dir.mkdir(parents=True, exist_ok=True)
    with _locked(build_dir / ".lock"):
        newest = max(p.stat().st_mtime for p in inputs)
        if binary.exists() and binary.stat().st_mtime >= newest:
            return binary
        tmp = build_dir / f"{target}.{os.getpid()}.tmp"
        cmd = [_compiler(target), *_CFLAGS, *defines, "-o", str(tmp),
               *(str(src / f) for f in sources), *libs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise ValueError(f"building {target} failed:\n"
                             f"{res.stderr.strip()}")
        os.replace(tmp, binary)
    return binary


def run_mpi_backend(opts: Options, *, hosts: str | None = None,
                    dry_run: bool = False, err=None) -> int:
    """Execute (or print, with ``dry_run``) the C baseline over the
    configured sweep.  Returns a process exit code."""
    err = err if err is not None else sys.stderr
    if opts.dtype != "float32":
        raise ValueError(
            "the mpi backend's payloads are byte/float32 buffers; "
            f"--dtype {opts.dtype} is torch-backend only"
        )
    if opts.extern_cmd:
        # the C driver has no -d mode (the reference's dotnet launcher is
        # vestigial, mpi_perf.c:147-168); running a real kernel instead of
        # the print-only mode would be worse than an error
        raise ValueError(
            "-d/--extern-cmd (print-only external launcher) is "
            "torch-backend only (op=extern)"
        )
    if opts.profile_dir:
        print("[tpu-perf-torch] --profile-dir is torch-backend only; "
              "ignored for --backend mpi", file=err)
    if opts.window > 1:
        print("[tpu-perf-torch] the C windowed kernel keeps a fixed 256-slot "
              "window (WINDOW_SLOTS); --window ignored for --backend mpi",
              file=err)
    sizes = mpi_sizes_for(opts)
    env = dict(os.environ)
    if opts.logfolder and not hosts:
        # a local launch gets its folder made, as RotatingCsvLog does; on
        # a cluster that is host preparation, not the launcher's
        os.makedirs(opts.logfolder, exist_ok=True)
    if opts.logfolder and "TPU_PERF_INGEST_CMD" not in env:
        # the rotation-triggered ingest pass, as a separate process (the
        # reference's kusto_ingest.py system() call, mpi_perf.c:363-364)
        from tpu_perf_torch.ingest.pipeline import ingest_command

        env["TPU_PERF_INGEST_CMD"] = shlex.join(
            ingest_command(opts.logfolder, opts.ppn))
    for nbytes in sizes:
        cmd = plan_command(opts, nbytes, hosts=hosts)
        if dry_run:
            print(shlex.join(cmd))
            continue
        if hosts:
            if shutil.which("mpirun") is None:
                raise ValueError(
                    "--hosts needs mpirun on PATH (or drop --hosts to use "
                    "the no-MPI pthread shim)"
                )
            ensure_built("mpi_perf")
        else:
            ensure_built("mpi_perf_shim")
        res = subprocess.run(cmd, env=env)
        if res.returncode != 0:
            return res.returncode
    return 0
