"""Run configuration for this package's ``run`` slice.

Defaults and validation messages are the JAX package's
(``tpu_perf/config.py``): op ``pingpong``, iters 10 (mpi_perf.c:15), buffer
456131 bytes (mpi_perf.c:14), one run, the same payload dtypes and fence
names, ``-u`` / ``-x``, ``-r -1`` for the infinite daemon, and the
fused fence's chunk count, ``-p`` flows per node, the windowed ``-x``
(``--window``), the ``-f`` / ``-n`` group-1 file, ``-d`` the print-only
external launcher, ``--backend mpi``, the JSON heartbeat, ``--streams``
(overlapped dispatch), ``contend``'s background ``load``, and the mesh
and multi-process flags (``--mesh`` / ``--axes``, ``--distributed``,
``--hybrid-mesh``).  The additions are the sim world's rank count and the
device; ``backend`` names ``torch`` where the JAX package names ``jax``.
"""

from __future__ import annotations

import dataclasses
import uuid as _uuid

from tpu_perf_torch.sweep import DEF_BUF_SZ

#: the reference's log folder (run-*.sh), ``ingest``'s default
DEFAULT_LOG_DIR = "/mnt/tcp-logs"
#: mpi_perf.c:15 — default number of messages per run.
DEF_ITERS = 10
#: mpi_perf.c:16 — log-rotation period, seconds.
LOG_REFRESH_TIME_SEC = 900
#: mpi_perf.c:564 — a min/max/avg heartbeat goes to stderr every this many runs.
STATS_EVERY_RUNS = 1000
#: ranks of the single-card sim world (the JAX tests' 8 virtual devices)
DEF_SIM_RANKS = 8

#: payload dtypes supported by the kernels
SUPPORTED_DTYPES = ("float32", "bfloat16", "float16", "int32", "uint8")

#: how a timed call is fenced (tpu_perf_torch.timing); the JAX package's
#: names
FENCE_MODES = ("block", "readback", "slope", "trace", "fused", "auto")
#: who runs the measurement: this package on the card, or the repo's C
#: baseline (backends/mpi) on the host
BACKENDS = ("torch", "mpi")
#: the stderr heartbeat's formats
HEARTBEAT_FORMATS = ("human", "json")


def new_job_id() -> str:
    """Random UUID string, the reference's uuid_generate/unparse
    (mpi_perf.c:335-338)."""
    return str(_uuid.uuid4())


@dataclasses.dataclass
class Options:
    """One benchmark invocation's configuration."""

    logfolder: str | None = None      # -l
    iters: int = DEF_ITERS            # -i
    ppn: int = 1                      # -p  (flows per node; NumOfFlows column)
    buff_sz: int = DEF_BUF_SZ         # -b
    num_runs: int = 1                 # -r  (-1 = infinite daemon mode)
    uuid: str = dataclasses.field(default_factory=new_job_id)
    op: str = "pingpong"              # the reference's blocking ping-pong,
                                      # or a comma-separated family
    uni_dir: bool = False             # -u: payload one way, 1-element ack back
    nonblocking: bool = False         # -x: both directions at once (exchange)
    extern_cmd: str | None = None     # -d: print-only external launcher
                                      # template (mpi_perf.c:147-168); takes
                                      # precedence over every kernel
    window: int = 1                   # buffers in flight for -x (MAX_REQ_NUM
                                      # analogue, mpi_perf.c:88)
    group1_file: str | None = None    # -f: hostnames of group 1
    n_group1: int = 0                 # -n: expected group-1 host count,
                                      # checked against the file (0 =
                                      # unchecked; mpi_perf.c:287-289)
    backend: str = "torch"            # BACKENDS
    heartbeat_format: str = "human"   # HEARTBEAT_FORMATS
    sweep: str | None = None          # e.g. "8:1G"; None = single buff_sz point
    dtype: str = "float32"
    log_refresh_sec: int = LOG_REFRESH_TIME_SEC
    stats_every: int = STATS_EVERY_RUNS
    warmup_runs: int = 1              # run 0 skipped as warm-up (mpi_perf.c:545)
    fence: str = "block"              # FENCE_MODES
    fused_chunks: int = 0             # --fused-chunks: dispatches a point
                                      # (0 = auto: one)
    measure_dispatch: bool = False    # --measure-dispatch: each row's
                                      # overhead_us (block/readback)
    profile_dir: str | None = None    # --profile-dir: torch.profiler traces
    max_runs: int | None = None       # --max-runs: the daemon stops after
                                      # this many measured runs
    streams: int = 1                  # --streams K: keep up to K sweep
                                      # points in flight, each on its own
                                      # CUDA stream, fenced in dispatch
                                      # order (tpu_perf_torch.streams);
                                      # rows carry their 1-based lane in
                                      # the stream column; 1 = serial
    load: str = ""                    # `contend`: the background load the
                                      # victim races ("mxu_gemm",
                                      # "hbm_stream" or any ported op);
                                      # "" = a quiet card (every other
                                      # subcommand)
    sim_ranks: int = DEF_SIM_RANKS    # --sim-ranks
    mesh_shape: tuple[int, ...] = ()  # --mesh; () = every rank on one axis
    mesh_axes: tuple[str, ...] = ()   # --axes, names matching mesh_shape
    distributed: bool = False         # --distributed: one process a rank
                                      # of a torch.distributed world
    hybrid_mesh: bool = False         # --hybrid-mesh: (dcn, ici) over the
                                      # nodes and their local ranks
    device: str | None = None         # None = "cuda"; "cpu" only when asked

    def __post_init__(self) -> None:
        if self.iters <= 0:
            raise ValueError(f"iters must be positive, got {self.iters}")
        if self.buff_sz <= 0:
            raise ValueError(f"buff_sz must be positive, got {self.buff_sz}")
        if self.num_runs == 0 or self.num_runs < -1:
            raise ValueError(f"num_runs must be positive or -1, got {self.num_runs}")
        if self.ppn <= 0:
            raise ValueError(f"ppn must be positive, got {self.ppn}")
        if self.n_group1 < 0:
            raise ValueError(f"n_group1 must be >= 0, got {self.n_group1}")
        if self.n_group1 and not self.group1_file:
            # a bare -n is the JAX package's stale iters spelling; ignoring
            # it would run with the default iters
            raise ValueError(
                "-n/--group1-hosts needs -f/--group1-file (note: iters moved "
                "to -i, matching the reference's flags)"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {'|'.join(BACKENDS)}, got "
                f"{self.backend!r}")
        if self.op == "extern" and not self.extern_cmd:
            raise ValueError(
                "op='extern' needs a command template (extern_cmd / -d)"
            )
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.window > 1 and not self.nonblocking and self.op not in (
            "exchange", "ppermute",
        ):
            raise ValueError("window > 1 requires the windowed kernel (-x or op=exchange)")
        if self.heartbeat_format not in HEARTBEAT_FORMATS:
            raise ValueError(
                "heartbeat_format must be 'human' or 'json', "
                f"got {self.heartbeat_format!r}"
            )
        if self.fence not in FENCE_MODES:
            raise ValueError(
                f"fence must be one of {'|'.join(FENCE_MODES)}, got {self.fence!r}"
            )
        if self.fused_chunks < 0:
            raise ValueError(
                f"fused_chunks must be >= 0 (0 = auto), got "
                f"{self.fused_chunks}"
            )
        if self.fused_chunks and self.fence != "fused":
            # a knob nothing will consult is a loud error, never a silent
            # no-op mistaken for chunked fused measurement
            raise ValueError(
                f"fused_chunks applies to --fence fused only (fence is "
                f"{self.fence!r})"
            )
        if self.fused_chunks and self.infinite:
            raise ValueError(
                "fused_chunks applies to finite sweeps; daemon visits "
                "are one run (one dispatch) each"
            )
        if self.max_runs is not None and self.max_runs < 1:
            raise ValueError(f"max_runs must be >= 1, got {self.max_runs}")
        if self.max_runs is not None and not self.infinite:
            # on a finite run --max-runs is the JAX package's adaptive
            # cap, and adaptive runs are not ported yet
            raise ValueError(
                "max_runs on a finite run is the adaptive cap, and adaptive "
                "runs are not yet ported (use -r for a fixed budget; in "
                "daemon mode --max-runs keeps its stop-after-N meaning)"
            )
        if self.dtype not in SUPPORTED_DTYPES:
            raise ValueError(
                f"unsupported dtype {self.dtype!r}; supported: {SUPPORTED_DTYPES}"
            )
        if self.sim_ranks < 1:
            raise ValueError(
                f"sim_ranks must be >= 1, got {self.sim_ranks}")
        if len(self.mesh_shape) != len(self.mesh_axes):
            raise ValueError(
                f"mesh_shape {self.mesh_shape} and mesh_axes {self.mesh_axes} "
                "must have matching length"
            )
        if self.distributed and self.sim_ranks > 1:
            # a process of a distributed world holds one rank; n rows of
            # one allocation would be a sim world inside each process
            raise ValueError(
                f"sim_ranks {self.sim_ranks} with distributed: a process of "
                "a distributed world holds one rank (drop --sim-ranks; the "
                "world's size comes from the launcher)")
        if self.distributed and self.backend != "torch":
            raise ValueError(
                "distributed joins a torch.distributed world; "
                f"backend={self.backend!r} launches its own ranks")
        if self.device not in (None, "cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if self.streams < 1:
            raise ValueError(
                f"streams must be >= 1 (1 = serial dispatch), got "
                f"{self.streams}")
        if self.streams > 1:
            # K steps are in flight before the first fence: every mode
            # whose timing or semantics need one step alone on the card
            # fails loudly
            if self.backend != "torch":
                raise ValueError(
                    "overlapped dispatch (--streams) rides the torch async "
                    f"dispatch; backend={self.backend!r} has no in-flight "
                    "window")
            if self.extern_cmd:
                raise ValueError(
                    "extern mode runs no kernel; --streams does not apply")
            if self.infinite:
                raise ValueError(
                    "overlapped dispatch applies to finite sweeps; the "
                    "daemon's round-robin is one visit (one dispatch) at "
                    "a time by design")
            if self.fence in ("fused", "trace", "slope"):
                raise ValueError(
                    f"overlapped dispatch needs a per-run fence that "
                    f"tolerates concurrent lanes (block/readback); the "
                    f"{self.fence!r} fence's batched/paired capture "
                    f"assumes its program is alone in flight")
        if self.load:
            if self.backend != "torch":
                raise ValueError(
                    "contention loads (--load) are torch programs; "
                    f"backend={self.backend!r} cannot race them")
            if self.extern_cmd:
                raise ValueError(
                    "extern mode runs no kernel; --load does not apply")
            if self.infinite:
                raise ValueError(
                    "contention runs (--load) are finite measurements; "
                    "daemon mode does not race a background load")
        if self.uni_dir and self.nonblocking:
            # the reference picks one kernel by if / else if
            # (mpi_perf.c:506-523); the conflict is made loud instead
            raise ValueError("uni_dir and nonblocking are mutually exclusive")

    @property
    def infinite(self) -> bool:
        """Daemon mode: ``-r -1`` (``monitor``)."""
        return self.num_runs == -1
