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
``--hybrid-mesh``), the adaptive stop rule (``--ci-rel``,
``--ci-confidence``, ``--ci-statistic``, ``--min-runs``, ``--max-runs`` as
its cap), the compile pipeline (``--precompile``,
``--compile-cache``), the health monitor (``--health*``), span tracing
(``--spans``, ``--spans-sample``) and fault injection (``chaos``'s
schedule, ``--seed``, ``--synthetic``).  The additions are the sim world's rank count and the
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
    algo: str = "native"              # --algo: the decomposition(s) to run
                                      # (tpu_perf_torch.arena): "native",
                                      # one algorithm, a comma family, or
                                      # "all" (native and every registered
                                      # algorithm the op and world allow)
                                      # or "auto" (each point's winner in
                                      # the selection artifact)
    algo_artifact: str | None = None  # --algo-artifact: the selection
                                      # artifact `--algo auto` resolves
                                      # points against (`tune` makes it);
                                      # required with auto, an error with
                                      # any other --algo
    tune_margin: float = 1.02         # --tune-margin: an entry whose
                                      # best-vs-runner-up p50 ratio falls
                                      # below this runs native (loud)
    tune_max_age: float = 0.0         # --tune-max-age SECONDS: the
                                      # artifact's staleness horizon,
                                      # judged once at load; 0 = none (a
                                      # plan never flips on wall time
                                      # unless asked)
    sweep: str | None = None          # e.g. "8:1G"; None = single buff_sz point
    skew_spread: tuple[int, ...] = () # --skew-spread: arrival spreads in
                                      # us; every (op, algo, size) point is
                                      # measured once a spread, each run's
                                      # entry staggered (the last rank
                                      # exactly the spread late, the rest
                                      # seeded in [0, spread)); rows carry
                                      # it in skew_us; () = synchronized
    imbalance: tuple[int, ...] = ()   # --imbalance: max/min per-rank
                                      # payload ratios of the v-ops and
                                      # scenarios (a build coordinate);
                                      # () = balanced only
    scenario: tuple = ()              # `scenario`: the selected scenarios
                                      # (built-in names or spec.json
                                      # paths), resolved to ScenarioSpec
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
                                      # this many measured runs; on a
                                      # finite run, the adaptive cap (with
                                      # --ci-rel; None = -r)
    ci_rel: float | None = None       # --ci-rel: stop each point once the
                                      # relative half-width of its CI falls
                                      # under this (tpu_perf_torch.adaptive);
                                      # None = the fixed -r budget
    ci_confidence: float = 0.95       # --ci-confidence: 0.90 / 0.95 / 0.99
    ci_statistic: str = "mean"        # --ci-statistic: mean (t interval)
                                      # or p50 (order-statistic interval)
    min_runs: int = 5                 # --min-runs: samples before the stop
                                      # rule is asked
    precompile: int = 0               # --precompile N: build the host half
                                      # of up to N upcoming points on a
                                      # worker thread (0 = serial builds)
    precompile_auto: bool = False     # --precompile auto: the depth follows
                                      # the compile / measure phase ratio;
                                      # `precompile` is then its start (1)
    compile_cache: str | None = None  # --compile-cache DIR: kernel builds
                                      # (nvcc, Triton) kept in DIR
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
    # --- harness span tracing (tpu_perf_torch.spans) ---
    spans: bool = False               # --spans: job/sweep/point/run spans
                                      # and the harness' activity, to the
                                      # spans-*.log family; each row and
                                      # health event carries its run span
    spans_sample: int = 1             # --spans-sample N: a daemon keeps
                                      # every Nth run's whole span tree,
                                      # the other runs their run span
                                      # (rotate/ingest/inject/heartbeat
                                      # and error spans always)
    # --- fleet health (tpu_perf_torch.health) ---
    health: bool = False              # --health: per-point baselines and
                                      # detectors, health-*.log events
    health_threshold: float = 0.5     # relative step-regression threshold
                                      # (EWMA against the long-run median)
    health_warmup: int = 30           # samples before a point is judged
    health_textfile: str | None = None  # Prometheus textfile of the gauges
    # --- fault injection (tpu_perf_torch.faults) ---
    faults: object = None             # a JSON spec path (str) or a
                                      # list[FaultSpec]; None = none
    fault_seed: int = 0               # --seed: the injector's RNG root
    synthetic_s: float | None = None  # --synthetic: a seeded series around
                                      # this latency (s) replaces every
                                      # measured sample
    # --- the live telemetry push plane (tpu_perf_torch.push) ---
    push_url: str | None = None       # --push: NDJSON HTTP base URL; every
                                      # family but the chaos ledger teed
                                      # into a bounded queue a background
                                      # thread sends to <url>/v1/<Table>
    push_textfile: str | None = None  # --push-textfile: the plane's live
                                      # Prometheus textfile (rank 0)
    push_queue: int = 0               # --push-queue: the tee queue's bound
                                      # in records (0: push.DEFAULT_QUEUE)

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
        if not self.algo:
            raise ValueError("algo must not be empty (use 'native')")
        if self.algo != "native":
            # the arena's decompositions are torch programs: an --algo on
            # the C baseline would label rows with an algorithm that
            # never ran
            if self.backend != "torch":
                raise ValueError(
                    f"algo={self.algo!r} applies to the torch backend "
                    f"(the arena races library decompositions), got "
                    f"backend={self.backend!r}")
            if self.extern_cmd:
                raise ValueError("extern mode runs no kernel; --algo "
                                 "does not apply")
            if self.window > 1:
                raise ValueError("window does not apply to arena "
                                 "algorithms")
        if self.algo == "auto":
            if not self.algo_artifact:
                raise ValueError(
                    "--algo auto resolves sweep points against a "
                    "selection artifact; name one with --algo-artifact "
                    "PATH (produce it with `tpu-perf-torch tune`)")
            if self.load:
                raise ValueError(
                    "--algo auto applies to run/monitor/chaos/scenario; "
                    "a contention race (--load) names its algorithms "
                    "explicitly")
        elif self.algo_artifact:
            # an artifact that resolves nothing is an inert knob: loud
            raise ValueError(
                f"--algo-artifact applies only with --algo auto (got "
                f"--algo {self.algo!r})")
        if self.tune_margin < 1.0:
            raise ValueError(
                f"tune_margin is a best-vs-runner-up ratio and must be "
                f">= 1.0, got {self.tune_margin}")
        if self.tune_max_age < 0:
            raise ValueError(
                f"tune_max_age must be >= 0 seconds (0 = no staleness "
                f"check), got {self.tune_max_age}")
        if self.push_queue < 0:
            raise ValueError(
                f"push_queue must be >= 0 (0 = default), got "
                f"{self.push_queue}")
        if self.push_queue and not self.push_url:
            # a knob nothing consults is loud: a --push-textfile-only
            # plane tees nothing, so its queue is never used
            raise ValueError(
                "push_queue sizes the push plane's tee queue and needs "
                "--push URL to enable delivery (a --push-textfile-only "
                "plane tees no records)")
        if (self.push_url or self.push_textfile) and self.backend != "torch":
            # the C backend's driver builds no plane: an inert --push
            # would read as telemetry flowing
            raise ValueError(
                "the push plane (--push/--push-textfile) rides the torch "
                f"driver's record plane; backend={self.backend!r} has no "
                "tee boundary")
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
        if (self.max_runs is not None and self.ci_rel is None
                and not self.infinite):
            # on a finite run nothing consults the cap without the
            # controller; ignoring it would run the -r budget unasked
            raise ValueError(
                "max_runs on a finite run is the adaptive cap and needs "
                "--ci-rel (use -r for a fixed budget; in daemon mode "
                "--max-runs keeps its stop-after-N meaning)"
            )
        if self.ci_rel is not None and not 0.0 < self.ci_rel < 1.0:
            raise ValueError(f"ci_rel must be in (0, 1), got {self.ci_rel}")
        from tpu_perf_torch.adaptive import (
            SUPPORTED_CONFIDENCES, SUPPORTED_STATISTICS,
        )

        if self.ci_confidence not in SUPPORTED_CONFIDENCES:
            raise ValueError(
                f"ci_confidence must be one of {SUPPORTED_CONFIDENCES}, "
                f"got {self.ci_confidence}"
            )
        if self.ci_statistic not in SUPPORTED_STATISTICS:
            raise ValueError(
                f"ci_statistic must be one of {SUPPORTED_STATISTICS}, "
                f"got {self.ci_statistic!r}"
            )
        if self.ci_statistic != "mean" and self.ci_rel is None:
            raise ValueError(
                "ci_statistic selects the adaptive stop rule's target "
                "and needs --ci-rel (nothing else consults it)"
            )
        if self.min_runs < 2:
            raise ValueError(
                f"min_runs must be >= 2 (a variance needs two samples), "
                f"got {self.min_runs}"
            )
        if self.precompile < 0:
            raise ValueError(
                f"precompile must be >= 0 (0 = serial builds), got "
                f"{self.precompile}"
            )
        if self.precompile_auto and self.precompile < 1:
            raise ValueError(
                "precompile auto needs a positive initial depth (the CLI "
                "maps --precompile auto to 1)"
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
            if self.infinite and not (
                    self.faults or self.synthetic_s is not None):
                # a chaos soak is exempt: the driver runs it serially,
                # and says so (the ledger's byte-identity is defined over
                # the serial dispatch sequence)
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
            if self._wants_skew():
                raise ValueError(
                    "arrival skew staggers one program's entry per run; "
                    "under --streams the lanes already overlap, so the "
                    "staggered-entry measurement is unimplementable — "
                    "run the skew axis serially")
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
        if any(s < 0 for s in self.skew_spread):
            raise ValueError(
                f"skew spread values must be >= 0 us, got "
                f"{self.skew_spread}")
        if any(int(r) != r or r < 1 for r in self.imbalance):
            raise ValueError(
                f"imbalance ratios must be integers >= 1 (max/min "
                f"per-rank payload), got {self.imbalance}")
        if self.scenario:
            # names and paths resolved once, here (replace() re-runs this
            # on the resolved specs, which pass through)
            from tpu_perf_torch.scenarios.spec import resolve_scenarios

            self.scenario = resolve_scenarios(self.scenario)
            if self.op != "scenario":
                raise ValueError(
                    "a scenario selection runs under op='scenario' (the "
                    "`tpu-perf-torch scenario` subcommand sets it); got "
                    f"op={self.op!r}")
            if self.backend != "torch":
                raise ValueError(
                    "scenarios compose torch phases; "
                    f"backend={self.backend!r} has no composition path")
            if self.extern_cmd:
                raise ValueError(
                    "extern mode runs no kernel; scenarios do not apply")
            if self.window > 1:
                raise ValueError("window does not apply to scenarios")
        elif self.op == "scenario":
            raise ValueError(
                "op='scenario' needs a scenario selection (use "
                "`tpu-perf-torch scenario NAME` or a spec.json path)")
        if any(r > 1 for r in self.imbalance):
            from tpu_perf_torch.scenarios.vops import IMBALANCE_OPS

            capable = set(IMBALANCE_OPS) | {"scenario"}
            ops = [o.strip() for o in self.op.split(",") if o.strip()]
            bad = [o for o in ops if o not in capable]
            if bad:
                raise ValueError(
                    f"--imbalance applies to the v-variant ops "
                    f"{IMBALANCE_OPS} and to scenarios; op(s) {bad} "
                    f"have no uneven-payload schedule")
            if self.scenario and not any(
                    sc.uses_imbalance for sc in self.scenario):
                raise ValueError(
                    f"none of the selected scenarios "
                    f"({[sc.name for sc in self.scenario]}) has a "
                    f"v-variant phase; the imbalance axis would decorate "
                    f"rows while changing nothing")
        if isinstance(self.faults, str):
            # a spec path is parsed once, here (dataclasses.replace runs
            # this again, on the parsed list)
            from tpu_perf_torch.faults import load_spec

            try:
                self.faults = load_spec(self.faults)
            except OSError as e:
                raise ValueError(f"cannot read fault spec: {e}") from None
        if self._wants_skew():
            # per-run entry stagger needs a dispatch a run: a finite
            # fused point replays its whole budget as one graph, a finite
            # trace point one capture pair.  A fused daemon visit is one
            # replay of a one-run graph, so a stagger before it lands
            # between the graph's events of every rank that waits
            if self.fence == "fused" and not self.infinite:
                raise ValueError(
                    "arrival skew (--skew-spread / skew faults) cannot "
                    "run on a finite --fence fused sweep: a point's "
                    "whole run budget is one graph replay, so per-run "
                    "entry stagger is unimplementable there (a fused "
                    "daemon replays one run a visit and supports skew)")
            if self.fence == "trace" and not self.infinite:
                raise ValueError(
                    "arrival skew (--skew-spread / skew faults) cannot "
                    "run under the finite trace fence: one batched "
                    "capture covers the point's whole budget, so per-run "
                    "entry stagger is unimplementable there (daemon-mode "
                    "trace captures per run and supports skew)")
            if self.backend != "torch":
                raise ValueError(
                    "arrival skew staggers the in-process torch dispatch; "
                    f"it does not apply to backend={self.backend!r}")
            if self.extern_cmd:
                raise ValueError(
                    "extern mode runs no kernel; arrival skew does not "
                    "apply")
        if self.spans_sample < 1:
            raise ValueError(
                f"spans_sample must be >= 1 (1 = keep every run's "
                f"spans), got {self.spans_sample}")
        if self.health_threshold <= 0:
            raise ValueError(
                f"health_threshold must be positive, got "
                f"{self.health_threshold}")
        if self.health_warmup < 1:
            raise ValueError(
                f"health_warmup must be >= 1, got {self.health_warmup}")
        if self.synthetic_s is not None and self.synthetic_s <= 0:
            raise ValueError(
                f"synthetic_s must be positive seconds, got "
                f"{self.synthetic_s}")
        if self.uni_dir and self.nonblocking:
            # the reference picks one kernel by if / else if
            # (mpi_perf.c:506-523); the conflict is made loud instead
            raise ValueError("uni_dir and nonblocking are mutually exclusive")

    def _wants_skew(self) -> bool:
        """True when the job staggers collective entry: a non-zero
        ``--skew-spread`` value, or a ``skew`` fault in the schedule."""
        if any(self.skew_spread):
            return True
        return any(getattr(f, "kind", None) == "skew"
                   for f in self.faults or ())

    @property
    def infinite(self) -> bool:
        """Daemon mode: ``-r -1`` (``monitor``)."""
        return self.num_runs == -1
