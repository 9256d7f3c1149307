"""Command-line interface (port of the ``run``, ``monitor``, ``arena``,
``scenario``, ``contend``, ``chaos``, ``chaos verify``, ``health``,
``ingest``, ``push replay``, ``report``, ``grid``, ``linkmap``,
``linkmap report``, ``tune``, ``ops``, ``chips``, ``selftest`` and
``bench`` subcommands of ``tpu_perf/cli.py``).

Flag letters keep the reference's meanings (mpi_perf.c:273-339) where the
port has them: ``-i`` iters, ``-b`` buffer size, ``-r`` runs, ``-l`` log
folder, ``-u`` unidirectional with a 1-byte ack, ``-x`` non-blocking
exchange (``--window W`` buffers in flight), ``-p`` flows per node,
``-f`` / ``-n`` the group-1 file and its host count, ``-d`` the
print-only external launcher; the default op is the reference's blocking
ping-pong.  ``--backend mpi`` runs the repo's C baseline (backends/mpi)
on the host instead.  ``--distributed`` joins a ``torch.distributed``
world, one process a rank (``torchrun``); ``--mesh`` / ``--axes`` and
``--hybrid-mesh`` lay the ranks over a named mesh.  Additions:
``--sim-ranks`` (ranks of the single-card sim world) and ``--device``
(``cuda``, the default, or ``cpu`` for the plain PyTorch versions)::

    python -m tpu_perf_torch run            # pingpong at 456131 B, 8 ranks
    python -m tpu_perf_torch run -u         # pingpong_unidir
    python -m tpu_perf_torch run -x         # exchange
    python -m tpu_perf_torch run -x --window 256   # 256 buffers in flight
    python -m tpu_perf_torch run --backend mpi -x -b 64K -l /tmp/logs
    python -m tpu_perf_torch monitor --op pl_allreduce,pl_ring,allreduce \
        --sweep 4K,16M --heartbeat-format json
    python -m tpu_perf_torch run --op pl_allreduce --sweep 4K:256M
    python -m tpu_perf_torch run --op hier_allreduce --mesh 2x4 --axes dcn,ici
    torchrun --nproc-per-node 8 -m tpu_perf_torch run --distributed \
        --op allreduce,pl_allreduce --sweep 4K:256M
    python -m tpu_perf_torch run --op all_to_all --sweep 4K:256M
    python -m tpu_perf_torch run --op pl_all_gather_bidir --sweep 4K:256M
    python -m tpu_perf_torch run --op pl_allreduce --sweep 4K:256M --fence fused
    python -m tpu_perf_torch monitor --op pl_allreduce --sweep 4K,16M \
        --fence fused -l /tmp/logs         # -r -1; ingest on each rotation
    python -m tpu_perf_torch ingest -d /tmp/logs
    python -m tpu_perf_torch report /tmp/logs --compare-pallas
    python -m tpu_perf_torch grid --op pl_hbm_copy,hbm_stream --sizes 256M,1G \
        --iters 8,32 --spec hbm --sim-ranks 1
    python -m tpu_perf_torch run --op mxu_gemm,overlap_ring -b 4M --sim-ranks 8
    python -m tpu_perf_torch grid --op mxu_gemm --sizes 16M,32M --iters 10,20 \
        --spec mxu --dtype bfloat16 --sim-ranks 1 --fence trace
    python -m tpu_perf_torch run --op pl_allreduce,pl_ring --sweep 4K,16M \
        --streams 4
    python -m tpu_perf_torch contend --op allreduce --load hbm_stream -b 256K \
        -i 4 -r 12 -l /tmp/logs; python -m tpu_perf_torch report /tmp/logs
    python -m tpu_perf_torch contend --mesh 2x4 --axes dcn,ici --op allreduce \
        --load allreduce --victim-axis ici --load-axis dcn -b 1M
    python -m tpu_perf_torch run --op pl_allreduce --sweep 4K:256M \
        --ci-rel 0.05 --min-runs 5 --max-runs 50 --precompile auto \
        --compile-cache /tmp/kcache -l /tmp/logs
    python -m tpu_perf_torch monitor --op pl_allreduce --sweep 4K,16M \
        --fence fused --health --spans -l /tmp/logs --max-runs 5000
    python -m tpu_perf_torch chaos --faults spec.json --seed 7 \
        --op pl_allreduce --sweep 4K,16M --fence fused --max-runs 4000 \
        -l /tmp/chaos; python -m tpu_perf_torch chaos verify /tmp/chaos
    python -m tpu_perf_torch health /tmp/logs
    python -m tpu_perf_torch report /tmp/chaos --compare-chaos
    python -m tpu_perf_torch arena --sweep 4K,4M,256M -l /tmp/arena
    python -m tpu_perf_torch run --op allgatherv --algo all --imbalance 1,8
    python -m tpu_perf_torch scenario moe-dispatch-combine --imbalance 1,8
    python -m tpu_perf_torch monitor --op pl_allreduce -b 4K -l /tmp/logs \
        --push http://127.0.0.1:8080; python -m tpu_perf_torch push replay \
        /tmp/logs --url http://127.0.0.1:8080
    python -m tpu_perf_torch linkmap --mesh 2x4 -b 4M -l /tmp/lm
    python -m tpu_perf_torch linkmap report /tmp/lm
    torchrun --nproc-per-node 4 -m tpu_perf_torch linkmap --distributed \
        --all-pairs -b 256M
    python -m tpu_perf_torch tune -d /tmp/arena -o sel.json
    python -m tpu_perf_torch run --op allreduce --sweep 4K,4M --algo auto \
        --algo-artifact sel.json
    python -m tpu_perf_torch contend --op ppermute --split 2 -b 4M
    python -m tpu_perf_torch ops
    python -m tpu_perf_torch chips
    python -m tpu_perf_torch selftest
    python -m tpu_perf_torch bench
"""

from __future__ import annotations

import argparse
import contextlib
import math
import sys

from tpu_perf_torch.config import (
    BACKENDS, DEF_ITERS, DEF_SIM_RANKS, DEFAULT_LOG_DIR, FENCE_MODES,
    HEARTBEAT_FORMATS, LOG_REFRESH_TIME_SEC, Options,
)
from tpu_perf_torch.extern_launch import DEFAULT_TEMPLATE
from tpu_perf_torch.schema import HEALTH_PREFIX, RESULT_HEADER
from tpu_perf_torch.sweep import (
    DEF_BUF_SZ, format_size, parse_imbalance, parse_size, parse_skew_spread,
)


class _ZeroOne(argparse.Action):
    """Reference-style boolean flag: bare ``-u`` means on, ``-u 0``/``-u 1``
    are the reference's explicit spelling (mpi_perf.c:312,322)."""

    def __init__(self, option_strings, dest, **kwargs):
        super().__init__(option_strings, dest, nargs="?", const="1",
                         default=False, choices=("0", "1"), **kwargs)

    def __call__(self, parser, namespace, value, option_string=None):
        setattr(namespace, self.dest, (value or "1") == "1")


def _precompile_arg(value: str):
    """``--precompile N|auto``: a depth, or ``auto``."""
    if value == "auto":
        return value
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--precompile takes a depth N >= 0 or 'auto', got {value!r}")
    if n < 0:
        raise argparse.ArgumentTypeError(
            f"--precompile depth must be >= 0, got {n}")
    return n


def _add_world_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sim-ranks", type=int, default=None,
                   help=f"ranks of the single-card sim world (rows of one "
                        f"allocation; rows carry backend torch-sim when > 1; "
                        f"default {DEF_SIM_RANKS}, 1 under --distributed)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (default) runs the kernels on the card; cpu "
                        "runs their plain PyTorch versions")
    p.add_argument("--dtype", default="float32")


def _add_mesh_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", default=None,
                   help="mesh shape over the ranks, e.g. 8 or 2x4")
    p.add_argument("--axes", default=None, help="axis names, e.g. dcn,ici")


def _sim_ranks(args: argparse.Namespace) -> int:
    """--sim-ranks, or its default: a process of a distributed world holds
    one rank."""
    if args.sim_ranks is not None:
        return args.sim_ranks
    return 1 if getattr(args, "distributed", False) else DEF_SIM_RANKS


def _sim_world(args: argparse.Namespace):
    """The sim world of ``grid`` and ``selftest``: --sim-ranks ranks on
    the card (or the CPU), laid over ``--mesh`` / ``--axes`` when given,
    as ``run`` lays them."""
    from tpu_perf_torch.parallel import make_mesh
    from tpu_perf_torch.world import SimWorld, resolve_device

    n = _sim_ranks(args)
    shape, axes = _parse_mesh(args)
    mesh = make_mesh(shape, axes, n=n) if shape else None
    return SimWorld(n, resolve_device(args.device), mesh)


def _parse_mesh(args: argparse.Namespace) -> tuple[tuple[int, ...],
                                                   tuple[str, ...]]:
    """``--mesh 2x4`` / ``--axes dcn,ici`` as (shape, axis names); a shape
    without names gets ``ax0, ax1, ...`` (``x`` for one axis), as the JAX
    CLI names them."""
    shape: tuple[int, ...] = ()
    axes: tuple[str, ...] = ()
    if args.mesh:
        shape = tuple(int(s) for s in
                      args.mesh.lower().replace("x", ",").split(",") if s)
    if args.axes:
        axes = tuple(a.strip() for a in args.axes.split(",") if a.strip())
    if shape and not axes:
        axes = (tuple(f"ax{i}" for i in range(len(shape))) if len(shape) > 1
                else ("x",))
    return shape, axes


def _options_from(args: argparse.Namespace, **overrides) -> Options:
    """The run flags as Options; ``overrides`` win."""
    mesh_shape, mesh_axes = _parse_mesh(args)
    # the scenario selection: the `scenario` subcommand's positional or
    # the shared --scenario flag; either implies op="scenario" when the op
    # was left at its default (a conflicting --op stays an Options error)
    scenario = getattr(args, "_scenario", ())
    if not scenario and args.scenario:
        scenario = tuple(s.strip() for s in args.scenario.split(",")
                         if s.strip())
    op = args.op
    if scenario and op == "pingpong":
        op = "scenario"
    kw = dict(
        logfolder=args.logfolder, iters=args.iters, ppn=args.ppn,
        buff_sz=parse_size(args.size), num_runs=args.runs, op=op,
        algo=args.algo, scenario=scenario,
        algo_artifact=args.algo_artifact, tune_margin=args.tune_margin,
        tune_max_age=args.tune_max_age,
        skew_spread=(parse_skew_spread(args.skew_spread)
                     if args.skew_spread else ()),
        imbalance=(parse_imbalance(args.imbalance)
                   if args.imbalance else ()),
        push_url=args.push_url, push_textfile=args.push_textfile,
        push_queue=args.push_queue,
        uni_dir=args.unidir, nonblocking=args.nonblocking,
        extern_cmd=args.extern_cmd, window=args.window,
        group1_file=args.group1_file, n_group1=args.group1_hosts,
        backend=args.backend, heartbeat_format=args.heartbeat_format,
        sweep=args.sweep,
        dtype=args.dtype, fence=args.fence, fused_chunks=args.fused_chunks,
        measure_dispatch=args.measure_dispatch, profile_dir=args.profile_dir,
        max_runs=args.max_runs, ci_rel=args.ci_rel,
        ci_confidence=args.ci_confidence, ci_statistic=args.ci_statistic,
        min_runs=args.min_runs,
        precompile=1 if args.precompile == "auto" else args.precompile,
        precompile_auto=args.precompile == "auto",
        compile_cache=args.compile_cache,
        stats_every=args.stats_every, log_refresh_sec=args.log_refresh_sec,
        streams=args.streams, sim_ranks=_sim_ranks(args), device=args.device,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes,
        distributed=args.distributed, hybrid_mesh=args.hybrid_mesh,
        spans=args.spans, spans_sample=args.spans_sample,
        health=args.health, health_threshold=args.health_threshold,
        health_warmup=args.health_warmup,
        health_textfile=args.health_textfile,
        # the chaos knobs (`chaos` and `contend --synthetic` set them)
        faults=getattr(args, "_fault_spec", None), fault_seed=args.seed,
        synthetic_s=getattr(args, "synthetic", None),
    )
    kw.update(overrides)
    return Options(**kw)


def _cmd_run(args: argparse.Namespace, *, infinite: bool = False) -> int:
    opts = _options_from(args, num_runs=-1 if infinite else args.runs)
    if opts.backend == "mpi":
        # before anything of the card: the C baseline runs on the host,
        # and must run where no card is visible
        from tpu_perf_torch.mpi_launch import run_mpi_backend

        return run_mpi_backend(opts, hosts=args.hosts, dry_run=args.dry_run)
    if args.dry_run or args.hosts:
        # both are mpirun launcher knobs; a local run under cluster host
        # names would mislabel its rows as cluster results
        flag = "--dry-run" if args.dry_run else "--hosts"
        print(f"tpu-perf-torch: error: {flag} applies to --backend mpi (the "
              "torch backend runs in-process; a multi-process torch world "
              "uses --distributed)", file=sys.stderr)
        return 2
    if opts.hybrid_mesh and opts.mesh_shape:
        print("tpu-perf-torch: error: --hybrid-mesh and --mesh are exclusive",
              file=sys.stderr)
        return 2

    import os

    from tpu_perf_torch.driver import Driver

    # a chaos soak with no real ingest backend keeps its rotated logs:
    # the default pass deletes what it ingests, and `chaos verify` needs
    # the ledger and the events after the soak
    chaos_keep_logs = (
        getattr(args, "_chaos", False)
        and os.environ.get("TPU_PERF_INGEST", "none") in ("", "none")
        and not os.environ.get("TPU_PERF_INGEST_CMD"))
    ingest = None
    if opts.logfolder and not chaos_keep_logs:
        # the ingest pass (both families, through the `ingest` subcommand)
        # runs in its own process, so a slow pass never stalls the next
        # measured run, as the reference forks its uploader
        # (mpi_perf.c:363-364); TPU_PERF_INGEST_CMD overrides the command.
        # The driver hooks it where the node's local rank 0 runs, with the
        # node's live writers skipped (Driver.ingest_skip)
        from tpu_perf_torch.ingest import SubprocessIngest, ingest_command

        def ingest(skip_newest: int):
            return SubprocessIngest(ingest_command(opts.logfolder,
                                                   skip_newest))
    driver = Driver(opts, ingest=ingest)
    try:
        rows = driver.run()
    finally:
        if driver.on_rotate is not None:
            driver.on_rotate.finish()
    if args.csv or not opts.logfolder:
        _print_rows(rows)
    return 0


def _print_rows(rows) -> None:
    """The rows as one rectangular CSV table: the header carries the
    trailing columns up to the widest row's (span, algo, skew, imbalance,
    the lane of ``--streams``, the load of ``contend``), and every row
    pads to its width."""
    header = RESULT_HEADER
    if any(r.load for r in rows):
        header += ",span_id,algo,skew_us,imbalance,stream,load"
    elif any(r.stream > 0 for r in rows):
        header += ",span_id,algo,skew_us,imbalance,stream"
    elif any(r.imbalance > 1 for r in rows):
        header += ",span_id,algo,skew_us,imbalance"
    elif any(r.skew_us for r in rows):
        header += ",span_id,algo,skew_us"
    elif any(r.algo for r in rows):
        header += ",span_id,algo"
    elif any(r.span_id for r in rows):
        header += ",span_id"
    width = header.count(",") + 1
    print(header)
    for row in rows:
        parts = row.to_csv().split(",")
        print(",".join(parts + [""] * (width - len(parts))))


def _cmd_scenario(args: argparse.Namespace) -> int:
    """A model-step scenario sweep: the run path with op='scenario' and
    the selection riding the algo coordinate (one label a scenario), so
    the daemon, --ci-rel, --precompile, chaos and skew all apply."""
    if args.list_scenarios:
        from tpu_perf_torch.scenarios.spec import BUILTIN_SCENARIOS

        for name, spec in sorted(BUILTIN_SCENARIOS.items()):
            phases = " -> ".join(p.label for p in spec.phases)
            print(f"{name}: {phases}\n    {spec.summary}")
        return 0
    flag = args.scenario
    if args.names and flag and flag != args.names:
        print(f"tpu-perf-torch: error: positional scenarios {args.names!r} "
              f"and --scenario {flag!r} conflict (name the selection "
              "once)", file=sys.stderr)
        return 2
    names = args.names or flag
    if not names:
        print("tpu-perf-torch: error: name at least one scenario (or "
              "--list for the catalog)", file=sys.stderr)
        return 2
    if args.op != "pingpong":
        print(f"tpu-perf-torch: error: --op {args.op!r} conflicts with a "
              "scenario selection (scenarios run under op='scenario'; "
              "drop --op, or use `tpu-perf-torch run` for plain kernels)",
              file=sys.stderr)
        return 2
    args.op = "scenario"
    args._scenario = tuple(s.strip() for s in names.split(",")
                           if s.strip())
    return _cmd_run(args, infinite=args.runs == -1)


def _cmd_push_replay(args: argparse.Namespace) -> int:
    """Deliver every live dead-letter spool in the folder to a sink,
    deleting each file only after its batch is accepted.  Quarantined
    spools (``.spool.quarantined``, the dead-letter default) need
    ``ingest --requeue`` first."""
    import os

    from tpu_perf_torch.ingest.pipeline import list_quarantined
    from tpu_perf_torch.push import (
        HttpSink, live_spool_files, parse_spool_family, read_spool,
    )

    files = live_spool_files(args.folder)
    if not files:
        n_q = sum(1 for p in list_quarantined(args.folder)
                  if parse_spool_family(p) is not None)
        print(f"tpu-perf-torch: no live spool files in {args.folder}"
              + (f" ({n_q} quarantined — requeue with `tpu-perf-torch "
                 f"ingest --folder {args.folder} --requeue` first)" if n_q
                 else ""), file=sys.stderr)
        return 0
    sink = HttpSink(args.url, timeout=args.timeout)
    replayed = failed = 0
    for path, family in files:
        try:
            lines = read_spool(path)
        except OSError as e:
            print(f"tpu-perf-torch: cannot read {os.path.basename(path)}: "
                  f"{e}", file=sys.stderr)
            failed += 1
            continue
        if lines:
            try:
                sink.send(family, lines)
            except Exception as e:  # noqa: BLE001 — the file is kept
                print(f"tpu-perf-torch: replay FAILED for "
                      f"{os.path.basename(path)}: {e} (file kept)",
                      file=sys.stderr)
                failed += 1
                continue
        os.remove(path)
        replayed += 1
        print(f"tpu-perf-torch: replayed {len(lines)} {family} record(s) "
              f"from {os.path.basename(path)}", file=sys.stderr)
    print(f"tpu-perf-torch: {replayed} spool file(s) replayed, {failed} "
          f"failed", file=sys.stderr)
    return 1 if failed else 0


def _cmd_contend(args: argparse.Namespace) -> int:
    """The contention race (tpu_perf_torch.streams.contend): a victim op
    against a concurrent load on the stream engine's lanes, a compute
    kernel (--load mxu_gemm / hbm_stream), a sibling op (--load OP), or
    K split-channel ppermute lanes against the single channel (--split K).
    Every point is measured idle and loaded in one job, so `report`
    renders the interference matrix from the rows."""
    from tpu_perf_torch.schema import EXT_PREFIX
    from tpu_perf_torch.streams.contend import run_contend

    if bool(args.load) == bool(args.split):
        print("tpu-perf-torch: error: name exactly one load shape: --load "
              "OP (a compute kernel or sibling collective) or --split K "
              "(K concurrent split-channel ppermute lanes)", file=sys.stderr)
        return 2
    if args.split and args.split < 2:
        print(f"tpu-perf-torch: error: --split needs K >= 2 lanes, got "
              f"{args.split}", file=sys.stderr)
        return 2
    if args.streams != 1:
        # contend's lane count comes from the load shape (2 for a race)
        print("tpu-perf-torch: error: --streams applies to run/monitor "
              "(contend derives its lane count from the load shape)",
              file=sys.stderr)
        return 2
    if args.backend == "mpi":
        print("tpu-perf-torch: error: contend drives the torch backend (the "
              "stream engine dispatches in-process steps; the C baseline "
              "has no dispatch lanes)", file=sys.stderr)
        return 2
    if args.ci_rel is not None or args.precompile != 0:
        print("tpu-perf-torch: error: --ci-rel / --precompile apply to "
              "run/monitor (contend races fixed run counts, idle and "
              "loaded alike)", file=sys.stderr)
        return 2
    if args.hybrid_mesh and args.mesh:
        print("tpu-perf-torch: error: --hybrid-mesh and --mesh are exclusive",
              file=sys.stderr)
        return 2
    opts = _options_from(
        args, load=f"split:{args.split}" if args.split else args.load)
    from tpu_perf_torch.runner import world_for
    from tpu_perf_torch.world import is_dist

    world, n_devices, rank = None, None, 0
    if opts.synthetic_s is not None:
        # no device is touched: the seeded series is the timing source,
        # so the rank count is stated, not found
        if not opts.mesh_shape:
            print("tpu-perf-torch: error: --synthetic contend needs an "
                  "explicit --mesh shape (no devices are raced)",
                  file=sys.stderr)
            return 2
        n_devices = math.prod(opts.mesh_shape)
    else:
        world = world_for(opts)
        rank = world.rank if is_dist(world) else 0
    tracer = None
    if opts.spans:
        if not opts.logfolder:
            print("tpu-perf-torch: error: --spans needs -l/--logfolder "
                  "(spans ride the rotating-log families)", file=sys.stderr)
            return 2
        from tpu_perf_torch.driver import RotatingCsvLog
        from tpu_perf_torch.schema import SPANS_PREFIX
        from tpu_perf_torch.spans import SpanTracer

        tracer = SpanTracer(
            opts.uuid, rank=rank,
            log=RotatingCsvLog(opts.logfolder, opts.uuid, rank,
                               refresh_sec=10**9, prefix=SPANS_PREFIX,
                               lazy=True))
    try:
        rows = run_contend(opts, world=world, axis=args.victim_axis,
                           load_axis=args.load_axis, n_devices=n_devices,
                           tracer=tracer, err=sys.stderr)
    finally:
        if tracer is not None:
            tracer.close()
    if opts.logfolder:
        # the rotating extended-row family, so `report <folder>` renders
        # the interference matrix from this job
        from tpu_perf_torch.driver import RotatingCsvLog

        log = RotatingCsvLog(opts.logfolder, opts.uuid, rank,
                             refresh_sec=opts.log_refresh_sec,
                             prefix=EXT_PREFIX)
        for row in rows:
            log.write_row(row)
        log.close()
    if rank != 0:
        # every rank holds the same rows (each run's time its maximum
        # over the ranks); rank 0 prints them
        return 0
    if args.csv or not opts.logfolder:
        _print_rows(rows)
    from tpu_perf_torch.report import aggregate, interference_matrix

    for cell in interference_matrix(aggregate(rows)):
        slow = "—" if cell.slowdown is None else f"{cell.slowdown:.3g}x"
        print(f"[tpu-perf-torch contend] {cell.op} @ {cell.nbytes} B under "
              f"{cell.load}: slowdown {slow}", file=sys.stderr)
    return 0


def _linkmap_world(args: argparse.Namespace, shape, axes):
    """The world a real linkmap sweep probes: this rank of a joined
    ``--distributed`` world (every card pair a link), or the sim ranks of
    one card laid over ``--mesh`` (default: --sim-ranks on one axis)."""
    from tpu_perf_torch.runner import world_for

    n = args.sim_ranks
    if n is None and not args.distributed:
        n = math.prod(shape) if shape else DEF_SIM_RANKS
    elif n is None:
        n = 1  # a process of a distributed world holds one rank
    return world_for(Options(device=args.device, sim_ranks=n,
                             mesh_shape=shape, mesh_axes=axes,
                             distributed=args.distributed))


def _linkmap_roofline(args: argparse.Namespace, world, axes):
    """``(roofline GB/s or None, its axes or None)``: an explicit
    --roofline-gbps applies to every probed axis (0 disables); else, as
    the JAX package rules, none for a synthetic or all-pairs sweep or a
    dcn* axis, and the detected card's NVLink rate for the other axes of
    a multi-process world on cards.  The sim world has no link (a probe
    is a memory copy), so it grades by its peers alone, with a note."""
    roofline, roofline_axes = args.roofline_gbps, None
    if roofline is None and world is not None and not args.all_pairs:
        from tpu_perf_torch.world import is_dist

        fast_axes = tuple(a for a in axes if not a.lower().startswith("dcn"))
        if not is_dist(world) or world.device.type != "cuda":
            what = ("the sim world's ranks share one card, so a probe is a "
                    "memory copy" if not is_dist(world)
                    else "a CPU world has no NVLink")
            if not is_dist(world) or world.rank == 0:
                    print(f"tpu-perf-torch: linkmap: no default roofline "
                      f"({what}); links are graded against their peers "
                      "alone (give --roofline-gbps to grade against a "
                      "spec)", file=sys.stderr)
        elif fast_axes:
            from tpu_perf_torch.chips import card_spec

            roofline = card_spec().nvlink_gbps
            if len(fast_axes) < len(axes):
                roofline_axes = fast_axes
    return (None if roofline == 0 else roofline), roofline_axes


def _cmd_linkmap(args: argparse.Namespace) -> int:
    """One probe sweep: plan the mesh's links, measure each, grade against
    the roofline + row/col MAD, render, persist, and surface sick links as
    link_degraded health events.  Across processes every rank probes and
    grades the same reduced samples and returns the same code; rank 0
    alone writes and prints."""
    from tpu_perf_torch.config import new_job_id
    from tpu_perf_torch.linkmap import (
        GradeConfig, LinkProber, grade, linkmap_to_json, linkmap_to_markdown,
        meta_record, plan_all_pairs, plan_mesh_links,
    )

    for flag, v in (("--roofline-gbps", args.roofline_gbps),
                    ("--dcn-roofline-gbps", args.dcn_roofline_gbps)):
        if v is not None and v < 0:
            # checked before the sweep: a long probe must not be thrown
            # away over an argv typo (only 0 is the "disable" spelling)
            print(f"tpu-perf-torch: error: {flag} must be >= 0 (0 "
                  f"disables), got {v:g}", file=sys.stderr)
            return 2
    faults = _load_faults(args)
    if faults is None:
        return 2
    if any(f.kind == "skew" for f in faults):
        # a probe is one timed ppermute, not a lockstep collective the
        # ranks enter independently: a skew fault would be a silent no-op
        print("tpu-perf-torch: error: skew faults apply to the run loop's "
              "collective entry (run/monitor/chaos), not to linkmap "
              "probes", file=sys.stderr)
        return 2
    synthetic = args.synthetic is not None
    injector = None
    if faults or synthetic:
        from tpu_perf_torch.faults import FaultInjector

        injector = FaultInjector(faults, seed=args.seed,
                                 synthetic_s=args.synthetic)
    shape, axes = _parse_mesh(args)
    world, rank = None, 0
    if synthetic:
        # no device is touched: the seeded series is the timing source, so
        # the sweep's shape is stated, not found
        if not shape:
            print("tpu-perf-torch: error: --synthetic linkmap needs an "
                  "explicit --mesh shape (no devices are probed)",
                  file=sys.stderr)
            return 2
        n = math.prod(shape)
    else:
        from tpu_perf_torch.parallel.mesh import make_mesh
        from tpu_perf_torch.world import is_dist

        world = _linkmap_world(args, shape, axes)
        mesh = world.mesh if world.mesh is not None else make_mesh(n=world.n)
        shape, axes, n = tuple(mesh.shape), tuple(mesh.axis_names), world.n
        rank = world.rank if is_dist(world) else 0
    if args.all_pairs:
        schedules, mode = plan_all_pairs(n), "allpairs"
    else:
        schedules = plan_mesh_links(shape, axes, wrap=not args.no_wrap)
        mode = "neighbor"
    if not schedules:
        print(f"tpu-perf-torch: mesh {shape} has no links to probe",
              file=sys.stderr)
        return 1
    roofline, roofline_axes = _linkmap_roofline(args, world, axes)
    # GradeConfig validates every grading knob before the sweep
    cfg = GradeConfig(
        roofline_gbps=roofline, roofline_axes=roofline_axes,
        dcn_roofline_gbps=args.dcn_roofline_gbps or None,
        roofline_floor=args.roofline_floor, mad_z=args.mad_z,
        rel_threshold=args.rel_threshold, dead_ratio=args.dead_ratio)
    if args.compile_cache:
        from tpu_perf_torch.compilepipe import enable_compile_cache

        enable_compile_cache(args.compile_cache)
    job_id = new_job_id()  # before the sweep: spans and records share it
    tracer = None
    if args.spans:
        if not args.logfolder:
            print("tpu-perf-torch: error: --spans needs -l/--logfolder "
                  "(spans ride the rotating-log families)", file=sys.stderr)
            return 2
        if rank == 0:
            from tpu_perf_torch.driver import RotatingCsvLog
            from tpu_perf_torch.schema import SPANS_PREFIX
            from tpu_perf_torch.spans import SpanTracer

            tracer = SpanTracer(job_id, rank=0, log=RotatingCsvLog(
                args.logfolder, job_id, 0, refresh_sec=10**9,
                prefix=SPANS_PREFIX, lazy=True))
    prober = LinkProber(
        world, nbytes=parse_size(args.size), iters=args.iters,
        runs=args.runs, fence=args.fence, dtype=args.dtype,
        injector=injector, n_devices=n, precompile=args.precompile,
        tracer=tracer, err=sys.stderr)
    try:
        result = prober.probe(schedules, concurrent=args.concurrent)
        # a concurrent sweep's flagged links are re-measured serially
        # before the final grading, so the verdicts name the sick link
        # and not its whole schedule (--no-bisect keeps the batch bounds)
        if result.concurrent and not args.no_bisect:
            result, n_bisected = prober.bisect_flagged(result, cfg)
            if n_bisected and rank == 0:
                print(f"[tpu-perf-torch linkmap] re-probed {n_bisected} "
                      f"flagged link(s) serially, with their grading "
                      f"peers (auto-bisection)",
                      file=sys.stderr)
    finally:
        if tracer is not None:
            tracer.close()
    verdicts = grade(result, cfg)
    sick = [v for v in verdicts if v.verdict != "ok"]
    if rank != 0:
        return 6 if sick else 0
    meta = meta_record(result, job_id=job_id, config=cfg,
                       seed=args.seed if injector is not None else None,
                       mode=mode)
    probe_recs = [r.to_record() for r in result.probes]
    verdict_recs = [v.to_record() for v in verdicts]
    if args.logfolder:
        _write_linkmap_logs(args, job_id, [meta, *probe_recs,
                                           *verdict_recs], sick, result)
    if args.push:
        # the live counterpart of -l: one shot, loud on failure, never
        # fatal (the durable records make a failed push re-runnable)
        from tpu_perf_torch.push import push_records_once
        from tpu_perf_torch.schema import LINKMAP_PREFIX

        push_records_once(
            args.push, LINKMAP_PREFIX,
            [r.to_json() for r in [meta, *probe_recs, *verdict_recs]],
            err=sys.stderr)
    if args.format == "json":
        print(linkmap_to_json(meta.data, [r.data for r in probe_recs],
                              [v.data for v in verdict_recs]))
    else:
        print(linkmap_to_markdown(meta.data, [v.data for v in verdict_recs]))
    # exit 6: the linkmap gate code — a sick link fails CI/cron wrappers
    return 6 if sick else 0


def _write_linkmap_logs(args: argparse.Namespace, job_id: str, records,
                        sick, result) -> None:
    """One finished linkmap-*.log a sweep, and a link_degraded health
    event a sick link (its baseline the verdict's own reference: the peer
    median for a MAD verdict, the roofline's latency for a roofline
    one)."""
    from tpu_perf_torch.driver import RotatingCsvLog
    from tpu_perf_torch.schema import LINKMAP_PREFIX

    log = RotatingCsvLog(args.logfolder, job_id, 0, refresh_sec=10**9,
                         prefix=LINKMAP_PREFIX, lazy=True)
    try:
        for rec in records:
            log.write_row(rec)
    finally:
        log.close()
    if not sick:
        return
    from tpu_perf_torch.health import HealthConfig, HealthMonitor

    monitor = HealthMonitor(
        HealthConfig(), job_id=job_id, dtype=args.dtype,
        event_log=RotatingCsvLog(args.logfolder, job_id, 0,
                                 refresh_sec=10**9, prefix=HEALTH_PREFIX,
                                 lazy=True))
    # a traced sweep's events point at the probe's probe_schedule span
    span_by_op = {r.probe.op: r.span_id for r in result.probes}
    try:
        for v in sick:
            monitor.observe_link(
                v.op, result.nbytes, v.run_id, (v.lat_us or 0.0) * 1e-6,
                (v.baseline_us or 0.0) * 1e-6,
                severity="critical" if v.verdict == "dead" else "warning",
                rank=v.rank, span_id=span_by_op.get(v.op, ""))
    finally:
        monitor.close()


def _cmd_linkmap_report(args: argparse.Namespace) -> int:
    """Replay durable linkmap-*.log records into the rendering the live
    sweep prints (heatmap + verdict table, or the JSON artifact);
    ``--diff BASE.json`` also gates each link's latency against a prior
    sweep's artifact."""
    from tpu_perf_torch.linkmap import (
        diff_linkmaps, linkdiff_summary, linkdiff_to_markdown,
        linkmap_to_json, linkmap_to_markdown, load_linkmap_artifact,
        read_linkmap,
    )
    from tpu_perf_torch.report import collect_paths
    from tpu_perf_torch.schema import LINKMAP_PREFIX

    paths = collect_paths(args.target, prefix=LINKMAP_PREFIX,
                          include_open=True)
    if not paths:
        print(f"tpu-perf-torch: no linkmap logs match {args.target!r}",
              file=sys.stderr)
        return 1
    try:
        meta, probes, verdicts = read_linkmap(paths)
    except ValueError as e:
        print(f"tpu-perf-torch: bad linkmap logs: {e}", file=sys.stderr)
        return 1
    if not verdicts:
        # a sweep killed mid-write graded nothing: replaying it as exit 0
        # would pass the sick-link gate
        print("tpu-perf-torch: linkmap logs hold no verdict records (sweep "
              "killed before grading?) — re-run the sweep", file=sys.stderr)
        return 1
    diffs = None
    if args.diff:
        # the cross-sweep gate: a link degraded past the threshold since
        # the base sweep can still sit inside its own sweep's MAD band
        try:
            _, base_verdicts = load_linkmap_artifact(args.diff)
            diffs = diff_linkmaps(base_verdicts, verdicts,
                                  threshold_pct=args.diff_threshold)
        except (OSError, ValueError) as e:
            print(f"tpu-perf-torch: bad linkmap diff base: {e}",
                  file=sys.stderr)
            return 2
    if args.format == "json":
        print(linkmap_to_json(
            meta, probes, verdicts,
            diff=None if diffs is None else {
                "base": args.diff, "threshold_pct": args.diff_threshold,
                "links": diffs}))
    else:
        print(linkmap_to_markdown(meta, verdicts))
        if diffs is not None:
            print(f"\n### Link diff vs {args.diff}\n")
            print(linkdiff_to_markdown(diffs))
            print()
            print(linkdiff_summary(diffs, args.diff_threshold))
    if diffs is not None and any(d["diff"] == "degraded" for d in diffs):
        return 6
    return 6 if any(v["verdict"] != "ok" for v in verdicts) else 0


def _cmd_tune(args: argparse.Namespace) -> int:
    """Close the measure->select loop: fold arena/contend rows into the
    versioned selection artifact `--algo auto` reads (build mode), or
    re-grade fresh rows against a published artifact and exit 10 when a
    measured crossover moved against it (--check, the drift gate)."""
    import time as _time

    from tpu_perf_torch.report import collect_paths, stream_aggregate
    from tpu_perf_torch.tuner import (
        build_selection, check_drift, current_device_kind, read_artifact,
        write_artifact,
    )

    # include_open: a killed arena soak's active log still carries rows
    paths = collect_paths(args.logdir, include_open=True)
    if not paths:
        print(f"tpu-perf-torch: no result files match {args.logdir!r}",
              file=sys.stderr)
        return 1
    points = stream_aggregate(paths, err=sys.stderr)
    now = _time.time()
    fresh = build_selection(
        points,
        generated=_time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime(now)),
        generated_unix=now, device_kind=current_device_kind(),
        source=args.logdir)
    if not fresh.entries:
        print(f"tpu-perf-torch: no arena verdicts in {args.logdir!r} — tune "
              "needs rows that raced at least one non-native algorithm "
              "(e.g. `tpu-perf-torch arena -l LOGDIR`)", file=sys.stderr)
        return 1
    if args.check:
        try:
            published = read_artifact(args.check)
        except (OSError, ValueError) as e:
            print(f"tpu-perf-torch: cannot read published artifact: {e}",
                  file=sys.stderr)
            return 2
        findings = check_drift(published, fresh, margin_min=args.margin)
        for f in findings:
            print(f"tpu-perf-torch: crossover drift: {f.describe()}",
                  file=sys.stderr)
        if findings:
            # exit 10: the tuner drift-gate code (linkmap's is 6)
            print(f"tpu-perf-torch: {len(findings)} crossover(s) moved "
                  f"against {args.check!r} — re-run `tpu-perf-torch tune` "
                  "to republish", file=sys.stderr)
            return 10
        print(f"tpu-perf-torch: no crossover drift against {args.check!r} "
              f"({len(fresh.entries)} fresh verdict(s) re-graded)",
              file=sys.stderr)
        return 0
    write_artifact(fresh, args.output)
    print(f"tpu-perf-torch: wrote selection artifact ({len(fresh.entries)} "
          f"winner(s)) to {args.output}", file=sys.stderr)
    from tpu_perf_torch.schema import decorate_op

    print("| op | size | dtype | winner | p50 (us) | margin "
          "| native/best | samples |")
    print("|---|---|---|---|---|---|---|---|")
    for e in fresh.entries:
        op = decorate_op(e.op, skew_us=e.skew_us, imbalance=e.imbalance,
                         load=e.load)
        margin = f"{e.margin:.3g}x" if e.margin else "one-sided"
        print(f"| {op} | {format_size(e.nbytes)} | {e.dtype} | {e.winner} "
              f"| {e.winner_p50_us:.2f} | {margin} "
              f"| {e.native_vs_best:.3g}x | {e.samples} |")
    if args.logfolder or args.push_url:
        from tpu_perf_torch.config import new_job_id
        from tpu_perf_torch.schema import TUNE_PREFIX

        job_id = new_job_id()
        records = fresh.to_records(job_id)
        if args.logfolder:
            # one finished tune-*.log a publish (lazy until closed)
            from tpu_perf_torch.driver import RotatingCsvLog

            log = RotatingCsvLog(args.logfolder, job_id, 0,
                                 refresh_sec=10**9, prefix=TUNE_PREFIX,
                                 lazy=True)
            try:
                for rec in records:
                    log.write_row(rec)
            finally:
                log.close()
        if args.push_url:
            from tpu_perf_torch.push import push_records_once

            push_records_once(args.push_url, TUNE_PREFIX,
                              [r.to_json() for r in records],
                              err=sys.stderr)
    return 0


def _load_faults(args: argparse.Namespace) -> list | None:
    """The --faults / --fault schedule; None (after the error is printed)
    when the spec file is unreadable."""
    from tpu_perf_torch.faults import load_spec, parse_fault_arg

    try:
        faults = list(load_spec(args.faults)) if args.faults else []
    except OSError as e:
        print(f"tpu-perf-torch: cannot read fault spec: {e}", file=sys.stderr)
        return None
    faults += [parse_fault_arg(s) for s in args.fault or []]
    return faults


def _cmd_chaos(args: argparse.Namespace) -> int:
    """A bounded (or infinite) daemon soak with fault injection: the
    monitor path with a seeded FaultInjector in the Driver and the health
    monitor forced on (chaos without the judge detects nothing)."""
    if args.backend == "mpi":
        print("tpu-perf-torch: error: chaos drives the torch backend (the "
              "injector wraps the in-process run loop; the C backend has "
              "no injection point)", file=sys.stderr)
        return 2
    faults = _load_faults(args)
    if faults is None:
        return 2
    args._fault_spec = faults
    args.health = True
    args._chaos = True  # _cmd_run keeps the rotated logs for verify
    return _cmd_run(args, infinite=True)


def _cmd_chaos_verify(args: argparse.Namespace) -> int:
    """Join a soak's ledger (chaos-*.log) against its health events
    (health-*.log), and its spans (spans-*.log) when traced: a verdict a
    fault, a precision / recall row a detector.  Exit 5 on a missed
    critical fault (or, with --fail-on-false-alarm, on a false alarm)."""
    import os

    from tpu_perf_torch.faults import (
        read_ledger, report_to_json, report_to_markdown, run_conformance,
    )
    from tpu_perf_torch.health.events import read_events
    from tpu_perf_torch.report import collect_paths
    from tpu_perf_torch.schema import CHAOS_PREFIX, SPANS_PREFIX
    from tpu_perf_torch.spans import read_span_records

    # include_open: a killed soak leaves its active lazy logs as .open
    ledger_paths = collect_paths(args.target, prefix=CHAOS_PREFIX,
                                 include_open=True)
    if os.path.isdir(args.target):
        event_dirs = [args.target]
    else:
        # a file or glob names the ledger; the events and spans are found
        # next to each ledger file
        event_dirs = sorted(
            {os.path.dirname(os.path.abspath(p)) for p in ledger_paths})
    if not ledger_paths:
        print(f"tpu-perf-torch: no chaos ledger matches {args.target!r} — "
              "run `tpu-perf-torch chaos` with a logfolder first",
              file=sys.stderr)
        return 1

    def beside(prefix: str) -> list[str]:
        return sorted({p for d in event_dirs
                       for p in collect_paths(d, prefix=prefix,
                                              include_open=True)})

    span_paths = beside(SPANS_PREFIX)
    try:
        records = read_ledger(ledger_paths)
        events = read_events(beside(HEALTH_PREFIX))
        spans = read_span_records(span_paths) if span_paths else []
        report = run_conformance(records, events, grace_runs=args.grace_runs,
                                 spans=spans)
    except ValueError as e:
        print(f"tpu-perf-torch: bad chaos artifacts: {e}", file=sys.stderr)
        return 1
    if args.textfile:
        # written even when the gate below fails; a failed write is said,
        # never fatal
        import time

        from tpu_perf_torch.faults.conformance import (
            render_conformance_textfile,
        )
        from tpu_perf_torch.health.exporter import write_textfile

        try:
            write_textfile(args.textfile, render_conformance_textfile(
                report, now=time.time()))
        except OSError as e:
            print(f"tpu-perf-torch: conformance textfile write failed: {e}",
                  file=sys.stderr)
    print(report_to_json(report) if args.format == "json"
          else report_to_markdown(report))
    failures = []
    if report.missed_critical:
        failures.append(
            f"{len(report.missed_critical)} critical fault(s) MISSED "
            f"(spec {[v.spec_index for v in report.missed_critical]})")
    if args.fail_on_false_alarm and report.false_alarms:
        failures.append(
            f"{len(report.false_alarms)} false alarm(s) on a gate that "
            "allows none")
    if failures:
        print(f"tpu-perf-torch: chaos conformance failed: "
              f"{'; '.join(failures)}", file=sys.stderr)
        return 5
    return 0


def _audit_join(target: str, spans: list[dict],
                rank: int | None = None) -> tuple[list[str], str]:
    """The join-completeness audit over one record folder: every result
    row, health event, and chaos ledger entry must resolve to exactly
    one enclosing run span.  Returns ``(problems, summary)`` — shared
    by `timeline --check` and `fleet timeline --check` (per host)."""
    import os
    import re

    from tpu_perf_torch.faults import read_ledger
    from tpu_perf_torch.health.events import read_events
    from tpu_perf_torch.report import collect_paths, read_rows
    from tpu_perf_torch.schema import CHAOS_PREFIX, EXT_PREFIX, HEALTH_PREFIX
    from tpu_perf_torch.trace import join_completeness

    def job_rank_of(path: str):
        # <prefix>-<uuid>-<rank>-<YYYYmmdd-HHMMSS>[-i].log[.open] —
        # uuid and timestamp both carry dashes, so anchor on the
        # timestamp shape (driver.log_file_name)
        m = re.match(
            r"[a-z]+-(.+)-(\d+)-\d{8}-\d{6}(?:-\d+)?\.log(?:\.open)?$",
            os.path.basename(path))
        return (m.group(1), int(m.group(2))) if m else (None, 0)

    # rows and ledger records carry no rank column and the ledger no
    # job column (the file name carries both); span IDs are unique
    # per (job, rank), not across them — so the join audits each
    # (job, rank)'s record files against its own spans
    row_paths = collect_paths(target, prefix=EXT_PREFIX)
    ledger_paths = collect_paths(target, prefix=CHAOS_PREFIX,
                                 include_open=True)
    events = read_events(collect_paths(
        target, prefix=HEALTH_PREFIX, include_open=True))
    keys = sorted(
        {job_rank_of(p) for p in row_paths + ledger_paths}
        | {(ev.job_id, ev.rank) for ev in events},
        key=lambda k: (str(k[0]), k[1]),
    )
    if rank is not None:
        # the span set is already rank-filtered; audit only that rank's
        # records too, or every other rank's records would spuriously
        # fail against the filtered spans
        keys = [k for k in keys if k[1] == rank]
    problems: list[str] = []
    n_rows = n_fault = 0
    for job, rk in keys:
        rows = read_rows([p for p in row_paths
                          if job_rank_of(p) == (job, rk)])
        lpaths = [p for p in ledger_paths
                  if job_rank_of(p) == (job, rk)]
        ledger = read_ledger(lpaths) if lpaths else []
        n_rows += len(rows)
        n_fault += sum(1 for r in ledger if r.get("record") == "fault")
        problems += join_completeness(
            spans, rows=rows,
            events=[ev for ev in events
                    if (ev.job_id, ev.rank) == (job, rk)],
            ledger=ledger, rank=rk, job_id=job,
        )
    summary = (f"{n_rows} row(s), {len(events)} event(s), {n_fault} "
               "ledger entr(ies) each resolve to one run span (untraced "
               "jobs, if any, make no claim)")
    return problems, summary


def _align_ranks(spans: list[dict]) -> list[dict]:
    """Merge-time clock alignment: processes launched seconds apart
    disagree by seconds of perf-counter epoch, so raw-merged ranks draw
    concurrent work far apart.  Offsets are anchored on the heartbeat
    collectives' shared boundaries (fleet.timeline.clock_offsets); a
    single-rank export is untouched (offset 0 by construction)."""
    from tpu_perf_torch.fleet.timeline import align_spans, clock_offsets

    offsets = clock_offsets(spans)
    moved = sum(1 for v in offsets.values() if v)
    if moved:
        print(f"tpu-perf-torch: aligned {moved} process clock(s) onto the "
              "job's reference clock (heartbeat-boundary anchors; "
              "--no-align exports raw clocks)", file=sys.stderr)
        return align_spans(spans, offsets)
    return spans


def _cmd_timeline(args: argparse.Namespace) -> int:
    """Export harness trace spans (spans-*.log, from --spans) to Chrome
    trace-event JSON.  All ranks found in the target merge into one
    timeline (pid = rank) unless --rank filters — with per-process
    clock-skew alignment anchored on the heartbeat collectives (ranks
    of one job are launched seconds apart; their perf-counter epochs
    differ by exactly that); --check additionally runs the
    join-completeness audit against the sibling row/event/ledger files
    (exit 7 on an incomplete join)."""
    import os

    from tpu_perf_torch.report import collect_paths
    from tpu_perf_torch.schema import SPANS_PREFIX
    from tpu_perf_torch.spans import read_span_records
    from tpu_perf_torch.trace import chrome_trace_json, write_timeline

    paths = collect_paths(args.target, prefix=SPANS_PREFIX,
                          include_open=True)
    if not paths:
        print(f"tpu-perf-torch: no span logs match {args.target!r} — run with "
              "--spans and a logfolder first", file=sys.stderr)
        return 1
    try:
        spans = read_span_records(paths)
    except ValueError as e:
        print(f"tpu-perf-torch: bad span log: {e}", file=sys.stderr)
        return 1
    if args.rank is not None:
        spans = [s for s in spans if s.get("rank") == args.rank]
        if not spans:
            print(f"tpu-perf-torch: no spans for rank {args.rank}",
                  file=sys.stderr)
            return 1
    rc = 0
    if args.check:
        if not os.path.isdir(args.target):
            print("tpu-perf-torch: error: --check needs a directory target "
                  "(the sibling row/event/ledger files)", file=sys.stderr)
            return 2
        problems, summary = _audit_join(args.target, spans,
                                        rank=args.rank)
        if problems:
            for p in problems:
                print(f"tpu-perf-torch: join incomplete: {p}", file=sys.stderr)
            rc = 7  # the timeline still exports: evidence beats silence
        else:
            print(f"tpu-perf-torch: join complete: {summary}", file=sys.stderr)
    if not args.no_align:
        # AFTER the join audit (joins key on IDs, not clocks) and
        # BEFORE export: the rendered geometry is what alignment fixes
        spans = _align_ranks(spans)
    content = chrome_trace_json(spans)
    if args.output:
        # atomic, like the phase sidecar: a collector uploading the
        # artifact mid-export must never see a torn JSON file
        write_timeline(args.output, content)
        print(f"tpu-perf-torch: wrote {len(spans)} span(s) to {args.output} "
              "(load in https://ui.perfetto.dev)", file=sys.stderr)
    else:
        print(content, end="")
    return rc


def _cmd_fleet_report(args: argparse.Namespace) -> int:
    """The cross-host collector (reads files only: no CUDA context, no
    ``--device``; a collector host may have no card): walk every host
    folder under the fleet
    root (streaming — bounded memory over any row count), roll up
    per-(host, op, size) percentiles, grade hosts against their peers
    through the linkmap MAD machinery, detect fleet-wide shifts against
    a baseline artifact, and render markdown / the JSON artifact / the
    Prometheus staleness textfile.  Exit 9 when grading named a sick
    host or a fleet-wide shift (and, with --fail-on-stale, a stale
    host)."""
    from tpu_perf_torch.fleet import (
        FleetGradeConfig, build_report, load_baseline_artifact,
        render_textfile, report_to_json, report_to_markdown,
        write_fleet_records,
    )
    from tpu_perf_torch.health.exporter import write_textfile

    # validate the grading knobs BEFORE walking a potentially huge
    # fleet root (the linkmap precedent: an argv typo costs an instant
    # error, not a minutes-long discarded pass) — ValueError lands in
    # main()'s exit-2 path
    cfg = FleetGradeConfig(
        mad_z=args.mad_z, rel_threshold=args.rel_threshold,
        min_hosts=args.min_hosts, shift_threshold=args.shift_threshold,
        stale_after=args.stale_after,
    )
    baseline = None
    if args.baseline:
        try:
            baseline = load_baseline_artifact(args.baseline)
        except (OSError, ValueError) as e:
            print(f"tpu-perf-torch: cannot read fleet baseline: {e}",
                  file=sys.stderr)
            return 2
    rep = build_report(args.root, config=cfg, baseline=baseline)
    if not rep.hosts:
        print(f"tpu-perf-torch: no host record folders under {args.root!r} "
              "(a fleet root holds one subfolder of rotating logs per "
              "host)", file=sys.stderr)
        return 1
    if args.format == "json":
        print(report_to_json(rep))
    else:
        print(report_to_markdown(rep))
    if args.output:
        # the machine artifact is ALWAYS the JSON form (it is the next
        # report's --baseline food), whatever stdout rendered; atomic
        # like every artifact write
        from tpu_perf_torch.trace import write_timeline as _atomic_write

        _atomic_write(args.output, report_to_json(rep) + "\n")
        print(f"tpu-perf-torch: wrote fleet artifact to {args.output}",
              file=sys.stderr)
    if args.textfile:
        # reported, never fatal: the verdict below must not be replaced
        # by a permissions traceback (the exporter stance)
        try:
            write_textfile(args.textfile, render_textfile(rep))
        except OSError as e:
            print(f"tpu-perf-torch: fleet textfile write failed: {e}",
                  file=sys.stderr)
    # the merged fleet selection: per-host winner tables folded into ONE
    # tuner artifact (majority winners) — --tune-out persists it for
    # `--algo auto` consumers, --push tees its records through the live
    # plane's tune route next to the fleet rollup records
    merged = None
    if args.tune_out or (args.push and rep.tune_majority):
        import time as _time

        from tpu_perf_torch.fleet.rollup import merge_fleet_selection
        from tpu_perf_torch.tuner.artifact import smi_device_kind

        merged = merge_fleet_selection(
            rep.hosts,
            generated=_time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                     _time.gmtime(rep.now)),
            generated_unix=rep.now,
            device_kind=smi_device_kind(),
            source=f"fleet:{args.root}")
    if args.tune_out:
        from tpu_perf_torch.tuner import write_artifact

        write_artifact(merged, args.tune_out)
        print(f"tpu-perf-torch: wrote merged fleet selection artifact "
              f"({len(merged.entries)} entries, "
              f"{len(rep.tune_disagreements)} disagreement(s)) to "
              f"{args.tune_out}", file=sys.stderr)
    from tpu_perf_torch.config import new_job_id

    job_id = new_job_id()
    # --drain-hook: the sick-host verdict ACTS — the operator-supplied
    # scheduler-drain command runs once per graded-sick host, rate-
    # limited per host through the fleet root's state sidecar, each
    # execution spanned (with -l) and failures health-evented.  Runs
    # BEFORE the rollup records are written so the drain outcomes land
    # in the same fleet-*.log the verdict does.
    drains = []
    if args.drain_hook and rep.sick_hosts:
        from tpu_perf_torch.fleet.drain import run_drain_hooks
        from tpu_perf_torch.spans import NULL_TRACER, SpanTracer

        tracer = NULL_TRACER
        span_log = None
        if args.logfolder:
            from tpu_perf_torch.driver import RotatingCsvLog
            from tpu_perf_torch.schema import SPANS_PREFIX

            span_log = RotatingCsvLog(
                args.logfolder, job_id, 0, refresh_sec=10**9,
                prefix=SPANS_PREFIX, lazy=True)
            tracer = SpanTracer(job_id, rank=0, log=span_log)
        try:
            drains = run_drain_hooks(
                args.root, rep.sick_hosts, args.drain_hook,
                interval=args.drain_interval, err=sys.stderr,
                tracer=tracer)
        finally:
            tracer.close()
        failed = [d for d in drains if d.action == "failed"]
        if failed and args.logfolder:
            from tpu_perf_torch.driver import RotatingCsvLog
            from tpu_perf_torch.health import HealthConfig, HealthMonitor
            from tpu_perf_torch.schema import HEALTH_PREFIX

            event_log = RotatingCsvLog(
                args.logfolder, job_id, 0, refresh_sec=10**9,
                prefix=HEALTH_PREFIX, lazy=True)
            monitor = HealthMonitor(HealthConfig(), job_id=job_id,
                                    dtype="none", event_log=event_log)
            try:
                for d in failed:
                    # a drain that silently did not happen leaves the
                    # scheduler placing work on a condemned host —
                    # critical, and queryable next to the verdict
                    monitor.observe_drain_fail(d.host)
            finally:
                monitor.close()
    if args.logfolder:
        write_fleet_records(args.logfolder, rep, job_id=job_id,
                            drains=drains)
    if args.push:
        # the live half: the same records the fleet-*.log carries,
        # POSTed now (one-shot; the durable file is the source of
        # truth, so a failed push is loud and re-runnable, never fatal)
        from tpu_perf_torch.fleet import fleet_records
        from tpu_perf_torch.push import push_records_once
        from tpu_perf_torch.schema import FLEET_PREFIX

        push_records_once(
            args.push, FLEET_PREFIX,
            [r.to_json() for r in fleet_records(rep, job_id=job_id,
                                                drains=drains)],
            err=sys.stderr)
        if merged is not None and merged.entries:
            from tpu_perf_torch.schema import TUNE_PREFIX

            push_records_once(
                args.push, TUNE_PREFIX,
                [r.to_json() for r in merged.to_records(job_id)],
                err=sys.stderr)
    failures = []
    if rep.sick_hosts:
        failures.append(
            f"{len(rep.sick_hosts)} host(s) graded sick: "
            f"{', '.join(rep.sick_hosts)}")
    if rep.shifts:
        failures.append(f"{len(rep.shifts)} fleet-wide shift(s) vs "
                        "baseline")
    if args.fail_on_stale and rep.stale_hosts:
        failures.append(
            f"{len(rep.stale_hosts)} stale host(s): "
            f"{', '.join(rep.stale_hosts)}")
    if failures:
        # exit 9: the fleet gate code (report --diff 3, grid 4, chaos
        # verify 5, linkmap 6, timeline join 7, lint 8)
        print(f"tpu-perf-torch: fleet unhealthy: {'; '.join(failures)}",
              file=sys.stderr)
        return 9
    return 0


def _cmd_fleet_timeline(args: argparse.Namespace) -> int:
    """Stitch every host's spans-*.log into ONE Perfetto view: each
    (host, job, rank) lane is its own process track, and ranks of one
    distributed job are clock-aligned on their shared heartbeat
    boundaries — a multi-host stall reads as one timeline, not N
    disjoint ones.  --check audits join completeness per host folder
    (exit 7 on any incomplete join)."""
    from tpu_perf_torch.fleet import discover_hosts, stitch_hosts
    from tpu_perf_torch.report import collect_paths
    from tpu_perf_torch.schema import SPANS_PREFIX
    from tpu_perf_torch.spans import read_span_records
    from tpu_perf_torch.trace import chrome_trace_json, write_timeline

    hosts = discover_hosts(args.root)
    if not hosts:
        print(f"tpu-perf-torch: no host record folders under {args.root!r}",
              file=sys.stderr)
        return 1
    host_spans: dict[str, list[dict]] = {}
    for host, folder in sorted(hosts.items()):
        paths = collect_paths(folder, prefix=SPANS_PREFIX,
                              include_open=True)
        if not paths:
            continue
        try:
            host_spans[host] = read_span_records(paths)
        except ValueError as e:
            # one hard-killed host's corrupt log must not blind the
            # stitched view to the other N-1 — the incident being
            # diagnosed is exactly when the rest of the fleet's
            # timeline matters (same stance as the report collector's
            # per-host read problems)
            print(f"tpu-perf-torch: bad span log on host {host}: {e} — "
                  "host skipped, stitching the rest", file=sys.stderr)
    if not host_spans:
        print(f"tpu-perf-torch: no span logs in any host folder under "
              f"{args.root!r} — run the daemons with --spans",
              file=sys.stderr)
        return 1
    rc = 0
    if args.check:
        ok_summaries = []
        for host in sorted(host_spans):
            problems, summary = _audit_join(hosts[host],
                                            host_spans[host])
            if problems:
                for p in problems:
                    print(f"tpu-perf-torch: host {host}: join incomplete: {p}",
                          file=sys.stderr)
                rc = 7
            else:
                ok_summaries.append(f"{host}: {summary}")
        for line in ok_summaries:
            print(f"tpu-perf-torch: join complete: {line}", file=sys.stderr)
    spans, names = stitch_hosts(host_spans, align=not args.no_align)
    content = chrome_trace_json(spans, names)
    if args.output:
        write_timeline(args.output, content)
        print(f"tpu-perf-torch: wrote {len(spans)} span(s) from "
              f"{len(host_spans)} host(s) to {args.output} "
              "(load in https://ui.perfetto.dev)", file=sys.stderr)
    else:
        print(content, end="")
    return rc


def _cmd_lint(args: argparse.Namespace) -> int:
    """Run the static invariant analyzer (tpu_perf_torch.analysis) over the
    tree.  Exit 0 when every finding is baselined (or none exist), 8 on
    any unbaselined finding — the CI gate's contract — and 2 on
    configuration errors (bad manifest/rule/baseline), via main()'s
    ValueError path."""
    import os

    from tpu_perf_torch.analysis import (
        default_manifest_path, default_root, lint_tree, load_manifest,
        render_baseline, render_json, render_rule_catalog, render_text,
        resolve_rules,
    )

    if args.list_rules:
        print(render_rule_catalog(), end="")
        return 0
    manifest_path = args.manifest or default_manifest_path()
    root = os.path.abspath(args.root) if args.root else default_root()
    try:
        manifest = load_manifest(manifest_path, root)
    except OSError as e:
        raise ValueError(f"cannot read manifest: {e}") from None
    rules = resolve_rules(args.rule)
    baseline = args.baseline
    if args.write_baseline and not baseline:
        raise ValueError("--write-baseline requires --baseline PATH")
    if baseline is not None and not os.path.exists(baseline) \
            and not args.write_baseline:
        raise ValueError(f"baseline file not found: {baseline}")
    try:
        result = lint_tree(
            root, manifest, rules=rules,
            baseline_path=baseline
            if baseline and os.path.exists(baseline) else None,
        )
    except OSError as e:
        raise ValueError(str(e)) from None
    if args.write_baseline:
        try:
            with open(baseline, "w") as fh:
                fh.write(render_baseline(result.findings))
        except OSError as e:
            # configuration error -> exit 2, like every other bad path
            raise ValueError(f"cannot write baseline: {e}") from None
        print(f"tpu-perf-torch: wrote {len(result.findings)} finding(s) to "
              f"{baseline}", file=sys.stderr)
        return 0
    if args.format == "json":
        print(render_json(result), end="")
    else:
        print(render_text(result), end="")
    return 8 if result.unbaselined else 0


def _cmd_health(args: argparse.Namespace) -> int:
    """Replay health-*.log events (the live daemon's .open file too) into
    the per-point summary table, or the raw events as JSON."""
    from tpu_perf_torch.health.events import (
        events_to_json, events_to_markdown, read_events, summarize_events,
    )
    from tpu_perf_torch.report import collect_paths

    paths = collect_paths(args.target, prefix=HEALTH_PREFIX,
                          include_open=True)
    if not paths:
        print(f"tpu-perf-torch: no health logs match {args.target!r}",
              file=sys.stderr)
        return 1
    try:
        # a torn final line is skipped with a warning; corruption
        # mid-file is an error
        events = read_events(paths)
    except ValueError as e:
        print(f"tpu-perf-torch: bad health event log: {e}", file=sys.stderr)
        return 1
    print(events_to_json(events) if args.format == "json"
          else events_to_markdown(summarize_events(events)))
    return 0


def _anomaly_context(target: str) -> None:
    """The report's anomaly-context section (a --spans soak's folder): a
    row a health event, with its run span and the rotations, ingest passes
    and builds that overlapped it."""
    import os

    if not os.path.isdir(target):
        return
    from tpu_perf_torch.health.events import read_events
    from tpu_perf_torch.report import collect_paths
    from tpu_perf_torch.schema import SPANS_PREFIX
    from tpu_perf_torch.spans import read_span_records
    from tpu_perf_torch.trace import anomaly_context, anomaly_to_markdown

    span_paths = collect_paths(target, prefix=SPANS_PREFIX,
                               include_open=True)
    event_paths = collect_paths(target, prefix=HEALTH_PREFIX,
                                include_open=True)
    if not (span_paths and event_paths):
        return
    try:
        ctx = anomaly_context(read_events(event_paths),
                              read_span_records(span_paths))
    except ValueError as e:
        print(f"tpu-perf-torch: skipping anomaly context: {e}",
              file=sys.stderr)
        return
    if ctx:
        print("\n### Anomaly context\n")
        print(anomaly_to_markdown(ctx))


def _cmd_ingest(args: argparse.Namespace) -> int:
    from tpu_perf_torch.ingest import (
        build_backend_from_env, list_quarantined, requeue_quarantined,
        run_all_ingest_passes,
    )

    if args.list_quarantined and args.requeue:
        # the list branch runs no pass and mutates nothing; skipping the
        # requeue silently would leave the poison files where they are
        print("tpu-perf-torch: error: --list-quarantined and --requeue are "
              "exclusive (list first, then requeue)", file=sys.stderr)
        return 2
    if args.list_quarantined:
        paths = list_quarantined(args.folder)
        for path in paths:
            print(path)
        print(f"{len(paths)} quarantined file(s) in {args.folder}",
              file=sys.stderr)
        return 0
    if args.requeue:
        restored = requeue_quarantined(args.folder)
        print(f"requeued {len(restored)} quarantined file(s)"
              + (": " + ", ".join(restored) if restored else ""),
              file=sys.stderr)
    n = run_all_ingest_passes(args.folder, skip_newest=args.flows,
                              backend=build_backend_from_env())
    print(f"ingested {n} files", file=sys.stderr)
    return 0


def _cmd_report(args: argparse.Namespace) -> int:
    from tpu_perf_torch import report
    from tpu_perf_torch.schema import LEGACY_PREFIX

    compares = (args.compare, args.compare_pallas, args.compare_chaos)
    if args.legacy:
        if (any(compares) or args.diff is not None
                or args.format != "markdown"):
            print("tpu-perf-torch: error: --legacy renders markdown only "
                  "and is exclusive with --compare*/--diff", file=sys.stderr)
            return 2
        paths = report.collect_paths(args.target, prefix=LEGACY_PREFIX)
        if not paths:
            print(f"tpu-perf-torch: no legacy logs match {args.target!r}",
                  file=sys.stderr)
            return 1
        print(report.legacy_to_markdown(report.aggregate_legacy(
            report.read_legacy_rows(paths))))
        return 0
    if args.diff is not None:
        if any(compares) or args.format != "markdown":
            print("tpu-perf-torch: error: --diff renders markdown only and "
                  "is exclusive with --compare*", file=sys.stderr)
            return 2
        base = report.points_from_artifact(args.diff)
        new = report.points_from_artifact(args.target)
        if not base or not new:
            which = args.diff if not base else args.target
            print(f"tpu-perf-torch: no curve points in {which!r}",
                  file=sys.stderr)
            return 1
        diffs = report.diff_points(base, new,
                                   threshold_pct=args.diff_threshold)
        print(report.diff_to_markdown(diffs))
        # a vanished curve point and a zero judged metric fail the gate
        # as a regression does
        regressed = [d for d in diffs if d.verdict == "regressed"]
        missing = [] if args.diff_ignore_missing else \
            [d for d in diffs if d.verdict == "base-only"]
        incomparable = [d for d in diffs if d.verdict == "incomparable"]
        if regressed or missing or incomparable:
            parts = []
            if regressed:
                parts.append(f"{len(regressed)} curve point(s) regressed "
                             f"beyond {args.diff_threshold:g}%")
            if missing:
                parts.append(f"{len(missing)} base curve point(s) missing "
                             "from the new run (--diff-ignore-missing to "
                             "allow subset comparisons)")
            if incomparable:
                parts.append(f"{len(incomparable)} curve point(s) "
                             "incomparable (zero judged metric on one "
                             "side — corrupt or partial artifact)")
            print(f"tpu-perf-torch: {'; '.join(parts)}", file=sys.stderr)
            return 3
        return 0
    paths = report.collect_paths(args.target)
    if not paths:
        print(f"tpu-perf-torch: no result files match {args.target!r}",
              file=sys.stderr)
        return 1
    # one streaming pass folds the curves and the adaptive verdicts
    points, adaptive = report.stream_report(paths)
    if any(compares):
        if args.format != "markdown" or sum(map(bool, compares)) > 1:
            print("tpu-perf-torch: error: --compare/--compare-pallas/"
                  "--compare-chaos render markdown only and are mutually "
                  "exclusive", file=sys.stderr)
            return 2
        if args.compare_pallas:
            print(report.compare_pallas_to_markdown(
                report.compare_pallas(points)))
        elif args.compare_chaos:
            cmp = report.compare_chaos(points)
            if not cmp:
                print("tpu-perf-torch: no chaos-mode rows in the target "
                      "(run `tpu-perf-torch chaos` with a fault schedule "
                      "and a logfolder first)", file=sys.stderr)
                return 1
            print(report.compare_chaos_to_markdown(cmp))
        else:
            print(report.compare_to_markdown(report.compare(points)))
        return 0
    fmt = {"markdown": report.to_markdown, "csv": report.to_csv,
           "json": report.to_json}[args.format]
    print(fmt(points))
    if args.format == "markdown":
        # contend's loaded rows against their idle twins; only when loaded
        # rows exist, so every other report is unchanged
        interference = report.interference_matrix(points)
        if interference:
            print("\n### Interference matrix\n")
            print(report.interference_to_markdown(interference))
        # the harness' own phases (the phase-*.json sidecars beside the
        # logs) and the early stop's savings (rows with runs_requested),
        # each only when there is one
        entries = report.read_phases(args.target)
        if entries:
            print("\n### Harness phases\n")
            print(report.phases_to_markdown(entries))
        # the push plane's counters from the same sidecars, when a --push
        # job wrote them
        if any(isinstance(e.get("push"), dict) for e in entries):
            print("\n### Push plane\n")
            print(report.push_to_markdown(entries))
        if adaptive:
            print("\n### Adaptive savings\n")
            print(report.adaptive_to_markdown(adaptive))
        # the arena's, the hierarchy's, the arrival spread's, the
        # scenarios' and the imbalance axis' views, each only when its
        # rows exist (the JAX package's sections, in its order)
        for title, table, render in (
                ("Arena crossover", report.compare_arena,
                 report.arena_to_markdown),
                ("Hierarchical DCN traffic model", report.hier_traffic,
                 report.hier_traffic_to_markdown),
                ("Straggler cost", report.straggler_cost,
                 report.straggler_to_markdown),
                ("Scenario steps", report.scenario_steps,
                 report.scenario_to_markdown),
                ("Imbalance cost", report.imbalance_cost,
                 report.imbalance_to_markdown)):
            got = table(points)
            if got:
                print(f"\n### {title}\n")
                print(render(got))
        # a --spans soak's health events beside what the harness was
        # doing when each fired
        _anomaly_context(args.target)
    return 0


def _cmd_grid(args: argparse.Namespace) -> int:
    from tpu_perf_torch.config import new_job_id
    from tpu_perf_torch.grid import grid_caption, grid_to_markdown, run_grid

    world = _sim_world(args)
    source = ("--spec-tflops" if args.spec_tflops is not None
              else "--spec-gbps" if args.spec_gbps is not None
              else "not given")
    if args.chip_spec_family:
        # the card table's peak and floor for the judged metric (and, for
        # mxu, the run's dtype); explicit flags win.  An unknown card raises.
        from tpu_perf_torch.chips import card_peak, card_spec

        spec = card_spec()
        peak = card_peak(spec, args.chip_spec_family, args.dtype)
        if args.chip_spec_family == "hbm":
            if args.spec_gbps is None:
                args.spec_gbps = peak
                source = f"{spec.device_name}, card table"
            if args.floor_gbps is None:
                args.floor_gbps = spec.stream_floor_gbps
        else:
            if args.spec_tflops is None:
                args.spec_tflops = peak
                source = f"{spec.device_name}, card table, {args.dtype}"
            if args.floor_tflops is None:
                args.floor_tflops = spec.mxu_floor_tflops.get(args.dtype)
        print(f"[tpu-perf-torch] grid specs from card table: {spec.kind} "
              f"({'measured' if spec.defended else 'derived'} floors)",
              file=sys.stderr)
        if args.chip_spec_family == "hbm":
            print("[tpu-perf-torch] the stream floor is the hbm_stream / "
                  "hbm_triad plateaus'; other ops are judged against it as "
                  "well (hbm_read, a reduction, reads under it on a healthy "
                  "card)", file=sys.stderr)
    compute = args.spec_tflops is not None or args.floor_tflops is not None
    sizes = [parse_size(s) for s in args.sizes.split(",") if s.strip()]
    iters_list = [int(s) for s in args.iters.split(",") if s.strip()]
    if not sizes or not iters_list:
        raise ValueError("grid needs at least one size and one iters value")

    def progress(cell):
        print(f"[grid] {cell.op} {format_size(cell.nbytes)} x{cell.iters}: "
              f"p50 {cell.p50:.1f} {cell.unit} -> {cell.verdict}",
              file=sys.stderr)

    job_id = new_job_id()
    on_rows = None
    grid_log = None
    if args.logfolder:
        # the raw rows behind the verdict table, in a rotating
        # extended-schema log stamped with the grid's job id
        from tpu_perf_torch.driver import RotatingCsvLog
        from tpu_perf_torch.schema import EXT_PREFIX

        grid_log = RotatingCsvLog(args.logfolder, job_id, 0,
                                  refresh_sec=10**9, prefix=EXT_PREFIX)

        def on_rows(rows):
            for row in rows:
                grid_log.write_row(row)

    try:
        cells = run_grid(world, args.op, sizes, iters_list, dtype=args.dtype,
                         runs=args.runs, fence=args.fence,
                         spec_gbps=args.spec_gbps, floor_gbps=args.floor_gbps,
                         spec_tflops=args.spec_tflops,
                         floor_tflops=args.floor_tflops,
                         on_cell=progress, on_rows=on_rows, job_id=job_id)
    finally:
        if grid_log is not None:
            grid_log.close()
    if compute:
        print(grid_caption(args.spec_tflops, args.floor_tflops, source,
                           unit="TFLOP/s"))
    else:
        print(grid_caption(args.spec_gbps, args.floor_gbps, source))
    print(grid_to_markdown(cells, fence=args.fence))
    chosen_by_op = {c.op: c for c in cells if c.chosen}
    for c in chosen_by_op.values():
        print(f"tpu-perf-torch: chosen operating point: {c.op} "
              f"{format_size(c.nbytes)} x{c.iters} ({c.p50:.1f} {c.unit} "
              "p50)", file=sys.stderr)
    missing = sorted({c.op for c in cells} - set(chosen_by_op))
    if missing:
        print(f"tpu-perf-torch: grid found no ok operating point for "
              f"{', '.join(missing)} (every cell unphysical/degraded/failed)",
              file=sys.stderr)
        return 4
    return 0


def _cmd_chips(args: argparse.Namespace) -> int:
    from tpu_perf_torch.chips import CARDS, detected_name, resolve_card

    name = args.kind if args.kind is not None else detected_name()
    if name is None:
        print("no CUDA device is visible; grid --spec hbm needs a card in "
              "this table or an explicit --spec-gbps")
    elif resolve_card(name) is None:
        # an unknown card is never dressed up as a match
        print(f"card {name!r} is not in the table; grid --spec hbm refuses "
              "it (give --spec-gbps)")
    found = resolve_card(name) if name is not None else None
    def cell(value) -> str:
        return "—" if value is None else f"{value:g}"

    def by_dtype(table: dict) -> str:
        return " / ".join(cell(table.get(dt)) for dt in ("bfloat16",
                                                          "float32"))

    print("| card | torch device name | HBM GB/s | bf16 dense TFLOP/s "
          "| f32 TFLOP/s | NVLink GB/s each way | stream nominal "
          "| triad nominal | stream floor | mxu nominal bf16 / f32 "
          "| mxu floor bf16 / f32 | allreduce nominal | floors |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for spec in CARDS.values():
        mark = " (detected)" if spec is found else ""
        print(f"| {spec.kind}{mark} | {spec.device_name} | {spec.hbm_gbps:g} "
              f"| {spec.bf16_tflops:g} | {spec.f32_tflops:g} "
              f"| {cell(spec.nvlink_gbps)} | {cell(spec.stream_nominal_gbps)} "
              f"| {cell(spec.triad_nominal_gbps)} "
              f"| {cell(spec.stream_floor_gbps)} "
              f"| {by_dtype(spec.mxu_nominal_tflops)} "
              f"| {by_dtype(spec.mxu_floor_tflops)} "
              f"| {cell(spec.allreduce_nominal_gbps)} "
              f"| {'measured' if spec.defended else 'derived'} |")
    return 0


def _cmd_ops(_args: argparse.Namespace) -> int:
    from tpu_perf_torch.ops.collectives import known_ops

    print("\n".join(known_ops()))
    return 0


def _cmd_selftest(args: argparse.Namespace) -> int:
    from tpu_perf_torch.selftest import format_results, run_selftest

    world = _sim_world(args)
    ops = [o.strip() for o in args.ops.split(",") if o.strip()] if args.ops else None
    results = run_selftest(world, ops=ops, nbytes=parse_size(args.size),
                           dtype=args.dtype, iters=args.iters)
    print(format_results(results))
    return 1 if any(r.status == "fail" for r in results) else 0


def _cmd_bench(args: argparse.Namespace) -> int:
    from tpu_perf_torch.bench import main as bench_main

    bench_main(args.device)
    return 0


def _add_run_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-l", "--logfolder", default=None,
                   help="CSV log folder (rotating tcp-*/tpu-* logs)")
    p.add_argument("-i", "--iters", type=int, default=DEF_ITERS,
                   help="chained executions per run")
    p.add_argument("-b", "--size", default=str(DEF_BUF_SZ),
                   help="buffer size (e.g. 4M)")
    p.add_argument("-u", "--unidir", action=_ZeroOne,
                   help="unidirectional + ack kernel (pingpong_unidir)")
    p.add_argument("-r", "--runs", type=int, default=1,
                   help="measured runs (-1 = infinite, as monitor)")
    p.add_argument("-p", "--ppn", type=int, default=1,
                   help="flows per node (NumOfFlows)")
    p.add_argument("-x", "--nonblocking", action=_ZeroOne,
                   help="windowed exchange kernel (both directions at once)")
    p.add_argument("-d", "--extern-cmd", nargs="?", const=DEFAULT_TEMPLATE,
                   default=None, metavar="TEMPLATE",
                   help="print-only external launcher mode: render TEMPLATE "
                        "({role} {ip} {port} {flows} {bytes} {iters}) per "
                        "process instead of running a kernel")
    p.add_argument("-f", "--group1-file", default=None,
                   help="group-1 hostnames (validation)")
    p.add_argument("-n", "--group1-hosts", type=int, default=0,
                   help="expected group-1 host count (cross-checked against "
                        "the -f file, mpi_perf.c:287-289)")
    p.add_argument("--window", type=int, default=1,
                   help="buffers in flight (exchange)")
    p.add_argument("--backend", choices=BACKENDS, default="torch",
                   help="torch runs this package on the card; mpi runs the "
                        "repo's C baseline (backends/mpi) on the host")
    p.add_argument("--hosts", default=None,
                   help="mpi backend: comma-separated hosts for the real "
                        "mpirun launch (omit to run the no-MPI pthread "
                        "shim on this machine)")
    p.add_argument("--dry-run", action="store_true",
                   help="mpi backend: print the exact launch command "
                        "instead of executing it (DRY_RUN=1 in the "
                        "profile scripts)")
    p.add_argument("--op", default="pingpong",
                   help="measurement op (see `ops`), or a comma-separated "
                        "family: the run walks it op by op, the daemon "
                        "round-robins over every (op, size) point; -u / "
                        "-x pick the kernel when it is the default "
                        "pingpong")
    p.add_argument("--algo", default="native",
                   help="collective decomposition(s) to run "
                        "(tpu_perf_torch.arena): native (the library call, "
                        "default), one of ring/rhd/bruck/binomial (one "
                        "axis), hier/hier-<inner> (the composed "
                        "slow-axis-minimal algorithms on a 2-axis dcn,ici "
                        "mesh, keyed per mesh-axis tuple), a v-schedule "
                        "of the v-ops (sortring, doubling, vhier, ring, "
                        "or a flat allreduce inner for seg_allreduce), a "
                        "comma family, or 'all': native and every "
                        "registered algorithm the op and world allow, "
                        "raced head to head (the `arena` default).  "
                        "'auto' runs at each sweep point the winner a "
                        "`tune` selection artifact (--algo-artifact) "
                        "published for it, resolved statically at plan "
                        "time with a loud native fallback on unmeasured, "
                        "low-margin, stale or foreign points")
    p.add_argument("--algo-artifact", default=None, metavar="PATH",
                   help="--algo auto's selection artifact (the versioned "
                        "winner table `tune` writes), loaded once at plan "
                        "time: every point resolves to its published "
                        "winner (nearest measured size bucket) or loudly "
                        "to native")
    p.add_argument("--tune-margin", type=float, default=1.02,
                   metavar="RATIO",
                   help="--algo auto's confidence floor: an entry whose "
                        "winner beat the runner-up by less than RATIO "
                        "(p50 ratio) runs native with a note (default "
                        "1.02 = 2%%)")
    p.add_argument("--tune-max-age", type=float, default=0.0,
                   metavar="SEC",
                   help="--algo auto's staleness bound: an artifact older "
                        "than SEC runs native everywhere, loudly (default "
                        "0 = never stale; judged once at plan time)")
    p.add_argument("--sweep", default=None,
                   help="size sweep, e.g. 8:1G or 8,64K,4M")
    p.add_argument("--skew-spread", default=None, metavar="LIST",
                   help="arrival-spread sweep axis (e.g. 0,250us,1ms; bare "
                        "numbers are us): every point is measured once a "
                        "spread, each run's entry staggered, the last "
                        "rank exactly the spread late, the others at "
                        "seeded arrivals in [0, spread).  Rows carry it "
                        "in skew_us; `report` renders the straggler-cost "
                        "table (include 0).  Not on a finite --fence "
                        "fused or trace sweep")
    p.add_argument("--scenario", default=None, metavar="NAMES",
                   help="sweep model-step scenarios (built-in names or "
                        "spec.json paths; implies --op scenario): each "
                        "scenario's phases run as one step a point")
    p.add_argument("--imbalance", default=None, metavar="LIST",
                   help="uneven-payload sweep axis (integer ratios, e.g. "
                        "1,2,8): the v-ops and v-phase scenarios are "
                        "built once a ratio, the last rank carrying ratio "
                        "times the base chunk.  Rows carry it; `report` "
                        "renders the imbalance-cost table (include 1)")
    p.add_argument("--fence", choices=FENCE_MODES, default="block",
                   help="timing fence (tpu_perf_torch.timing); auto picks "
                        "trace (device clock) on a card and slope on the "
                        "CPU; fused captures a sweep point's whole run "
                        "budget into one CUDA graph replayed once, with "
                        "per-run device times from events inside the "
                        "graph (chunk means on the CPU) — the fence for "
                        "microsecond message sizes, where the host launch "
                        "is every per-run fence's floor")
    p.add_argument("--streams", type=int, default=1, metavar="K",
                   help="overlapped dispatch: keep up to K sweep points in "
                        "flight, each on its own CUDA stream, fenced in "
                        "dispatch order (block/readback fences, finite "
                        "runs); rows carry their 1-based lane in the "
                        "stream column")
    p.add_argument("--fused-chunks", type=int, default=0, metavar="N",
                   help="--fence fused sub-dispatch count per point "
                        "(0 = auto: one dispatch on a fixed budget)")
    p.add_argument("--measure-dispatch", action="store_true",
                   help="measure the launch floor once per point and "
                        "record it in each row's overhead_us column "
                        "(block/readback fences; slope rows record 0 — "
                        "the slope already cancels constant overheads)")
    p.add_argument("--profile-dir", default=None,
                   help="keep one torch.profiler chrome trace per point's "
                        "measured window here (finite runs)")
    p.add_argument("--max-runs", type=int, default=None, metavar="N",
                   help="daemon mode (monitor, -r -1): stop after N "
                        "measured runs (the soak/CI safety valve); on a "
                        "finite run with --ci-rel, each point's run cap "
                        "(default: -r)")
    p.add_argument("--ci-rel", type=float, default=None, metavar="FRAC",
                   help="adaptive sampling: stop each point once the "
                        "relative half-width of its confidence interval "
                        "falls under FRAC (e.g. 0.05), bounded by "
                        "--min-runs / --max-runs; block, readback, slope "
                        "and fused (a chunk a vote) fences, finite runs")
    p.add_argument("--ci-confidence", type=float, default=0.95,
                   help="the interval's confidence: 0.90, 0.95 or 0.99")
    p.add_argument("--ci-statistic", choices=("mean", "p50"),
                   default="mean",
                   help="the stop rule's target: the mean (t interval) or "
                        "the median (order-statistic interval; the mean "
                        "under --fence fused)")
    p.add_argument("--min-runs", type=int, default=5, metavar="N",
                   help="samples before the stop rule is asked")
    p.add_argument("--precompile", type=_precompile_arg, default=0,
                   metavar="N|auto",
                   help="build the host half of up to N upcoming points "
                        "(nvcc, host constants) on a worker thread while "
                        "the main thread measures; auto tunes N from the "
                        "compile / measure phase ratio")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="keep the kernel builds (nvcc libraries, Triton's "
                        "cache) in DIR, so a later process builds none")
    p.add_argument("--stats-every", type=int, default=1000)
    p.add_argument("--heartbeat-format", choices=HEARTBEAT_FORMATS,
                   default="human",
                   help="stderr heartbeat format; json emits one machine-"
                        "readable object per stats boundary")
    p.add_argument("--log-refresh-sec", type=int,
                   default=LOG_REFRESH_TIME_SEC)
    p.add_argument("--csv", action="store_true",
                   help="print extended rows as CSV to stdout")
    p.add_argument("--health", action="store_true",
                   help="online fleet health: per-(op, size, dtype) "
                        "streaming baselines with step/spike/flatline/"
                        "capture-loss detectors; events land in rotating "
                        "health-*.log files (JSONL) beside the rows and "
                        "ride the same ingest pass")
    p.add_argument("--health-threshold", type=float, default=0.5,
                   metavar="REL",
                   help="relative step-regression threshold: alert when "
                        "the short-term EWMA exceeds the long-run median "
                        "by this fraction (default 0.5 = +50%%)")
    p.add_argument("--health-warmup", type=int, default=30, metavar="N",
                   help="baseline samples per point before it is judged")
    p.add_argument("--health-textfile", default=None, metavar="PATH",
                   help="write the gauges (p50/p99 latency, busbw, drop "
                        "rate, severity) to this Prometheus textfile at "
                        "every heartbeat boundary (rank 0 only)")
    p.add_argument("--spans", action="store_true",
                   help="harness span tracing: job/sweep/point/run spans "
                        "and the build/warmup/fence/rotation/ingest-hook/"
                        "stop-vote/inject activity to the spans-*.log "
                        "family, the run span stamped into rows and "
                        "health events; off, rows and chaos ledgers are "
                        "byte-identical")
    p.add_argument("--spans-sample", type=int, default=1, metavar="N",
                   help="daemon span retention: every Nth run's whole span "
                        "tree; other runs keep their run span, and rotate/"
                        "ingest/inject/heartbeat/error spans are always "
                        "kept (default 1 = everything)")
    p.add_argument("--push", default=None, metavar="URL", dest="push_url",
                   help="live telemetry push plane: tee every record "
                        "family (rows, health events, spans; never the "
                        "chaos ledger) after its durable write into a "
                        "bounded queue a background thread POSTs as "
                        "NDJSON to URL/v1/<Table>, with timeout, retry "
                        "and jittered backoff, a dead-letter spool beside "
                        "the logs (`ingest --requeue`, `push replay`) and "
                        "overflow drops counted, never a measurement stall")
    p.add_argument("--push-textfile", default=None, metavar="PATH",
                   help="live Prometheus textfile of the push plane's "
                        "meters, refreshed every sender cycle (rank 0)")
    p.add_argument("--push-queue", type=int, default=0, metavar="N",
                   help="the push plane's tee-queue bound in records "
                        "(default 10000); overflow drops are counted")
    p.add_argument("--seed", type=int, default=0,
                   help="the chaos injector's seed: same seed + spec => "
                        "the same perturbations and chaos-*.log ledger")
    _add_mesh_flags(p)
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed world, one process a rank "
                        "(torchrun's RANK / WORLD_SIZE / LOCAL_RANK / "
                        "MASTER_ADDR / MASTER_PORT): NCCL on the card, gloo "
                        "with --device cpu")
    p.add_argument("--hybrid-mesh", action="store_true",
                   help="lay the ranks over a (dcn, ici) mesh: the nodes "
                        "(WORLD_SIZE / LOCAL_WORLD_SIZE) by the ranks of a "
                        "node")
    _add_world_flags(p)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tpu-perf-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="one-shot benchmark / sweep")
    _add_run_flags(p_run)
    p_run.set_defaults(func=_cmd_run)

    p_mon = sub.add_parser("monitor", help="infinite monitoring daemon (-r -1)")
    _add_run_flags(p_mon)  # --max-runs is the daemon's safety valve
    p_mon.set_defaults(func=lambda a: _cmd_run(a, infinite=True))

    p_arena = sub.add_parser(
        "arena",
        help="collective-algorithm arena: hand-built allreduce / "
             "all_gather / reduce_scatter / all_to_all decompositions "
             "(ring, recursive halving/doubling, Bruck, binomial; on a "
             "2-axis dcn,ici mesh the hier* compositions) raced against "
             "the native call; `report` renders the crossover table")
    _add_run_flags(p_arena)
    p_arena.set_defaults(func=_cmd_run, op="allreduce,all_gather,"
                         "reduce_scatter,all_to_all", algo="all")

    p_scn = sub.add_parser(
        "scenario",
        help="model-step scenario sweep (tpu_perf_torch.scenarios): a "
             "named phase sequence (TP allreduce burst, MoE dispatch / "
             "combine, pipeline chain, or a spec.json) run as one step a "
             "point; --imbalance sweeps the v-phases' payload ratio "
             "(--list for the catalog)")
    p_scn.add_argument("names", nargs="?", default=None,
                       metavar="NAME[,NAME|SPEC.json]",
                       help="scenarios to sweep: built-in names and/or "
                            "JSON spec paths, comma-separated")
    p_scn.add_argument("--list", action="store_true",
                       dest="list_scenarios",
                       help="list the built-in scenario catalog and exit")
    _add_run_flags(p_scn)
    p_scn.set_defaults(func=_cmd_scenario)

    p_chaos = sub.add_parser(
        "chaos",
        help="fault-injected daemon soak; `chaos verify <dir>` judges "
             "detector conformance")
    chaos_sub = p_chaos.add_subparsers(dest="chaos_cmd")
    p_cver = chaos_sub.add_parser(
        "verify",
        help="join the injection ledger (chaos-*.log) against the health "
             "events: a caught/missed verdict a fault and a precision/"
             "recall row a detector")
    p_cver.add_argument("target", help="log folder (or glob/file) holding "
                                       "chaos-*.log + health-*.log")
    p_cver.add_argument("--format", choices=("markdown", "json"),
                        default="markdown")
    p_cver.add_argument("--grace-runs", type=int, default=None, metavar="N",
                        help="runs past a fault's last injection an event "
                             "still counts as its detection (default 2x "
                             "the soak's stats_every)")
    p_cver.add_argument("--fail-on-false-alarm", action="store_true",
                        help="also exit 5 when any event is not "
                             "attributable to an injected fault")
    p_cver.add_argument("--textfile", default=None, metavar="PATH",
                        help="also write per-detector caught/missed/false-"
                             "alarm gauges and a last-verify timestamp to "
                             "this Prometheus textfile")
    p_cver.set_defaults(func=_cmd_chaos_verify)
    _add_run_flags(p_chaos)
    p_chaos.add_argument("--faults", default=None, metavar="SPEC.json",
                         help="fault schedule (tpu_perf_torch.faults.spec "
                              "JSON); omit for a fault-free soak")
    p_chaos.add_argument("--fault", action="append", default=None,
                         metavar="KIND[:OP[:NBYTES[:START-END[:MAG]]]]",
                         help="one inline fault (repeatable), appended to "
                              "the --faults schedule; e.g. "
                              "delay:ring:32:100-400:2.0")
    p_chaos.add_argument("--synthetic", type=float, default=None,
                         metavar="SECONDS",
                         help="replace measured samples with a seeded "
                              "series around this base latency (points "
                              "are still built and warmed on the device)")
    p_chaos.set_defaults(func=_cmd_chaos)  # --max-runs bounds the soak

    p_health = sub.add_parser(
        "health", help="replay health-*.log events into a per-point "
                       "summary table")
    p_health.add_argument("target",
                          help="file, log folder, or glob of health-*.log")
    p_health.add_argument("--format", choices=("markdown", "json"),
                          default="markdown",
                          help="markdown = the summary table; json = the "
                               "raw events as a JSON array")
    p_health.set_defaults(func=_cmd_health)

    p_ing = sub.add_parser("ingest", help="one telemetry ingest pass")
    p_ing.add_argument("-d", "--folder", default=DEFAULT_LOG_DIR)
    p_ing.add_argument("-f", "--flows", type=int, default=10,
                       help="skip this many newest files (kusto_ingest.py:38-40)")
    p_ing.add_argument("--list-quarantined", action="store_true",
                       help="list files quarantined after repeated ingest "
                            "failures (<name>.quarantined) and exit; no "
                            "pass runs")
    p_ing.add_argument("--requeue", action="store_true",
                       help="strip the .quarantined suffix (and clear any "
                            "stale sidecar failure count a killed pass "
                            "left armed) on every quarantined file, then "
                            "run the pass")
    p_ing.set_defaults(func=_cmd_ingest)

    p_rep = sub.add_parser("report", help="aggregate result logs into "
                                          "curve tables")
    p_rep.add_argument("target", help="file, log folder, or glob of tpu-*.log")
    p_rep.add_argument("--format", choices=("markdown", "csv", "json"),
                       default="markdown")
    p_rep.add_argument("--compare", action="store_true",
                       help="pivot backends into side-by-side columns per "
                            "(op, size) with torch/mpi ratios")
    p_rep.add_argument("--compare-pallas", action="store_true",
                       help="pivot each pl_* kernel against its library "
                            "counterpart per (op, size)")
    p_rep.add_argument("--compare-chaos", action="store_true",
                       help="pivot chaos-mode rows (a fault-injected soak) "
                            "against the clean soak of the same spec per "
                            "(op, size)")
    p_rep.add_argument("--legacy", action="store_true",
                       help="aggregate reference-schema tcp-*.log rows "
                            "(wall-time stats per measurement config)")
    p_rep.add_argument("--diff", metavar="BASE", default=None,
                       help="diff TARGET against BASE (each a report-JSON "
                            "artifact or raw logs); exits 3 when any curve "
                            "point regressed beyond the threshold")
    p_rep.add_argument("--diff-threshold", type=float, default=10.0,
                       metavar="PCT",
                       help="regression threshold in percent (default 10)")
    p_rep.add_argument("--diff-ignore-missing", action="store_true",
                       help="do not fail the gate on base-only curve "
                            "points (for diffing a subset run against a "
                            "full published artifact)")
    p_rep.set_defaults(func=_cmd_report)

    p_grid = sub.add_parser(
        "grid", help="size x iters operating-point grid with physical-"
                     "ceiling verdicts")
    p_grid.add_argument("--op", required=True, help="comma-separated ops")
    p_grid.add_argument("--sizes", required=True,
                        help="comma-separated sizes (e.g. 256M,1G)")
    p_grid.add_argument("--iters", required=True,
                        help="comma-separated lo iteration counts (slope "
                             "and trace time each against 4x)")
    p_grid.add_argument("-r", "--runs", type=int, default=8)
    p_grid.add_argument("--fence", choices=FENCE_MODES, default="slope")
    p_grid.add_argument("--spec", choices=("hbm", "mxu"), default=None,
                        dest="chip_spec_family",
                        help="take the judged metric's ceiling and floor "
                             "from the detected card's entry "
                             "(tpu_perf_torch.chips): "
                             "hbm = busbw against its device-memory peak, "
                             "mxu = TFLOP/s against its product peak for "
                             "--dtype (bf16/f16: tensor cores; f32: the "
                             "float32 rate, TF32 off); explicit --spec-* "
                             "/ --floor-* override")
    p_grid.add_argument("--spec-gbps", type=float, default=None,
                        help="physical busbw ceiling (H100 SXM: 3350); p50 "
                             "above it = unphysical")
    p_grid.add_argument("--floor-gbps", type=float, default=None,
                        help="plateau floor; p50 below it = degraded "
                             "(--spec hbm: the card's stream floor, measured "
                             "on hbm_stream / hbm_triad and applied to every "
                             "--op: hbm_read reads under it on a healthy "
                             "card)")
    p_grid.add_argument("--spec-tflops", type=float, default=None,
                        help="judge cells on TFLOP/s against this compute "
                             "ceiling instead of bus bandwidth (H100 SXM "
                             "bf16: 989, f32: 67); compute instruments only")
    p_grid.add_argument("--floor-tflops", type=float, default=None,
                        help="compute plateau floor; p50 below it = "
                             "degraded (--spec mxu: the card's floor for "
                             "--dtype)")
    p_grid.add_argument("-l", "--logfolder", default=None,
                        help="also write every cell's raw rows here "
                             "(extended schema)")
    _add_mesh_flags(p_grid)
    _add_world_flags(p_grid)
    p_grid.set_defaults(func=_cmd_grid)

    p_ct = sub.add_parser(
        "contend",
        help="contention race (tpu_perf_torch.streams.contend): a victim op "
             "against a concurrent load on the stream engine's lanes, a "
             "compute kernel (--load mxu_gemm/hbm_stream), a sibling op "
             "(--load OP) or K split-channel lanes (--split K); every point "
             "is measured idle and loaded so "
             "`report` renders the interference matrix")
    _add_run_flags(p_ct)
    p_ct.add_argument("--load", default="", metavar="OP",
                      help="background load: a compute kernel (mxu_gemm, "
                           "hbm_stream) or any op from `ops`")
    p_ct.add_argument("--split", type=int, default=0, metavar="K",
                      help="split-channel shape (op ppermute): the payload "
                           "cut into K slices, each on its own concurrent "
                           "ppermute lane along one of the linkmap "
                           "planner's link-disjoint ring shifts, against "
                           "the single-channel full payload")
    p_ct.add_argument("--victim-axis", default=None, metavar="AXIS",
                      help="mesh axis the victim runs along (default: "
                           "every axis)")
    p_ct.add_argument("--load-axis", default=None, metavar="AXIS",
                      help="mesh axis a collective load runs along: the "
                           "victim's for shared-fabric contention, another "
                           "for the disjoint-axis control (default: every "
                           "axis)")
    p_ct.add_argument("--synthetic", type=float, default=None,
                      metavar="SECONDS",
                      help="no device raced: seeded samples around this "
                           "base latency, the loaded ones the idle series "
                           "times a modeled contention factor (needs "
                           "--mesh for the rank count)")
    # the default victim: the bandwidth-bound collective the interference
    # question is usually asked about
    p_ct.set_defaults(func=_cmd_contend, op="allreduce")

    p_push = sub.add_parser(
        "push",
        help="push plane tooling (the plane rides `run --push URL`): "
             "`push replay` delivers dead-letter spool files to a sink")
    push_sub = p_push.add_subparsers(dest="push_cmd", required=True)
    p_pr = push_sub.add_parser(
        "replay",
        help="POST every live spool file's records to the sink, deleting "
             "each file only after its batch is accepted (quarantined "
             "spools need `ingest --requeue` first)")
    p_pr.add_argument("folder", help="the log folder holding push-*.spool "
                                     "dead letters")
    p_pr.add_argument("--url", required=True, metavar="URL",
                      help="push sink base URL (records go to "
                           "URL/v1/<Table>)")
    p_pr.add_argument("--timeout", type=float, default=5.0, metavar="SEC",
                      help="per-request timeout (default 5 s)")
    p_pr.set_defaults(func=_cmd_push_replay)

    p_lm = sub.add_parser(
        "linkmap",
        help="per-link probe sweep: plan the mesh's directed links, time "
             "each through the fences, grade against the card's NVLink "
             "roofline (across cards) and the row/col MAD, and localize "
             "sick links (exit 6 on any non-ok link); `linkmap report "
             "<dir>` replays the durable linkmap-*.log records")
    lm_sub = p_lm.add_subparsers(dest="linkmap_cmd")
    p_lmr = lm_sub.add_parser(
        "report",
        help="replay linkmap-*.log records into the heatmap + verdict "
             "table (or the JSON artifact)")
    p_lmr.add_argument("target",
                       help="file, log folder, or glob of linkmap-*.log")
    p_lmr.add_argument("--format", choices=("markdown", "json"),
                       default="markdown")
    p_lmr.add_argument("--diff", default=None, metavar="BASE.json",
                       help="also diff this sweep's per-link latencies "
                            "against a prior sweep's `linkmap --format "
                            "json` artifact and exit 6 on any link "
                            "degraded past --diff-threshold (a slowly "
                            "dying link degrades against itself, not its "
                            "peers)")
    p_lmr.add_argument("--diff-threshold", type=float, default=30.0,
                       metavar="PCT",
                       help="latency-rise gate for --diff, percent "
                            "(default 30)")
    p_lmr.set_defaults(func=_cmd_linkmap_report)
    p_lm.add_argument("-b", "--size", default="4M",
                      help="per-probe message size (default 4M)")
    p_lm.add_argument("-i", "--iters", type=int, default=10,
                      help="chained ppermutes per timed sample")
    p_lm.add_argument("-r", "--runs", type=int, default=5,
                      help="samples per link (the per-link statistic is "
                           "their MEAN: intermittent stalls stay visible)")
    p_lm.add_argument("--fence", choices=("block", "readback"),
                      default="block",
                      help="timing fence per sample (per-link probes are "
                           "single timed calls; constant overheads cancel "
                           "in the grader's cross-link comparison)")
    p_lm.add_argument("--mesh", default=None,
                      help="mesh shape, e.g. 2x4 (required with "
                           "--synthetic; default: every rank on one axis)")
    p_lm.add_argument("--axes", default=None, help="axis names, e.g. dcn,ici")
    _add_world_flags(p_lm)
    p_lm.add_argument("--distributed", action="store_true",
                      help="probe the links between the ranks of a "
                           "torch.distributed world (one process a card, "
                           "from torchrun's variables): one NVLink "
                           "direction a probe")
    p_lm.add_argument("-l", "--logfolder", default=None,
                      help="persist meta/probe/verdict records as a "
                           "linkmap-*.log file (swept by `ingest` into its "
                           "own table) and surface non-ok links as "
                           "link_degraded health events")
    p_lm.add_argument("--all-pairs", action="store_true",
                      help="mpiGraph-style all-ordered-pairs tournament "
                           "instead of per-axis neighbor links")
    p_lm.add_argument("--no-wrap", action="store_true",
                      help="line fabric: skip the wraparound links")
    p_lm.add_argument("--precompile", type=int, default=0, metavar="N",
                      help="build up to N upcoming probe programs' host "
                           "halves on a worker thread while the current "
                           "probe measures; 0 = inline")
    p_lm.add_argument("--compile-cache", default=None, metavar="DIR",
                      help="kernel build cache directory, as on run (a "
                           "probe builds no kernel)")
    p_lm.add_argument("--spans", action="store_true",
                      help="trace each schedule walk as a probe_schedule "
                           "span to spans-*.log next to the linkmap "
                           "records (needs -l); probe records carry the "
                           "enclosing span id")
    p_lm.add_argument("--concurrent", action="store_true",
                      help="drive each schedule as ONE ppermute (probes "
                           "are link-disjoint by construction): per-link "
                           "values are upper bounds; flagged links are "
                           "then re-probed serially before grading")
    p_lm.add_argument("--no-bisect", action="store_true",
                      help="skip the concurrent sweep's re-probing and "
                           "grade the raw batch upper bounds")
    p_lm.add_argument("--synthetic", type=float, default=None,
                      metavar="SECONDS",
                      help="seeded per-link timing series around this "
                           "base latency instead of real probes: "
                           "deterministic gates, no device touched")
    p_lm.add_argument("--seed", type=int, default=0,
                      help="synthetic/fault seed")
    p_lm.add_argument("--faults", default=None, metavar="SPEC.json",
                      help="fault schedule injected into the probe "
                           "stream; target one link by op name "
                           "(link:(1,2)>(1,3)) and/or one rank")
    p_lm.add_argument("--fault", action="append", default=None,
                      metavar="KIND[:OP[:NBYTES[:START-END[:MAG]]]]",
                      help="one inline fault (repeatable)")
    p_lm.add_argument("--roofline-gbps", type=float, default=None,
                      help="per-link bandwidth spec to grade against "
                           "(default: the card's NVLink rate each way, on "
                           "the non-dcn axes of a multi-process world on "
                           "cards; none for the sim world, --all-pairs and "
                           "--synthetic; 0 disables; an explicit value "
                           "applies to everything probed)")
    p_lm.add_argument("--dcn-roofline-gbps", type=float, default=None,
                      help="per-link bandwidth spec for the dcn*-named "
                           "axes (default: MAD-only grading there)")
    p_lm.add_argument("--roofline-floor", type=float, default=0.5,
                      metavar="FRAC",
                      help="links under this fraction of the roofline "
                           "grade slow (default 0.5)")
    p_lm.add_argument("--mad-z", type=float, default=6.0,
                      help="robust z bar for row/col MAD outliers")
    p_lm.add_argument("--rel-threshold", type=float, default=0.25,
                      metavar="REL",
                      help="AND-gate on the MAD verdict: also need this "
                           "relative excess over the peer median "
                           "(default 0.25 = +25%%)")
    p_lm.add_argument("--dead-ratio", type=float, default=10.0,
                      help="mean this many times the peer median grades "
                           "dead instead of slow")
    p_lm.add_argument("--format", choices=("markdown", "json"),
                      default="markdown")
    p_lm.add_argument("--push", default=None, metavar="URL",
                      help="also POST the sweep's linkmap records (NDJSON) "
                           "to URL/v1/LinkMapTPU once grading finishes: "
                           "one shot, loud on failure, never fatal")
    p_lm.set_defaults(func=_cmd_linkmap)

    p_tl = sub.add_parser(
        "timeline",
        help="export harness trace spans (spans-*.log, from --spans) to "
             "Chrome trace-event JSON loadable in Perfetto: main thread, "
             "compile-pipeline worker, and ingest hook as separate "
             "tracks, ranks merged as processes",
    )
    p_tl.add_argument("target",
                      help="file, log folder, or glob of spans-*.log")
    p_tl.add_argument("-o", "--output", default=None, metavar="PATH",
                      help="write the trace JSON here (atomically) "
                           "instead of stdout")
    p_tl.add_argument("--rank", type=int, default=None,
                      help="export only this rank's spans (default: "
                           "merge all ranks found in the target)")
    p_tl.add_argument("--check", action="store_true",
                      help="also audit join completeness: every result "
                           "row, health event, and chaos ledger entry in "
                           "the folder must resolve to exactly one "
                           "enclosing run span (exit 7 otherwise; "
                           "directory targets only)")
    p_tl.add_argument("--no-align", action="store_true",
                      help="skip per-process clock alignment (by "
                           "default, ranks launched seconds apart are "
                           "aligned onto one clock via the heartbeat "
                           "collectives' shared boundaries)")
    p_tl.set_defaults(func=_cmd_timeline)

    p_fleet = sub.add_parser(
        "fleet",
        help="fleet observability plane: `fleet report <root>` walks N "
             "hosts' record folders (streaming) into topology-aware "
             "rollups — cross-host MAD grading names the worst hosts, "
             "a baseline artifact exposes fleet-wide shifts, staleness "
             "gauges land in a Prometheus textfile (exit 9 on sick "
             "hosts); `fleet timeline <root>` stitches every host's "
             "spans into one clock-aligned Perfetto view",
    )
    fleet_sub = p_fleet.add_subparsers(dest="fleet_cmd", required=True)
    p_fr = fleet_sub.add_parser(
        "report",
        help="collect + grade the fleet root (one subfolder of rotating "
             "logs per host)",
    )
    p_fr.add_argument("root", help="fleet root directory (one host "
                                   "record folder per subdirectory)")
    p_fr.add_argument("--format", choices=("markdown", "json"),
                      default="markdown")
    p_fr.add_argument("-o", "--output", default=None, metavar="PATH",
                      help="also write the JSON artifact here "
                           "(atomically) — the next report's --baseline "
                           "input, whatever --format rendered")
    p_fr.add_argument("--textfile", default=None, metavar="PATH",
                      help="write per-host last-seen/staleness/sick "
                           "gauges and fleet totals to this Prometheus "
                           "textfile (node-exporter convention)")
    p_fr.add_argument("-l", "--logfolder", default=None,
                      help="persist the rollup as fleet-*.log records "
                           "(the seventh rotating family, swept by "
                           "`ingest` into FleetRollupTPU)")
    p_fr.add_argument("--baseline", default=None, metavar="FLEET.json",
                      help="a previous fleet artifact: points whose "
                           "FLEET median moved beyond --shift-threshold "
                           "are flagged as fleet-wide shifts — the "
                           "regression every host's local baseline "
                           "absorbs silently")
    p_fr.add_argument("--stale-after", type=float, default=3600.0,
                      metavar="SEC",
                      help="a host whose newest record is older than "
                           "this is stale (default 3600)")
    p_fr.add_argument("--fail-on-stale", action="store_true",
                      help="also exit 9 when any host is stale")
    p_fr.add_argument("--mad-z", type=float, default=6.0,
                      help="robust z bar for a host vs its peers "
                           "(the linkmap grader's core, host-scoped)")
    p_fr.add_argument("--rel-threshold", type=float, default=0.25,
                      metavar="REL",
                      help="AND-gate on the host verdict: also need "
                           "this relative excess over the peer median "
                           "(default 0.25 = +25%%)")
    p_fr.add_argument("--min-hosts", type=int, default=3,
                      metavar="N",
                      help="hosts that must have measured a point "
                           "before it is cross-host graded (default 3; "
                           "two hosts cannot outvote each other)")
    p_fr.add_argument("--shift-threshold", type=float, default=0.25,
                      metavar="REL",
                      help="fleet-median move vs --baseline that flags "
                           "a fleet-wide shift (default 0.25 = +25%%)")
    p_fr.add_argument("--drain-hook", default=None, metavar="CMD",
                      help="run this shell command once per graded-sick "
                           "host (the host name appended as one quoted "
                           "argument and exported as "
                           "TPU_PERF_SICK_HOST), so exit 9 ACTS — e.g. "
                           "--drain-hook 'kubectl drain'.  Rate-limited "
                           "per host (--drain-interval) through a "
                           ".drain-state.json sidecar in the fleet "
                           "root; executions are spanned and recorded "
                           "as drain records (with -l), failures "
                           "health-evented — and never fatal to the "
                           "report")
    p_fr.add_argument("--drain-interval", type=float, default=3600.0,
                      metavar="SEC",
                      help="minimum seconds between drain-hook "
                           "invocations for one host (default 3600): a "
                           "cron'd report must not re-drain a host "
                           "every pass")
    p_fr.add_argument("--push", default=None, metavar="URL",
                      help="also POST the rollup records (NDJSON) to "
                           "this push-plane endpoint "
                           "(URL/v1/FleetRollupTPU) — the live "
                           "counterpart of the -l fleet-*.log write; "
                           "one-shot, loud on failure, never fatal.  "
                           "Merged selection records (see --tune-out) "
                           "ride the same pass to "
                           "URL/v1/TuneSelectionTPU")
    p_fr.add_argument("--tune-out", default=None, metavar="PATH",
                      help="also fold every host's crossover winner "
                           "table into ONE merged fleet selection "
                           "artifact (majority winners; hosts whose "
                           "local winner disagrees are named in the "
                           "report) and write it here — `--algo auto` "
                           "food, like `tpu-perf-torch tune` but fleet-wide")
    p_fr.set_defaults(func=_cmd_fleet_report)
    p_ft = fleet_sub.add_parser(
        "timeline",
        help="stitch every host's spans-*.log into one Perfetto view "
             "(clock-aligned on heartbeat boundaries; one process "
             "track per (host, rank))",
    )
    p_ft.add_argument("root", help="fleet root directory")
    p_ft.add_argument("-o", "--output", default=None, metavar="PATH",
                      help="write the trace JSON here (atomically) "
                           "instead of stdout")
    p_ft.add_argument("--check", action="store_true",
                      help="audit join completeness per host folder "
                           "(exit 7 on any incomplete join)")
    p_ft.add_argument("--no-align", action="store_true",
                      help="skip clock alignment (raw per-process "
                           "clocks)")
    p_ft.set_defaults(func=_cmd_fleet_timeline)



    p_lint = sub.add_parser(
        "lint",
        help="static invariant analyzer (tpu_perf_torch.analysis): prove the "
             "determinism (R1), lockstep (R2), family-contract (R3), "
             "schema-drift (R4), and guarded-by (R5) contracts at parse "
             "time; exit 8 on any unbaselined finding",
    )
    p_lint.add_argument("root", nargs="?", default=None,
                        help="tree to lint (default: the repo root "
                             "containing the tpu_perf_torch package)")
    p_lint.add_argument("--manifest", default=None, metavar="PATH",
                        help="zone manifest (default: the checked-in "
                             "tpu_perf_torch/analysis/manifest.json)")
    p_lint.add_argument("--rule", action="append", default=None,
                        metavar="ID",
                        help="run only these rules (id or name, "
                             "comma-splittable, repeatable; default all)")
    p_lint.add_argument("--format", choices=("text", "json"),
                        default="text",
                        help="json = the machine-consumption schema "
                             "documented in docs/design.md")
    p_lint.add_argument("--baseline", default=None, metavar="PATH",
                        help="fingerprint baseline: findings listed there "
                             "do not fail the lint (the shipped "
                             "tpu_perf_torch/analysis/baseline.json is empty "
                             "by contract)")
    p_lint.add_argument("--write-baseline", action="store_true",
                        help="write the current findings to --baseline "
                             "and exit 0 (adopting the linter on a "
                             "pre-existing tree)")
    p_lint.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog with per-rule docs")
    p_lint.set_defaults(func=_cmd_lint)

    p_tune = sub.add_parser(
        "tune",
        help="close the measure->select loop: fold arena/contend rows into "
             "the versioned selection artifact `--algo auto` reads, or "
             "(--check) re-grade fresh rows against a published artifact "
             "and exit 10 on crossover drift")
    p_tune.add_argument("-d", "--logdir", required=True, metavar="TARGET",
                        help="rows to fold: a log folder (its tpu-*.log "
                             "files, the active .open included), one file, "
                             "or a glob, as `report` takes")
    p_tune.add_argument("-o", "--output", default="selection.json",
                        metavar="PATH",
                        help="artifact path (atomic write; default "
                             "selection.json); ignored under --check")
    p_tune.add_argument("--check", default=None, metavar="ARTIFACT",
                        help="drift gate: re-grade the fresh rows' verdicts "
                             "against this published artifact and exit 10 "
                             "when a measured crossover moved against it "
                             "with a convincing margin (--margin)")
    p_tune.add_argument("--margin", type=float, default=1.02,
                        metavar="RATIO",
                        help="--check's noise floor: a flip counts only "
                             "when the fresh winner's best-vs-runner-up "
                             "p50 ratio clears RATIO (default 1.02)")
    p_tune.add_argument("-l", "--logfolder", default=None,
                        help="also persist the artifact as tune-*.log "
                             "records (swept by `ingest` into "
                             "TuneSelectionTPU)")
    p_tune.add_argument("--push", default=None, metavar="URL",
                        dest="push_url",
                        help="also POST the artifact records (NDJSON) to "
                             "URL/v1/TuneSelectionTPU; one shot, loud on "
                             "failure, never fatal")
    p_tune.set_defaults(func=_cmd_tune)

    p_ops = sub.add_parser("ops", help="list measurement ops")
    p_ops.set_defaults(func=_cmd_ops)

    p_chips = sub.add_parser(
        "chips", help="print the card spec table (tpu_perf_torch.chips) and "
                      "the entry the detected card resolves to")
    p_chips.add_argument("--kind", default=None,
                         help="resolve this device name instead of the "
                              "detected card's (e.g. 'NVIDIA H100 PCIe')")
    p_chips.set_defaults(func=_cmd_chips)

    p_self = sub.add_parser("selftest",
                            help="validate every op's payload numerics")
    p_self.add_argument("-b", "--size", default="4096", help="buffer size")
    p_self.add_argument("-i", "--iters", type=int, default=1,
                        help="chained iterations (exercises the carry)")
    p_self.add_argument("--ops", default=None, help="comma-separated subset")
    _add_mesh_flags(p_self)
    _add_world_flags(p_self)
    p_self.set_defaults(func=_cmd_selftest)

    p_bench = sub.add_parser("bench", help="headline benchmark (one JSON line)")
    p_bench.add_argument("--device", choices=("cuda", "cpu"), default=None)
    p_bench.set_defaults(func=_cmd_bench)
    return parser


@contextlib.contextmanager
def _world_scope():
    """Around a command: leave the distributed world it joined when it
    ends (``multihost.leave_world``).  On success the ranks meet at a
    barrier before the group goes; when the command raises, the group goes
    without one (a peer may never arrive) and the command's own error
    propagates, whatever the teardown does.  A group joined before the
    command is left alone, and a command that never loaded
    ``torch.distributed`` (``--backend mpi``, ``ingest``) joined none."""

    def joined() -> bool:
        if "torch.distributed" not in sys.modules:
            return False
        from tpu_perf_torch.parallel.multihost import joined

        return joined()

    before = joined()
    try:
        yield
    except BaseException:
        if not before and joined():
            from tpu_perf_torch.parallel import leave_world

            with contextlib.suppress(Exception):
                leave_world(barrier=False)
        raise
    if not before and joined():
        from tpu_perf_torch.parallel import leave_world

        leave_world()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        with _world_scope():
            rc = args.func(args)
            sys.stdout.flush()
        return rc
    except (ValueError, NotImplementedError) as e:
        print(f"tpu-perf-torch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
