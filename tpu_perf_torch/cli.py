"""Command-line interface (port of the ``run``, ``monitor``, ``contend``,
``ingest``, ``report``, ``grid``, ``ops``, ``chips``, ``selftest`` and
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
    python -m tpu_perf_torch ops
    python -m tpu_perf_torch chips
    python -m tpu_perf_torch selftest
    python -m tpu_perf_torch bench
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from tpu_perf_torch.config import (
    BACKENDS, DEF_ITERS, DEF_SIM_RANKS, DEFAULT_LOG_DIR, FENCE_MODES,
    HEARTBEAT_FORMATS, LOG_REFRESH_TIME_SEC, Options,
)
from tpu_perf_torch.extern_launch import DEFAULT_TEMPLATE
from tpu_perf_torch.schema import RESULT_HEADER
from tpu_perf_torch.sweep import DEF_BUF_SZ, format_size, parse_size


class _ZeroOne(argparse.Action):
    """Reference-style boolean flag: bare ``-u`` means on, ``-u 0``/``-u 1``
    are the reference's explicit spelling (mpi_perf.c:312,322)."""

    def __init__(self, option_strings, dest, **kwargs):
        super().__init__(option_strings, dest, nargs="?", const="1",
                         default=False, choices=("0", "1"), **kwargs)

    def __call__(self, parser, namespace, value, option_string=None):
        setattr(namespace, self.dest, (value or "1") == "1")


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
    kw = dict(
        logfolder=args.logfolder, iters=args.iters, ppn=args.ppn,
        buff_sz=parse_size(args.size), num_runs=args.runs, op=args.op,
        uni_dir=args.unidir, nonblocking=args.nonblocking,
        extern_cmd=args.extern_cmd, window=args.window,
        group1_file=args.group1_file, n_group1=args.group1_hosts,
        backend=args.backend, heartbeat_format=args.heartbeat_format,
        sweep=args.sweep,
        dtype=args.dtype, fence=args.fence, fused_chunks=args.fused_chunks,
        measure_dispatch=args.measure_dispatch, profile_dir=args.profile_dir,
        max_runs=args.max_runs,
        stats_every=args.stats_every, log_refresh_sec=args.log_refresh_sec,
        streams=args.streams, sim_ranks=_sim_ranks(args), device=args.device,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes,
        distributed=args.distributed, hybrid_mesh=args.hybrid_mesh,
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

    from tpu_perf_torch.driver import Driver

    ingest = None
    if opts.logfolder:
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
    """The rows as one rectangular CSV table: lane rows (``--streams``)
    carry the trailing columns up to ``stream``, loaded rows (``contend``)
    up to ``load``, and every row pads to the header's width."""
    header = RESULT_HEADER
    if any(r.load for r in rows):
        header += ",span_id,algo,skew_us,imbalance,stream,load"
    elif any(r.stream > 0 for r in rows):
        header += ",span_id,algo,skew_us,imbalance,stream"
    width = header.count(",") + 1
    print(header)
    for row in rows:
        parts = row.to_csv().split(",")
        print(",".join(parts + [""] * (width - len(parts))))


def _cmd_contend(args: argparse.Namespace) -> int:
    """The contention race (tpu_perf_torch.streams.contend): a victim op
    against a concurrent load on the stream engine's lanes, a compute
    kernel (--load mxu_gemm / hbm_stream) or a sibling op (--load OP).
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
    refused = [
        (args.victim_axis is not None or args.load_axis is not None,
         "--victim-axis / --load-axis need the multi-card world"),
        (args.distributed or args.hybrid_mesh or bool(args.mesh),
         "contend in a multi-rank world or on a mesh"),
        (args.synthetic is not None,
         "--synthetic needs the fault injector's seeded series"),
        (args.algo != "native", f"--algo {args.algo} needs the arena"),
    ]
    for hit, why in refused:
        if hit:
            raise NotImplementedError(f"{why}: not yet ported, see ROADMAP")
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
    opts = _options_from(
        args, load=f"split:{args.split}" if args.split else args.load)
    rows = run_contend(opts)
    if opts.logfolder:
        # the rotating extended-row family, so `report <folder>` renders
        # the interference matrix from this job
        from tpu_perf_torch.driver import RotatingCsvLog

        log = RotatingCsvLog(opts.logfolder, opts.uuid, 0,
                             refresh_sec=opts.log_refresh_sec,
                             prefix=EXT_PREFIX)
        for row in rows:
            log.write_row(row)
        log.close()
    if args.csv or not opts.logfolder:
        _print_rows(rows)
    from tpu_perf_torch.report import aggregate, interference_matrix

    for cell in interference_matrix(aggregate(rows)):
        slow = "—" if cell.slowdown is None else f"{cell.slowdown:.3g}x"
        print(f"[tpu-perf-torch contend] {cell.op} @ {cell.nbytes} B under "
              f"{cell.load}: slowdown {slow}", file=sys.stderr)
    return 0


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

    if args.legacy:
        if (args.compare or args.compare_pallas or args.diff is not None
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
        if args.compare or args.compare_pallas or args.format != "markdown":
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
    points = report.stream_aggregate(paths)
    if args.compare or args.compare_pallas:
        if args.format != "markdown" or (args.compare and args.compare_pallas):
            print("tpu-perf-torch: error: --compare/--compare-pallas render "
                  "markdown only and are mutually exclusive", file=sys.stderr)
            return 2
        if args.compare_pallas:
            print(report.compare_pallas_to_markdown(
                report.compare_pallas(points)))
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
    return 0


def _cmd_grid(args: argparse.Namespace) -> int:
    from tpu_perf_torch.config import new_job_id
    from tpu_perf_torch.grid import grid_caption, grid_to_markdown, run_grid

    world = _sim_world(args)
    source = ("--spec-tflops" if args.spec_tflops is not None
              else "--spec-gbps" if args.spec_gbps is not None
              else "not given")
    if args.chip_spec_family:
        # the card table's peak for the judged metric (and, for mxu, the
        # run's dtype); explicit flags win.  An unknown card raises.
        from tpu_perf_torch.chips import card_peak, card_spec

        spec = card_spec()
        peak = card_peak(spec, args.chip_spec_family, args.dtype)
        if args.chip_spec_family == "hbm":
            if args.spec_gbps is None:
                args.spec_gbps = peak
                source = f"{spec.device_name}, card table"
            if args.floor_gbps is None:
                args.floor_gbps = spec.stream_floor_gbps
        elif args.spec_tflops is None:
            args.spec_tflops = peak
            source = f"{spec.device_name}, card table, {args.dtype}"
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
    print("| card | torch device name | HBM GB/s | bf16 dense TFLOP/s "
          "| f32 TFLOP/s | stream floor |")
    print("|---|---|---|---|---|---|")
    for spec in CARDS.values():
        mark = " (detected)" if spec is found else ""
        floor = ("not measured" if spec.stream_floor_gbps is None
                 else f"{spec.stream_floor_gbps:g}")
        print(f"| {spec.kind}{mark} | {spec.device_name} | {spec.hbm_gbps:g} "
              f"| {spec.bf16_tflops:g} | {spec.f32_tflops:g} | {floor} |")
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
    p.add_argument("--sweep", default=None,
                   help="size sweep, e.g. 8:1G or 8,64K,4M")
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
                        "measured runs (the soak/CI safety valve)")
    p.add_argument("--stats-every", type=int, default=1000)
    p.add_argument("--heartbeat-format", choices=HEARTBEAT_FORMATS,
                   default="human",
                   help="stderr heartbeat format; json emits one machine-"
                        "readable object per stats boundary")
    p.add_argument("--log-refresh-sec", type=int,
                   default=LOG_REFRESH_TIME_SEC)
    p.add_argument("--csv", action="store_true",
                   help="print extended rows as CSV to stdout")
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
                        help="take the judged metric's ceiling from the "
                             "detected card's entry (tpu_perf_torch.chips): "
                             "hbm = busbw against its device-memory peak, "
                             "mxu = TFLOP/s against its product peak for "
                             "--dtype (bf16/f16: tensor cores; f32: the "
                             "float32 rate, TF32 off); explicit --spec-gbps "
                             "/ --spec-tflops override")
    p_grid.add_argument("--spec-gbps", type=float, default=None,
                        help="physical busbw ceiling (H100 SXM: 3350); p50 "
                             "above it = unphysical")
    p_grid.add_argument("--floor-gbps", type=float, default=None,
                        help="plateau floor; p50 below it = degraded (none "
                             "by default: no floor is defended yet)")
    p_grid.add_argument("--spec-tflops", type=float, default=None,
                        help="judge cells on TFLOP/s against this compute "
                             "ceiling instead of bus bandwidth (H100 SXM "
                             "bf16: 989, f32: 67); compute instruments only")
    p_grid.add_argument("--floor-tflops", type=float, default=None,
                        help="compute plateau floor; p50 below it = "
                             "degraded (none by default)")
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
             "compute kernel (--load mxu_gemm/hbm_stream) or a sibling op "
             "(--load OP); every point is measured idle and loaded so "
             "`report` renders the interference matrix")
    _add_run_flags(p_ct)
    p_ct.add_argument("--load", default="", metavar="OP",
                      help="background load: a compute kernel (mxu_gemm, "
                           "hbm_stream) or any op from `ops`")
    p_ct.add_argument("--split", type=int, default=0, metavar="K",
                      help="split-channel lanes (not yet ported)")
    p_ct.add_argument("--victim-axis", default=None, metavar="AXIS",
                      help="the victim's mesh axis (not yet ported)")
    p_ct.add_argument("--load-axis", default=None, metavar="AXIS",
                      help="the load's mesh axis (not yet ported)")
    p_ct.add_argument("--synthetic", type=float, default=None,
                      metavar="SECONDS",
                      help="seeded synthetic samples (not yet ported)")
    p_ct.add_argument("--algo", default="native",
                      help="the victim's decomposition (only native is "
                           "ported)")
    # the default victim: the bandwidth-bound collective the interference
    # question is usually asked about
    p_ct.set_defaults(func=_cmd_contend, op="allreduce")

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
