"""Command-line interface (port of the ``run``, ``grid``, ``ops``,
``chips``, ``selftest`` and ``bench`` subcommands of ``tpu_perf/cli.py``).

Flag letters keep the reference's meanings (mpi_perf.c:273-339) where the
port has them: ``-i`` iters, ``-b`` buffer size, ``-r`` runs, ``-l`` log
folder, ``-u`` unidirectional with a 1-byte ack, ``-x`` non-blocking
exchange; the default op is the reference's blocking ping-pong.
Additions: ``--sim-ranks`` (ranks of the single-card sim world) and
``--device`` (``cuda``, the default, or ``cpu`` for the plain PyTorch
versions)::

    python -m tpu_perf_torch run            # pingpong at 456131 B, 8 ranks
    python -m tpu_perf_torch run -u         # pingpong_unidir
    python -m tpu_perf_torch run -x         # exchange
    python -m tpu_perf_torch run --op pl_allreduce --sweep 4K:256M
    python -m tpu_perf_torch run --op all_to_all --sweep 4K:256M
    python -m tpu_perf_torch run --op pl_all_gather_bidir --sweep 4K:256M
    python -m tpu_perf_torch grid --op pl_hbm_copy,hbm_stream --sizes 256M,1G \
        --iters 8,32 --spec hbm --sim-ranks 1
    python -m tpu_perf_torch ops
    python -m tpu_perf_torch chips
    python -m tpu_perf_torch selftest
    python -m tpu_perf_torch bench
"""

from __future__ import annotations

import argparse
import sys

from tpu_perf_torch.config import (
    DEF_ITERS, DEF_SIM_RANKS, FENCE_MODES, Options,
)
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
    p.add_argument("--sim-ranks", type=int, default=DEF_SIM_RANKS,
                   help="ranks of the single-card sim world (rows of one "
                        "allocation; rows carry backend torch-sim when > 1)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (default) runs the kernels on the card; cpu "
                        "runs their plain PyTorch versions")
    p.add_argument("--dtype", default="float32")


def _cmd_run(args: argparse.Namespace) -> int:
    from tpu_perf_torch.driver import Driver

    opts = Options(
        logfolder=args.logfolder, iters=args.iters,
        buff_sz=parse_size(args.size), num_runs=args.runs, op=args.op,
        uni_dir=args.unidir, nonblocking=args.nonblocking, sweep=args.sweep,
        dtype=args.dtype, fence=args.fence,
        stats_every=args.stats_every, log_refresh_sec=args.log_refresh_sec,
        sim_ranks=args.sim_ranks, device=args.device,
    )
    rows = Driver(opts).run()
    if args.csv or not opts.logfolder:
        print(RESULT_HEADER)
        for row in rows:
            print(row.to_csv())
    return 0


def _cmd_grid(args: argparse.Namespace) -> int:
    from tpu_perf_torch.config import new_job_id
    from tpu_perf_torch.grid import grid_caption, grid_to_markdown, run_grid
    from tpu_perf_torch.world import SimWorld, resolve_device

    if (args.chip_spec_family == "mxu" or args.spec_tflops is not None
            or args.floor_tflops is not None):
        raise NotImplementedError(
            "compute grids (--spec mxu, --spec-tflops, --floor-tflops) are "
            "not yet ported: they wait for mxu_gemm; see ROADMAP")
    world = SimWorld(args.sim_ranks, resolve_device(args.device))
    source = "--spec-gbps" if args.spec_gbps is not None else "not given"
    if args.chip_spec_family == "hbm":
        # the card table's defaults for the judged metric; explicit flags win
        from tpu_perf_torch.chips import card_spec

        if args.spec_gbps is None:
            spec = card_spec()
            args.spec_gbps = spec.hbm_gbps
            source = f"{spec.device_name}, card table"
            if args.floor_gbps is None:
                args.floor_gbps = spec.stream_floor_gbps
    sizes = [parse_size(s) for s in args.sizes.split(",") if s.strip()]
    iters_list = [int(s) for s in args.iters.split(",") if s.strip()]
    if not sizes or not iters_list:
        raise ValueError("grid needs at least one size and one iters value")

    def progress(cell):
        print(f"[grid] {cell.op} {format_size(cell.nbytes)} x{cell.iters}: "
              f"p50 {cell.p50:.1f} GB/s -> {cell.verdict}",
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
                         on_cell=progress, on_rows=on_rows, job_id=job_id)
    finally:
        if grid_log is not None:
            grid_log.close()
    print(grid_caption(args.spec_gbps, args.floor_gbps, source))
    print(grid_to_markdown(cells, fence=args.fence))
    chosen_by_op = {c.op: c for c in cells if c.chosen}
    for c in chosen_by_op.values():
        print(f"tpu-perf-torch: chosen operating point: {c.op} "
              f"{format_size(c.nbytes)} x{c.iters} ({c.p50:.1f} GB/s p50)",
              file=sys.stderr)
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
    from tpu_perf_torch.world import SimWorld, resolve_device

    world = SimWorld(args.sim_ranks, resolve_device(args.device))
    ops = [o.strip() for o in args.ops.split(",") if o.strip()] if args.ops else None
    results = run_selftest(world, ops=ops, nbytes=parse_size(args.size),
                           dtype=args.dtype, iters=args.iters)
    print(format_results(results))
    return 1 if any(r.status == "fail" for r in results) else 0


def _cmd_bench(args: argparse.Namespace) -> int:
    from tpu_perf_torch.bench import main as bench_main

    bench_main(args.device)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tpu-perf-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="one-shot benchmark / sweep")
    p_run.add_argument("-l", "--logfolder", default=None,
                       help="CSV log folder (rotating tcp-*/tpu-* logs)")
    p_run.add_argument("-i", "--iters", type=int, default=DEF_ITERS,
                       help="chained executions per run")
    p_run.add_argument("-b", "--size", default=str(DEF_BUF_SZ),
                       help="buffer size (e.g. 4M)")
    p_run.add_argument("-u", "--unidir", action=_ZeroOne,
                       help="unidirectional + ack kernel (pingpong_unidir)")
    p_run.add_argument("-r", "--runs", type=int, default=1, help="measured runs")
    p_run.add_argument("-x", "--nonblocking", action=_ZeroOne,
                       help="both directions at once (exchange)")
    p_run.add_argument("--op", default="pingpong",
                       help="measurement op (see `ops`); -u / -x pick the "
                            "kernel when it is the default pingpong")
    p_run.add_argument("--sweep", default=None, help="size sweep, e.g. 8:1G or 8,64K,4M")
    p_run.add_argument("--fence", choices=FENCE_MODES, default="block",
                       help="timing fence (tpu_perf_torch.timing); fused and "
                            "auto are not yet ported")
    p_run.add_argument("--stats-every", type=int, default=1000)
    p_run.add_argument("--log-refresh-sec", type=int, default=900)
    p_run.add_argument("--csv", action="store_true",
                       help="print extended rows as CSV to stdout")
    _add_world_flags(p_run)
    p_run.set_defaults(func=_cmd_run)

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
                        help="hbm: judge busbw against the detected card's "
                             "device-memory peak (tpu_perf_torch.chips); "
                             "mxu is not yet ported; explicit --spec-gbps / "
                             "--floor-gbps override")
    p_grid.add_argument("--spec-gbps", type=float, default=None,
                        help="physical busbw ceiling (H100 SXM: 3350); p50 "
                             "above it = unphysical")
    p_grid.add_argument("--floor-gbps", type=float, default=None,
                        help="plateau floor; p50 below it = degraded (none "
                             "by default: no floor is defended yet)")
    p_grid.add_argument("--spec-tflops", type=float, default=None,
                        help="compute grids: not yet ported")
    p_grid.add_argument("--floor-tflops", type=float, default=None,
                        help="compute grids: not yet ported")
    p_grid.add_argument("-l", "--logfolder", default=None,
                        help="also write every cell's raw rows here "
                             "(extended schema)")
    _add_world_flags(p_grid)
    p_grid.set_defaults(func=_cmd_grid)

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
    _add_world_flags(p_self)
    p_self.set_defaults(func=_cmd_selftest)

    p_bench = sub.add_parser("bench", help="headline benchmark (one JSON line)")
    p_bench.add_argument("--device", choices=("cuda", "cpu"), default=None)
    p_bench.set_defaults(func=_cmd_bench)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        rc = args.func(args)
        sys.stdout.flush()
        return rc
    except (ValueError, NotImplementedError) as e:
        print(f"tpu-perf-torch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
