"""Command-line interface (port of the ``run``, ``ops``, ``selftest`` and
``bench`` subcommands of ``tpu_perf/cli.py``).

Flag letters keep the reference's meanings (mpi_perf.c:273-339) where the
slice has them: ``-i`` iters, ``-b`` buffer size, ``-r`` runs, ``-l`` log
folder.  Additions: ``--sim-ranks`` (ranks of the single-card sim world)
and ``--device`` (``cuda``, the default, or ``cpu`` for the plain PyTorch
versions)::

    python -m tpu_perf_torch run --op pl_allreduce --sweep 4K:256M
    python -m tpu_perf_torch ops
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
from tpu_perf_torch.sweep import DEF_BUF_SZ, parse_size


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
        sweep=args.sweep, dtype=args.dtype, fence=args.fence,
        stats_every=args.stats_every, log_refresh_sec=args.log_refresh_sec,
        sim_ranks=args.sim_ranks, device=args.device,
    )
    rows = Driver(opts).run()
    if args.csv or not opts.logfolder:
        print(RESULT_HEADER)
        for row in rows:
            print(row.to_csv())
    return 0


def _cmd_ops(_args: argparse.Namespace) -> int:
    from tpu_perf_torch.ops.collectives import known_ops
    from tpu_perf_torch.ops.pallas_ring import PALLAS_OPS, PORTED_OPS

    for name in known_ops():
        unported = name in PALLAS_OPS and name not in PORTED_OPS
        print(f"{name}  (not yet ported)" if unported else name)
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
    p_run.add_argument("-r", "--runs", type=int, default=1, help="measured runs")
    p_run.add_argument("--op", default="pl_allreduce",
                       help="measurement op (see `ops`)")
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

    p_ops = sub.add_parser("ops", help="list measurement ops")
    p_ops.set_defaults(func=_cmd_ops)

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
