"""Compare two checkouts of the PyTorch port on one card, run for run.

    python -m tpu_perf_torch.tools.compare_trees BASE CHANGE \\
        --op pl_hbm_copy:1,pl_ring:8,pl_exchange:8 [--sweep 4K:256M]
        [-i 5] [-r 3] [--at 4K,256M] [--out FILE] [--device cpu]

For each ``op:ranks`` runs ``python -m tpu_perf_torch run --op OP --sweep
SWEEP -i I -r R --sim-ranks RANKS`` from the root of each checkout, in the
order BASE, CHANGE, CHANGE, BASE, so that a drift of the card over the
call weighs on both alike.  Prints, for each op and size of ``--at``, the
median over the rows of both turns of time_ms, lat_us and busbw_gbps for
each checkout, and writes every row to ``--out`` (JSON lines) when given.
Both checkouts must hold the port; the card's name and power limit lead
the output.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import os
import statistics
import subprocess
import sys

UNITS = {"K": 1024, "M": 1024**2, "G": 1024**3}


def parse_size(text: str) -> int:
    text = text.strip().upper()
    if text[-1] in UNITS:
        return int(text[:-1]) * UNITS[text[-1]]
    return int(text)


def run_rows(tree: str, op: str, ranks: int, args) -> tuple[list[dict], float]:
    """The rows of one run from checkout ``tree``, and its wall seconds."""
    import time

    cmd = [sys.executable, "-m", "tpu_perf_torch", "run", "--op", op,
           "--sweep", args.sweep, "-i", str(args.iters), "-r", str(args.runs),
           "--sim-ranks", str(ranks), "--csv"]
    if args.device:
        cmd += ["--device", args.device]
    env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                          text=True)
    wall = time.perf_counter() - t0
    if done.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} in {tree} exited "
                           f"{done.returncode}:\n{done.stderr[-4000:]}")
    lines = [ln for ln in done.stdout.splitlines() if ln.strip()]
    start = next(i for i, ln in enumerate(lines) if ln.startswith("timestamp,"))
    return list(csv.DictReader(io.StringIO("\n".join(lines[start:])))), wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--op", required=True,
                    help="comma-separated op:ranks, e.g. pl_ring:8")
    ap.add_argument("--sweep", default="4K:256M")
    ap.add_argument("-i", "--iters", type=int, default=5)
    ap.add_argument("-r", "--runs", type=int, default=3)
    ap.add_argument("--at", default="4K,256M",
                    help="sizes per rank whose medians are printed")
    ap.add_argument("--out", default=None, help="JSON lines of every row")
    ap.add_argument("--device", default=None,
                    help="passed to run (cpu for a rehearsal without a card)")
    args = ap.parse_args(argv)

    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, check=True).stdout.strip())
    trees = {"base": args.base, "change": args.change}
    at = [parse_size(s) for s in args.at.split(",")]
    out = open(args.out, "w") if args.out else None
    for spec in args.op.split(","):
        op, ranks = spec.split(":")
        got: dict[str, list[dict]] = {"base": [], "change": []}
        for turn, which in enumerate(("base", "change", "change", "base")):
            rows, wall = run_rows(trees[which], op, int(ranks), args)
            got[which] += rows
            print(f"{op} x{ranks} turn {turn} {which}: {len(rows)} rows in "
                  f"{wall:.1f} s", flush=True)
            if out:
                for r in rows:
                    out.write(json.dumps({"tree": which, "turn": turn, **r})
                              + "\n")
        for size in at:
            for which in ("base", "change"):
                # the op rounds its size, so take the rows nearest the ask
                sizes = {int(r["nbytes"]) for r in got[which]}
                near = min(sizes, key=lambda s: abs(s - size))
                rows = [r for r in got[which] if int(r["nbytes"]) == near]
                med = {k: statistics.median(float(r[k]) for r in rows)
                       for k in ("time_ms", "lat_us", "busbw_gbps")}
                print(f"{op} x{ranks} {near} B {which}: median of "
                      f"{len(rows)} rows: time_ms {med['time_ms']:.4f} "
                      f"lat_us {med['lat_us']:.2f} busbw_gbps "
                      f"{med['busbw_gbps']:.2f}; per row "
                      f"{[round(float(r['time_ms']), 4) for r in rows]}")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
