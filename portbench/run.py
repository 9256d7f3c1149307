"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--dtype <dtype>]

from the root of a checkout that holds the port (``tpu_perf_torch``).
The last line on standard output is one JSON object; the numbers compared
for ``correct`` are the last lines on standard error.  ``--dtype``
replaces the configuration's dtype: the lower-precision control, which
the benchmark's own runs never use.  Exits 2, printing no result, when
the card or the cards the cell asks for are missing, and 1 on any other
failure.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout's root, not this folder, is where the packages are found
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))
# Triton's kernel cache at a fixed path inside the checkout, so only a
# checkout's first run compiles (the nvcc libraries are the port's own
# tpu_perf_torch/_build/)
os.environ["TRITON_CACHE_DIR"] = str(HERE / "_cache" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    line = harness.run(cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), t0=T0, device="cuda",
                       dtype=args.dtype)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
