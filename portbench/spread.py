"""Medians and quartile spreads of result lines, the figures the bounds
are set from:

    python3 portbench/spread.py RESULT_FILE...

Each file holds one run's standard output; its last line is the result.
Prints, per metric, the runs' values, their median and their spread (the
distance between the first and third quartile over the median, as
``statistics.quantiles(values, n=4)`` gives them), and the widest
compared number beside its limit.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.arith import quartile_spread  # noqa: E402


def main(paths: list[str]) -> None:
    lines = [json.loads(Path(p).read_text().strip().splitlines()[-1])
             for p in paths]
    names = sorted({m for line in lines for m in line["metrics"]})
    for m in names:
        vals = [line["metrics"][m]["value"] for line in lines
                if m in line["metrics"]]
        spread = quartile_spread(vals) if len(vals) > 1 else 0.0
        print(f"{m}: n={len(vals)} median={statistics.median(vals)!r} "
              f"spread={spread!r} values={vals!r}")
    for key in lines[0]["checks"]:
        worst = max(line["checks"][key]["value"] for line in lines)
        print(f"{key}: widest {worst!r} limit "
              f"{lines[0]['checks'][key]['limit']!r}; correct "
              f"{sum(line['correct'] for line in lines)}/{len(lines)}")


if __name__ == "__main__":
    main(sys.argv[1:])
