"""Message-size sweep generation (copy of ``tpu_perf/sweep.py``'s sweep
parser).

The reference benchmarks a single buffer size per invocation
(``DEF_BUF_SZ = 456131`` at mpi_perf.c:14; 4 MiB in scripts/run-1-pair.sh:9).
Sweeps are powers of two plus those two legacy sizes, so rows stay
comparable with the reference's and with the JAX package's curve keys.
"""

from __future__ import annotations

import re

#: mpi_perf.c:14 — the reference's default (and monitoring-profile) buffer size.
DEF_BUF_SZ = 456131
#: scripts/run-1-pair.sh:9 — the reference's bandwidth-profile buffer size.
LEGACY_BW_BUF_SZ = 4 * 1024 * 1024

_SUFFIX = {"": 1, "K": 1024, "M": 1024**2, "G": 1024**3}


def parse_size(text: str) -> int:
    """Parse a human size like ``8``, ``64K``, ``4M``, ``1G`` into bytes."""
    m = re.fullmatch(r"\s*(\d+)\s*([KMGkmg]?)[iI]?[bB]?\s*", str(text))
    if not m:
        raise ValueError(f"unparseable size: {text!r}")
    return int(m.group(1)) * _SUFFIX[m.group(2).upper()]


def sweep_sizes(
    lo: int = 8,
    hi: int = 1024**3,
    *,
    align: int = 1,
) -> list[int]:
    """Powers-of-two sweep in ``[lo, hi]`` plus the legacy reference points.

    ``align`` rounds every size up to a multiple (e.g. 4 for float32 payloads)
    so a size always maps to a whole number of elements.
    """
    if lo <= 0 or hi < lo:
        raise ValueError(f"bad sweep range [{lo}, {hi}]")
    sizes = set()
    n = 1
    while n < lo:
        n *= 2
    while n <= hi:
        sizes.add(n)
        n *= 2
    for legacy in (DEF_BUF_SZ, LEGACY_BW_BUF_SZ):
        if lo <= legacy <= hi:
            sizes.add(legacy)
    if align > 1:
        sizes = {-(-s // align) * align for s in sizes}
    return sorted(sizes)


def parse_sweep(spec: str, *, align: int = 1) -> list[int]:
    """Parse a CLI sweep spec.

    Accepted forms::

        "8:1G"          lo:hi powers-of-two sweep (plus legacy points)
        "4M"            single size
        "8,64K,4M"      explicit comma list
    """
    spec = spec.strip()
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return sweep_sizes(parse_size(lo), parse_size(hi), align=align)
    if "," in spec:
        sizes = sorted({parse_size(s) for s in spec.split(",") if s.strip()})
    else:
        sizes = [parse_size(spec)]
    if align > 1:
        sizes = sorted({-(-s // align) * align for s in sizes})
    return sizes
