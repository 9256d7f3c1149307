"""The zone manifest: which invariants apply where.

The manifest is a checked-in JSON file (``tpu_perf_torch/analysis/
manifest.json`` for this repo) — the analyzer's *declared* contract
surface, reviewed like code.  It names the deterministic zones (R1), the
collective call names and taint sources (R2), and the files/constants
that carry the family and row-schema contracts (R3/R4).  Rules read the
manifest instead of hard-coding repo paths, so the same engine lints the
fixture trees the test suite builds and any downstream fork's layout.

All paths are POSIX-relative to the lint root.  A zone entry ending in
``/`` covers the subtree; otherwise it names one file.
"""

from __future__ import annotations

import dataclasses
import json
import os

#: wall-clock / entropy calls banned in deterministic zones (canonical
#: dotted names after alias resolution — astutil.dotted_name)
DEFAULT_CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns", "time.clock_gettime", "time.clock_gettime_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
})

#: module prefixes whose *global-state* RNG calls are banned in zones;
#: seeded constructors (random.Random(x), numpy.random.default_rng(x))
#: are the sanctioned alternative and stay legal WITH arguments
DEFAULT_RNG_PREFIXES = ("random.", "numpy.random.", "secrets.")
DEFAULT_SEEDED_CTORS = frozenset({
    "random.Random", "numpy.random.default_rng", "numpy.random.RandomState",
    "numpy.random.Generator", "numpy.random.PCG64", "numpy.random.Philox",
    "numpy.random.SeedSequence",
})

DEFAULT_CLOCK_PARAMS = frozenset({"perf_clock", "clock", "perf_ns"})

DEFAULT_COLLECTIVES = frozenset({
    "allreduce_times", "process_allgather", "psum", "psum_scatter",
    "all_gather", "all_to_all", "ppermute", "should_stop",
})

DEFAULT_RANK_NAMES = frozenset({
    "rank", "process_index", "local_rank", "host_id", "local_ip",
})


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Parsed manifest + defaults.  ``root`` is the directory every
    relative path resolves against."""

    root: str
    source_path: str = "<manifest>"  # where the manifest was loaded
    #                                  from (root-relative when inside
    #                                  the root) — R6's finding anchor
    include: tuple[str, ...] = ("tpu_perf_torch/**/*.py",)
    exclude: tuple[str, ...] = ()
    deterministic_zones: tuple[str, ...] = ()
    clock_calls: frozenset[str] = DEFAULT_CLOCK_CALLS
    rng_prefixes: tuple[str, ...] = DEFAULT_RNG_PREFIXES
    seeded_ctors: frozenset[str] = DEFAULT_SEEDED_CTORS
    clock_params: frozenset[str] = DEFAULT_CLOCK_PARAMS
    collectives: frozenset[str] = DEFAULT_COLLECTIVES
    rank_names: frozenset[str] = DEFAULT_RANK_NAMES
    family_contract: dict | None = None
    schema_drift: dict | None = None

    @staticmethod
    def zone_matches(zone: str, relpath: str) -> bool:
        """THE definition of zone membership (trailing ``/`` covers the
        subtree, else one file) — shared by R1's enforcement and R6's
        coverage check, so the two can never disagree about what a zone
        entry matches."""
        rel = relpath.replace(os.sep, "/")
        if zone.endswith("/"):
            return rel.startswith(zone)
        return rel == zone

    def in_zone(self, relpath: str) -> bool:
        return any(self.zone_matches(zone, relpath)
                   for zone in self.deterministic_zones)


def default_manifest_path() -> str:
    """The checked-in manifest shipped next to this module."""
    return os.path.join(os.path.dirname(__file__), "manifest.json")


def default_root() -> str:
    """The repo/package root the shipped manifest's paths are relative
    to: the directory CONTAINING the ``tpu_perf_torch`` package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def load_manifest(path: str, root: str) -> Manifest:
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, dict):
        raise ValueError(f"manifest {path!r} must be a JSON object")
    version = data.get("version", 1)
    if version != 1:
        raise ValueError(f"manifest {path!r}: unsupported version {version}")
    known = {
        "version", "include", "exclude", "deterministic_zones",
        "extra_clock_calls", "clock_params", "collectives", "rank_names",
        "family_contract", "schema_drift",
    }
    unknown = set(data) - known
    if unknown:
        raise ValueError(
            f"manifest {path!r}: unknown key(s) {sorted(unknown)} "
            f"(known: {sorted(known)})"
        )

    def _strings(key, default):
        val = data.get(key)
        if val is None:
            return default
        if (not isinstance(val, list)
                or not all(isinstance(v, str) for v in val)):
            raise ValueError(f"manifest {path!r}: {key} must be a string list")
        return tuple(val)

    clock_calls = DEFAULT_CLOCK_CALLS | set(
        _strings("extra_clock_calls", ())
    )
    abs_root = os.path.abspath(root)
    abs_path = os.path.abspath(path)
    source_path = (os.path.relpath(abs_path, abs_root).replace(os.sep, "/")
                   if abs_path.startswith(abs_root + os.sep)
                   else os.path.basename(path))
    return Manifest(
        root=abs_root,
        source_path=source_path,
        include=_strings("include", Manifest.include),
        exclude=_strings("exclude", ()),
        deterministic_zones=_strings("deterministic_zones", ()),
        clock_calls=frozenset(clock_calls),
        clock_params=frozenset(_strings("clock_params",
                                        tuple(DEFAULT_CLOCK_PARAMS))),
        collectives=frozenset(_strings("collectives",
                                       tuple(DEFAULT_COLLECTIVES))),
        rank_names=frozenset(_strings("rank_names",
                                      tuple(DEFAULT_RANK_NAMES))),
        family_contract=data.get("family_contract"),
        schema_drift=data.get("schema_drift"),
    )
