"""Static invariant analysis — ``tpu-perf-torch lint`` (port of
``tpu_perf/analysis``, run over the port's own tree).

An AST-walking rule engine (stdlib ``ast`` only, no new dependencies)
that proves the framework's load-bearing contracts at parse time instead
of discovering them at runtime:

* **R1 no-wallclock** — deterministic zones (``faults/``, span-ID
  derivation, the adaptive vote path; declared in the checked-in
  manifest) never read wall clocks or unseeded RNGs, and any function
  taking an injectable clock parameter routes through it;
* **R2 lockstep** — collective call sites are never control-dependent
  on rank-local or timing-derived state, so every rank enters every
  collective in the same order;
* **R3 family-contract** — the ``*_PREFIX`` rotating-log families are
  fully wired across schema, ingest routing, Kusto tables, and the
  lazy no-newest-skip set;
* **R4 schema-drift** — every ``ResultRow`` field has a parser width
  that accepts it (the 12/13/15/18/19 ladder);
* **R5 guarded-by** — attributes annotated as lock-guarded are only
  touched under their lock (the compile-pipeline race detector).

Layout: ``manifest.py`` loads the checked-in zone manifest
(``manifest.json``), ``engine.py`` owns sources/pragmas/registry/output,
``rules.py`` implements R1-R5, ``findings.py`` the stable fingerprints
and the baseline file (``baseline.json`` ships EMPTY — every true
positive in this tree is fixed, not baselined).
"""

from tpu_perf_torch.analysis.engine import (  # noqa: F401
    JSON_SCHEMA_VERSION, LintResult, Rule, all_rules, lint_tree,
    render_json, render_rule_catalog, render_text, resolve_rules,
)
from tpu_perf_torch.analysis.findings import Finding, render_baseline  # noqa: F401
from tpu_perf_torch.analysis.manifest import (  # noqa: F401
    Manifest, default_manifest_path, default_root, load_manifest,
)
