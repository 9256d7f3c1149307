"""The invariant rules (R1-R5).

Each rule's docstring IS its catalog entry (``tpu-perf-torch lint
--list-rules``).  The rules prove, at parse time, the contracts the
runtime suites can only catch by executing the violation: clock-free
deterministic zones (R1), rank-lockstep collective order (R2), the
fully-wired rotating-log family contract (R3), the row-schema /
parser-width ladder (R4), and lock-guarded shared attributes (R5).
"""

from __future__ import annotations

import ast

from tpu_perf_torch.analysis.astutil import (
    TaintChecker, ancestors, dotted_name, enclosing_function,
    import_aliases, terminal_name,
)
from tpu_perf_torch.analysis.engine import Rule, Source, register
from tpu_perf_torch.analysis.findings import Finding
from tpu_perf_torch.analysis.manifest import Manifest


def _call_args_empty(call: ast.Call) -> bool:
    return not call.args and not call.keywords


def _banned_clock_call(call: ast.Call, manifest: Manifest,
                       aliases: dict[str, str]) -> str | None:
    """The canonical dotted name when ``call`` is a forbidden clock/RNG
    read, else None."""
    dotted = dotted_name(call.func, aliases)
    if dotted is None:
        return None
    if dotted in manifest.clock_calls:
        return dotted
    if dotted in manifest.seeded_ctors:
        # seeded constructors are the sanctioned pattern — but only when
        # actually seeded; zero-arg default_rng()/Random() draw OS entropy
        return dotted if _call_args_empty(call) else None
    if dotted.startswith(manifest.rng_prefixes):
        return dotted
    return None


@register
class NoWallclockRule(Rule):
    """Deterministic zones must not read wall clocks or unseeded RNGs.

    The chaos ledger's byte-identical-per-seed contract, clock-free span
    IDs, and the adaptive vote's replayability all hang on the declared
    zones (manifest ``deterministic_zones``) deriving every value from
    injected clocks and seeded RNGs.  Two checks:

    * in a zone file, any call of ``time.*`` clocks, ``datetime.now``
      family, ``os.urandom``/``uuid.uuid1/4``, the global ``random``/
      ``numpy.random`` state, or an UNSEEDED seeded-ctor
      (``random.Random()``, ``numpy.random.default_rng()``) is a
      finding;
    * in ANY file, a function that takes an injectable clock parameter
      (manifest ``clock_params``: perf_clock/clock/perf_ns) must not
      also call a wall clock directly — the injected clock exists to be
      routed through, and a stray direct read silently splits a run's
      timeline across two clocks.

    Escape hatch: ``# tpuperf: allow-clock(<reason>)`` on the call's
    line; every use is counted and reported.
    """

    id = "R1"
    name = "no-wallclock"

    def check(self, source: Source, manifest: Manifest) -> list[Finding]:
        aliases = import_aliases(source.tree)
        findings: list[Finding] = []
        in_zone = manifest.in_zone(source.relpath)
        clock_only = frozenset(
            c for c in manifest.clock_calls
            if c.startswith(("time.", "datetime."))
        )
        for node in ast.walk(source.tree):
            if not isinstance(node, ast.Call):
                continue
            banned = _banned_clock_call(node, manifest, aliases)
            if banned is None:
                continue
            if in_zone:
                findings.append(source.finding(
                    self, node,
                    f"'{banned}' called in deterministic zone — route "
                    f"through an injected clock / seeded RNG or annotate "
                    f"'# tpuperf: allow-clock(<reason>)'",
                ))
                continue
            if banned not in clock_only:
                continue
            func = enclosing_function(node)
            while func is not None:
                params = {
                    a.arg for a in (func.args.posonlyargs + func.args.args
                                    + func.args.kwonlyargs)
                }
                hit = params & manifest.clock_params
                if hit:
                    findings.append(source.finding(
                        self, node,
                        f"'{banned}' called directly inside "
                        f"'{func.name}', which takes the injectable "
                        f"clock parameter '{sorted(hit)[0]}' — use the "
                        f"injected clock",
                    ))
                    break
                func = enclosing_function(func)
        return findings


def _condition_chain(call: ast.Call):
    """Yield (condition_expr, carrier_node) for every enclosing construct
    that makes ``call``'s execution conditional, up to the function
    boundary."""
    node: ast.AST = call
    for anc in ancestors(call):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return
        if isinstance(anc, ast.If) and node is not anc.test:
            yield anc.test, anc
        elif isinstance(anc, ast.While) and node is not anc.test:
            yield anc.test, anc
        elif isinstance(anc, (ast.For, ast.AsyncFor)) and node is not anc.iter:
            # a tainted ITERATION COUNT (for _ in range(self.rank): ...)
            # varies the per-rank entry count exactly like a tainted test
            yield anc.iter, anc
        elif isinstance(anc, ast.IfExp) and node is not anc.test:
            yield anc.test, anc
        elif isinstance(anc, ast.BoolOp):
            # short-circuit: every operand before the one holding the
            # call guards its evaluation
            for value in anc.values:
                if value is node or any(n is node for n in ast.walk(value)):
                    break
                yield value, anc
        elif isinstance(anc, (ast.ListComp, ast.SetComp, ast.DictComp,
                              ast.GeneratorExp)):
            for gen in anc.generators:
                for cond in gen.ifs:
                    yield cond, anc
                if not any(n is node for n in ast.walk(gen.iter)):
                    yield gen.iter, anc
        node = anc


def _exit_skips_call(if_stmt: ast.If, call: ast.Call) -> bool:
    """Can the tainted condition route SOME ranks around ``call``?
    Checked for both branches — a rank-guarded exit in the ``else`` arm
    splits the mesh exactly like one in the body.  Return/Raise exit the
    whole function, so yes.  Break/Continue exit only the innermost
    enclosing loop — they skip the call only when the call sits inside
    that SAME loop (a rank-local retry loop BEFORE a collective is
    lockstep-legal; every rank still reaches the collective)."""
    for stmt in if_stmt.body + if_stmt.orelse:
        if isinstance(stmt, (ast.Return, ast.Raise)):
            return True
        if isinstance(stmt, (ast.Break, ast.Continue)):
            loop = next(
                (a for a in ancestors(if_stmt)
                 if isinstance(a, (ast.For, ast.AsyncFor, ast.While))),
                None,
            )
            if loop is not None and any(a is loop for a in ancestors(call)):
                return True
    return False


@register
class LockstepRule(Rule):
    """Collective call sites must not be control-dependent on rank-local
    or timing-derived state.

    Every rank must enter every collective (``allreduce_times``, the
    ``psum``/``ppermute`` kernels, the adaptive ``should_stop`` vote) the
    same number of times in the same order, or the mesh deadlocks — and
    the variant that only deadlocks at 256 chips never fires in CI.  The
    rule walks each collective call's enclosing ``if``/``while``/ternary
    /short-circuit conditions (to the function boundary) and flags any
    condition tainted by a rank source (manifest ``rank_names``:
    rank/process_index/local_ip/...) or a timing read (wall clocks or an
    injected-clock parameter call), with one intra-function assignment
    fixed point so ``t = perf_clock(); if t > x: vote()`` is caught.  A
    rank-tainted early exit (``if rank != 0: return``) lexically before
    a collective in the same function is flagged the same way.  A
    one-level interprocedural summary registers this module's functions
    whose RETURN value is tainted (``def _lucky(self): return
    self.rank``) as sources themselves, so a helper cannot launder rank
    state past the walk; the summary is one level and module-local by
    design — deeper chains need a pragma, not whole-program analysis.

    Uniform-on-every-rank conditions (``n_hosts > 1``, config flags) are
    deliberately legal.  Audited sites annotate
    ``# tpuperf: allow-lockstep(<reason>)``.
    """

    id = "R2"
    name = "lockstep"

    def check(self, source: Source, manifest: Manifest) -> list[Finding]:
        aliases = import_aliases(source.tree)
        taint = TaintChecker(
            rank_names=manifest.rank_names,
            clock_calls=frozenset(
                c for c in manifest.clock_calls
                if c.startswith(("time.", "datetime."))
            ),
            clock_params=manifest.clock_params,
            aliases=aliases,
        # the one-level summary: module functions returning tainted
        # values become sources for every check below (the taint cache
        # is built AFTER this, so assignments from such helpers
        # propagate through the intra-function fixed point too)
        ).with_summaries(source.tree)
        findings: list[Finding] = []
        tainted_cache: dict[int, frozenset[str]] = {}

        def tainted_names_for(func) -> frozenset[str]:
            if func is None:
                return frozenset()
            key = id(func)
            if key not in tainted_cache:
                tainted_cache[key] = taint.tainted_names(func)
            return tainted_cache[key]

        collective_calls: list[ast.Call] = []
        for node in ast.walk(source.tree):
            if isinstance(node, ast.Call):
                callee = terminal_name(node.func)
                if callee in manifest.collectives:
                    collective_calls.append(node)

        for call in collective_calls:
            func = enclosing_function(call)
            tainted = tainted_names_for(func)
            callee = terminal_name(call.func)
            for cond, carrier in _condition_chain(call):
                if taint.seeded(cond, tainted):
                    findings.append(source.finding(
                        self, call,
                        f"collective '{callee}' is control-dependent on "
                        f"rank-local/timing-derived state "
                        f"(condition at line {cond.lineno}) — every rank "
                        f"must enter it in lockstep",
                    ))
                    break
            else:
                if func is None:
                    continue
                enclosing = set(map(id, ancestors(call)))
                for stmt in ast.walk(func):
                    if (stmt.lineno if hasattr(stmt, "lineno") else 0) \
                            >= call.lineno:
                        continue
                    # a return/raise inside a NESTED function exits only
                    # the closure — it cannot skip the outer function's
                    # collective
                    if isinstance(stmt, (ast.If, ast.Assert)) \
                            and enclosing_function(stmt) is not func:
                        continue
                    # `assert rank == 0` IS a conditional raise: every
                    # non-matching rank skips the collective
                    exits = (
                        isinstance(stmt, ast.Assert)
                        or (isinstance(stmt, ast.If)
                            and id(stmt) not in enclosing
                            and _exit_skips_call(stmt, call))
                    )
                    if exits and taint.seeded(stmt.test, tainted):
                        findings.append(source.finding(
                            self, stmt,
                            f"rank-local/timing-conditional early exit "
                            f"precedes collective '{callee}' (line "
                            f"{call.lineno}) in the same function — "
                            f"ranks taking the exit skip the collective",
                        ))
                        break
        return findings


def _module_consts(tree: ast.Module, suffix: str) -> dict[str, tuple[str, int]]:
    """Module-level ``NAME = "literal"`` assignments whose name carries
    ``suffix`` -> (value, line)."""
    out: dict[str, tuple[str, int]] = {}
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id.endswith(suffix)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)):
            out[stmt.targets[0].id] = (stmt.value.value, stmt.lineno)
    return out


def _name_tuple(node: ast.AST) -> list[str] | None:
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Name) for e in node.elts):
        return [e.id for e in node.elts]
    return None


def _tree_finding(rule, path: str, line: int, message: str,
                  snippet: str = "") -> Finding:
    from tpu_perf_torch.analysis.findings import normalize_snippet

    return Finding(rule=rule.id, name=rule.name, path=path, line=line,
                   col=0, scope="<module>", message=message,
                   snippet=normalize_snippet(snippet))


@register
class FamilyContractRule(Rule):
    """A rotating-log family must be fully wired or not exist.

    The rotating families (``tcp``/``tpu`` CSV + ``health``/``chaos``/
    ``linkmap``/``spans``/``fleet`` JSONL) share one contract spread
    over three files: ``schema.py`` declares ``*_PREFIX`` constants and
    sweeps them in ``ALL_PREFIXES``; the ingest pipeline routes each
    prefix to its own Kusto table and exempts the lazy
    (``.open``-suffixed) JSONL families from the newest-N skip; the
    push plane's sink module routes each family live (``PUSH_ROUTES``)
    or declares it tee-free (``TEE_FREE_FAMILIES`` — the chaos ledger's
    byte-identity exclusion).  The rule cross-checks all three
    (manifest ``family_contract`` names the files and which families
    are CSV), so a new family cannot ship half-wired: declared but not
    swept, swept but not routed, routed but starved by the newest-N
    heuristic, short a Kusto table, or absent from the push plane's
    routed-xor-tee-free partition.
    """

    id = "R3"
    name = "family-contract"
    scope = "tree"

    def check_tree(self, sources: dict[str, Source],
                   manifest: Manifest) -> list[Finding]:
        cfg = manifest.family_contract
        if not cfg:
            return []
        findings: list[Finding] = []
        schema_path = cfg.get("schema", "")
        ingest_path = cfg.get("ingest", "")
        csv_families = set(cfg.get("csv_families", ()))
        default_family = cfg.get("default_family", "")
        schema = sources.get(schema_path)
        pipeline = sources.get(ingest_path)
        for path, src in ((schema_path, schema), (ingest_path, pipeline)):
            if src is None:
                findings.append(_tree_finding(
                    self, path or "<manifest>", 1,
                    f"family-contract surface {path!r} is not among the "
                    f"linted sources",
                ))
        if schema is None or pipeline is None:
            return findings

        prefixes = _module_consts(schema.tree, "_PREFIX")
        all_prefixes: list[str] | None = None
        all_line = 1
        for stmt in schema.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "ALL_PREFIXES"):
                all_prefixes = _name_tuple(stmt.value)
                all_line = stmt.lineno
        if all_prefixes is None:
            findings.append(_tree_finding(
                self, schema.relpath, 1,
                "ALL_PREFIXES tuple of family constants not found",
            ))
            return findings

        for name, (_, line) in sorted(prefixes.items()):
            if name not in all_prefixes:
                findings.append(_tree_finding(
                    self, schema.relpath, line,
                    f"family constant {name} is declared but missing from "
                    f"ALL_PREFIXES — its logs would never be ingested",
                    schema.line_text(line),
                ))
        for name in all_prefixes:
            if name not in prefixes:
                findings.append(_tree_finding(
                    self, schema.relpath, all_line,
                    f"ALL_PREFIXES entry {name} has no string constant "
                    f"in {schema.relpath}",
                    schema.line_text(all_line),
                ))

        # --- ingest routing: every non-default family needs its own
        # startswith() branch in an ingest() method
        routed: set[str] = set()
        ingest_line = 1
        props_calls = 0
        for node in ast.walk(pipeline.tree):
            if isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "startswith"
                        and node.args
                        and isinstance(node.args[0], ast.Name)):
                    routed.add(node.args[0].id)
                if terminal_name(node.func) == "IngestionProperties":
                    props_calls += 1
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name == "ingest"):
                ingest_line = max(ingest_line, node.lineno)
        for name in all_prefixes:
            if name == default_family:
                continue
            if name not in routed:
                findings.append(_tree_finding(
                    self, pipeline.relpath, ingest_line,
                    f"family {name} has no startswith() routing branch in "
                    f"{pipeline.relpath} — its rows would land in the "
                    f"default table and fail the column mapping",
                ))
        if props_calls < len(all_prefixes):
            # zero found is the LOUDEST case, not a disabled check: a
            # refactor that moves/renames the table construction must
            # fail here (and update the contract files), never silently
            # retire the Kusto-table surface
            findings.append(_tree_finding(
                self, pipeline.relpath, 1,
                f"{props_calls} IngestionProperties table route(s) for "
                f"{len(all_prefixes)} families — a family is missing its "
                f"Kusto table" if props_calls else
                f"no IngestionProperties table routes found in "
                f"{pipeline.relpath} for {len(all_prefixes)} families — "
                f"the Kusto-table surface is unwired (or moved; update "
                f"the family_contract manifest if so)",
            ))

        # --- lazy (.open) families: everything that is not CSV must be
        # exempt from the newest-N skip, and nothing CSV may be
        lazy: list[str] | None = None
        lazy_line = 1
        for node in ast.walk(pipeline.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "lazy_families"):
                lazy = _name_tuple(node.value)
                lazy_line = node.lineno
        if lazy is None:
            findings.append(_tree_finding(
                self, pipeline.relpath, 1,
                "lazy_families tuple not found — the JSONL families would "
                "all suffer the newest-N skip and starve",
            ))
        else:
            for name in all_prefixes:
                if name in csv_families:
                    if name in lazy:
                        findings.append(_tree_finding(
                            self, pipeline.relpath, lazy_line,
                            f"CSV family {name} is in lazy_families — its "
                            f"still-being-written newest files would be "
                            f"swept mid-row",
                            pipeline.line_text(lazy_line),
                        ))
                elif name not in lazy:
                    findings.append(_tree_finding(
                        self, pipeline.relpath, lazy_line,
                        f"JSONL family {name} is missing from "
                        f"lazy_families — the newest-N skip would starve "
                        f"its sparse logs",
                        pipeline.line_text(lazy_line),
                    ))

        # --- push routing (tpu_perf_torch.push, --push): every family must be
        # either live-routed (a PUSH_ROUTES key) or declared tee-free
        # (TEE_FREE_FAMILIES) — exactly one of the two.  Missing from
        # both is the half-wired eighth family (its records rotate but
        # never reach a live sink, and nothing says that was a choice);
        # present in both means a family whose byte-identity contract
        # depends on the plane's absence just gained a route.
        push_path = cfg.get("push", "")
        if not push_path:
            return findings
        sink_src = sources.get(push_path)
        if sink_src is None:
            findings.append(_tree_finding(
                self, push_path, 1,
                f"family-contract push surface {push_path!r} is not "
                f"among the linted sources",
            ))
            return findings
        routes: list[str] | None = None
        routes_line = 1
        tee_free: list[str] | None = None
        tee_line = 1
        for stmt in sink_src.tree.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            target = stmt.targets[0].id
            if target == "PUSH_ROUTES" and isinstance(stmt.value, ast.Dict):
                if all(isinstance(k, ast.Name) for k in stmt.value.keys):
                    routes = [k.id for k in stmt.value.keys]
                    routes_line = stmt.lineno
            elif target == "TEE_FREE_FAMILIES":
                tee_free = _name_tuple(stmt.value)
                tee_line = stmt.lineno
        if routes is None:
            findings.append(_tree_finding(
                self, sink_src.relpath, 1,
                "PUSH_ROUTES dict of family-constant keys not found — "
                "the live push routing surface is unwired (or moved; "
                "update the family_contract manifest if so)",
            ))
        if tee_free is None:
            findings.append(_tree_finding(
                self, sink_src.relpath, 1,
                "TEE_FREE_FAMILIES tuple not found — the chaos ledger's "
                "push-exclusion is undeclared and unprovable",
            ))
        if routes is None or tee_free is None:
            return findings
        for name in all_prefixes:
            in_routes = name in routes
            in_tee_free = name in tee_free
            if in_routes and in_tee_free:
                findings.append(_tree_finding(
                    self, sink_src.relpath, routes_line,
                    f"family {name} is declared tee-free AND routed in "
                    f"PUSH_ROUTES — a byte-identity family can never "
                    f"gain a live route",
                    sink_src.line_text(routes_line),
                ))
            elif not in_routes and not in_tee_free:
                findings.append(_tree_finding(
                    self, sink_src.relpath, routes_line,
                    f"family {name} is neither routed in PUSH_ROUTES nor "
                    f"declared in TEE_FREE_FAMILIES — a new family must "
                    f"choose (the half-wired-eighth-family check)",
                    sink_src.line_text(routes_line),
                ))
        for name in routes:
            if name.endswith("_PREFIX") and name not in all_prefixes:
                findings.append(_tree_finding(
                    self, sink_src.relpath, routes_line,
                    f"PUSH_ROUTES key {name} is not in ALL_PREFIXES — a "
                    f"route for a family that does not rotate delivers "
                    f"nothing",
                    sink_src.line_text(routes_line),
                ))
        for name in tee_free:
            if name not in all_prefixes:
                findings.append(_tree_finding(
                    self, sink_src.relpath, tee_line,
                    f"TEE_FREE_FAMILIES entry {name} is not in "
                    f"ALL_PREFIXES — the exclusion protects nothing",
                    sink_src.line_text(tee_line),
                ))
        return findings


@register
class SchemaDriftRule(Rule):
    """Every ``ResultRow`` field must be parseable back.

    Rows stream through rotating logs and replay through ``from_csv``;
    the parser accepts the historical width ladder (12/13/15/18/19
    columns) so old logs stay readable.  A new column appended to the
    dataclass without a parser branch fails at REPLAY time, in
    production, on the first row that carries it.  The rule counts the
    row class's fields, extracts the accepted-widths tuple from the
    ``len(parts) not in (...)`` guard, and requires (a) the max accepted
    width to equal the field count and (b) the emitted header's column
    count to be one of the accepted widths (manifest ``schema_drift``
    names the file, class, and header constant).
    """

    id = "R4"
    name = "schema-drift"
    scope = "tree"

    def check_tree(self, sources: dict[str, Source],
                   manifest: Manifest) -> list[Finding]:
        cfg = manifest.schema_drift
        if not cfg:
            return []
        findings: list[Finding] = []
        schema_path = cfg.get("schema", "")
        schema = sources.get(schema_path)
        if schema is None:
            return [_tree_finding(
                self, schema_path or "<manifest>", 1,
                f"schema-drift surface {schema_path!r} is not among the "
                f"linted sources",
            )]
        row_class = cfg.get("row_class", "ResultRow")
        header_const = cfg.get("header_const")

        cls = next(
            (n for n in schema.tree.body
             if isinstance(n, ast.ClassDef) and n.name == row_class), None)
        if cls is None:
            return [_tree_finding(
                self, schema.relpath, 1,
                f"row class {row_class} not found",
            )]
        fields = [stmt for stmt in cls.body
                  if isinstance(stmt, ast.AnnAssign)
                  and isinstance(stmt.target, ast.Name)]
        n_fields = len(fields)

        widths: tuple[int, ...] | None = None
        widths_line = cls.lineno
        for node in ast.walk(cls):
            if not isinstance(node, ast.Compare):
                continue
            if not any(isinstance(op, (ast.In, ast.NotIn))
                       for op in node.ops):
                continue
            left = node.left
            if not (isinstance(left, ast.Call)
                    and terminal_name(left.func) == "len"):
                continue
            comp = node.comparators[0]
            if isinstance(comp, (ast.Tuple, ast.List, ast.Set)) and all(
                    isinstance(e, ast.Constant) and isinstance(e.value, int)
                    for e in comp.elts):
                widths = tuple(e.value for e in comp.elts)
                widths_line = node.lineno
                break
        if widths is None:
            findings.append(_tree_finding(
                self, schema.relpath, cls.lineno,
                f"{row_class}: no accepted-widths guard "
                f"(len(parts) in/not in (...)) found in its parser",
            ))
            return findings
        if max(widths) != n_fields:
            findings.append(_tree_finding(
                self, schema.relpath, widths_line,
                f"{row_class} has {n_fields} fields but the parser's "
                f"accepted widths top out at {max(widths)} "
                f"({widths}) — a row carrying every column would fail "
                f"replay; add the new width (and a parser branch)",
                schema.line_text(widths_line),
            ))
        if header_const:
            consts = _module_consts(schema.tree, header_const)
            if header_const not in consts:
                findings.append(_tree_finding(
                    self, schema.relpath, 1,
                    f"header constant {header_const} not found",
                ))
            else:
                value, line = consts[header_const]
                n_cols = value.count(",") + 1
                if n_cols not in widths:
                    findings.append(_tree_finding(
                        self, schema.relpath, line,
                        f"{header_const} declares {n_cols} columns, which "
                        f"is not an accepted parser width {widths}",
                        schema.line_text(line),
                    ))
        return findings


@register
class GuardedByRule(Rule):
    """Lock-guarded attributes may only be touched under their lock.

    An attribute assignment annotated ``# tpuperf: guarded-by(<lock>)``
    declares that every OTHER access of that attribute in the module
    (the declaring line itself is the exemption — construction happens
    before the object is shared) must sit lexically inside a ``with
    <obj>.<lock>:`` block.  This is the compile-pipeline race detector:
    the driver's ``_canon``/``_canon_refs`` refcounts and the pipeline
    worker's result/credit state are exactly the words a worker thread
    and the main thread race on.  Deliberate unguarded access (a
    single-threaded reader, a monitoring read) annotates
    ``# tpuperf: allow-unguarded(<reason>)``.  Scope is the declaring
    CLASS within the declaring module: an unrelated class reusing a
    common attribute name is a different attribute, and cross-module
    (or cross-class) accesses are out of reach of a parse-time rule —
    they belong to code review.
    """

    id = "R5"
    name = "guarded-by"

    def check(self, source: Source, manifest: Manifest) -> list[Finding]:
        # keyed by (declaring class, attr): an unrelated same-module
        # class reusing a common name ('builds', '_done') is a different
        # attribute, not a violation of this one's lock contract
        guarded: dict[tuple[int, str], tuple[str, set[int]]] = {}
        findings: list[Finding] = []

        decl_pragmas = source.pragmas_of_kind("guarded-by")
        if not decl_pragmas:
            return []
        # map each pragma to the self.<attr> assignment(s) on its line
        # (a = b = 0 declares EVERY attribute target, or the annotation
        # would silently cover only the first).  Each entry carries the
        # assignment node's FULL line range: a pragma on a multi-line
        # declaration's continuation line must exempt the whole
        # statement, including the target's (earlier) line.
        def _enclosing_class(node):
            for anc in ancestors(node):
                if isinstance(anc, ast.ClassDef):
                    return anc
            return None

        assigns: dict[int, tuple[list[str], range, int]] = {}
        for node in ast.walk(source.tree):
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            # chained (a = b = 0) AND unpacking (a, b = 0, 1) forms both
            # declare every attribute target
            flat: list[ast.AST] = []
            for t in targets:
                if isinstance(t, (ast.Tuple, ast.List)):
                    flat.extend(t.elts)
                else:
                    flat.append(t)
            attrs = [t.attr for t in flat
                     if isinstance(t, ast.Attribute)
                     and isinstance(t.value, ast.Name)]
            if attrs:
                span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
                cls = _enclosing_class(node)
                cls_key = id(cls) if cls is not None else 0
                for line in span:
                    prev = assigns.get(line)
                    merged = (prev[0] + attrs) if prev else list(attrs)
                    assigns[line] = (merged, span, cls_key)
        for pragma in decl_pragmas:
            # the annotation attaches to its own line, or — standalone
            # (comment-only line) — to the assignment directly below,
            # the same two placements every suppression pragma honors
            entry = assigns.get(pragma.line)
            if entry is None and source.is_comment_only_line(pragma.line):
                entry = assigns.get(pragma.line + 1)
            attrs, decl_span, cls_key = entry if entry else (None, None, 0)
            if not attrs:
                findings.append(Finding(
                    rule=self.id, name=self.name, path=source.relpath,
                    line=pragma.line, col=0, scope="<module>",
                    message="guarded-by pragma is not attached to an "
                            "attribute assignment",
                    snippet=source.line_text(pragma.line).strip(),
                ))
                continue
            for attr in attrs:
                lock, lines = guarded.setdefault(
                    (cls_key, attr), (pragma.arg, set()))
                if lock != pragma.arg:
                    findings.append(Finding(
                        rule=self.id, name=self.name, path=source.relpath,
                        line=pragma.line, col=0, scope="<module>",
                        message=f"attribute '{attr}' declared guarded by "
                                f"both '{lock}' and '{pragma.arg}'",
                    ))
                lines.update(decl_span)

        def _receiver_chain(node: ast.AST) -> tuple[str, ...] | None:
            """(``self``,) for ``self.x``, (``self``, ``pipe``) for
            ``self.pipe.x`` — None for anything not a plain chain."""
            parts: list[str] = []
            cur = node
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if not isinstance(cur, ast.Name):
                return None
            parts.append(cur.id)
            return tuple(reversed(parts))

        def under_lock(node: ast.Attribute, lock: str) -> bool:
            # the held lock must live on the SAME receiver as the
            # guarded attribute: `with other._cond:` while touching
            # `self._results` is a real race, not a guarded access.
            # Unresolvable receivers (a local alias named after the
            # lock, a call result) fall back to the name match —
            # arbitrarily-named aliases need an allow-unguarded pragma,
            # not a guess.
            want = _receiver_chain(node.value)
            for anc in ancestors(node):
                if isinstance(anc, (ast.With, ast.AsyncWith)):
                    for item in anc.items:
                        expr = item.context_expr
                        if terminal_name(expr) != lock:
                            continue
                        have = (_receiver_chain(expr.value)
                                if isinstance(expr, ast.Attribute)
                                else None)
                        if want is None or have is None or want == have:
                            return True
            return False

        for node in ast.walk(source.tree):
            if not isinstance(node, ast.Attribute):
                continue
            cls = _enclosing_class(node)
            entry = guarded.get((id(cls) if cls is not None else 0,
                                 node.attr))
            if entry is None:
                continue
            lock, decl_lines = entry
            if node.lineno in decl_lines:
                continue  # the declaring assignment itself
            if under_lock(node, lock):
                continue
            findings.append(source.finding(
                self, node,
                f"'{node.attr}' is guarded by '{lock}' but accessed "
                f"outside any 'with ...{lock}:' block — annotate "
                f"'# tpuperf: allow-unguarded(<reason>)' if this access "
                f"is provably race-free",
            ))
        return findings


@register
class ZoneCoverageRule(Rule):
    """Every declared deterministic zone must match at least one file.

    The R1 zone manifest names paths (``tpu_perf_torch/faults/``,
    ``tpu_perf_torch/spans.py``, ...); a rename or move of the module behind
    one of them would not FAIL anything — the zone would simply stop
    matching and the no-wallclock contract would silently shrink to
    nothing for that subsystem.  This rule makes the shrink loud: a
    zone entry that matches no linted source is a finding anchored at
    the manifest itself (cheap and loud).
    """

    id = "R6"
    name = "zone-coverage"
    scope = "tree"

    def check_tree(self, sources: dict[str, Source],
                   manifest: Manifest) -> list[Finding]:
        findings: list[Finding] = []
        for zone in manifest.deterministic_zones:
            hit = any(manifest.zone_matches(zone, rel) for rel in sources)
            if not hit:
                findings.append(_tree_finding(
                    self, manifest.source_path, 1,
                    f"deterministic zone {zone!r} matches no linted file "
                    f"— a renamed or moved module has silently left the "
                    f"no-wallclock contract (update the manifest or "
                    f"restore the path)",
                    zone,
                ))
        return findings
