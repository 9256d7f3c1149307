"""Rule engine: sources, pragmas, the registry, and the lint pass.

The engine parses every manifest-included file once, hands each rule a
:class:`Source` (text + AST with parent links + pragma table), collects
findings, applies pragma suppressions, fingerprints what remains, and
splits it against the baseline.  Rules are registered declaratively —
``tpu-perf-torch lint --list-rules`` renders the catalog from their docstrings,
so a rule cannot ship undocumented.

Pragma grammar (one per comment, reason REQUIRED)::

    # tpuperf: <directive>(<reason or lock name>)

Directives: ``allow-clock`` (suppresses R1 on its line), ``allow-lockstep``
(R2), ``allow-unguarded`` (R5), ``guarded-by`` (R5's *annotation* — its
argument names the lock attribute protecting the assigned attribute).
Suppressions are never silent: every pragma site is counted and reported
in both output formats, so an audit reads the waivers next to the
findings.  A malformed or unknown directive is itself a finding (rule
``P0``) — a typo'd escape hatch must fail the lint, not silently stop
suppressing.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize

from tpu_perf_torch.analysis.astutil import add_parents
from tpu_perf_torch.analysis.findings import (
    Finding, assign_fingerprints, load_baseline, normalize_snippet,
)
from tpu_perf_torch.analysis.manifest import Manifest

#: pragma comment shape: the pragma must be the WHOLE comment (anchored
#: at its first character), and everything after the marker must parse
#: as directive(argument) — held deliberately rigid so greps stay
#: trivial and prose that merely *mentions* the marker never arms one
PRAGMA_RE = re.compile(r"^#\s*tpuperf:\s*(?P<rest>.*)$")
DIRECTIVE_RE = re.compile(
    r"^(?P<kind>[a-z-]+)\s*\(\s*(?P<arg>[^()]*?)\s*\)\s*$"
)

#: directive -> rule id it suppresses (guarded-by is an annotation, not
#: a suppression; it is consumed by R5 directly)
SUPPRESS_KINDS = {
    "allow-clock": "R1",
    "allow-lockstep": "R2",
    "allow-unguarded": "R5",
}
KNOWN_KINDS = frozenset(SUPPRESS_KINDS) | {"guarded-by"}


@dataclasses.dataclass(frozen=True)
class Pragma:
    path: str
    line: int
    kind: str
    arg: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Source:
    """One parsed file: what every per-file rule receives."""

    relpath: str          # posix-relative to the lint root
    text: str
    tree: ast.Module
    lines: list[str]
    pragmas: dict[int, list[Pragma]]  # line -> pragmas on that line

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule, node: ast.AST, message: str) -> Finding:
        from tpu_perf_torch.analysis.astutil import scope_qualname

        return Finding(
            rule=rule.id, name=rule.name, path=self.relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            scope=scope_qualname(node), message=message,
            snippet=normalize_snippet(
                self.line_text(getattr(node, "lineno", 1))
            ),
        )

    def pragmas_of_kind(self, kind: str) -> list[Pragma]:
        return [p for ps in self.pragmas.values() for p in ps
                if p.kind == kind]

    def is_comment_only_line(self, lineno: int) -> bool:
        return self.line_text(lineno).lstrip().startswith("#")

    def suppressed(self, kind: str, lineno: int) -> Pragma | None:
        """The pragma of ``kind`` covering ``lineno``: inline on the line
        itself, or STANDALONE (comment-only line) directly above.  An
        inline pragma must never bleed onto the next line — each waiver
        covers exactly the one site its author audited."""
        for p in self.pragmas.get(lineno, ()):
            if p.kind == kind:
                return p
        if self.is_comment_only_line(lineno - 1):
            for p in self.pragmas.get(lineno - 1, ()):
                if p.kind == kind:
                    return p
        return None


def scan_pragmas(relpath: str, text: str) -> tuple[dict[int, list[Pragma]],
                                                   list[Finding]]:
    """Tokenize-based comment scan (never matches string contents).
    Returns (line -> pragmas, grammar findings)."""
    pragmas: dict[int, list[Pragma]] = {}
    findings: list[Finding] = []

    def bad(line: int, col: int, msg: str) -> None:
        findings.append(Finding(
            rule="P0", name="pragma", path=relpath, line=line, col=col,
            scope="<module>", message=msg,
            snippet=normalize_snippet(text.splitlines()[line - 1]
                                      if line <= len(text.splitlines())
                                      else ""),
        ))

    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = PRAGMA_RE.search(tok.string)
            if not m:
                continue
            line, col = tok.start
            dm = DIRECTIVE_RE.match(m.group("rest"))
            if not dm:
                bad(line, col, "malformed pragma: expected "
                    "'# tpuperf: <directive>(<reason>)'")
                continue
            kind, arg = dm.group("kind"), dm.group("arg")
            if kind not in KNOWN_KINDS:
                bad(line, col,
                    f"unknown pragma directive {kind!r} "
                    f"(known: {', '.join(sorted(KNOWN_KINDS))})")
                continue
            if not arg:
                bad(line, col, f"pragma '{kind}' requires a "
                    f"{'lock name' if kind == 'guarded-by' else 'reason'}")
                continue
            pragmas.setdefault(line, []).append(
                Pragma(path=relpath, line=line, kind=kind, arg=arg)
            )
    except (tokenize.TokenError, SyntaxError):
        # IndentationError (a SyntaxError subclass) included: tokenize
        # raises it on bad dedents.  The parse rule reports the
        # underlying syntax problem as a P1 finding either way.
        pass
    return pragmas, findings


class Rule:
    """Base rule.  ``scope`` is ``"file"`` (check(source, manifest) per
    parsed file) or ``"tree"`` (check_tree(sources, manifest) once)."""

    id: str = ""
    name: str = ""
    scope: str = "file"

    def check(self, source: Source, manifest: Manifest) -> list[Finding]:
        return []

    def check_tree(self, sources: dict[str, Source],
                   manifest: Manifest) -> list[Finding]:
        return []

    @classmethod
    def doc(cls) -> str:
        return (cls.__doc__ or "").strip()


_REGISTRY: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    rule = rule_cls()
    for key in (rule.id, rule.name):
        if key in _REGISTRY:
            raise ValueError(f"duplicate rule registration: {key}")
    _REGISTRY[rule.id] = rule
    _REGISTRY[rule.name] = rule
    return rule_cls


def all_rules() -> list[Rule]:
    import tpu_perf_torch.analysis.rules  # noqa: F401 — registers the rules

    seen, out = set(), []
    for rule in _REGISTRY.values():
        if rule.id not in seen:
            seen.add(rule.id)
            out.append(rule)
    return sorted(out, key=lambda r: r.id)


def resolve_rules(selectors: list[str] | None) -> list[Rule]:
    """Rule selection for ``--rule`` (ids or names, comma-splittable)."""
    if not selectors:
        return all_rules()
    all_rules()  # ensure the registry is populated
    out, seen = [], set()
    for sel in selectors:
        for token in sel.split(","):
            token = token.strip()
            if not token:
                continue
            rule = _REGISTRY.get(token)
            if rule is None:
                known = ", ".join(r.id + "/" + r.name for r in all_rules())
                raise ValueError(f"unknown rule {token!r} (known: {known})")
            if rule.id not in seen:
                seen.add(rule.id)
                out.append(rule)
    if not out:
        # a selector that dissolves to nothing (--rule ",") must not
        # silently run zero checks and report the tree clean
        raise ValueError(f"--rule {selectors!r} selected no rules")
    return out


def collect_files(manifest: Manifest) -> list[str]:
    """Manifest include/exclude globs -> sorted relative posix paths."""
    import glob

    root = manifest.root
    found: set[str] = set()
    for pattern in manifest.include:
        for path in glob.glob(os.path.join(root, pattern), recursive=True):
            if not os.path.isfile(path):
                continue
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            if "__pycache__" in rel:
                continue
            found.add(rel)
    def glob_re(pattern: str):
        # glob where '*'/'?' stay INSIDE a path segment and only '**'
        # crosses '/' — fnmatch's '*' matches '/' and would let
        # "pkg/gen*" silently swallow pkg/gen/tool.py (and "a*.py" a
        # whole subtree), shrinking coverage with no finding
        out, i = [], 0
        while i < len(pattern):
            c = pattern[i]
            if c == "*":
                if pattern[i:i + 2] == "**":
                    out.append(".*")
                    i += 2
                    continue
                out.append("[^/]*")
            elif c == "?":
                out.append("[^/]")
            else:
                out.append(re.escape(c))
            i += 1
        return re.compile("".join(out) + r"\Z")

    def excluded(rel: str, pattern: str) -> bool:
        # segment-safe glob match, or a directory prefix WITH its '/'
        # boundary — never a bare string prefix ("pkg/gen" must not
        # silently drop pkg/genuine.py from coverage)
        if glob_re(pattern).match(rel):
            return True
        prefix = pattern.rstrip("*")
        return prefix.endswith("/") and rel.startswith(prefix)

    for pattern in manifest.exclude:
        found = {rel for rel in found if not excluded(rel, pattern)}
    return sorted(found)


def parse_source(root: str, relpath: str) -> tuple[Source | None,
                                                   list[Finding]]:
    path = os.path.join(root, relpath)
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except OSError as e:
        return None, [Finding(
            rule="P1", name="parse", path=relpath, line=1, col=0,
            scope="<module>", message=f"unreadable: {e}",
        )]
    pragmas, findings = scan_pragmas(relpath, text)
    try:
        tree = ast.parse(text, filename=relpath)
    except SyntaxError as e:
        findings.append(Finding(
            rule="P1", name="parse", path=relpath, line=e.lineno or 1,
            col=e.offset or 0, scope="<module>",
            message=f"syntax error: {e.msg}",
        ))
        return None, findings
    add_parents(tree)
    return Source(relpath=relpath, text=text, tree=tree,
                  lines=text.splitlines(), pragmas=pragmas), findings


@dataclasses.dataclass
class LintResult:
    root: str
    rules: list[Rule]
    findings: list[Finding]          # unsuppressed, fingerprinted, sorted
    suppressed: list[dict]           # {"finding": ..., "pragma": ...}
    pragmas: list[Pragma]            # every pragma site in the tree
    files: list[str]
    baseline_path: str | None = None
    baseline_stale: list[str] = dataclasses.field(default_factory=list)

    @property
    def unbaselined(self) -> list[Finding]:
        return [f for f in self.findings if not f.baselined]


def lint_tree(
    root: str,
    manifest: Manifest,
    *,
    rules: list[Rule] | None = None,
    baseline_path: str | None = None,
) -> LintResult:
    """The whole pass: scan, check, suppress, fingerprint, baseline."""
    import tpu_perf_torch.analysis.rules  # noqa: F401 — registers the rules

    active = rules if rules is not None else all_rules()
    files = collect_files(manifest)
    sources: dict[str, Source] = {}
    raw: list[Finding] = []
    all_pragmas: list[Pragma] = []
    for rel in files:
        src, findings = parse_source(root, rel)
        raw.extend(findings)
        if src is not None:
            sources[rel] = src
            all_pragmas.extend(p for ps in src.pragmas.values() for p in ps)
    for rule in active:
        if rule.scope == "file":
            for src in sources.values():
                raw.extend(rule.check(src, manifest))
        else:
            raw.extend(rule.check_tree(sources, manifest))

    kept: list[Finding] = []
    waived: list[tuple[Finding, Pragma]] = []
    for f in raw:
        kind = next((k for k, rid in SUPPRESS_KINDS.items()
                     if rid == f.rule), None)
        src = sources.get(f.path)
        pragma = src.suppressed(kind, f.line) if src and kind else None
        if pragma is not None:
            waived.append((f, pragma))
        else:
            kept.append(f)
    kept = assign_fingerprints(kept)
    # suppressed findings are fingerprinted too (among themselves, so a
    # waiver-auditing consumer can key and diff them across runs) —
    # SEPARATELY from the kept set, so adding or removing a pragma at
    # one site never renumbers a kept finding's baseline identity
    waived_fps = assign_fingerprints([f for f, _ in waived])
    suppressed = [
        {"finding": f.to_dict(), "pragma": p.to_dict()}
        for f, (_, p) in zip(waived_fps, sorted(
            waived, key=lambda fp: (fp[0].path, fp[0].line, fp[0].col,
                                    fp[0].rule)))
    ]

    stale: list[str] = []
    if baseline_path is not None:
        baseline = load_baseline(baseline_path)
        live = {f.fingerprint for f in kept}
        kept = [dataclasses.replace(f, baselined=f.fingerprint in baseline)
                for f in kept]
        stale = sorted(set(baseline) - live)
    return LintResult(
        root=root, rules=active, findings=kept, suppressed=suppressed,
        pragmas=sorted(all_pragmas, key=lambda p: (p.path, p.line)),
        files=files, baseline_path=baseline_path, baseline_stale=stale,
    )


# ---------------------------------------------------------------- output

#: machine-consumption contract for --format json (the JAX package's
#: shape, key for key); bump on any breaking shape change
JSON_SCHEMA_VERSION = 1


def render_json(result: LintResult) -> str:
    data = {
        "version": JSON_SCHEMA_VERSION,
        "root": result.root,
        "rules": [{"id": r.id, "name": r.name} for r in result.rules],
        "files": len(result.files),
        "findings": [f.to_dict() for f in result.findings],
        "suppressed": result.suppressed,
        "pragmas": [p.to_dict() for p in result.pragmas],
        "baseline": {
            "path": result.baseline_path,
            "matched": sum(1 for f in result.findings if f.baselined),
            "stale": result.baseline_stale,
        },
        "summary": {
            "files": len(result.files),
            "findings": len(result.findings),
            "unbaselined": len(result.unbaselined),
            "suppressed": len(result.suppressed),
        },
    }
    return json.dumps(data, indent=2, sort_keys=True) + "\n"


def render_text(result: LintResult) -> str:
    out = io.StringIO()
    for f in result.findings:
        mark = " [baselined]" if f.baselined else ""
        print(f.render() + mark, file=out)
    by_kind: dict[str, int] = {}
    for p in result.pragmas:
        by_kind[p.kind] = by_kind.get(p.kind, 0) + 1
    pragma_note = ", ".join(f"{k} x{n}" for k, n in sorted(by_kind.items()))
    print(
        f"{len(result.files)} file(s), "
        f"{len(result.unbaselined)} finding(s) "
        f"({sum(1 for f in result.findings if f.baselined)} baselined, "
        f"{len(result.suppressed)} pragma-suppressed"
        + (f"; pragmas: {pragma_note}" if pragma_note else "")
        + ")",
        file=out,
    )
    if result.baseline_stale:
        print(
            f"note: {len(result.baseline_stale)} stale baseline entr"
            f"{'y' if len(result.baseline_stale) == 1 else 'ies'} "
            f"(fixed or moved): {', '.join(result.baseline_stale)}",
            file=out,
        )
    return out.getvalue()


def render_rule_catalog() -> str:
    """--list-rules: the per-rule docs, from the docstrings."""
    import tpu_perf_torch.analysis.rules  # noqa: F401 — registers the rules

    out = io.StringIO()
    for rule in all_rules():
        print(f"{rule.id} ({rule.name})", file=out)
        for line in rule.doc().splitlines():
            print(f"    {line.rstrip()}", file=out)
        print(file=out)
    return out.getvalue()
