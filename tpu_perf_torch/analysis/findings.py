"""Findings, stable fingerprints, and the baseline file.

A finding's **fingerprint** is what the baseline keys on, so it must
survive unrelated edits: it hashes the rule id, the file's path, the
enclosing scope's qualname, and the *normalized source of the flagged
line* — never the line number.  Adding code above a finding moves its
line but not its fingerprint; changing the flagged line itself (the only
edit that plausibly addresses the finding) retires the old fingerprint,
so a baseline entry can never mask a *different* violation that happens
to land on the same line later.  Identical snippets in one scope are
disambiguated by an occurrence index.

The baseline file is JSON (``{"version": 1, "findings": [...]}``); the
shipped one — ``tpu_perf_torch/analysis/baseline.json`` — is **empty** by
contract: every true positive the analyzer finds in this tree gets
fixed, not baselined.  The baseline mechanism exists
for downstream forks adopting the linter against an older tree.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str       # rule id, e.g. "R1"
    name: str       # rule name, e.g. "no-wallclock"
    path: str       # repo-relative posix path
    line: int       # 1-based line of the flagged node
    col: int        # 0-based column
    scope: str      # enclosing qualname ("Driver._heartbeat", "<module>")
    message: str
    snippet: str = ""       # normalized source of the flagged line
    fingerprint: str = ""   # stable id (see module docstring)
    baselined: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}({self.name}) {self.message}")


def normalize_snippet(source_line: str) -> str:
    """Whitespace-collapsed source line — the fingerprint's code anchor."""
    return " ".join(source_line.split())


def fingerprint(rule: str, path: str, scope: str, snippet: str,
                occurrence: int = 0) -> str:
    payload = f"{rule}|{path}|{scope}|{snippet}|{occurrence}"
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def assign_fingerprints(findings: list[Finding]) -> list[Finding]:
    """Fill each finding's fingerprint, numbering duplicates of the same
    (rule, path, scope, snippet) in source order so two identical
    violations in one scope stay distinct baseline entries."""
    seen: dict[tuple, int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.scope, f.snippet)
        n = seen.get(key, 0)
        seen[key] = n + 1
        out.append(dataclasses.replace(
            f, fingerprint=fingerprint(f.rule, f.path, f.scope, f.snippet, n)
        ))
    return out


def load_baseline(path: str) -> dict[str, dict]:
    """fingerprint -> baseline entry.  A malformed file is a hard error:
    CI silently gating against garbage would pass everything."""
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or not isinstance(data.get("findings"), list):
        raise ValueError(
            f"baseline {path!r} must be a JSON object with a 'findings' list"
        )
    out: dict[str, dict] = {}
    for entry in data["findings"]:
        if not isinstance(entry, dict) or "fingerprint" not in entry:
            raise ValueError(
                f"baseline {path!r}: every entry needs a 'fingerprint'"
            )
        out[str(entry["fingerprint"])] = entry
    return out


def render_baseline(findings: list[Finding]) -> str:
    """The ``--write-baseline`` artifact: enough context per entry that a
    reviewer can audit what was waived without re-running the linter."""
    entries = [
        {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
         "scope": f.scope, "message": f.message}
        for f in findings
    ]
    return json.dumps({"version": 1, "findings": entries}, indent=2) + "\n"
