"""Shared AST plumbing for the invariant rules.

Everything here is stdlib-``ast`` only (the analyzer must run in any
environment the package itself runs in, including the bare CI image —
no third-party parser).  The helpers are deliberately *syntactic*:
alias-aware dotted-name resolution, parent links, enclosing-scope
qualnames, and a small intra-function taint pass.  They trade soundness
for zero-configuration usefulness — a rule that needs to see through a
helper call uses the pragma escape hatch, not a whole-program analysis.
"""

from __future__ import annotations

import ast

_PARENT = "_tpuperf_parent"


def add_parents(tree: ast.AST) -> ast.AST:
    """Attach a parent link to every node (walkable with :func:`parent`)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            setattr(child, _PARENT, node)
    return tree


def parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, _PARENT, None)


def ancestors(node: ast.AST):
    """Yield parents innermost-first, up to (and including) the Module."""
    cur = parent(node)
    while cur is not None:
        yield cur
        cur = parent(cur)


def enclosing_function(node: ast.AST) -> ast.AST | None:
    """Nearest enclosing FunctionDef/AsyncFunctionDef, else None."""
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def scope_qualname(node: ast.AST) -> str:
    """Dotted enclosing-scope name (``Class.method`` / ``<module>``) —
    part of the finding fingerprint, so a finding keeps its identity when
    unrelated code above it shifts line numbers."""
    names: list[str] = []
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(anc.name)
    return ".".join(reversed(names)) or "<module>"


def import_aliases(tree: ast.AST) -> dict[str, str]:
    """Local name -> dotted origin for every import in the module.

    ``import time as _time`` maps ``_time -> time``; ``from datetime
    import datetime`` maps ``datetime -> datetime.datetime`` — so a
    banned call resolves to the same canonical dotted name however the
    module spelled the import.
    """
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                target = a.name if a.asname else a.name.split(".")[0]
                aliases[local] = target
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_name(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Resolve a Name/Attribute chain to a canonical dotted string
    (``np.random.rand`` under ``import numpy as np`` ->
    ``numpy.random.rand``); None for anything not a plain chain
    (a call result, a subscript)."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(aliases.get(cur.id, cur.id))
    return ".".join(reversed(parts))


def terminal_name(node: ast.AST) -> str | None:
    """The last segment of a Name/Attribute chain (``self.rank`` ->
    ``rank``) — how rank-source and collective matching stays robust to
    the receiver's spelling."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def assigned_names(target: ast.AST) -> set[str]:
    """Plain local names bound by an assignment target (tuples unpacked;
    attribute/subscript targets are skipped — ``self.t = clock()`` binds
    no local name and must not taint ``self`` itself)."""
    out: set[str] = set()
    if isinstance(target, ast.Name):
        out.add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            out |= assigned_names(elt)
    elif isinstance(target, ast.Starred):
        out |= assigned_names(target.value)
    return out


class TaintChecker:
    """Is an expression derived from rank-local or timing state?

    Seeds: any Name/Attribute whose terminal segment is a declared rank
    source, any call of a banned clock (canonical dotted name) or of a
    declared injectable-clock parameter name, plus function-local names
    assigned from such expressions (one intra-function fixed point over
    simple assignments — enough to catch ``t = perf_clock(); if t > x:``
    without whole-program dataflow).
    """

    def __init__(self, rank_names: frozenset[str],
                 clock_calls: frozenset[str],
                 clock_params: frozenset[str],
                 aliases: dict[str, str],
                 tainted_callees: frozenset[str] = frozenset()):
        self.rank_names = rank_names
        self.clock_calls = clock_calls
        self.clock_params = clock_params
        self.aliases = aliases
        #: function names whose RETURN value carries taint (the
        #: one-level interprocedural summary — return_taint_summary);
        #: calls of these names seed taint like a direct source
        self.tainted_callees = tainted_callees

    def seeded(self, expr: ast.AST, tainted: frozenset[str]) -> bool:
        """True when ``expr`` contains a taint source or tainted name."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and node.id in tainted:
                return True
            term = terminal_name(node)
            if term is not None and term in self.rank_names:
                return True
            if isinstance(node, ast.Call):
                dotted = dotted_name(node.func, self.aliases)
                callee = terminal_name(node.func)
                if dotted in self.clock_calls:
                    return True
                if (callee in self.clock_params
                        or callee in self.rank_names
                        or callee in self.tainted_callees):
                    return True
        return False

    def with_summaries(self, tree: ast.AST) -> "TaintChecker":
        """A checker that additionally treats calls of this module's
        taint-returning helpers as sources (one-level interprocedural
        summary — see :func:`return_taint_summary`).  Returns ``self``
        when the module defines no such helper, so the common case pays
        nothing."""
        summary = return_taint_summary(tree, self)
        if not summary:
            return self
        return TaintChecker(
            rank_names=self.rank_names, clock_calls=self.clock_calls,
            clock_params=self.clock_params, aliases=self.aliases,
            tainted_callees=self.tainted_callees | summary,
        )

    def tainted_names(self, func: ast.AST) -> frozenset[str]:
        """Fixed point of function-local names carrying taint."""
        tainted: set[str] = set()
        args = getattr(func, "args", None)
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs
                      + ([args.vararg] if args.vararg else [])
                      + ([args.kwarg] if args.kwarg else [])):
                if a.arg in self.rank_names:
                    tainted.add(a.arg)
        assigns: list[tuple[set[str], ast.AST]] = []
        for node in ast.walk(func):
            if isinstance(node, ast.Assign):
                names = set()
                for t in node.targets:
                    names |= assigned_names(t)
                assigns.append((names, node.value))
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                    and node.value is not None:
                assigns.append((assigned_names(node.target), node.value))
            elif isinstance(node, ast.NamedExpr):
                assigns.append((assigned_names(node.target), node.value))
        for _ in range(len(assigns) + 1):  # bounded fixed point
            grew = False
            frozen = frozenset(tainted)
            for names, value in assigns:
                if not names <= tainted and self.seeded(value, frozen):
                    tainted |= names
                    grew = True
            if not grew:
                break
        return frozenset(tainted)


def return_taint_summary(tree: ast.AST,
                         checker: TaintChecker) -> frozenset[str]:
    """One-level interprocedural taint: the names of this module's
    functions whose RETURN value derives from a rank/timing source
    (``def _lucky(self): return self.rank``).  A caller conditioning a
    collective on such a helper's result launders rank state past a
    purely intra-function walk; registering the helper as a taint
    SOURCE closes that hole without whole-program dataflow.

    Deliberately ONE level and module-local: the summary pass itself
    sees only direct sources — a helper returning another helper's
    result, or a helper imported from elsewhere, still needs its own
    direct source (or an allow-lockstep pragma at the call site) to
    register.  Matching is by bare function name, consistent with how
    collective and rank-source names match (``terminal_name``).
    Requires the tree to carry parent links (:func:`add_parents`)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        local = checker.tainted_names(node)
        for stmt in ast.walk(node):
            if (isinstance(stmt, ast.Return) and stmt.value is not None
                    and enclosing_function(stmt) is node
                    and checker.seeded(stmt.value, local)):
                out.add(node.name)
                break
    return frozenset(out)
