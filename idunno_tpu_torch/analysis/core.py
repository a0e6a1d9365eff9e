"""Shared machinery for the protocol-contract checkers.

One ``Module`` per source file: the parsed AST plus the derived maps every
checker needs (parent links, qualnames, per-line ``# lint:`` pragmas).
Checkers register themselves in ``CHECKERS`` via the ``checker`` decorator
and receive the full module map — each filters down to its own targets, so
one parse pass serves all six.

Suppression is two-tier, both requiring a justification:
- ``analysis/allowlist.py`` entries (checker, file, symbol, tag) — the
  reviewed ledger; unmatched entries are themselves findings so the
  ledger can never rot.
- an inline ``# lint: ok <checker> -- <why>`` pragma on the flagged line,
  for cases where the justification belongs next to the code.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str
    file: str        # repo-relative posix path
    line: int
    symbol: str      # qualname of the enclosing def/class ("" = module)
    tag: str         # stable, line-independent token for allowlisting
    message: str

    @property
    def key(self) -> str:
        return f"{self.checker}:{self.file}:{self.symbol}:{self.tag}"

    def to_wire(self) -> dict:
        return {"checker": self.checker, "file": self.file,
                "line": self.line, "symbol": self.symbol,
                "tag": self.tag, "message": self.message}


_PRAGMA = re.compile(r"#\s*lint:\s*ok\s+([\w,-]+)\s*--\s*(\S.*)")


class Module:
    """A parsed source file with the derived maps checkers share."""

    def __init__(self, path: str, relpath: str) -> None:
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=path)
        self.parents: dict[ast.AST, ast.AST] = {}
        self._quals: dict[ast.AST, str] = {}
        self._index(self.tree, None, "")
        # line -> set of checker names granted by an inline pragma (a
        # pragma without a justification after ``--`` never parses, so
        # every suppression carries its why)
        self.pragmas: dict[int, set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _PRAGMA.search(text)
            if m:
                self.pragmas[i] = set(m.group(1).split(","))

    def _index(self, node: ast.AST, parent: ast.AST | None,
               qual: str) -> None:
        if parent is not None:
            self.parents[node] = parent
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            qual = f"{qual}.{node.name}" if qual else node.name
            self._quals[node] = qual
        for child in ast.iter_child_nodes(node):
            self._index(child, node, qual)

    # -- lookups -----------------------------------------------------------

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing(self, node: ast.AST, kinds) -> ast.AST | None:
        for a in self.ancestors(node):
            if isinstance(a, kinds):
                return a
        return None

    def enclosing_function(self, node: ast.AST):
        return self.enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))

    def enclosing_class(self, node: ast.AST):
        return self.enclosing(node, ast.ClassDef)

    def qualname(self, node: ast.AST) -> str:
        scope = node if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef,
                   ast.ClassDef)) else self.enclosing(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        return self._quals.get(scope, "") if scope is not None else ""

    def classes(self) -> dict[str, ast.ClassDef]:
        return {n.name: n for n in self.tree.body
                if isinstance(n, ast.ClassDef)}

    def function(self, qualname: str):
        """Resolve a dotted qualname ("Class.method" or "fn") to its def."""
        for node, q in self._quals.items():
            if q == qualname and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return node
        return None

    def segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.source, node) or ""

    def suppressed(self, checker: str, line: int) -> bool:
        names = self.pragmas.get(line)
        return names is not None and (checker in names or "all" in names)

    def finding(self, checker: str, node: ast.AST, tag: str,
                message: str) -> Finding | None:
        line = getattr(node, "lineno", 0)
        if self.suppressed(checker, line):
            return None
        return Finding(checker, self.relpath, line,
                       self.qualname(node), tag, message)


# -- helpers used by several checkers ---------------------------------------

def dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ("self.transport.call")."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return ""


def call_name(call: ast.Call) -> str:
    return dotted(call.func)


def has_dict_key(fn: ast.AST, key: str) -> bool:
    """True if any dict literal / subscript-store / kwarg inside ``fn``
    carries ``key`` — the shape every wire-stamp takes."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and k.value == key:
                    return True
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == key:
                    return True
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Constant)
                        and t.slice.value == key):
                    return True
    return False


def calls_in(fn: ast.AST) -> list[ast.Call]:
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)]


def calls_named(fn: ast.AST, suffix: str) -> list[ast.Call]:
    """Calls whose dotted name ends with ``suffix`` (``check_payload``
    matches both the bare import and ``epoch.check_payload``)."""
    out = []
    for c in calls_in(fn):
        name = call_name(c)
        if name == suffix or name.endswith("." + suffix):
            out.append(c)
    return out


# -- registry + runner ------------------------------------------------------

CHECKERS: dict[str, object] = {}


def checker(name: str):
    def wrap(fn):
        CHECKERS[name] = fn
        fn.checker_name = name
        return fn
    return wrap


def load_modules(root: str,
                 subdirs=("idunno_tpu_torch",)) -> dict[str, Module]:
    """Parse every .py under ``root``'s subdirs into Modules, keyed by
    repo-relative posix path. Unparseable files raise — a tree that does
    not parse has bigger problems than protocol drift."""
    modules: dict[str, Module] = {}
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base):
            rel = os.path.relpath(base, root)
            modules[rel.replace(os.sep, "/")] = Module(base, rel)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root)
                modules[rel.replace(os.sep, "/")] = Module(path, rel)
    return modules


def run_analysis(root: str, contracts=None, checkers=None,
                 modules: dict[str, Module] | None = None) -> dict:
    """Run the registered checkers and apply the allowlist.

    Returns {"findings": [Finding...], "files_scanned": int,
             "allowlisted": int, "allowlist_size": int,
             "by_checker": {name: count}} — findings include one
    ``allowlist`` entry per allowlist row that matched nothing (a stale
    suppression is a finding too: the ledger must describe the tree)."""
    # import here, not at module top: contracts imports checkers' registries
    from idunno_tpu_torch.analysis import contracts as contracts_mod
    from idunno_tpu_torch.analysis import (determinism, fence_check,  # noqa: F401
                                     idem_check, lock_discipline,
                                     retry_safety, stamp_check)
    ctr = contracts if contracts is not None else contracts_mod.default()
    if modules is None:
        modules = load_modules(root)
    names = list(checkers) if checkers else sorted(CHECKERS)
    raw: list[Finding] = []
    for name in names:
        raw.extend(CHECKERS[name](modules, ctr))
    kept: list[Finding] = []
    used = [False] * len(ctr.allowlist)
    suppressed = 0
    for f in raw:
        hit = False
        for i, a in enumerate(ctr.allowlist):
            if a.matches(f):
                used[i] = True
                hit = True
        if hit:
            suppressed += 1
        else:
            kept.append(f)
    for i, a in enumerate(ctr.allowlist):
        # an entry can only be judged stale by the checker that owns it:
        # a subset run (e.g. the chaos-soak determinism preflight) must
        # not age entries belonging to checkers that did not run
        if a.checker not in names:
            continue
        if not used[i]:
            kept.append(Finding(
                "allowlist", a.file, 0, a.symbol, a.tag,
                f"allowlist entry matches nothing on the tree "
                f"(checker={a.checker!r}): remove it or fix its anchor"))
    kept.sort(key=lambda f: (f.file, f.line, f.checker))
    by: dict[str, int] = {}
    for f in kept:
        by[f.checker] = by.get(f.checker, 0) + 1
    return {"findings": kept, "files_scanned": len(modules),
            "allowlisted": suppressed,
            "allowlist_size": len(ctr.allowlist), "by_checker": by}
