"""Built-in error-class linter: the ruff.toml baseline without ruff.

The container image does not ship ruff (and nothing may be pip-installed),
so the pinned error-class baseline (``ruff.toml``: F / E9 / PLE — classes
that are outright bugs, never style) is enforceable offline by this
fallback. ``tests/test_error_baseline.py`` prefers real ruff when a binary
is on PATH and falls back here otherwise; both must read ZERO on the tree.

Implemented checks (a deliberate, high-precision subset):

- E999  syntax error (``compile()`` — also catches tab/indent errors)
- F401  unused import (module scope; ``__init__.py`` skipped — re-export
        surface; names in ``__all__`` count as used)
- F841  local variable assigned but never read (simple ``name = ...``
        targets only; ``_``-prefixed names exempt by convention)
- F632  ``is``/``is not`` comparison against a str/number literal
- F541  f-string without any placeholder
- F821  undefined name — LENIENT: one module-wide defined-name set (no
        scope modeling), annotation subtrees skipped, wildcard imports
        disable it for the file; only true typos survive the filter

A ``# noqa`` comment on the flagged line suppresses it (bare, or listing
the code). Output mirrors the checkers' Finding shape so the two lint
surfaces read alike.
"""
from __future__ import annotations

import ast
import builtins
import os
import re
import warnings

_NOQA = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Z0-9, ]+))?", re.I)


def _noqa_lines(source: str) -> dict[int, set[str] | None]:
    """line -> set of codes (None = bare noqa, suppress everything)."""
    out: dict[int, set[str] | None] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _NOQA.search(text)
        if m:
            codes = m.group("codes")
            out[i] = (None if not codes else
                      {c.strip().upper() for c in codes.split(",")})
    return out


class _FileLint:
    def __init__(self, path: str, relpath: str) -> None:
        self.relpath = relpath
        with open(path, encoding="utf-8") as f:
            self.source = f.read()
        self.noqa = _noqa_lines(self.source)
        self.problems: list[dict] = []

    def flag(self, code: str, line: int, message: str) -> None:
        codes = self.noqa.get(line, ())
        if codes is None or (codes and code in codes):
            return
        self.problems.append({"code": code, "file": self.relpath,
                              "line": line, "message": message})

    def run(self) -> list[dict]:
        try:
            tree = ast.parse(self.source, filename=self.relpath)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", SyntaxWarning)
                compile(self.source, self.relpath, "exec")
        except SyntaxError as e:
            # E999 is never noqa-suppressible: a tree that does not parse
            # cannot be trusted to have parsed its own noqa comment
            self.problems.append({
                "code": "E999", "file": self.relpath,
                "line": e.lineno or 0, "message": f"syntax error: {e.msg}"})
            return self.problems
        except ValueError as e:   # e.g. null bytes
            self.problems.append({"code": "E999", "file": self.relpath,
                                  "line": 0, "message": str(e)})
            return self.problems
        self._f401(tree)
        self._f541_f632(tree)
        self._f841(tree)
        self._f821(tree)
        return self.problems

    # -- F401: unused module-scope imports --------------------------------

    def _f401(self, tree: ast.Module) -> None:
        if os.path.basename(self.relpath) == "__init__.py":
            return                         # re-export surface
        bound: dict[str, tuple[int, str]] = {}
        for node in tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    bound[name] = (node.lineno, a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        return             # can't reason about usage
                    bound[a.asname or a.name] = (node.lineno, a.name)
        if not bound:
            return
        used: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                base = node
                while isinstance(base, ast.Attribute):
                    base = base.value
                if isinstance(base, ast.Name):
                    used.add(base.id)
            elif (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                used.add(node.value)       # __all__ strings, doc refs
        for name, (line, orig) in bound.items():
            if name not in used:
                self.flag("F401", line, f"{orig!r} imported but unused")

    # -- F541 / F632 ------------------------------------------------------

    def _f541_f632(self, tree: ast.Module) -> None:
        # a "{x:08x}" format spec is itself a JoinedStr of constants on
        # py<3.12 — those are never F541
        specs = {id(n.format_spec) for n in ast.walk(tree)
                 if isinstance(n, ast.FormattedValue)
                 and n.format_spec is not None}
        for node in ast.walk(tree):
            if isinstance(node, ast.JoinedStr) and id(node) not in specs:
                if not any(isinstance(v, ast.FormattedValue)
                           for v in node.values):
                    self.flag("F541", node.lineno,
                              "f-string without any placeholders")
            elif isinstance(node, ast.Compare):
                for op, cmp in zip(node.ops, node.comparators):
                    if isinstance(op, (ast.Is, ast.IsNot)):
                        for side in (node.left, cmp):
                            if (isinstance(side, ast.Constant)
                                    and isinstance(side.value, (str, int,
                                                                float))
                                    and not isinstance(side.value, bool)):
                                self.flag("F632", node.lineno,
                                          "use == to compare str/num "
                                          "literals, not 'is'")

    # -- F841: assigned-but-never-read locals -----------------------------

    def _f841(self, tree: ast.Module) -> None:
        for fn in (n for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))):
            reads: set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                             ast.Load):
                    reads.add(node.id)
                elif isinstance(node, (ast.Global, ast.Nonlocal)):
                    reads.update(node.names)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if (isinstance(t, ast.Name)
                            and not t.id.startswith("_")
                            and t.id not in reads):
                        self.flag("F841", node.lineno,
                                  f"local {t.id!r} assigned but never "
                                  f"used")

    # -- F821: lenient undefined-name -------------------------------------

    def _f821(self, tree: ast.Module) -> None:
        defined = set(dir(builtins)) | {"__file__", "__name__", "__doc__",
                                        "__package__", "__spec__",
                                        "__builtins__", "__debug__"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)):
                defined.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                if not isinstance(node, ast.Lambda):
                    defined.add(node.name)
                a = node.args
                for arg in (a.posonlyargs + a.args + a.kwonlyargs
                            + ([a.vararg] if a.vararg else [])
                            + ([a.kwarg] if a.kwarg else [])):
                    defined.add(arg.arg)
            elif isinstance(node, ast.ClassDef):
                defined.add(node.name)
            elif isinstance(node, ast.Import):
                for al in node.names:
                    defined.add(al.asname or al.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for al in node.names:
                    if al.name == "*":
                        return             # wildcard: give up, stay quiet
                    defined.add(al.asname or al.name)
            elif isinstance(node, ast.ExceptHandler) and node.name:
                defined.add(node.name)
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                defined.update(node.names)
        skip: set[int] = set()             # ids of annotation subtrees
        for node in ast.walk(tree):
            ann = getattr(node, "annotation", None)
            if ann is not None:
                for sub in ast.walk(ann):
                    skip.add(id(sub))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.returns is not None:
                for sub in ast.walk(node.returns):
                    skip.add(id(sub))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and id(node) not in skip
                    and node.id not in defined):
                self.flag("F821", node.lineno,
                          f"undefined name {node.id!r}")


def lint_paths(root: str, targets) -> list[dict]:
    """Lint every .py under the given files/dirs (repo-relative)."""
    problems: list[dict] = []
    for target in targets:
        base = os.path.join(root, target)
        if os.path.isfile(base):
            problems.extend(_FileLint(base, target).run())
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                problems.extend(_FileLint(path, rel).run())
    problems.sort(key=lambda p: (p["file"], p["line"], p["code"]))
    return problems


# the baseline surface: the package, the drivers, the tools — tests are
# exercised by pytest itself and excluded on purpose (fixture files seed
# deliberate violations)
BASELINE_TARGETS = ("idunno_tpu_torch", "chip_smoke.py")


def main() -> int:
    import json
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    problems = lint_paths(root, BASELINE_TARGETS)
    print(json.dumps({"suite": "errorlint", "problems_total": len(problems),
                      "problems": problems[:50]}))
    return 0 if not problems else 1


if __name__ == "__main__":
    raise SystemExit(main())
