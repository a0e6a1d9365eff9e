"""lock-discipline: documented lock-guarded fields stay under their lock.

Contract: fields declared in ``contracts.GUARDED`` (e.g.
``ControlService._reg_lock`` over ``_lm_loops``/``_train_jobs``) are only
read or written inside a ``with self.<lock>:`` block. Transports run one
handler thread per connection, so an unguarded registry read races the
guarded writes — a check-then-act on a torn view leaks a loop or double-
spawns a job.

Conventions honored:
- ``__init__`` is exempt (no concurrency before construction returns).
- methods named ``*_locked`` assert the caller holds the lock — the
  repo's documented convention — and are exempt; callers are checked at
  their own call sites instead.
- declaring a *different* registered lock in the ``with`` does NOT count:
  the field's declared lock is the one that serializes it.
"""
from __future__ import annotations

import ast

from idunno_tpu_torch.analysis.core import Module, checker


def _with_locks(mod: Module, node: ast.AST) -> set[str]:
    """Names of self.<lock> contexts lexically enclosing ``node``."""
    out = set()
    for a in mod.ancestors(node):
        if isinstance(a, ast.With):
            for item in a.items:
                ctx = item.context_expr
                if (isinstance(ctx, ast.Attribute)
                        and isinstance(ctx.value, ast.Name)
                        and ctx.value.id == "self"):
                    out.add(ctx.attr)
    return out


@checker("lock")
def check(modules: dict[str, Module], contracts) -> list:
    findings = []
    for g in contracts.guarded:
        mod = modules.get(g.file)
        if mod is None:
            continue
        cls = mod.classes().get(g.cls)
        if cls is None:
            findings.append(mod.finding(
                "lock", mod.tree, g.cls,
                f"GUARDED registry names class {g.cls!r} which no longer "
                f"exists in {g.file} — update contracts.GUARDED")
                or _never())
            continue
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in g.fields):
                continue
            fn = mod.enclosing_function(node)
            if fn is None or fn.name == "__init__" \
                    or fn.name.endswith("_locked"):
                continue
            if g.lock in _with_locks(mod, node):
                continue
            f = mod.finding(
                "lock", node, f"{node.attr}@{fn.name}",
                f"{g.cls}.{node.attr} accessed in {fn.name!r} outside "
                f"'with self.{g.lock}:' — handler threads race the "
                f"guarded writers (declared in contracts.GUARDED)")
            if f is not None:
                findings.append(f)
    # one finding per (symbol, tag) — a field read twice in one method is
    # one discipline violation, not two ledger entries
    seen, out = set(), []
    for f in findings:
        k = (f.file, f.symbol, f.tag)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def _never():
    raise AssertionError("class-level findings are never pragma-suppressed")
