"""fence-check: every transport handler fences before it mutates.

Contract (the repository's contributor rules, membership/epoch.py): a
handler registered via ``transport.serve`` must run
``membership.epoch.check_payload`` before any state mutation, so a deposed
coordinator's stamped verbs are rejected typed instead of corrupting
adopted state. Exemptions, encoded here:

- membership gossip (modules under ``membership/``) calls
  ``observe_payload`` instead — gossip must carry ANY epoch so a deposed
  master learns it was deposed; rejecting stale gossip would prevent
  exactly that convergence.
- read-only handlers (no state mutation anywhere on their dispatch
  paths) have nothing to fence — e.g. the log-grep scanner.

Mutation = an assignment/del through ``self.<attr>`` (or a subscript of
one), or a call on a ``self.<attr>.<method>`` chain (conservatively: a
sub-object call may mutate it). Handlers that delegate (``return
self._x(msg)``) are analyzed through the delegate, three levels deep; a
delegate that fences internally before its own mutations counts as a
fence at the call site.
"""
from __future__ import annotations

import ast

from idunno_tpu_torch.analysis.core import Module, checker, dotted


def _is_self_attr(node: ast.AST) -> bool:
    """self.<attr> or a subscript chain rooted at one."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _events(mod: Module, cls: ast.ClassDef, fn: ast.FunctionDef,
            depth: int = 0):
    """Yield (lineno, kind) events in source order for ``fn``: kind in
    {"fence", "observe", "mutate"}. Delegate calls fold their callee's
    verdict into the call line."""
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    events: list[tuple[int, str]] = []
    for node in ast.walk(fn):
        line = getattr(node, "lineno", 0)
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(_is_self_attr(t) for t in targets):
                events.append((line, "mutate"))
        elif isinstance(node, ast.Delete):
            if any(_is_self_attr(t) for t in node.targets):
                events.append((line, "mutate"))
        elif isinstance(node, ast.Call):
            name = dotted(node.func)
            if name.endswith("check_payload"):
                events.append((line, "fence"))
            elif name.endswith("observe_payload"):
                events.append((line, "observe"))
            elif name.startswith("self."):
                parts = name.split(".")
                if len(parts) == 2 and parts[1] in methods:
                    if depth < 3:             # delegate: fold its verdict
                        sub = sorted(_events(mod, cls, methods[parts[1]],
                                             depth + 1))
                        verdict = _verdict(sub)
                        if verdict == "fenced":
                            events.append((line, "fence"))
                        elif verdict == "unfenced":
                            events.append((line, "mutate"))
                        if any(k == "observe" for _, k in sub):
                            events.append((line, "observe"))
                elif len(parts) >= 3:
                    # a call on a self-owned sub-object may mutate it
                    events.append((line, "mutate"))
    return events


def _verdict(events: list[tuple[int, str]]) -> str:
    """"clean" (no mutation), "fenced" (fence precedes first mutation,
    or fences and never mutates), or "unfenced"."""
    first_fence = min((ln for ln, k in events if k == "fence"),
                      default=None)
    first_mut = min((ln for ln, k in events if k == "mutate"),
                    default=None)
    if first_mut is None:
        return "fenced" if first_fence is not None else "clean"
    if first_fence is not None and first_fence <= first_mut:
        return "fenced"
    return "unfenced"


@checker("fence")
def check(modules: dict[str, Module], contracts) -> list:
    findings = []
    for rel, mod in modules.items():
        if not any(rel == t or rel.startswith(t)
                   for t in contracts.fence_targets):
            continue
        for call in (n for n in ast.walk(mod.tree)
                     if isinstance(n, ast.Call)):
            fname = dotted(call.func)
            if not fname.endswith("transport.serve") \
                    and fname != "transport.serve":
                continue
            if len(call.args) < 2:
                continue
            handler = call.args[1]
            cls = mod.enclosing_class(call)
            resolved = None
            if (cls is not None and isinstance(handler, ast.Attribute)
                    and isinstance(handler.value, ast.Name)
                    and handler.value.id == "self"):
                resolved = next(
                    (n for n in cls.body
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and n.name == handler.attr), None)
            if resolved is None:
                f = mod.finding(
                    "fence", call, f"handler:{dotted(handler) or '?'}",
                    "transport.serve handler is not a resolvable method "
                    "of this class — the fence contract cannot be "
                    "checked; register a named method")
                if f is not None:
                    findings.append(f)
                continue
            events = sorted(_events(mod, cls, resolved))
            verdict = _verdict(events)
            if verdict in ("clean", "fenced"):
                continue
            observes = any(k == "observe" for _, k in events)
            if observes and rel.startswith("idunno_tpu_torch/membership/"):
                continue        # gossip exemption: observe, never reject
            first_mut = min(ln for ln, k in events if k == "mutate")
            f = mod.finding(
                "fence", resolved, resolved.name,
                f"handler {resolved.name!r} mutates state (first at line "
                f"{first_mut}) without a prior "
                f"membership.epoch.check_payload — a deposed "
                f"coordinator's stamped verbs would not be rejected")
            if f is not None:
                findings.append(f)
    return findings
