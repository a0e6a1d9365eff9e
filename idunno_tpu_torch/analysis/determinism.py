"""determinism-lint: no wall-clock or rng draws in chaos-reachable code.

The chaos harness (idunno_tpu_torch/chaos.py) replays one seed through
fake clocks and a seeded network; a single ``time.time()`` read that lands
in journaled state, or one global-rng draw on a decision path, makes a
printed seed unreplayable. The contract (the contributor rules):
chaos-reachable modules draw time/randomness only through injected
clock/seed parameters.

What counts as a draw (only *calls* are flagged — referencing
``time.monotonic`` to build a default parameter or pass an injection IS
the sanctioned mechanism and passes):

- ``time.time/monotonic/perf_counter/strftime/...`` calls
- ``datetime.now/utcnow/today`` calls (module or class form)
- module-level ``random.<draw>()`` calls, including via aliases and
  ``from random import ...``; ``random.Random(seed)`` with an argument is
  the injection idiom and passes, ``random.Random()`` bare does not
- any ``secrets.*`` call

``time.sleep`` is deliberately not flagged: pacing real threads is not a
clock *read* and never lands in journaled state. Draws on non-module
objects (``self.rng.random()``, ``self.clock()``) pass structurally —
that is the injected form. The ChaosCluster scripted-pressure rng rides
``self.rng`` and so needs no carve-out entry.
"""
from __future__ import annotations

import ast

from idunno_tpu_torch.analysis.core import Module, checker

TIME_DRAWS = {"time", "monotonic", "perf_counter", "process_time",
              "thread_time", "time_ns", "monotonic_ns",
              "perf_counter_ns", "strftime", "localtime", "gmtime",
              "ctime", "asctime"}
DATETIME_DRAWS = {"now", "utcnow", "today"}
RANDOM_OK = {"Random", "SystemRandom", "seed", "getstate", "setstate"}


def _module_aliases(tree: ast.Module) -> dict[str, str]:
    """name -> stdlib module it binds ("time", "random", ...)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("time", "random", "secrets", "datetime"):
                    out[a.asname or a.name] = a.name
    return out


def _from_imports(tree: ast.Module) -> dict[str, tuple[str, str]]:
    """bound name -> (module, original name) for the flagged modules."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
                "time", "random", "secrets", "datetime"):
            for a in node.names:
                out[a.asname or a.name] = (node.module, a.name)
    return out


def _names_in(expr: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


@checker("determinism")
def check(modules: dict[str, Module], contracts) -> list:
    findings = []
    for rel, mod in modules.items():
        if not any(rel == t or rel.startswith(t)
                   for t in contracts.determinism_targets):
            continue
        aliases = _module_aliases(mod.tree)
        froms = _from_imports(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            tag = _draw(node, aliases, froms)
            if tag is None:
                continue
            f = mod.finding(
                "determinism", node, tag,
                f"{tag}() draw in chaos-reachable module: route it "
                f"through an injected clock/rng parameter (see "
                f"comm/retry.py, serve/autoscaler.py for the idiom)")
            if f is not None:
                findings.append(f)
    return findings


def _draw(call: ast.Call, aliases: dict[str, str],
          froms: dict[str, tuple[str, str]]) -> str | None:
    """The dotted draw name if this call is a flagged draw, else None."""
    fn = call.func
    if isinstance(fn, ast.Name):
        src = froms.get(fn.id)
        if src is None:
            return None
        module, orig = src
        return _flagged(module, orig, call)
    if isinstance(fn, ast.Attribute):
        # receiver may be any expression mentioning a module alias
        # (``(rng or random).random`` still draws from the module)
        for name in _names_in(fn.value):
            module = aliases.get(name)
            if module is None and name in ("datetime", "date"):
                src = froms.get(name)
                module = src[0] if src else None
            if module is None:
                continue
            hit = _flagged(module, fn.attr, call)
            if hit:
                return hit
    return None


def _flagged(module: str, attr: str, call: ast.Call) -> str | None:
    if module == "time" and attr in TIME_DRAWS:
        return f"time.{attr}"
    if module == "datetime" and attr in DATETIME_DRAWS:
        return f"datetime.{attr}"
    if module == "secrets":
        return f"secrets.{attr}"
    if module == "random":
        if attr in RANDOM_OK:
            if attr == "Random" and not call.args and not call.keywords:
                return "random.Random"      # unseeded construction
            return None
        return f"random.{attr}"
    return None
