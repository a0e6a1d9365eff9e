"""retry-safety: retries only where exactly-once is guaranteed.

Three rules, grounded in comm/retry.py and membership/epoch.py:

1. every ``call_with_retry`` call site must be declared in
   ``contracts.RETRY_SAFE`` (file + enclosing qualname + the idem-registry
   verbs it may carry, with a justification). An undeclared site is a
   finding: retrying an unkeyed mutation double-books on a lost ACK.
   Declared sites are cross-checked — every verb they claim must exist in
   the idem registry, and a declared site that no longer exists is stale.

2. ``StaleEpoch`` is never caught-and-retried: an ``except`` clause that
   names StaleEpoch and then calls a send/retry helper (or ``continue``s
   a loop that does) is a finding — a fenced coordinator must step down,
   not hammer the new owner. Catching it to *stop* (log, return, raise)
   is the sanctioned shape.

3. nobody forges the fence: constructing ``TransportError(...,
   reason="stale_epoch")`` outside membership/epoch.py would bypass the
   typed never-retryable contract.
"""
from __future__ import annotations

import ast

from idunno_tpu_torch.analysis.core import Finding, Module, checker, dotted


def _handles_stale(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names = []
    if t is not None:
        names = [dotted(n) for n in ast.walk(t)
                 if isinstance(n, (ast.Name, ast.Attribute))]
    return any(n.endswith("StaleEpoch") for n in names)


@checker("retry")
def check(modules: dict[str, Module], contracts) -> list:
    findings = []
    declared = {(s.file, s.symbol): s for s in contracts.retry_safe}
    seen_sites = set()
    idem_verbs = {v.verb for v in contracts.idem_verbs}

    for s in contracts.retry_safe:
        for v in s.verbs:
            if v not in idem_verbs:
                findings.append(Finding(
                    "retry", s.file, 0, s.symbol, f"verb:{v}",
                    f"RETRY_SAFE site {s.symbol!r} claims verb {v!r} "
                    f"which is not in the idem registry — declare the "
                    f"verb's exactly-once story first"))

    for rel, mod in modules.items():
        if not rel.startswith("idunno_tpu_torch/"):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and (
                    dotted(node.func).endswith("call_with_retry")):
                qual = mod.qualname(node)
                seen_sites.add((rel, qual))
                if (rel, qual) not in declared:
                    f = mod.finding(
                        "retry", node, qual,
                        f"call_with_retry in {qual!r} is not declared in "
                        f"contracts.RETRY_SAFE — an unkeyed mutating verb "
                        f"retried after a lost ACK double-books; declare "
                        f"the site with the verbs it carries and why "
                        f"each is retry-safe")
                    if f is not None:
                        findings.append(f)
            elif isinstance(node, ast.ExceptHandler) \
                    and _handles_stale(node):
                resends = any(
                    isinstance(c, ast.Call) and any(
                        dotted(c.func).endswith(x) for x in
                        ("call_with_retry", "transport.call",
                         "oneshot_call", ".datagram"))
                    for c in ast.walk(node))
                loops_on = any(isinstance(c, ast.Continue)
                               for c in ast.walk(node))
                if resends or loops_on:
                    f = mod.finding(
                        "retry", node, mod.qualname(node),
                        "except StaleEpoch handler retries/continues — a "
                        "fenced coordinator must step down (the typed "
                        "rejection is never retryable by design)")
                    if f is not None:
                        findings.append(f)
            elif isinstance(node, ast.Call) \
                    and dotted(node.func).endswith("TransportError") \
                    and rel != "idunno_tpu_torch/membership/epoch.py":
                if any(kw.arg == "reason"
                       and isinstance(kw.value, ast.Constant)
                       and kw.value.value == "stale_epoch"
                       for kw in node.keywords):
                    f = mod.finding(
                        "retry", node, mod.qualname(node),
                        "TransportError(reason='stale_epoch') forged "
                        "outside membership/epoch.py — raise the typed "
                        "StaleEpoch so retry/step-down semantics hold")
                    if f is not None:
                        findings.append(f)

    for (file, symbol), s in declared.items():
        if (file, symbol) not in seen_sites:
            findings.append(Finding(
                "retry", file, 0, symbol, "stale-site",
                f"RETRY_SAFE declares {symbol!r} in {file} but no "
                f"call_with_retry site exists there anymore — remove or "
                f"re-anchor the declaration"))
    return findings


@checker("hedge")
def check_hedge(modules: dict[str, Module], contracts) -> list:
    """hedge-safety: tail-hedged duplicates only for declared read verbs.

    Mirrors the retry checker for ``call_hedged``: every call
    site must be declared in ``contracts.HEDGE_SAFE``, every verb a site
    claims must exist in the ``HEDGE_VERBS`` registry of idempotent
    reads, and stale declarations are findings. Hedging an undeclared
    verb is the same bug class as retrying an unkeyed mutation — the
    duplicate request lands twice."""
    findings = []
    hedge_sites = tuple(getattr(contracts, "hedge_safe", ()) or ())
    hedge_verbs = {v.verb for v in
                   getattr(contracts, "hedge_verbs", ()) or ()}
    declared = {(s.file, s.symbol): s for s in hedge_sites}
    seen_sites = set()

    for s in hedge_sites:
        for v in s.verbs:
            if v not in hedge_verbs:
                findings.append(Finding(
                    "hedge", s.file, 0, s.symbol, f"verb:{v}",
                    f"HEDGE_SAFE site {s.symbol!r} claims verb {v!r} "
                    f"which is not in HEDGE_VERBS — declare why a "
                    f"duplicated concurrent read of it converges first"))

    for rel, mod in modules.items():
        if not rel.startswith("idunno_tpu_torch/"):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and (
                    dotted(node.func).endswith("call_hedged")):
                qual = mod.qualname(node)
                seen_sites.add((rel, qual))
                if (rel, qual) not in declared:
                    f = mod.finding(
                        "hedge", node, qual,
                        f"call_hedged in {qual!r} is not declared in "
                        f"contracts.HEDGE_SAFE — a hedged mutation lands "
                        f"twice; declare the site with its idempotent "
                        f"read verbs and why first-reply-wins is safe")
                    if f is not None:
                        findings.append(f)

    for (file, symbol), s in declared.items():
        if (file, symbol) not in seen_sites:
            findings.append(Finding(
                "hedge", file, 0, symbol, "stale-site",
                f"HEDGE_SAFE declares {symbol!r} in {file} but no "
                f"call_hedged site exists there anymore — remove or "
                f"re-anchor the declaration"))
    return findings
