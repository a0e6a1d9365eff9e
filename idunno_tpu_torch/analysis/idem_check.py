"""idem-check: the mutating-verb registry keeps its exactly-once anchors.

Contract (the repository's contributor rules, comm/retry.py): every
mutating verb carries a client idempotency key deduped server-side (and
replicated with the journal), or is idempotent by construction (named
resource / journaled deterministic counter). ``contracts.IDEM_VERBS``
*declares* each verb and anchors the code that implements its story:
(file, qualname, marker). This checker verifies the anchors still resolve
— the anchored function exists and its source still contains the marker —
so a refactor that moves or drops a dedupe path turns into a loud finding
instead of a silent double-booking.

For ``kind="keyed"`` verbs it additionally requires a *use* of the key,
not just its mention: some anchored function must test membership or
``.get``/subscript the dedupe structure.
"""
from __future__ import annotations

from idunno_tpu_torch.analysis.core import Finding, Module, checker


@checker("idem")
def check(modules: dict[str, Module], contracts) -> list:
    findings = []
    for verb in contracts.idem_verbs:
        key_used = False
        for file, qualname, marker in verb.anchors:
            mod = modules.get(file)
            if mod is None:
                findings.append(Finding(
                    "idem", file, 0, qualname, verb.verb,
                    f"idem registry anchor for verb {verb.verb!r} names a "
                    f"missing file — update contracts.IDEM_VERBS"))
                continue
            fn = mod.function(qualname)
            if fn is None:
                findings.append(Finding(
                    "idem", file, 0, qualname, verb.verb,
                    f"idem registry anchor for verb {verb.verb!r} names a "
                    f"missing function {qualname!r} — the dedupe moved; "
                    f"update contracts.IDEM_VERBS to its new home"))
                continue
            seg = mod.segment(fn)
            if marker not in seg:
                findings.append(Finding(
                    "idem", file, fn.lineno, qualname, verb.verb,
                    f"anchor {qualname!r} no longer mentions {marker!r} — "
                    f"the {verb.verb!r} exactly-once path may have been "
                    f"refactored away; re-anchor or restore it"))
                continue
            if verb.kind == "keyed" and (
                    f"in self.{marker}" in seg or f"in {marker}" in seg
                    or f"{marker}.get(" in seg or f"{marker}[" in seg):
                key_used = True
        if verb.kind == "keyed" and not key_used:
            f0, q0, m0 = verb.anchors[0]
            findings.append(Finding(
                "idem", f0, 0, q0, verb.verb,
                f"verb {verb.verb!r} is declared keyed but no anchor "
                f"actually *uses* its dedupe structure ({m0!r}: no "
                f"membership test / .get / subscript) — the key is "
                f"threaded but nothing dedupes it"))
    return findings
