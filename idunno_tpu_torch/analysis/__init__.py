"""Protocol-contract static analyzer.

The control plane's safety rests on conventions the chaos harness can only
certify *after* the fact (a forgotten ``check_payload`` in a new verb shows
up as a split-brain seed, if a schedule happens to hit it). This package
enforces the conventions mechanically, at the AST level, before any soak:

- fence-check      — every ``transport.serve`` handler fences with
                     ``membership.epoch.check_payload`` before mutating
                     (membership gossip observes instead, by design)
- stamp-check      — coordinator-originated send sites stamp epoch and
                     trace together (or are fence-aware clients)
- idem-check       — the declared mutating-verb registry keeps its client
                     key + server dedupe anchors through refactors
- determinism-lint — no wall-clock/rng draws in chaos-reachable modules
                     outside the injected clock/seed parameters
- lock-discipline  — fields documented as lock-guarded are only touched
                     under ``with`` on that lock
- retry-safety     — ``call_with_retry`` only wraps registered-safe verbs;
                     ``StaleEpoch`` is never caught-and-retried

Driver: ``python -m idunno_tpu_torch.analysis`` (ONE JSON line, like
bench.py). Gate: ``tests/test_torch_protocol_lint.py`` asserts zero
findings on the port's tree; ``python -m idunno_tpu_torch.chaos_soak``
refuses to soak over determinism-lint findings.

Suppressions go in ``analysis/allowlist.py`` — one entry per call site,
each with a mandatory justification sentence.
"""
from idunno_tpu_torch.analysis.core import (CHECKERS, Finding, Module,
                                      load_modules, run_analysis)

__all__ = ["CHECKERS", "Finding", "Module", "load_modules", "run_analysis"]
