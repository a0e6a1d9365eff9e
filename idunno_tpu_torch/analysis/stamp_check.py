"""stamp-check: coordinator send sites stamp epoch and trace together.

Contract (the contributor rules' "when adding a coordinator verb"): a
coordinator-originated payload is stamped with the sender's fence view,
and the trace context rides beside the stamp. Mechanically, every
transport send site (``transport.call`` / ``transport.datagram`` /
``oneshot_call``) in the coordinator-plane modules must satisfy one of:

- the enclosing function stamps an epoch: an ``"epoch"`` dict key /
  ``epoch=`` kwarg / ``payload["epoch"] = ...`` store, or a call to
  ``membership.epoch.stamp`` — the coordinator form;
- the enclosing function is fence-aware on the *reply* path: it calls
  ``reply_is_stale`` or ``observe_payload`` — the client form (clients
  never stamp; they learn the fence from whoever answers);
- an allowlist entry justifies the exception (e.g. read-only
  observability fan-out where replies carry no fence view).

Trace coupling: a function that opens a span (``spans.start``) AND sends
must also ``stamp_trace`` the payload — a span that never rides the wire
breaks the waterfall exactly where a request crosses hosts.
"""
from __future__ import annotations

import ast

from idunno_tpu_torch.analysis.core import (Module, calls_named, checker, dotted,
                                      has_dict_key)

_SEND_ATTRS = ("transport.call", "transport.datagram")


def _send_calls(fn: ast.AST) -> list[tuple[ast.Call, str]]:
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name == "oneshot_call" or name.endswith(".oneshot_call"):
            out.append((node, "oneshot_call"))
        elif any(name == s or name.endswith("." + s)
                 for s in _SEND_ATTRS):
            out.append((node, name.split(".")[-1]))
    return out


@checker("stamp")
def check(modules: dict[str, Module], contracts) -> list:
    findings = []
    for rel, mod in modules.items():
        if not any(rel == t or rel.startswith(t)
                   for t in contracts.stamp_targets):
            continue
        seen_fns = set()
        for call, kind in _send_calls(mod.tree):
            fn = mod.enclosing_function(call)
            if fn is None or id(fn) in seen_fns:
                continue
            seen_fns.add(id(fn))
            stamps = (has_dict_key(fn, "epoch")
                      or bool(calls_named(fn, "stamp")))
            fence_aware = (bool(calls_named(fn, "reply_is_stale"))
                           or bool(calls_named(fn, "observe_payload")))
            if not stamps and not fence_aware:
                f = mod.finding(
                    "stamp", call, fn.name,
                    f"{kind} send in {fn.name!r} neither stamps an epoch "
                    f"(coordinator form) nor checks replies with "
                    f"reply_is_stale/observe_payload (client form) — a "
                    f"deposed sender would keep acting, a client would "
                    f"never learn the fence moved")
                if f is not None:
                    findings.append(f)
                    continue
            opens_span = any(
                dotted(c.func).endswith("spans.start")
                or dotted(c.func).endswith("self.spans.start")
                for c in ast.walk(fn) if isinstance(c, ast.Call))
            if opens_span and not calls_named(fn, "stamp_trace"):
                f = mod.finding(
                    "stamp", fn, f"{fn.name}:trace",
                    f"{fn.name!r} opens a span and sends, but never "
                    f"stamp_trace()s the payload — the trace breaks at "
                    f"the host boundary (stamp epoch and trace together)")
                if f is not None:
                    findings.append(f)
    return findings
