"""Fixture tests for the port's protocol-contract analyzer
(``idunno_tpu_torch/analysis/``, a copy of the JAX package's retargeted to
the port's tree).

Every checker gets a positive (seeded violation → finding) and a negative
(compliant twin → clean) fixture, built as tiny synthetic modules in a tmp
tree with purpose-built contracts — so the tests pin the checkers'
*semantics*, not the repo's current state. The repo-state gate (zero
findings on the shipped tree, <10 s) lives at the bottom, in the fast lane.

Encoded exemptions proven here:
- membership gossip handlers observe (never reject) any epoch;
- the ChaosCluster scripted-pressure rng rides ``self.rng`` — injected
  draws pass structurally while a bare ``random.random()`` is flagged.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

from idunno_tpu_torch.analysis.contracts import (Allow, Contracts, Guard,
                                           IdemVerb, RetrySite)
from idunno_tpu_torch.analysis.core import load_modules, run_analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _contracts(**over) -> Contracts:
    base = dict(
        fence_targets=("idunno_tpu_torch/",),
        stamp_targets=("idunno_tpu_torch/",),
        determinism_targets=("idunno_tpu_torch/",),
        idem_verbs=(), guarded=(), retry_safe=(), allowlist=())
    base.update(over)
    return Contracts(**base)


def _run(tmp_path, files: dict[str, str], contracts,
         checkers=None) -> list:
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    modules = load_modules(str(tmp_path))
    out = run_analysis(str(tmp_path), contracts=contracts,
                       checkers=checkers, modules=modules)
    return out["findings"]


# --------------------------------------------------------------------- #
# fence-check
# --------------------------------------------------------------------- #

UNFENCED = """
    class Svc:
        def __init__(self, transport):
            transport.serve("svc", self._handle)
        def _handle(self, service, msg):
            self._book = msg.payload           # mutate before any fence
            stale = check_payload(self.membership.epoch, msg.payload,
                                  self.host)
            if stale is not None:
                return stale
"""

FENCED = """
    class Svc:
        def __init__(self, transport):
            transport.serve("svc", self._handle)
        def _handle(self, service, msg):
            stale = check_payload(self.membership.epoch, msg.payload,
                                  self.host)
            if stale is not None:
                return stale
            self._book = msg.payload
"""


def test_fence_catches_mutation_before_check(tmp_path):
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": UNFENCED}, _contracts(),
              checkers=["fence"])
    assert [f.symbol for f in fs] == ["Svc._handle"]
    assert "check_payload" in fs[0].message


def test_fence_passes_fence_first_twin(tmp_path):
    assert _run(tmp_path, {"idunno_tpu_torch/svc.py": FENCED}, _contracts(),
                checkers=["fence"]) == []


def test_fence_sees_through_delegates(tmp_path):
    src = """
    class Svc:
        def __init__(self, transport):
            transport.serve("svc", self._handle)
        def _handle(self, service, msg):
            return self._inner(msg)
        def _inner(self, msg):
            self._book = msg.payload
    """
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": src}, _contracts(),
              checkers=["fence"])
    assert len(fs) == 1 and fs[0].symbol == "Svc._handle"


def test_fence_readonly_handler_needs_no_fence(tmp_path):
    src = """
    class Svc:
        def __init__(self, transport):
            transport.serve("svc", self._handle)
        def _handle(self, service, msg):
            return Message(MessageType.ACK, self.host,
                           {"lines": list(self.cache)})
    """
    assert _run(tmp_path, {"idunno_tpu_torch/svc.py": src}, _contracts(),
                checkers=["fence"]) == []


def test_fence_membership_gossip_exemption(tmp_path):
    gossip = """
    class Gossip:
        def __init__(self, transport):
            transport.serve("membership", self._handle)
        def _handle(self, service, msg):
            observe_payload(self.epoch, msg.payload)   # learn ANY epoch
            self._members = msg.payload["members"]
    """
    # under membership/: exempt (observe, never reject)
    assert _run(tmp_path, {"idunno_tpu_torch/membership/gossip.py": gossip},
                _contracts(), checkers=["fence"]) == []
    # the SAME handler outside membership/ is a finding: observe_payload
    # is not a fence
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/gossip.py": gossip},
              _contracts(), checkers=["fence"])
    assert len(fs) == 1


# --------------------------------------------------------------------- #
# stamp-check
# --------------------------------------------------------------------- #

def test_stamp_catches_unstamped_send(tmp_path):
    src = """
    class Coord:
        def push(self, h, payload):
            return self.transport.call(h, "svc",
                                       Message(MessageType.ACK, self.host,
                                               payload))
    """
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/c.py": src}, _contracts(),
              checkers=["stamp"])
    assert len(fs) == 1 and fs[0].symbol == "Coord.push"


def test_stamp_passes_coordinator_and_client_forms(tmp_path):
    src = """
    class Coord:
        def push(self, h):          # coordinator form: stamps the epoch
            payload = {"verb": "x", "epoch": list(self.epoch.view())}
            return self.transport.call(h, "svc", payload)

        def ask(self, h):           # client form: fence-aware replies
            out = self.transport.call(h, "svc", {"verb": "q"})
            if reply_is_stale(self.epoch, out):
                raise StaleEpoch(self.host)
            return out
    """
    assert _run(tmp_path, {"idunno_tpu_torch/serve/c.py": src}, _contracts(),
                checkers=["stamp"]) == []


def test_stamp_couples_span_with_trace_stamp(tmp_path):
    bad = """
    class Coord:
        def push(self, h, payload):
            sp = self.spans.start("push")
            payload["epoch"] = list(self.epoch.view())
            return self.transport.call(h, "svc", payload)
    """
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/c.py": bad}, _contracts(),
              checkers=["stamp"])
    assert [f.tag for f in fs] == ["push:trace"]
    good = bad.replace(
        'payload["epoch"] = list(self.epoch.view())',
        'payload["epoch"] = list(self.epoch.view())\n'
        '            stamp_trace(payload, (sp.trace_id, sp.span_id))')
    assert _run(tmp_path, {"idunno_tpu_torch/serve/c.py": good}, _contracts(),
                checkers=["stamp"]) == []


# --------------------------------------------------------------------- #
# idem-check
# --------------------------------------------------------------------- #

IDEM_OK = """
    class Svc:
        def submit(self, payload):
            key = payload.get("idem")
            if key is not None and key in self._idem:
                return self._idem[key]
            qnum = self._book(payload)
            if key is not None:
                self._idem[key] = qnum
            return qnum
"""


def test_idem_anchors_resolve_and_key_is_used(tmp_path):
    verbs = (IdemVerb("submit", "keyed", anchors=(
        ("idunno_tpu_torch/svc.py", "Svc.submit", "_idem"),)),)
    assert _run(tmp_path, {"idunno_tpu_torch/svc.py": IDEM_OK},
                _contracts(idem_verbs=verbs), checkers=["idem"]) == []


def test_idem_flags_refactored_away_dedupe(tmp_path):
    # the function exists but the dedupe structure is gone
    src = """
    class Svc:
        def submit(self, payload):
            return self._book(payload)
    """
    verbs = (IdemVerb("submit", "keyed", anchors=(
        ("idunno_tpu_torch/svc.py", "Svc.submit", "_idem"),)),)
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": src},
              _contracts(idem_verbs=verbs), checkers=["idem"])
    assert fs and all(f.checker == "idem" for f in fs)


def test_idem_flags_threaded_but_unused_key(tmp_path):
    # the marker is mentioned (assigned) but nothing ever dedupes on it
    src = """
    class Svc:
        def submit(self, payload):
            self._idem = {}
            return self._book(payload)
    """
    verbs = (IdemVerb("submit", "keyed", anchors=(
        ("idunno_tpu_torch/svc.py", "Svc.submit", "_idem"),)),)
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": src},
              _contracts(idem_verbs=verbs), checkers=["idem"])
    assert len(fs) == 1 and "nothing dedupes" in fs[0].message


def test_idem_flags_missing_anchor_function(tmp_path):
    verbs = (IdemVerb("submit", "keyed", anchors=(
        ("idunno_tpu_torch/svc.py", "Svc.gone", "_idem"),)),)
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": IDEM_OK},
              _contracts(idem_verbs=verbs), checkers=["idem"])
    assert any("missing function" in f.message for f in fs)


# --------------------------------------------------------------------- #
# determinism-lint
# --------------------------------------------------------------------- #

def test_determinism_flags_wall_clock_and_global_rng(tmp_path):
    src = """
    import time
    import random
    def decide():
        if random.random() < 0.5:        # global-rng decision
            return time.time()           # wall clock into state
        return 0.0
    """
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/x.py": src}, _contracts(),
              checkers=["determinism"])
    assert sorted(f.tag for f in fs) == ["random.random", "time.time"]


def test_determinism_injected_forms_pass(tmp_path):
    src = """
    import random
    import time
    class Harness:
        def __init__(self, seed, clock=time.monotonic):
            self.rng = random.Random(seed)   # seeded: the injection idiom
            self.clock = clock               # reference, not a draw
        def pressure(self):
            # ChaosCluster scripted-pressure shape: draws ride self.rng
            return self.rng.random() < 0.5 and self.clock() > 0
    """
    assert _run(tmp_path, {"idunno_tpu_torch/serve/x.py": src}, _contracts(),
                checkers=["determinism"]) == []


def test_determinism_flags_unseeded_random_and_aliases(tmp_path):
    src = """
    import random as rnd
    from datetime import datetime
    def f():
        r = rnd.Random()                 # unseeded construction
        return datetime.now(), r
    """
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/x.py": src}, _contracts(),
              checkers=["determinism"])
    assert sorted(f.tag for f in fs) == ["datetime.now", "random.Random"]


def test_determinism_scope_is_target_limited(tmp_path):
    src = "import time\nT0 = time.time()\n"
    ctr = _contracts(determinism_targets=("idunno_tpu_torch/serve/",))
    assert _run(tmp_path, {"idunno_tpu_torch/models/x.py": src}, ctr,
                checkers=["determinism"]) == []
    assert len(_run(tmp_path, {"idunno_tpu_torch/serve/x.py": src}, ctr,
                    checkers=["determinism"])) == 1


# --------------------------------------------------------------------- #
# lock-discipline
# --------------------------------------------------------------------- #

LOCK_SRC = """
    class Svc:
        def __init__(self):
            self._reg = {}                  # exempt: pre-concurrency
        def read_unlocked(self, name):
            return self._reg.get(name)      # RACE
        def read_locked(self, name):
            with self._reg_lock:
                return self._reg.get(name)
        def _scan_locked(self):
            return list(self._reg)          # caller holds the lock
"""


def test_lock_discipline_positive_and_negative(tmp_path):
    guards = (Guard("idunno_tpu_torch/svc.py", "Svc", "_reg_lock", ("_reg",)),)
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": LOCK_SRC},
              _contracts(guarded=guards), checkers=["lock"])
    assert [f.tag for f in fs] == ["_reg@read_unlocked"]


def test_lock_discipline_wrong_lock_does_not_count(tmp_path):
    src = """
    class Svc:
        def read(self, name):
            with self._other_lock:
                return self._reg.get(name)
    """
    guards = (Guard("idunno_tpu_torch/svc.py", "Svc", "_reg_lock", ("_reg",)),)
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": src},
              _contracts(guarded=guards), checkers=["lock"])
    assert len(fs) == 1


def test_lock_discipline_flags_stale_class_anchor(tmp_path):
    guards = (Guard("idunno_tpu_torch/svc.py", "Gone", "_l", ("_reg",)),)
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": LOCK_SRC},
              _contracts(guarded=guards), checkers=["lock"])
    assert len(fs) == 1 and "no longer exists" in fs[0].message


# --------------------------------------------------------------------- #
# retry-safety
# --------------------------------------------------------------------- #

def test_retry_flags_undeclared_site_and_passes_declared(tmp_path):
    src = """
    class C:
        def fire(self, msg):
            return call_with_retry(lambda: self.transport.call(
                "h", "svc", msg))
    """
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/c.py": src}, _contracts(),
              checkers=["retry"])
    assert len(fs) == 1 and "RETRY_SAFE" in fs[0].message
    sites = (RetrySite("idunno_tpu_torch/serve/c.py", "C.fire", verbs=("put",),
                       why="fixture: payloads carry the keyed put idem"),)
    verbs = (IdemVerb("put", "keyed", anchors=(
        ("idunno_tpu_torch/serve/c.py", "C.fire", "call_with_retry"),)),)
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/c.py": src},
              _contracts(retry_safe=sites, idem_verbs=verbs),
              checkers=["retry"])
    assert [f for f in fs if f.tag != "put"] == []


def test_retry_flags_stale_epoch_caught_and_retried(tmp_path):
    src = """
    class C:
        def fire(self, msg):
            try:
                return self.transport.call("h", "svc", msg)
            except StaleEpoch:
                return self.transport.call("h", "svc", msg)   # hammer
    """
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/c.py": src}, _contracts(),
              checkers=["retry"])
    assert any("step down" in f.message for f in fs)
    stop = src.replace(
        'return self.transport.call("h", "svc", msg)   # hammer',
        "return None                                   # step down")
    assert _run(tmp_path, {"idunno_tpu_torch/serve/c.py": stop}, _contracts(),
                checkers=["retry"]) == []


def test_retry_flags_forged_stale_epoch_reason(tmp_path):
    src = """
    def forge(host):
        raise TransportError(host, reason="stale_epoch")
    """
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/c.py": src}, _contracts(),
              checkers=["retry"])
    assert len(fs) == 1 and "forged" in fs[0].message


def test_retry_flags_stale_declaration(tmp_path):
    sites = (RetrySite("idunno_tpu_torch/serve/gone.py", "G.fire", verbs=(),
                       why="fixture: site was refactored away entirely"),)
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/c.py": "x = 1\n"},
              _contracts(retry_safe=sites), checkers=["retry"])
    assert [f.tag for f in fs] == ["stale-site"]


# --------------------------------------------------------------------- #
# suppression machinery
# --------------------------------------------------------------------- #

def test_allowlist_suppresses_and_stale_entry_is_a_finding(tmp_path):
    allow = (Allow("determinism", "idunno_tpu_torch/serve/x.py", "f",
                   "time.time",
                   "fixture: sanctioned wall-clock read for this test"),)
    src = "import time\ndef f():\n    return time.time()\n"
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/x.py": src},
              _contracts(allowlist=allow), checkers=["determinism"])
    assert fs == []
    # same allowlist, violation gone -> the entry itself is the finding
    fs = _run(tmp_path, {"idunno_tpu_torch/serve/x.py": "def f():\n    pass\n"},
              _contracts(allowlist=allow), checkers=["determinism"])
    assert [f.checker for f in fs] == ["allowlist"]


def test_subset_run_does_not_age_other_checkers_entries(tmp_path):
    # the chaos-soak preflight runs ONLY determinism: allowlist entries
    # owned by checkers that did not run must not be reported stale
    allow = (Allow("fence", "idunno_tpu_torch/svc.py", "S._h", "_h",
                   "fixture: owned by a checker that will not run here"),)
    assert _run(tmp_path, {"idunno_tpu_torch/svc.py": "x = 1\n"},
                _contracts(allowlist=allow),
                checkers=["determinism"]) == []
    # ...but a full run still ages it
    fs = _run(tmp_path, {"idunno_tpu_torch/svc.py": "x = 1\n"},
              _contracts(allowlist=allow))
    assert [f.checker for f in fs] == ["allowlist"]


def test_inline_pragma_requires_justification(tmp_path):
    with_why = ("import time\n"
                "def f():\n"
                "    return time.time()  "
                "# lint: ok determinism -- fixture says so\n")
    assert _run(tmp_path, {"idunno_tpu_torch/serve/x.py": with_why},
                _contracts(), checkers=["determinism"]) == []
    bare = with_why.replace(" -- fixture says so", "")
    assert len(_run(tmp_path, {"idunno_tpu_torch/serve/x.py": bare},
                    _contracts(), checkers=["determinism"])) == 1


def test_allow_rejects_empty_justification():
    import pytest
    with pytest.raises(ValueError):
        Allow("determinism", "f.py", "s", "t", "because")


# --------------------------------------------------------------------- #
# the shipped tree + driver
# --------------------------------------------------------------------- #

def test_shipped_tree_is_clean_and_fast():
    t0 = time.monotonic()
    out = run_analysis(ROOT)
    elapsed = time.monotonic() - t0
    assert out["findings"] == [], (
        "protocol lint regressed:\n" + "\n".join(
            f"  {f.checker} {f.file}:{f.line} {f.symbol} [{f.tag}] "
            f"{f.message}" for f in out["findings"]))
    assert out["files_scanned"] > 50
    assert elapsed < 10.0, f"analyzer took {elapsed:.1f}s (budget 10s)"


def test_driver_emits_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "idunno_tpu_torch.analysis"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    d = json.loads(lines[0])
    assert d["suite"] == "protocol_lint"
    assert d["findings_total"] == 0
    assert out.returncode == 0


# --------------------------------------------------------------------- #
# the port's own registries
# --------------------------------------------------------------------- #

# the mutating verbs of the port's control tier (serve/control.py), the
# ones it serves on its own engines included
PORT_MUTATING_VERBS = ("lm_submit", "lm_serve", "lm_stop", "generate",
                       "train_start", "train_stop", "prefix_publish",
                       "prefix_probe", "prefix_fetch", "kv_handoff",
                       "profile")


def test_analyzer_reads_the_port_only():
    mods = load_modules(ROOT)
    assert mods and all(rel.startswith("idunno_tpu_torch/") for rel in mods)
    assert "idunno_tpu_torch/serve/control.py" in mods
    assert "idunno_tpu_torch/chaos.py" in mods


def test_port_mutating_verbs_are_registered():
    """Each mutating verb the port's control tier dispatches is declared
    in IDEM_VERBS, so the idem checker resolves its anchors instead of
    passing over it."""
    from idunno_tpu_torch.analysis.contracts import IDEM_VERBS
    with open(os.path.join(ROOT, "idunno_tpu_torch", "serve",
                           "control.py")) as f:
        src = f.read()
    registered = {v.verb for v in IDEM_VERBS}
    for verb in PORT_MUTATING_VERBS:
        assert f'"{verb}"' in src, verb
        assert verb in registered, f"{verb} is not in IDEM_VERBS"


def test_lock_discipline_sees_the_ports_model_cache(tmp_path):
    """The port's control tier fills its load-once model cache under the
    registry lock; a copy that drops the lock is a finding."""
    from idunno_tpu_torch.analysis.contracts import GUARDED
    rel = "idunno_tpu_torch/serve/control.py"
    with open(os.path.join(ROOT, rel)) as f:
        src = f.read()
    guard = [g for g in GUARDED if g.file == rel]
    assert guard and "_lms" in guard[0].fields
    locked = ("            with self._reg_lock:\n"
              "                model = None if p.get(\"reload\") "
              "else self._lms.get(name)")
    assert locked in src
    bare = src.replace(locked, "            model = None if p.get("
                       "\"reload\") else self._lms.get(name)")
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text(src)
    ctr = _contracts(guarded=tuple(guard))
    assert run_analysis(str(tmp_path), contracts=ctr,
                        checkers=["lock"])["findings"] == []
    path.write_text(bare)
    fs = run_analysis(str(tmp_path), contracts=ctr,
                      checkers=["lock"])["findings"]
    assert [f.tag for f in fs] == ["_lms@_dispatch"], fs
