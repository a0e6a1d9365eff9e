"""Open-loop load for the gateway and autoscale LM bench suites: the
functions of ``tools/gateway_load.py`` and ``tools/autoscale_load.py`` that
``idunno_tpu/utils/lm_bench.py`` imports, copied so the port imports
nothing outside its own package.

``poisson_schedule``/``run_open_loop`` offer traffic the way a population
of independent clients would (Poisson arrivals pinned to wall-clock
offsets, never delayed by earlier completions); ``run_phases`` runs the
ramp/overload/underload regimes against one replica and the overload
against two behind ``ReplicaRouter``; ``summarize`` drives the real
``serve/autoscaler.py:Autoscaler`` through ``PolicyProbe`` on the
measured queue-wait p95s.
"""
from __future__ import annotations

import random
import time
from types import SimpleNamespace


# (tenant, priority, weight-in-mix, deadline_ms) — the default mix pairs a
# latency-sensitive interactive tenant against bulk batch traffic, the
# protect-the-interactive-class scenario the backpressure slacks encode
DEFAULT_MIX = (
    ("ivy", "interactive", 0.5, None),
    ("bulk", "batch", 0.5, None),
)


def poisson_schedule(rate_per_s: float, n: int, rng: random.Random,
                     mix=DEFAULT_MIX) -> list[tuple]:
    """``n`` arrivals as (t_offset_s, tenant, priority, deadline_ms),
    exponential inter-arrival gaps at ``rate_per_s``, mix drawn per
    arrival by weight. Deterministic under a seeded rng — the bench's
    offered load is reproducible run to run."""
    tenants = [m[0] for m in mix]
    weights = [m[2] for m in mix]
    by_tenant = {m[0]: m for m in mix}
    out, t = [], 0.0
    for _ in range(n):
        t += rng.expovariate(rate_per_s)
        tenant = rng.choices(tenants, weights=weights)[0]
        _, priority, _, deadline_ms = by_tenant[tenant]
        out.append((t, tenant, priority, deadline_ms))
    return out


def run_open_loop(loop, schedule, *, prompt_fn, max_new: int,
                  drain_timeout_s: float = 120.0,
                  poll_interval_s: float = 0.005) -> dict:
    """Offer ``schedule`` to ``loop`` open-loop and drain to completion.

    Returns per-class outcome counts (admitted / shed-by-reason /
    expired / completed), offered vs goodput request rates, goodput
    tokens/sec (generated tokens of non-rejected completions over the
    offer+drain wall clock), and the gateway's own queue-wait
    percentiles at the end of the run."""
    from idunno_tpu_torch.serve.admission import AdmissionShed

    classes: dict[str, dict] = {}

    def cls(priority: str) -> dict:
        return classes.setdefault(priority, {
            "offered": 0, "admitted": 0, "expired": 0, "completed": 0,
            "shed": {}})

    completions: dict[int, object] = {}
    admitted: dict[int, str] = {}            # rid -> priority

    def drain_polls() -> None:
        for c in loop.poll():
            completions[c.id] = c

    t0 = time.perf_counter()
    for t_off, tenant, priority, deadline_ms in schedule:
        while True:
            now = time.perf_counter() - t0
            if now >= t_off:
                break
            drain_polls()
            time.sleep(min(poll_interval_s, t_off - now))
        c = cls(priority)
        c["offered"] += 1
        try:
            rid = loop.submit(prompt_fn(), max_new, tenant=tenant,
                              priority=priority, deadline_ms=deadline_ms)
            admitted[rid] = priority
            c["admitted"] += 1
        except AdmissionShed as e:
            c["shed"][e.reason] = c["shed"].get(e.reason, 0) + 1
    offer_s = time.perf_counter() - t0

    deadline = time.perf_counter() + drain_timeout_s
    while (len(completions.keys() & admitted.keys()) < len(admitted)
           and time.perf_counter() < deadline):
        drain_polls()
        time.sleep(poll_interval_s)
    drain_polls()
    total_s = time.perf_counter() - t0

    goodput_tokens = 0
    for rid, priority in admitted.items():
        comp = completions.get(rid)
        if comp is None:
            continue
        if getattr(comp, "rejected", None) == "expired":
            cls(priority)["expired"] += 1
            continue
        cls(priority)["completed"] += 1
        goodput_tokens += len(comp.tokens) - comp.prompt_len

    n_offered = len(schedule)
    n_shed = sum(sum(c["shed"].values()) for c in classes.values())
    n_completed = sum(c["completed"] for c in classes.values())
    out = {
        "offered": n_offered,
        "offered_rps": round(n_offered / max(offer_s, 1e-9), 2),
        "goodput_rps": round(n_completed / max(total_s, 1e-9), 2),
        "tokens_per_s": round(goodput_tokens / max(total_s, 1e-9), 1),
        "shed_rate": round(n_shed / max(n_offered, 1), 3),
        "offer_s": round(offer_s, 3),
        "total_s": round(total_s, 3),
        "classes": classes,
    }
    gw = loop.stats().get("gateway")
    if gw:
        out["queue_wait_s"] = {p: c["queue_wait_s"]
                               for p, c in gw["classes"].items()}
    return out


# (name, offered load as a multiple of measured capacity)
PHASES = (("ramp", 0.8), ("overload", 2.0), ("underload", 0.3))


class ReplicaRouter:
    """Round-robins submissions across replica loops with namespaced
    rids — the group's decode routing stripped of the cluster, so
    `run_open_loop` can drive N replicas as one target."""

    _BASE = 1_000_000

    def __init__(self, loops) -> None:
        self.loops = list(loops)
        self._i = 0

    def submit(self, prompt, max_new, **kw) -> int:
        i = self._i % len(self.loops)
        self._i += 1
        return i * self._BASE + self.loops[i].submit(prompt, max_new, **kw)

    def poll(self):
        out = []
        for i, lp in enumerate(self.loops):
            for c in lp.poll():
                ns = SimpleNamespace(**vars(c))
                ns.id = i * self._BASE + c.id
                out.append(ns)
        return out

    def stats(self) -> dict:
        """Worst-replica gateway percentiles per class — the same
        max-over-replicas reduction the autoscaler's `_p95` applies."""
        classes: dict = {}
        for lp in self.loops:
            gw = lp.stats().get("gateway")
            if not gw:
                continue
            for p, c in gw["classes"].items():
                cur = classes.get(p)
                if (cur is None or c["queue_wait_s"].get("p95", 0.0)
                        > cur["queue_wait_s"].get("p95", 0.0)):
                    classes[p] = c
        return {"gateway": {"classes": classes}} if classes else {}


class PolicyProbe:
    """Minimal manager stand-in so the REAL `Autoscaler` control loop
    decides on measured gauges: the group_* mutations record decisions
    instead of placing pools. Shapes mirror `LMPoolManager.group_view`.

    Two repairs against ``tools/autoscale_load.py``'s probe, whose ticks
    raise inside `Autoscaler.tick` (logged, so its record carries no
    decisions): it lacked ``_quarantined_hosts``, and ``group_retire``/
    ``group_rebalance`` took no keyword attributes (the autoscaler passes
    ``predicted_rate``)."""

    def __init__(self, policy) -> None:
        self.policy = policy
        self.replicas = {"grp@r0": {"state": "active", "role": "decode",
                                    "t_drain": 0.0}}
        self._next = 1
        self.t_last_decision = 0.0
        self.decisions: list[dict] = []
        self.gauges: dict = {}
        self.now = 0.0

    def group_names(self):
        return ["grp"]

    def group_view(self, name):
        return {"policy": self.policy,
                "replicas": {r: dict(m, undelivered=0)
                             for r, m in self.replicas.items()},
                "t_last_decision": self.t_last_decision,
                "route_counts": {"total": 0, "prefill": 0},
                "debts": {}}

    def group_gauges(self, name):
        return dict(self.gauges)

    def _quarantined_hosts(self):
        return []                # the probe has no health ledger

    def _record(self, action: str, **attrs) -> dict:
        d = {"action": action, "t": round(self.now, 3), **attrs}
        self.decisions.append(d)
        self.t_last_decision = self.now
        return d

    def group_spawn(self, name, role="decode", **attrs):
        r = f"grp@r{self._next}"
        self._next += 1
        self.replicas[r] = {"state": "active", "role": role,
                            "t_drain": 0.0}
        return self._record("spawn", replica=r, role=role, **attrs)

    def group_retire_start(self, name, replica=None, **attrs):
        active = [r for r, m in self.replicas.items()
                  if m["state"] == "active"]
        if len(active) <= 1:
            return None
        victim = replica if replica is not None else max(active)
        self.replicas[victim].update(state="draining", t_drain=self.now)
        return self._record("retire_start", replica=victim, **attrs)

    def group_retire(self, name, replica, **attrs):
        if self.replicas.get(replica, {}).get("state") != "draining":
            return None
        del self.replicas[replica]
        return self._record("retire", replica=replica, **attrs)

    def group_rebalance(self, name, **attrs):
        return None


def probe_decisions(phase_p95: dict[str, float],
                    slack_s: float) -> dict:
    """Drive the real autoscaler through the measured regimes (one tick
    per phase on a fake clock, plus a drain tick) and return the
    decision stream — the record's proof of WHAT the loop does with
    these gauges on this hardware."""
    from idunno_tpu_torch.serve.autoscaler import Autoscaler, AutoscalePolicy

    policy = AutoscalePolicy(deadline_slack_s=slack_s, scale_in_frac=0.5,
                             dwell_s=1.0, drain_window_s=1.0,
                             max_replicas=2)
    probe = PolicyProbe(policy)
    auto = Autoscaler(probe, clock=lambda: probe.now)
    for i, (phase, _) in enumerate(PHASES):
        probe.now = 10.0 * (i + 1)
        # backlog 0: every phase drains fully, so p95 vs the slack is
        # the whole signal (the cumulative-window regime the scale-in
        # disjunction exists for)
        probe.gauges = {r: {"interactive_p95": phase_p95[phase], "n": 8,
                            "backlog": 0}
                        for r, m in probe.replicas.items()
                        if m["state"] == "active"}
        auto.tick()
    probe.now += 10.0        # past the drain window: retire completes
    auto.tick()
    return {"policy": {"deadline_slack_s": round(slack_s, 4),
                       "max_replicas": policy.max_replicas},
            "decisions": probe.decisions}


def interactive_p95(rec: dict) -> float:
    return float(((rec.get("queue_wait_s") or {})
                  .get("interactive") or {}).get("p95", 0.0))


def run_phases(make_loop, capacity_rps: float, *, n_requests: int,
               prompt_fn, max_new: int, seed: int = 0,
               deadline: float | None = None,
               scaled_overload: bool = True) -> dict:
    """The three offered-load regimes against one replica, plus the
    overload regime against TWO replicas behind a router. ``make_loop``
    builds a fresh gateway-fronted loop per phase (matching how every
    group replica owns its own gateway)."""
    out: dict = {}
    for i, (phase, multiple) in enumerate(PHASES):
        if deadline is not None and time.perf_counter() > deadline \
                and phase != "overload":
            continue        # the overload record is the headline
        loop = make_loop()
        try:
            sched = poisson_schedule(capacity_rps * multiple, n_requests,
                                     random.Random(seed + i))
            rec = run_open_loop(loop, sched, prompt_fn=prompt_fn,
                                max_new=max_new)
        finally:
            loop.stop()
        rec["load_multiple"] = multiple
        out[phase] = rec
    if scaled_overload:
        loops = [make_loop(), make_loop()]
        router = ReplicaRouter(loops)
        try:
            sched = poisson_schedule(capacity_rps * 2.0, n_requests,
                                     random.Random(seed + 1))
            rec = run_open_loop(router, sched, prompt_fn=prompt_fn,
                                max_new=max_new)
        finally:
            for lp in loops:
                lp.stop()
        rec["load_multiple"] = 2.0
        rec["replicas"] = 2
        out["overload_scaled"] = rec
    return out


def summarize(phases: dict) -> dict:
    """The scale-out story in four numbers + the probed decisions."""
    over = phases.get("overload", {})
    scaled = phases.get("overload_scaled", {})
    p95_before = interactive_p95(over)
    p95_after = interactive_p95(scaled)
    # Clockwork-style deadline slack, set between the measured regimes
    # so the record is robust to box speed: the overload regime breaches
    # it, the ramp regime (plus 10% headroom — if noise inverts the
    # regimes the probe honestly records NO decisions rather than a
    # scrambled spawn-at-ramp story) does not
    ramp_p95 = interactive_p95(phases.get("ramp", {}))
    slack = max(1e-3, 1.1 * ramp_p95, (ramp_p95 + p95_before) / 2.0)
    out = {"deadline_slack_s": round(slack, 4),
           "interactive_p95_1_replica": round(p95_before, 4),
           "interactive_p95_2_replicas": round(p95_after, 4),
           "slo_recovered": bool(p95_after <= slack < p95_before)}
    if over.get("goodput_rps") and scaled.get("goodput_rps"):
        out["goodput_gain"] = round(
            scaled["goodput_rps"] / max(over["goodput_rps"], 1e-9), 2)
    out.update(probe_decisions(
        {"ramp": ramp_p95, "overload": p95_before,
         "underload": interactive_p95(phases.get("underload", {}))},
        slack_s=slack))
    return out
