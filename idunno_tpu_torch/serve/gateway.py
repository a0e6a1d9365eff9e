"""QoS admission gateway for LM serving pools.

Front door between `lm_submit` and a pool's decode loop:

- **Per-tenant token buckets** rate-limit admission (``rate`` requests/s
  refill, ``burst`` capacity; rate 0 = the burst is the whole budget,
  rate None = unlimited).
- **Weighted fair queueing** orders non-deadlined requests within a
  class by start-time-fair virtual finish tags (cost 1/weight per
  request), so a heavy tenant cannot starve a light one.
- **EDF within a class**: any request with a ``deadline_ms`` sorts by
  absolute deadline ahead of all undeadlined ones; ``interactive``
  always dispatches before ``batch``.
- **Backpressure** (`serve/admission.py:BackpressureConfig`) sheds at
  admission time from live pool gauges — before the decode loop
  saturates, not after.
- **Expiry**: a queued request whose deadline passes is never
  dispatched; `take` returns it separately so the serving loop can
  complete it with ``rejected="expired"``.

All decisions go through an injectable monotonic ``clock`` so the unit
tests (`tests/test_gateway.py`) drive quotas/EDF/expiry deterministically
with a fake clock — no wall-clock sleeps in the fast lane.

The gateway is pool-local (one instance per `LMServingLoop`); the
manager journal records sheds/expiries as terminal states so recovery
never resubmits a request the gateway already rejected
(`serve/lm_manager.py`).
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from idunno_tpu_torch.serve.admission import (
    PRIORITIES, SHED_REASONS, AdmissionShed, BackpressureConfig)
from idunno_tpu_torch.serve.metrics import _percentile

DEFAULT_TENANT = "default"
_WAIT_WINDOW = 512       # queue-wait samples kept per class for p50/p99
_SHED_RING = 20          # recent sheds surfaced in lm-tail

_SPEC_KEYS = frozenset({
    "tenants", "default", "max_queue",
    "batch_wait_slack", "interactive_wait_slack", "min_free_kv_frac"})
_QUOTA_KEYS = frozenset({"rate", "burst", "weight"})


class TokenBucket:
    """Classic token bucket with an externally supplied ``now``."""

    __slots__ = ("rate", "burst", "_tokens", "_t")

    def __init__(self, rate: float | None, burst: float, now: float) -> None:
        self.rate = None if rate is None else float(rate)
        self.burst = float(burst)
        self._tokens = self.burst
        self._t = now

    def try_take(self, now: float) -> bool:
        if self.rate is None:
            return True
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


def _norm_quota(q: dict | None) -> dict:
    q = dict(q or {})
    unknown = set(q) - _QUOTA_KEYS
    if unknown:
        raise ValueError(f"unknown quota keys: {sorted(unknown)}")
    rate = q.get("rate")
    out = {"rate": None if rate is None else float(rate),
           "burst": float(q.get("burst", 1.0)),
           "weight": float(q.get("weight", 1.0))}
    if out["rate"] is not None and out["rate"] < 0:
        raise ValueError("quota rate must be >= 0 (None = unlimited)")
    if out["burst"] < 1.0:
        raise ValueError("quota burst must be >= 1")
    if out["weight"] <= 0:
        raise ValueError("quota weight must be > 0")
    return out


@dataclass
class _Entry:
    rid: int
    tenant: str
    priority: str
    payload: Any
    t_enq: float
    deadline: float | None   # absolute clock time, None = no deadline
    ft: float                # WFQ virtual finish tag
    seq: int

    def key(self) -> tuple:
        return (self.deadline if self.deadline is not None else math.inf,
                self.ft, self.seq)


@dataclass
class _ClassState:
    queue: list = field(default_factory=list)
    vt: float = 0.0                       # class virtual time
    last_ft: dict = field(default_factory=dict)   # tenant → last finish tag
    admitted: int = 0
    dispatched: int = 0
    expired: int = 0
    shed: dict = field(default_factory=lambda: {r: 0 for r in SHED_REASONS
                                                if r != "expired"})
    waits: deque = field(default_factory=lambda: deque(maxlen=_WAIT_WINDOW))


class AdmissionGateway:
    """One gateway fronting one serving loop; all methods thread-safe."""

    def __init__(self, spec: dict | None = None, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        spec = self.validate_spec(spec)
        self.clock = clock
        self._lock = threading.Lock()
        self._quotas = {t: _norm_quota(q)
                        for t, q in (spec.get("tenants") or {}).items()}
        self._default_quota = _norm_quota(spec.get("default"))
        self.max_queue = int(spec.get("max_queue", 256))
        self.backpressure = BackpressureConfig(
            batch_wait_slack=float(spec.get("batch_wait_slack", 2.0)),
            interactive_wait_slack=float(
                spec.get("interactive_wait_slack", 4.0)),
            min_free_kv_frac=float(spec.get("min_free_kv_frac", 0.125)))
        self._buckets: dict[str, TokenBucket] = {}
        self._classes = {p: _ClassState() for p in PRIORITIES}
        self._tenants: dict[str, dict] = {}   # per-tenant counters
        self._seq = 0
        self._recent_sheds: deque = deque(maxlen=_SHED_RING)

    @staticmethod
    def validate_spec(spec: dict | bool | None) -> dict:
        """Normalize/validate a gateway spec (loudly, before any registry
        mutation in `serve/control.py`). ``True``/None/{} = all defaults."""
        if spec is None or spec is True:
            spec = {}
        if not isinstance(spec, dict):
            raise ValueError(f"gateway spec must be a dict, got "
                             f"{type(spec).__name__}")
        unknown = set(spec) - _SPEC_KEYS
        if unknown:
            raise ValueError(f"unknown gateway spec keys: {sorted(unknown)}")
        for t, q in (spec.get("tenants") or {}).items():
            _norm_quota(q)
        _norm_quota(spec.get("default"))
        if int(spec.get("max_queue", 256)) < 1:
            raise ValueError("gateway max_queue must be >= 1")
        return dict(spec)

    # -- internals (call with self._lock held) ----------------------------

    def _quota(self, tenant: str) -> dict:
        return self._quotas.get(tenant, self._default_quota)

    def _tenant_counters(self, tenant: str) -> dict:
        return self._tenants.setdefault(
            tenant, {"admitted": 0, "dispatched": 0, "shed": 0, "expired": 0})

    def _queued_total_locked(self) -> int:
        return sum(len(c.queue) for c in self._classes.values())

    def _shed_locked(self, tenant: str, priority: str, reason: str,
                     detail: str) -> AdmissionShed:
        self._classes[priority].shed[reason] += 1
        self._tenant_counters(tenant)["shed"] += 1
        self._recent_sheds.append({"tenant": tenant, "priority": priority,
                                   "reason": reason, "detail": detail})
        return AdmissionShed(reason, detail)

    # -- submit side ------------------------------------------------------

    def admit(self, rid: int, payload: Any, *, tenant: str = DEFAULT_TENANT,
              priority: str = "interactive", deadline_ms: float | None = None,
              pool_gauges: dict | None = None, readmit: bool = False) -> None:
        """Admit-or-shed + enqueue, atomically. Raises AdmissionShed on
        rejection (counters already recorded). ``readmit=True`` bypasses
        quota/backpressure/queue-full: the manager re-forwards
        already-admitted requests after node death, and a replay must
        never be shed (the client was told it was in)."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        if deadline_ms is not None and float(deadline_ms) <= 0:
            raise ValueError("deadline_ms must be > 0")
        now = self.clock()
        with self._lock:
            cls = self._classes[priority]
            if not readmit:
                if not self._bucket_locked(tenant, now).try_take(now):
                    raise self._shed_locked(
                        tenant, priority, "quota",
                        f"tenant {tenant!r} over rate limit")
                if self._queued_total_locked() >= self.max_queue:
                    raise self._shed_locked(
                        tenant, priority, "queue_full",
                        f"gateway queue at max_queue={self.max_queue}")
                gauges = dict(pool_gauges or {})
                gauges["waiting"] = (int(gauges.get("waiting", 0))
                                    + self._queued_total_locked())
                detail = self.backpressure.pressure_reason(priority, gauges)
                if detail is not None:
                    raise self._shed_locked(tenant, priority,
                                            "backpressure", detail)
            quota = self._quota(tenant)
            start = max(cls.vt, cls.last_ft.get(tenant, 0.0))
            ft = start + 1.0 / quota["weight"]
            cls.last_ft[tenant] = ft
            self._seq += 1
            cls.queue.append(_Entry(
                rid=rid, tenant=tenant, priority=priority, payload=payload,
                t_enq=now,
                deadline=(None if deadline_ms is None
                          else now + float(deadline_ms) / 1000.0),
                ft=ft, seq=self._seq))
            cls.admitted += 1
            self._tenant_counters(tenant)["admitted"] += 1

    def _bucket_locked(self, tenant: str, now: float) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            q = self._quota(tenant)
            b = self._buckets[tenant] = TokenBucket(q["rate"], q["burst"], now)
        return b

    # -- dispatch side (serving loop thread) ------------------------------

    def take(self, budget: int,
             now: float | None = None) -> tuple[list[_Entry], list[_Entry]]:
        """Pop up to ``budget`` dispatchable entries (class order, then
        EDF, then WFQ finish tags) plus ALL expired entries (returned
        regardless of budget — an expired request must complete as
        rejected promptly, not wait for dispatch headroom)."""
        if now is None:
            now = self.clock()
        ready: list[_Entry] = []
        expired: list[_Entry] = []
        with self._lock:
            for p in PRIORITIES:
                cls = self._classes[p]
                if not cls.queue:
                    continue
                cls.queue.sort(key=_Entry.key)
                keep: list[_Entry] = []
                for e in cls.queue:
                    if e.deadline is not None and e.deadline < now:
                        expired.append(e)
                        cls.expired += 1
                        self._tenant_counters(e.tenant)["expired"] += 1
                    elif len(ready) < budget:
                        ready.append(e)
                        cls.dispatched += 1
                        cls.vt = max(cls.vt, e.ft)
                        cls.waits.append(max(0.0, now - e.t_enq))
                        self._tenant_counters(e.tenant)["dispatched"] += 1
                    else:
                        keep.append(e)
                cls.queue = keep
        return ready, expired

    def cancel(self, rid: int) -> _Entry | None:
        """Remove a still-queued entry (None = not queued here)."""
        with self._lock:
            for cls in self._classes.values():
                for i, e in enumerate(cls.queue):
                    if e.rid == rid:
                        del cls.queue[i]
                        return e
        return None

    def queued(self) -> int:
        with self._lock:
            return self._queued_total_locked()

    def drain(self) -> list[_Entry]:
        """Pop everything (pool stop: pending entries error upstream)."""
        with self._lock:
            out = [e for p in PRIORITIES for e in self._classes[p].queue]
            for cls in self._classes.values():
                cls.queue = []
            return out

    # -- observability ----------------------------------------------------

    def recent_sheds(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._recent_sheds]

    def stats(self) -> dict:
        """Per-class and per-tenant counters + queue-wait percentiles +
        reject rates — the `lm_stats`/`lm_qos`/`serve/metrics.py` surface."""
        with self._lock:
            classes = {}
            for p, cls in self._classes.items():
                shed_n = sum(cls.shed.values())
                submitted = cls.admitted + shed_n
                waits = sorted(cls.waits)
                classes[p] = {
                    "queued": len(cls.queue),
                    "admitted": cls.admitted,
                    "dispatched": cls.dispatched,
                    "expired": cls.expired,
                    "shed": dict(cls.shed),
                    "reject_rate": ((shed_n + cls.expired) / submitted
                                    if submitted else 0.0),
                    # p95 is the autoscaler's Clockwork-style SLO signal
                    # (serve/autoscaler.py): scale-out triggers when
                    # interactive p95 crosses the deadline slack
                    "queue_wait_s": {"p50": _percentile(waits, 50),
                                     "p95": _percentile(waits, 95),
                                     "p99": _percentile(waits, 99),
                                     "n": len(waits)},
                }
            tenants = {}
            for t, c in self._tenants.items():
                q = self._quota(t)
                tenants[t] = dict(
                    c, queued=sum(1 for cls in self._classes.values()
                                  for e in cls.queue if e.tenant == t),
                    rate=q["rate"], burst=q["burst"], weight=q["weight"])
            return {"queued": self._queued_total_locked(),
                    "max_queue": self.max_queue,
                    "classes": classes, "tenants": tenants,
                    "recent_sheds": [dict(s) for s in self._recent_sheds]}
