"""Closed-loop capacity: gauge-driven autoscaler for replica pool groups.

An `lm_serve` spec that carries `autoscale={...}` creates a replica pool
GROUP instead of a single pool (`serve/lm_manager.py`): the group owns a
set of ordinary managed replica pools (`{group}@r{i}`, deterministic
names journaled as `next_replica` — the spawn idempotency backstop,
since `LMPoolManager.serve` answers `{"already": True}` for a name that
exists) and the `Autoscaler` here closes the loop over them from the
acting master's `pump_once`:

  - scale OUT when the interactive p95 queue wait (the gateway's
    Clockwork-style SLO signal, `serve/gateway.py` `queue_wait_s.p95`)
    crosses `deadline_slack_s` — spawning a decode replica, or a
    `prefill_chunk`-tuned PREFILL replica when long-prompt admissions
    dominate (DistServe's prefill/decode split at request-routing
    granularity; Zhong et al., OSDI 2024);
  - scale IN when the signal falls below `scale_in_frac * slack` (or
    the group goes idle): mark the newest replica DRAINING — it takes
    no new routing but keeps delivering — and retire it only once every
    journaled request on it has been DELIVERED and `drain_window_s`
    has elapsed (zero admitted-request loss);
  - REBALANCE tenants across decode replicas by WFQ debt (outstanding
    journal work weighted by 1/tenant-weight) when the debt gap
    exceeds `rebalance_debt`.

Determinism: the loop runs on an injected `clock` and an injectable
`gauges_fn`, so unit tests (`tests/test_autoscaler.py`) and the chaos
harness drive threshold crossings on a fake clock with scripted gauges.
At most one scaling decision per group per `dwell_s` (retires of
already-draining replicas are completion of a prior decision and are
exempt). Every decision is journaled on the group (epoch-stamped,
span-recorded, replicated to the standby via
`FailoverManager.wal_scale`) so failover replays scaling state exactly
and a deposed master's decisions are refused by the epoch fence.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, fields
from typing import Any, Callable, Dict, List, Optional


@dataclass(frozen=True)
class AutoscalePolicy:
    """Per-group scaling policy; defaults come from ClusterConfig.

    Wire form (``to_wire``/``from_wire``) is a plain dict so it rides
    the group's journal entry through failover snapshots unchanged.
    """

    # scale-OUT: interactive p95 queue wait above this = SLO breach
    deadline_slack_s: float = 1.0
    # scale-IN: p95 below scale_in_frac * deadline_slack_s = underload
    scale_in_frac: float = 0.25
    # retire a draining replica only after this window with zero
    # undelivered journal entries (zero admitted-request loss)
    drain_window_s: float = 10.0
    min_replicas: int = 1
    max_replicas: int = 4
    # min seconds between scaling DECISIONS for the group (damper)
    dwell_s: float = 15.0
    # role split: prompts >= this many tokens are PREFILL-heavy and
    # route to the prefill-tuned replica (0 disables the split)
    prefill_len_threshold: int = 0
    # prefill replicas are spawned with this chunked-prefill setting
    prefill_chunk: int = 0
    # spawn a prefill (not decode) replica when at least this fraction
    # of routed admissions since the last decision were prefill-heavy
    prefill_share: float = 0.25
    # rebalance when max-min WFQ debt across decode replicas exceeds it
    rebalance_debt: float = 2.0
    # predictive scale-AHEAD (Clockwork-style provisioning,
    # Gujarati et al., OSDI 2020): forecast horizon in seconds (0
    # disables). A Holt (level+trend) forecast of the group's admission
    # arrival rate — fed from the gateway's cumulative per-class
    # ``admitted`` counters via group_gauges — spawns BEFORE the p95
    # breach when the predicted rate at the horizon exceeds serving
    # capacity (active replicas x predict_capacity_rps), and suppresses
    # scale-in while a breach is forecast (never below reactive).
    predict_horizon_s: float = 0.0
    predict_alpha: float = 0.5          # level smoothing (EWMA weight)
    predict_beta: float = 0.3           # trend smoothing
    predict_capacity_rps: float = 1.0   # per-replica sustainable req/s
    enabled: bool = True

    def __post_init__(self) -> None:
        if self.deadline_slack_s <= 0:
            raise ValueError("autoscale: deadline_slack_s must be > 0")
        if not 0.0 <= self.scale_in_frac < 1.0:
            raise ValueError("autoscale: scale_in_frac must be in [0, 1)")
        if self.drain_window_s < 0 or self.dwell_s < 0:
            raise ValueError("autoscale: windows must be >= 0")
        if self.min_replicas < 1:
            raise ValueError("autoscale: min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("autoscale: max_replicas < min_replicas")
        if self.prefill_len_threshold < 0 or self.prefill_chunk < 0:
            raise ValueError("autoscale: prefill knobs must be >= 0")
        if not 0.0 <= self.prefill_share <= 1.0:
            raise ValueError("autoscale: prefill_share must be in [0, 1]")
        if self.rebalance_debt <= 0:
            raise ValueError("autoscale: rebalance_debt must be > 0")
        if self.predict_horizon_s < 0:
            raise ValueError("autoscale: predict_horizon_s must be >= 0")
        if not 0.0 < self.predict_alpha <= 1.0 \
                or not 0.0 < self.predict_beta <= 1.0:
            raise ValueError("autoscale: predict smoothing factors must "
                             "be in (0, 1]")
        if self.predict_capacity_rps <= 0:
            raise ValueError("autoscale: predict_capacity_rps must "
                             "be > 0")

    @classmethod
    def keys(cls) -> frozenset:
        return frozenset(f.name for f in fields(cls))

    @classmethod
    def from_config(cls, config: Any,
                    overrides: Optional[Dict[str, Any]] = None
                    ) -> "AutoscalePolicy":
        """ClusterConfig defaults, then the lm_serve spec's overrides."""
        base = {
            "deadline_slack_s": float(config.autoscale_deadline_slack_s),
            "drain_window_s": float(config.autoscale_drain_window_s),
            "min_replicas": int(config.autoscale_min_replicas),
            "max_replicas": int(config.autoscale_max_replicas),
            "dwell_s": float(config.autoscale_dwell_s),
        }
        if overrides:
            unknown = set(overrides) - cls.keys()
            if unknown:
                raise ValueError(
                    f"autoscale: unknown policy keys {sorted(unknown)}; "
                    f"valid: {sorted(cls.keys())}")
            base.update(overrides)
        return cls(**base)

    def merged(self, updates: Dict[str, Any]) -> "AutoscalePolicy":
        """New validated policy with ``updates`` applied (lm_autoscale)."""
        unknown = set(updates) - self.keys()
        if unknown:
            raise ValueError(
                f"autoscale: unknown policy keys {sorted(unknown)}; "
                f"valid: {sorted(self.keys())}")
        return AutoscalePolicy(**{**asdict(self), **updates})

    def to_wire(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "AutoscalePolicy":
        return cls(**{k: v for k, v in d.items() if k in cls.keys()})


class Autoscaler:
    """The control loop. One instance per LMPoolManager; ``tick()`` is
    called from the manager's ``pump_once`` (so it only ever runs at the
    acting master — the same gate every managed mutation sits behind).

    ``gauges_fn(group) -> {replica: {"interactive_p95", "n",
    "backlog"}}`` is injectable for deterministic tests; the default
    reads the live ``lm_qos`` gauges through the manager.
    """

    def __init__(self, manager: Any,
                 clock: Callable[[], float] = time.time) -> None:
        self.manager = manager
        self.clock = clock
        self.gauges_fn: Optional[Callable[[str], Dict[str, Any]]] = None
        # Holt forecast memory per group: soft derived state —
        # the DECISIONS it produces journal/replicate like any other;
        # after failover the forecast reseeds from live counters in one
        # sample interval. {group: {t, admitted, level, trend,
        # predicted, spawns}}
        self._forecast: Dict[str, Dict[str, Any]] = {}

    # -- signal helpers ---------------------------------------------------

    @staticmethod
    def _p95(gauges: Dict[str, Any]) -> float:
        """Worst interactive p95 across replicas that have samples."""
        vals = [float(g.get("interactive_p95", 0.0))
                for g in gauges.values() if int(g.get("n", 0)) > 0]
        return max(vals) if vals else 0.0

    @staticmethod
    def _backlog(gauges: Dict[str, Any]) -> int:
        return sum(int(g.get("backlog", 0)) for g in gauges.values())

    # -- predictive scale-ahead -------------------------------------------

    def forecast_view(self, name: str) -> Dict[str, Any]:
        """Forecast gauges for ``lm_qos`` group status / shell display."""
        st = self._forecast.get(name)
        if st is None:
            return {"predicted_rate": 0.0, "predictive_spawns": 0}
        return {"predicted_rate": round(float(st["predicted"]), 4),
                "predictive_spawns": int(st["spawns"])}

    def _forecast_update(self, name: str, policy: AutoscalePolicy,
                         gauges: Dict[str, Any], now: float) -> float:
        """Advance the group's Holt (level+trend) arrival-rate forecast
        one sample and return the predicted rate at the horizon.

        The signal is the sum of the gateway's cumulative per-class
        ``admitted`` counters across replicas (group_gauges): the
        discrete rate between ticks feeds ``level' = a*inst +
        (1-a)*level``, ``trend' = b*(level'-level)/dt + (1-b)*trend``,
        and the horizon estimate is ``level' + trend'*horizon`` —
        trend-following, so a ramp crosses the capacity threshold
        BEFORE the queue-wait p95 breaches. Deterministic: runs on the
        injected clock, and a counter regression (group rebuilt,
        replica set changed under failover) reseeds instead of
        producing a negative rate."""
        if policy.predict_horizon_s <= 0:
            self._forecast.pop(name, None)
            return 0.0
        admitted = 0
        for g in gauges.values():
            adm = g.get("admitted") or {}
            admitted += sum(int(v) for v in adm.values())
        st = self._forecast.get(name)
        if st is None or admitted < st["admitted"]:
            self._forecast[name] = {"t": now, "admitted": admitted,
                                    "level": None, "trend": 0.0,
                                    "predicted": 0.0, "spawns": 0}
            return 0.0
        dt = now - st["t"]
        if dt <= 0:
            return float(st["predicted"])
        inst = (admitted - st["admitted"]) / dt
        if st["level"] is None:
            # Holt initialization: the first rate sample seeds the level
            # outright with zero trend — one sample carries no slope, and
            # deriving one against the zero seed made any first arrival
            # after a (re)seed look like a steep ramp, spawning on noise
            level, trend = inst, 0.0
        else:
            a, b = policy.predict_alpha, policy.predict_beta
            level = a * inst + (1 - a) * st["level"]
            trend = (b * ((level - st["level"]) / dt)
                     + (1 - b) * st["trend"])
        predicted = max(0.0, level + trend * policy.predict_horizon_s)
        st.update(t=now, admitted=admitted, level=level, trend=trend,
                  predicted=predicted)
        return predicted

    # -- the loop ---------------------------------------------------------

    def tick(self) -> List[Dict[str, Any]]:
        """One control-loop pass over every group; returns the decisions
        taken this tick (journaled on the group by the manager)."""
        decisions: List[Dict[str, Any]] = []
        for name in self.manager.group_names():
            try:
                decisions.extend(self._tick_group(name))
            except Exception:  # noqa: BLE001 - the loop must survive a
                # single group's bad tick; the next pump retries it
                import logging
                logging.getLogger("idunno.autoscaler").exception(
                    "autoscale tick failed for group %r", name)
        return decisions

    def _tick_group(self, name: str) -> List[Dict[str, Any]]:
        view = self.manager.group_view(name)
        if view is None:
            return []
        policy: AutoscalePolicy = view["policy"]
        if not policy.enabled:
            return []
        now = self.clock()
        out: List[Dict[str, Any]] = []

        # 1. complete in-flight retires: a DRAINING replica with zero
        #    undelivered journal entries, past the drain window, goes.
        #    This finishes a prior decision, so it is dwell-exempt.
        #    Every decision this tick carries the forecast's view
        #    (predicted_rate) so the journal is auditable per decision,
        #    not just per predictive spawn —
        #    retires run before this tick's forecast sample, so they
        #    stamp the LAST prediction.
        fc_prev = self.forecast_view(name)["predicted_rate"]
        for rname, meta in sorted(view["replicas"].items()):
            if meta["state"] != "draining":
                continue
            if (meta["undelivered"] == 0
                    and now - meta["t_drain"] >= policy.drain_window_s):
                d = self.manager.group_retire(name, rname,
                                              predicted_rate=fc_prev)
                if d:
                    out.append(d)

        view = self.manager.group_view(name)
        if view is None:
            return out

        # 1b. quarantine-and-drain: an ACTIVE replica on a
        #     node the differential-health plane QUARANTINED stops
        #     taking new routing now — spawn its replacement first
        #     (capacity), then mark it draining. Dwell-exempt like
        #     retire completion: a gray failure does not wait out the
        #     damper. The drain → retire path is the ordinary one, so
        #     zero admitted requests are lost; if the victim is the
        #     LAST active replica and no replacement could place,
        #     retire_start refuses and it keeps serving (availability
        #     beats health).
        quarantined = set(self.manager._quarantined_hosts())
        if quarantined:
            victims = sorted(
                r for r, m in view["replicas"].items()
                if m["state"] == "active"
                and m.get("node") in quarantined)
            n_active = sum(1 for m in view["replicas"].values()
                           if m["state"] == "active")
            for rname in victims:
                if n_active < policy.max_replicas:
                    d = self.manager.group_spawn(
                        name, role=view["replicas"][rname]["role"],
                        quarantine=True, replaced=rname,
                        predicted_rate=fc_prev)
                    if d:
                        out.append(d)
                        n_active += 1
                d = self.manager.group_retire_start(
                    name, replica=rname, quarantine=True,
                    predicted_rate=fc_prev)
                if d:
                    out.append(d)
                    n_active -= 1
            if victims:
                view = self.manager.group_view(name)
                if view is None:
                    return out

        # quarantined-but-undrainable replicas don't count as capacity:
        # thresholds below see only healthy actives
        active = sorted(r for r, m in view["replicas"].items()
                        if m["state"] == "active"
                        and m.get("node") not in quarantined)
        if not active:
            return out
        if now - view["t_last_decision"] < policy.dwell_s:
            return out

        gauges = (self.gauges_fn or self.manager.group_gauges)(name)
        gauges = {r: g for r, g in gauges.items() if r in active}
        p95 = self._p95(gauges)
        backlog = self._backlog(gauges)
        pred = self._forecast_update(name, policy, gauges, now)

        # 2. scale OUT on SLO breach
        if p95 > policy.deadline_slack_s and len(active) < policy.max_replicas:
            role = "decode"
            rc = view["route_counts"]
            if (policy.prefill_len_threshold > 0
                    and not any(view["replicas"][r]["role"] == "prefill"
                                for r in active)
                    and rc["total"] > 0
                    and rc["prefill"] / rc["total"] >= policy.prefill_share):
                role = "prefill"
            d = self.manager.group_spawn(name, role=role, p95=round(p95, 4),
                                         predicted_rate=round(pred, 4))
            if d:
                out.append(d)
            return out

        # 2b. predictive scale-AHEAD: the forecast arrival
        #     rate at the horizon exceeds what the active replicas can
        #     sustain — spawn BEFORE the reactive breach. Journaled
        #     exactly like a reactive spawn, tagged predictive.
        if (pred > len(active) * policy.predict_capacity_rps
                and len(active) < policy.max_replicas):
            d = self.manager.group_spawn(
                name, role="decode", predictive=True,
                predicted_rate=round(pred, 4), p95=round(p95, 4))
            if d:
                self._forecast[name]["spawns"] += 1
                metrics = getattr(getattr(self.manager, "service", None),
                                  "metrics", None)
                if metrics is not None:
                    metrics.record_counter("predictive_spawns")
                out.append(d)
            return out

        # 3. scale IN at underload: idle group, or p95 well under slack.
        #    (The gateway's wait window is cumulative, so "no backlog"
        #    is the reliable idle signal once traffic stops.) Suppressed
        #    while the forecast predicts the SMALLER replica set would
        #    breach — predictive never drops below what reactive keeps.
        if pred > (len(active) - 1) * policy.predict_capacity_rps \
                and policy.predict_horizon_s > 0:
            return out
        low = (backlog == 0
               or p95 < policy.scale_in_frac * policy.deadline_slack_s)
        if low and len(active) > policy.min_replicas:
            d = self.manager.group_retire_start(
                name, p95=round(p95, 4), predicted_rate=round(pred, 4))
            if d:
                out.append(d)
            return out

        # 4. rebalance tenants by WFQ debt across decode replicas
        debts = view["debts"]
        if len(debts) >= 2:
            hi = max(debts.values())
            lo = min(debts.values())
            if hi - lo > policy.rebalance_debt:
                d = self.manager.group_rebalance(
                    name, predicted_rate=round(pred, 4))
                if d:
                    out.append(d)
        return out
