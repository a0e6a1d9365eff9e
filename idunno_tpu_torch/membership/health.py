"""Differential health scoring: fail-SLOW detection beside fail-stop.

Membership (`membership/service.py`) detects only fail-stop — a limping
host that keeps its heartbeats keeps its traffic. This module closes the
differential-observability gap Huang et al. name in *Gray Failure: The
Achilles' Heel of Cloud-Scale Systems* (HotOS 2017): every node keeps
per-peer RPC service-latency EWMAs + error-rate EWMAs (fed by the
transport call sites in `comm/net.py` / `comm/inproc.py` and by the
manager's `lm_qos` gauge sweep), and a peer whose fleet-relative latency
deviation crosses policy while still heartbeat-alive walks a typed state
machine::

    healthy -> suspect --(breach sustained suspect_window_s)--> quarantined
                  |                                                |
                  +--(breach clears)--> healthy    (breach clears) v
       healthy <--(clean probation_s dwell)-- probation <----------+
                                                  |
                                                  +--(re-breach)--> quarantined

The ledger never forges a LEAVE — fail-stop detection is untouched; a
quarantined peer is still a cluster member, it just stops receiving
discretionary traffic (tenant-sticky decode routing, new scope claims,
full-window straggler patience) until probation clears it.

Verdicts gossip piggybacked on the five membership payloads under a
``"health"`` key, exactly like scope views: per-peer ``[state, seq,
score]`` where ``seq`` is a shared monotone bumped by whichever node
transitions the peer — merge keeps the higher seq (ties: more severe
state), so views converge like ``ScopeOwners`` claims. A node only
*derives* transitions for peers it holds >= ``min_samples`` local
observations on; sample-less nodes adopt gossip instead of "healing" a
quarantine they cannot see.

Injected clock throughout, zero rng — chaos seeds replay.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections.abc import Callable

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"
STATES = (HEALTHY, SUSPECT, QUARANTINED, PROBATION)
# merge tiebreak at equal seq: more severe wins (deterministic everywhere)
_SEVERITY = {HEALTHY: 0, PROBATION: 1, SUSPECT: 2, QUARANTINED: 3}


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Thresholds for the differential detector (config: ``health_*``)."""

    ewma_alpha: float = 0.3
    # breach when ewma > deviation_factor * fleet-median ewma AND > floor
    # — the absolute floor keeps microsecond-noise fleets (and the chaos
    # harness's zero-latency baseline) from ever breaching on nothing
    deviation_factor: float = 3.0
    floor_s: float = 0.02
    min_samples: int = 5
    suspect_window_s: float = 1.0
    probation_s: float = 2.0
    error_rate: float = 0.5

    def __post_init__(self) -> None:
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha={self.ewma_alpha}")
        if self.deviation_factor <= 1.0:
            raise ValueError(f"deviation_factor={self.deviation_factor}")
        if self.min_samples < 1:
            raise ValueError(f"min_samples={self.min_samples}")
        for f in ("floor_s", "suspect_window_s", "probation_s"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f}={getattr(self, f)}")
        if not 0.0 < self.error_rate <= 1.0:
            raise ValueError(f"error_rate={self.error_rate}")

    @classmethod
    def from_config(cls, config) -> "HealthPolicy":
        return cls(
            deviation_factor=config.health_deviation_factor,
            floor_s=config.health_floor_s,
            min_samples=config.health_min_samples,
            suspect_window_s=config.health_suspect_window_s,
            probation_s=config.health_probation_s,
            error_rate=config.health_error_rate)


class _Peer:
    """Per-peer observation + verdict record (all under the ledger lock)."""

    __slots__ = ("ewma", "n", "err", "serv_ewma", "serv_n",
                 "state", "seq", "t_breach", "t_clear")

    def __init__(self) -> None:
        self.ewma = 0.0        # RPC round-trip latency EWMA (s)
        self.n = 0             # RPC samples seen
        self.err = 0.0         # error-rate EWMA (1.0 = every call fails)
        self.serv_ewma = 0.0   # service-level latency EWMA (qos p95, s)
        self.serv_n = 0
        self.state = HEALTHY
        self.seq = 0
        self.t_breach = 0.0    # when the current breach streak started
        self.t_clear = 0.0     # when probation started


class HealthLedger:
    """One per node; owned by ``MembershipService`` as ``.health``."""

    def __init__(self, host: str, policy: HealthPolicy | None = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.host = host
        self.policy = policy or HealthPolicy()
        self.clock = clock
        self._lock = threading.RLock()
        self._peers: dict[str, _Peer] = {}
        self._remote: dict[str, float] = {}   # gossiped scores, display only
        # True once any direct observation landed: gates the gauge-sweep
        # feed so a cluster whose transports never attached the ledger
        # (chaos default schedules) derives nothing and shifts no seed
        self.active = False

    # -- observation feeds -------------------------------------------------

    def observe(self, peer: str, latency_s: float,
                error: bool = False) -> None:
        """One RPC round-trip against ``peer`` (transport call sites)."""
        if peer == self.host:
            return
        a = self.policy.ewma_alpha
        with self._lock:
            self.active = True
            p = self._peers.setdefault(peer, _Peer())
            lat = max(0.0, float(latency_s))
            p.ewma = lat if p.n == 0 else (1 - a) * p.ewma + a * lat
            p.err = (1 - a) * p.err + a * (1.0 if error else 0.0)
            p.n += 1

    def observe_service(self, peer: str, seconds: float) -> None:
        """Service-level latency signal (the manager's lm_qos p95 sweep).

        Ignored until the ledger is ``active`` (some transport observed a
        real call): a ledger nobody wired to a transport must stay inert.
        """
        if peer == self.host or not self.active or seconds <= 0.0:
            return
        a = self.policy.ewma_alpha
        with self._lock:
            p = self._peers.setdefault(peer, _Peer())
            s = float(seconds)
            p.serv_ewma = s if p.serv_n == 0 else \
                (1 - a) * p.serv_ewma + a * s
            p.serv_n += 1

    # -- verdict derivation ------------------------------------------------

    def _median(self, vals: list[float]) -> float:
        if not vals:
            return 0.0
        vs = sorted(vals)
        m = len(vs) // 2
        return vs[m] if len(vs) % 2 else 0.5 * (vs[m - 1] + vs[m])

    def _breach_locked(self, host: str, p: _Peer,
                       rpc: list[tuple[str, float]],
                       serv: list[tuple[str, float]]) -> bool:
        """Fleet-relative deviation with a LEAVE-ONE-OUT median: ``host``
        is judged against the median of the OTHER measured peers, never
        against a baseline it dominates. A ledger that mostly talks to
        one peer (a pool owner forwarding to its one replica node) would
        otherwise use the limping peer's own EWMA as "the fleet" and
        derive no breach — then fight every other ledger's quarantine
        verdict with probation heals, seq-bumping forever. With no other
        measured peer the median is 0 and the absolute floor governs."""
        pol = self.policy
        if p.n >= pol.min_samples:
            med = self._median([e for h, e in rpc if h != host])
            if p.ewma > max(pol.floor_s, pol.deviation_factor * med):
                return True
            if p.err > pol.error_rate:
                return True
        if p.serv_n >= pol.min_samples:
            med = self._median([e for h, e in serv if h != host])
            if p.serv_ewma > max(pol.floor_s,
                                 pol.deviation_factor * med):
                return True
        return False

    def tick(self, now: float | None = None) -> list[tuple[str, str, str]]:
        """Advance the state machine from local observations. Returns the
        transitions fired as ``(peer, old_state, new_state)``."""
        if now is None:
            now = self.clock()
        pol = self.policy
        out: list[tuple[str, str, str]] = []
        with self._lock:
            rpc = [(h, p.ewma) for h, p in self._peers.items()
                   if p.n >= pol.min_samples]
            serv = [(h, p.serv_ewma) for h, p in self._peers.items()
                    if p.serv_n >= pol.min_samples]
            for host, p in self._peers.items():
                # no local evidence -> the gossiped verdict stands
                if p.n < pol.min_samples and p.serv_n < pol.min_samples:
                    continue
                breach = self._breach_locked(host, p, rpc, serv)
                old = p.state
                if p.state == HEALTHY and breach:
                    p.state, p.t_breach = SUSPECT, now
                elif p.state == SUSPECT:
                    if not breach:
                        p.state = HEALTHY
                    elif now - p.t_breach >= pol.suspect_window_s:
                        p.state = QUARANTINED
                elif p.state == QUARANTINED and not breach:
                    p.state, p.t_clear = PROBATION, now
                elif p.state == PROBATION:
                    if breach:
                        p.state = QUARANTINED
                    elif now - p.t_clear >= pol.probation_s:
                        p.state = HEALTHY
                if p.state != old:
                    p.seq += 1
                    out.append((host, old, p.state))
        return out

    # -- gossip ------------------------------------------------------------

    def view_all(self) -> dict[str, list]:
        """Wire form: {peer: [state, seq, score_ms]} for non-trivial rows
        (a healthy seq-0 peer carries no information)."""
        with self._lock:
            return {h: [p.state, p.seq, round(p.ewma, 6)]
                    for h, p in self._peers.items()
                    if p.seq > 0 or p.state != HEALTHY}

    def observe_all(self, views: dict | None) -> None:
        """Merge a gossiped view: higher seq wins, ties go to the more
        severe state — same last-writer-wins register shape as
        ``ScopeOwners``, so every node converges on one verdict."""
        if not views:
            return
        with self._lock:
            for host, rec in views.items():
                if host == self.host:
                    continue
                try:
                    state, seq, score = rec[0], int(rec[1]), float(rec[2])
                except (TypeError, ValueError, IndexError):
                    continue
                if state not in _SEVERITY:
                    continue
                p = self._peers.setdefault(host, _Peer())
                if seq > p.seq or (seq == p.seq and
                                   _SEVERITY[state] > _SEVERITY[p.state]):
                    # adopting a fresher verdict restarts the local
                    # windows so our own next tick measures from now
                    if state == SUSPECT and p.state != SUSPECT:
                        p.t_breach = self.clock()
                    if state == PROBATION and p.state != PROBATION:
                        p.t_clear = self.clock()
                    p.state, p.seq = state, seq
                    self._remote[host] = score

    # -- accessors ---------------------------------------------------------

    def state(self, peer: str) -> str:
        with self._lock:
            p = self._peers.get(peer)
            return p.state if p is not None else HEALTHY

    def score(self, peer: str) -> float:
        with self._lock:
            p = self._peers.get(peer)
            if p is None:
                return 0.0
            return p.ewma if p.n else self._remote.get(peer, 0.0)

    def quarantined(self) -> set[str]:
        with self._lock:
            return {h for h, p in self._peers.items()
                    if p.state == QUARANTINED}

    def unhealthy(self) -> set[str]:
        """Peers under suspicion or worse (early-redispatch consumers)."""
        with self._lock:
            return {h for h, p in self._peers.items()
                    if p.state in (SUSPECT, QUARANTINED)}

    def watched(self) -> set[str]:
        """Peers in any non-healthy state: membership keeps probing these
        directly so recovery evidence arrives even after routing stopped
        sending them discretionary traffic."""
        with self._lock:
            return {h for h, p in self._peers.items()
                    if p.state != HEALTHY}

    def worst_ratio(self) -> float:
        """Max fleet-relative latency deviation (1.0 = at the median);
        the ``node_health_score`` gauge."""
        pol = self.policy
        with self._lock:
            med = self._median([p.ewma for p in self._peers.values()
                                if p.n >= pol.min_samples])
            base = max(pol.floor_s, med)
            ratios = [p.ewma / base for p in self._peers.values()
                      if p.n >= pol.min_samples]
            return max(ratios) if ratios else 0.0

    def gauges(self) -> dict:
        return {"node_health_score": round(self.worst_ratio(), 4),
                "quarantined_nodes": len(self.quarantined())}

    def table(self) -> list[tuple[str, str, float]]:
        """(peer, state, score) rows for the shell's list-master view."""
        with self._lock:
            return sorted(
                (h, p.state, round(p.ewma if p.n
                                   else self._remote.get(h, 0.0), 6))
                for h, p in self._peers.items())
