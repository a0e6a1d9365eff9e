"""Membership + failure detection service.

Reference semantics preserved (SURVEY.md C2):
- JOIN via introducer/master: newcomer asks the introducer, gets the full
  list back (`mp4_machinelearning.py:163-189`).
- Master-driven heartbeats: the acting master pings every other host on a
  0.3 s period, piggybacking its full membership list (`:191-220`);
  receivers merge by timestamp and PONG their own list back (`:272-287`).
- Suspicion: the acting master marks hosts LEAVE after 2 s of silence
  (`:832-884`) and the change propagates on the next ping wave.
- Voluntary leave (`:1038-1052`) is a LEAVE broadcast, distinct from a crash.

Beyond the reference (which hardcodes one master): mastership is *acting* —
if the configured coordinator is dead in the local view, the standby
coordinator assumes the heartbeat/monitor role, and it detects the
coordinator's death itself by ping silence. Status-change callbacks drive
store re-replication and scheduler reassignment (the reference couples these
inline in `monitor_program`, `:852-884`).

Periodic methods (``ping_once`` / ``monitor_once``) are pure steps driven by
the node runtime's threads — or directly by tests, no sleeping in here.
"""
from __future__ import annotations

import time
from collections.abc import Callable

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.transport import Transport, TransportError
from idunno_tpu_torch.config import ClusterConfig
from idunno_tpu_torch.membership.epoch import (EpochFence, FenceRegistry,
                                         ScopeOwners, observe_payload)
from idunno_tpu_torch.membership.health import HealthLedger, HealthPolicy
from idunno_tpu_torch.membership.list import MembershipList
from idunno_tpu_torch.utils.types import MemberStatus, MessageType

SERVICE = "membership"

# callback(host, old_status_or_None, new_status)
ChangeCallback = Callable[[str, MemberStatus | None, MemberStatus], None]


class MembershipService:
    def __init__(self, host: str, config: ClusterConfig, transport: Transport,
                 clock: Callable[[], float] = time.time) -> None:
        self.host = host
        self.config = config
        self.transport = transport
        self.clock = clock
        self.members = MembershipList()
        # coordinator epoch fence, shared by every service on this node
        # (stamped on coordinator verbs, advanced by gossip; epoch 0 /
        # no owner = bootstrap, the configured chain acts unfenced)
        self.epoch = EpochFence()
        # per-scope fences (one per managed LM pool/group, "pool:<name>");
        # scoped adoption mints here, scope views gossip beside the
        # cluster view — membership only ever OBSERVES scope stamps
        self.scopes = FenceRegistry()
        # gossiped scope→owner claims (routing only; the fences above are
        # the safety): pool-directed verbs go to the claimed owner first,
        # a wrong view costs one typed redirect hop
        self.owners = ScopeOwners()
        # differential fail-SLOW ledger: verdicts gossip on
        # every membership payload like scope views; the ledger never
        # forges a LEAVE — fail-stop detection below is untouched. It
        # only observes once a transport attaches it (node.py / chaos).
        self.health = HealthLedger(host, HealthPolicy.from_config(config),
                                   clock=clock)
        self._callbacks: list[ChangeCallback] = []
        self._left = False           # voluntary leave: never auto-refute
        transport.serve(SERVICE, self._handle)

    def _gossip_payload(self) -> dict:
        """The piggybacked view every membership message carries."""
        return {"members": self.members.to_wire(),
                "epoch": list(self.epoch.view()),
                "scopes": self.scopes.view_all(),
                "owners": self.owners.view_all(),
                "health": self.health.view_all()}

    # -- wiring -----------------------------------------------------------

    def on_change(self, cb: ChangeCallback, front: bool = False) -> None:
        """``front=True`` runs the callback before earlier registrations —
        the failover manager uses it so an adoption (epoch mint) lands
        before reassignment callbacks start dispatching under the old
        epoch."""
        if front:
            self._callbacks.insert(0, cb)
        else:
            self._callbacks.append(cb)

    def _fire(self, changes) -> None:
        for host, old, new in changes:
            for cb in self._callbacks:
                cb(host, old, new)

    # -- mastership -------------------------------------------------------

    def acting_master(self) -> str:
        """Where this node routes coordinator traffic: the current epoch
        owner while it is alive in the local view, else the configured
        coordinator→standby chain (the reference's primary→standby order,
        `mp4_machinelearning.py:47-48, 956-963` — but fence-aware: once an
        adoption minted an epoch, its owner stays master across heals
        instead of flapping back to the configured coordinator)."""
        _, owner = self.epoch.view()
        if owner is not None:
            o = self.members.get(owner)
            if o is None or o.status.alive:
                return owner
        c = self.config.coordinator
        if self.members.get(c) is None or self.members.is_alive(c):
            return c
        return self.config.standby_coordinator

    @property
    def is_acting_master(self) -> bool:
        """Acting-master DUTIES (dispatch, heartbeats, replication) require
        owning the fence: once any epoch has been minted, a node acts only
        if it is the owner — a node that merely *routes* to itself while a
        higher-epoch owner exists (e.g. the configured coordinator inside a
        partition that marked the owner LEAVE) stays fenced until it mints
        a higher epoch through FailoverManager.adopt."""
        if self.acting_master() != self.host:
            return False
        owner = self.epoch.owner()
        return owner is None or owner == self.host

    # -- lifecycle --------------------------------------------------------

    def join(self) -> None:
        """Introduce self. The introducer (or any alive seed) replies with
        the merged full list."""
        now = self.clock()
        self._left = False
        self.members.set(self.host, MemberStatus.RUNNING, now)
        self.members.touch(self.host, now)
        if self.host == self.config.introducer:
            return
        msg = Message(MessageType.JOIN, self.host, self._gossip_payload())
        for seed in (self.config.introducer, self.config.coordinator,
                     self.config.standby_coordinator):
            if seed == self.host:
                continue
            try:
                out = self.transport.call(seed, SERVICE, msg, timeout=5.0)
            except TransportError:
                continue
            if out is not None:
                # the ACK carries the cluster's fence view: a rejoiner that
                # lost its fence state re-learns the current epoch (and
                # every pool scope's) before it could ever act on a stale
                # one
                observe_payload(self.epoch, out.payload)
                self.scopes.observe_all(out.payload.get("scopes"))
                self.owners.observe_all(out.payload.get("owners"))
                self.health.observe_all(out.payload.get("health"))
                self._fire(self.members.merge(out.payload["members"]))
                return
        # nobody reachable — we are first up; keep our solo list.

    def leave(self) -> None:
        """Voluntary leave: broadcast a LEAVE-stamped list (distinct from a
        crash, which is only ever *detected*)."""
        now = self.clock()
        self._left = True
        self.members.set(self.host, MemberStatus.LEAVE, now)
        msg = Message(MessageType.LEAVE, self.host, self._gossip_payload())
        for h in self.config.hosts:
            if h != self.host:
                self.transport.datagram(  # lint: ok stamp -- _gossip_payload stamps the epoch view
                    h, SERVICE, msg)

    # -- periodic steps (driven by runtime threads or tests) --------------

    def ping_once(self) -> None:
        """Acting master only: heartbeat every other configured host with
        the full list piggybacked."""
        if not self.is_acting_master:
            return
        msg = Message(MessageType.PING, self.host, self._gossip_payload())
        for h in self.config.hosts:
            if h != self.host:
                self.transport.datagram(  # lint: ok stamp -- _gossip_payload stamps the epoch view
                    h, SERVICE, msg)

    def monitor_once(self) -> None:
        """Failure detection step.

        Acting master: mark alive members LEAVE after ``failure_timeout_s``
        of silence. Coordinator/standby when NOT acting master: watch only
        the current acting master's ping stream — silence there promotes
        the watcher on the next step (pre-fence this was standby-watches-
        coordinator only; with epochs the deposed coordinator equally
        watches the owner, so mastership can fail back under a NEW epoch
        when the owner dies).
        """
        now = self.clock()
        timeout = self.config.failure_timeout_s
        # differential health step: derive fail-slow verdicts
        # from what this node measured, then keep PROBING any peer under
        # a non-healthy verdict — quarantine diverts discretionary
        # traffic away from the peer, so recovery evidence must come
        # from somewhere, and a direct membership call (observed by the
        # transport's attached ledger) is that somewhere. Inert when no
        # transport ever attached the ledger (no samples -> no verdicts
        # -> no probes), so chaos schedules without the fail-slow flag
        # send not one extra datagram and existing seeds replay.
        self.health.tick(now)
        for peer in sorted(self.health.watched()):
            if peer == self.host or not self.members.is_alive(peer):
                continue
            try:
                self.transport.call(  # lint: ok stamp -- _gossip_payload stamps the epoch view
                    peer, SERVICE,
                    Message(MessageType.PING, self.host,
                            self._gossip_payload()),
                    timeout=max(0.5, self.config.ping_interval_s))
            except TransportError:
                pass  # observed as an error sample by the transport hook
        # SWIM-style refutation: if someone marked US dead (false suspicion
        # across a healed partition or a long GC pause) while we are in fact
        # alive, overwrite with a RUNNING stamp strictly newer than the
        # verdict's — max(now, verdict_ts + ε) wins the merge on every peer
        # even if our clock lags the issuer's (the ts domain doubles as the
        # incarnation number). Never after a voluntary leave.
        #
        # Convergence note: a healed node that was an isolated *coordinator*
        # may still carry LEAVE verdicts it issued for unreachable peers;
        # those propagate for one ping wave and each live peer refutes its
        # own entry on its next monitor tick, so views converge within
        # ~2 ping intervals (transient reassignment callbacks may fire —
        # exactly-once results hold regardless, see
        # tests/test_stress_concurrency.py). Genuinely dead peers stay dead.
        me = self.members.get(self.host)
        if me is not None and not me.status.alive and not self._left:
            refute_ts = max(now, me.ts + 1e-3)
            self.members.set(self.host, MemberStatus.RUNNING, refute_ts)
            # our own silence clocks are stale after an isolation — restart
            # them so we don't instantly re-suspect peers we couldn't hear
            for e in self.members.entries():
                self.members.touch(e.host, now)
            self._fire([(self.host, me.status, MemberStatus.RUNNING)])
        if self.is_acting_master:
            for e in self.members.entries():
                if e.host == self.host or not e.status.alive:
                    continue
                if not e.last_heard:
                    # never heard from (e.g. we just became master): start
                    # this host's silence clock NOW so a host that died
                    # during the failover window is still detected.
                    self.members.touch(e.host, now)
                    continue
                if now - e.last_heard > timeout:
                    self.members.set(e.host, MemberStatus.LEAVE, now)
                    self._fire([(e.host, MemberStatus.RUNNING,
                                 MemberStatus.LEAVE)])
        elif self.host in (self.config.coordinator,
                           self.config.standby_coordinator):
            target = self.acting_master()
            if target == self.host:
                return
            c = self.members.get(target)
            if (c is not None and c.status.alive and c.last_heard
                    and now - c.last_heard > timeout):
                self.members.set(c.host, MemberStatus.LEAVE, now)
                self._fire([(c.host, MemberStatus.RUNNING,
                             MemberStatus.LEAVE)])

    # -- message handling -------------------------------------------------

    def _handle(self, service: str, msg: Message) -> Message | None:
        now = self.clock()
        # fence gossip: every membership message carries the sender's
        # (epoch, owner) view; observing it here is what deposes a stale
        # coordinator within one ping wave of a heal. Scope views ride
        # beside it — membership observes scope fences, never rejects
        # (a deposed pool owner must still learn it was deposed)
        observe_payload(self.epoch, msg.payload)
        if isinstance(msg.payload, dict):
            self.scopes.observe_all(msg.payload.get("scopes"))
            self.owners.observe_all(msg.payload.get("owners"))
            # health verdicts gossip like scope views: observed, never
            # fenced — a quarantined peer must still learn its verdict
            self.health.observe_all(msg.payload.get("health"))
        if msg.type is MessageType.JOIN:
            self._fire(self.members.merge(msg.payload["members"]))
            self.members.touch(msg.sender, now)
            return Message(MessageType.ACK, self.host,
                           self._gossip_payload())
        if msg.type in (MessageType.PING, MessageType.PONG,
                        MessageType.LEAVE):
            self._fire(self.members.merge(msg.payload["members"]))
            self.members.touch(msg.sender, now)
            if msg.type is MessageType.PING:
                self.transport.datagram(
                    msg.sender, SERVICE,
                    Message(MessageType.PONG, self.host,
                            self._gossip_payload()))
            return None
        return None
