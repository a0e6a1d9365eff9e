"""Standby-coordinator failover (SURVEY.md C10).

Reference: the master streams its scheduler state, stringified, to the other
nine VMs once a second (`send_metadata`, `mp4_machinelearning.py:971-987`);
every host runs `receive_metadata` (`:989-1011`) — which assigns raw strings
over dict-typed fields, corrupting the very state it exists to preserve
(SURVEY.md §7 bugs-not-to-replicate). Clients fail over primary→standby
(`:956-963`).

Here the acting master replicates a *versioned, typed* snapshot (task book,
per-model query counters, metrics windows, accumulated results) to the
standby each period. When the standby observes the coordinator's death (via
its own ping-silence monitor) it adopts the newest snapshot, reassigns every
in-flight task stranded on dead hosts, and re-dispatches — resuming
unfinished query ranges instead of losing them. Workers already deliver
results master-then-standby, so results in flight during the switch land on
the new master.
"""
from __future__ import annotations

import json
import logging
import threading
from typing import Any

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.transport import Transport, TransportError
from idunno_tpu_torch.config import ClusterConfig
from idunno_tpu_torch.membership.epoch import (check_payload, check_scoped,
                                         place_scope, pool_scope,
                                         reply_is_stale, stamp_scoped)
from idunno_tpu_torch.membership.service import MembershipService
from idunno_tpu_torch.serve.inference_service import InferenceService
from idunno_tpu_torch.utils.types import MemberStatus, MessageType

SERVICE = "metadata"

log = logging.getLogger("idunno.failover")


class FailoverManager:
    def __init__(self, host: str, config: ClusterConfig,
                 transport: Transport, membership: MembershipService,
                 service: InferenceService, lm_manager=None) -> None:
        self.host = host
        self.config = config
        self.transport = transport
        self.membership = membership
        self.service = service
        self.lm_manager = lm_manager    # serve/lm_manager.LMPoolManager
        self._lock = threading.RLock()
        self._seq = 0
        self._received: dict[str, Any] | None = None
        self._received_seq = -1
        # satellite observability: acked queries whose write-ahead was
        # skipped because the standby was down (durability gap until the
        # periodic snapshot catches up) — also a metrics counter
        self.wal_skips = 0
        # standby-side per-query write-ahead deltas, (model, qnum) →
        # {"tasks": [...wire...], "dataset": ...}; applied on adopt for
        # queries the newest full snapshot predates, pruned as snapshots
        # catch up (wal_append / _handle / adopt)
        self._wal: dict[tuple[str, int], dict[str, Any]] = {}
        # standby-side autoscaler scaling deltas, group → {"decision",
        # "entry"} (entry = the group's full wire state at decision
        # time, newest kept); applied on adopt for scaling actions the
        # newest snapshot predates (wal_scale / _handle / adopt)
        self._scale_wal: dict[str, dict[str, Any]] = {}
        # standby-side per-pool journal deltas, pool → {"entry"} (the
        # pool's full wire state at its per-pool wal_seq, newest kept):
        # each managed pool's journal segment replicates independently,
        # so adopting one pool's scope replays only that pool's WAL
        # (wal_pool / _handle / adopt)
        self._pool_wal: dict[str, dict[str, Any]] = {}
        # satellite observability: bytes shipped over the pool WAL (full
        # entries + delta frames) — the delta-compaction win is this
        # gauge staying near-linear in mutations instead of quadratic
        # in journal depth (metrics_export: pool_wal_bytes)
        self._pool_wal_bytes = 0
        transport.serve(SERVICE, self._handle)
        # front: the adoption (epoch mint) must land BEFORE reassignment
        # callbacks start re-dispatching, so nothing dispatches under the
        # dead owner's epoch during the promotion itself
        membership.on_change(self._on_member_change, front=True)

    # -- master side: periodic replication --------------------------------

    def snapshot(self) -> dict[str, Any]:
        # self._lock: seq order must match state order — two interleaved
        # snapshot makers could otherwise deliver a STALE snapshot under a
        # HIGHER seq and the standby would keep it
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict[str, Any]:
        svc = self.service
        with svc._results_lock:
            results = {f"{m}\x00{q}": [list(r) for r in v]
                       for (m, q), v in svc._results.items()}
            qnum = dict(svc._qnum)
        self._seq += 1
        snap = {"seq": self._seq,
                "epoch": list(self.membership.epoch.view()),
                "tasks": svc.scheduler.book.to_wire(),
                "qnum": qnum,
                "idem": svc.idem_to_wire(),
                "metrics": svc.metrics.to_wire(),
                "results": results}
        if self.lm_manager is not None:
            # LM pool registry + request journal ride the same snapshot,
            # so decode pools and train jobs survive a coordinator death
            # exactly like the CNN task book
            snap["lm"] = self.lm_manager.to_wire()
        return snap

    def replicate_once(self) -> bool:
        """Acting master → standby; returns True if delivered."""
        if not self.membership.is_acting_master:
            return False
        standby = self.config.standby_coordinator
        if standby == self.host:
            return False
        msg = Message(MessageType.METADATA, self.host, self.snapshot())
        try:
            out = self.transport.call(standby, SERVICE, msg, timeout=10.0)
        except TransportError:
            return False
        if reply_is_stale(self.membership.epoch, out):
            # the standby has seen a higher epoch: we are deposed — the
            # observe above demoted us, stop replicating stale state
            return False
        return out is not None

    def wal_append(self, model: str, qnum: int, tasks, dataset,
                   idem: str | None = None) -> bool:
        """Synchronous per-query write-ahead for the submit path: a query
        the master has ACKed must survive an immediate coordinator death,
        not just one that lands after the next periodic tick. Ships ONLY
        the new query's task bookings (a few hundred bytes — the full
        snapshot grows with cluster lifetime and belongs on the periodic
        loop, not inside every client ack), on a short timeout so an
        alive-but-degraded standby bounds ack latency. Skips (False) when
        the standby is not currently ALIVE — a dead standby must not add
        its timeout to every ack; the periodic loop resumes replication
        when it returns — but the skip is *observable* (log + metrics
        counter), not silent: each one is an acked query that would be
        lost if this master died before the next snapshot."""
        standby = self.config.standby_coordinator
        if standby == self.host or not self.membership.is_acting_master:
            return False
        if standby not in self.membership.members.alive_hosts():
            self.wal_skips += 1
            self.service.metrics.record_counter("wal_skipped_standby_down")
            log.warning("wal_append skipped for %s q%d: standby %s not "
                        "alive (%d skips — acked queries unprotected until "
                        "the next snapshot)", model, qnum, standby,
                        self.wal_skips)
            return False
        msg = Message(MessageType.METADATA, self.host,
                      {"epoch": list(self.membership.epoch.view()),
                       "wal": {"model": model, "qnum": int(qnum),
                               "tasks": [t.to_wire() for t in tasks],
                               "dataset": dataset, "idem": idem}})
        try:
            out = self.transport.call(standby, SERVICE, msg, timeout=2.0)
        except TransportError:
            return False
        if reply_is_stale(self.membership.epoch, out):
            return False
        return out is not None

    def _scope_standby(self, scope: str) -> str | None:
        """The scope's OWN WAL successor: the next host in the
        scope's rendezvous placement order after this one, over the alive
        set. Every pool's journal fans out to its own standby instead of
        one global standby — so one host's death leaves every other
        scope's (owner, standby) pair serving untouched, and the adopter
        a death selects is exactly the host already holding the WAL
        (same formula, same liveness view)."""
        alive = set(self.membership.members.alive_hosts())
        return place_scope(scope, self.config.hosts,
                           alive - {self.host})

    def pool_wal_bytes(self) -> int:
        with self._lock:
            return self._pool_wal_bytes

    def wal_scale(self, group: str, decision: dict[str, Any],
                  entry: dict[str, Any]) -> bool:
        """Synchronous write-ahead for an autoscaler scaling decision
        (serve/lm_manager.py:_replicate_scale): a spawn/retire/rebalance
        the group's owner just journaled must survive an immediate
        death, not just one after the next periodic tick — otherwise the
        adopter would re-derive scaling state from gauges instead of
        REPLAYING it (the chaos exact-replay invariant). Ships the
        group's full wire entry (small: routing maps + a bounded
        decision log — replica request journals ride the pool WAL as
        usual) to the GROUP SCOPE's own standby successor; gated on
        holding the journal (the manager only replicates groups it
        owns), not on cluster mastership — scope owners need not be the
        acting master. Same skip discipline as wal_append: a
        dead standby must not stall the control loop, but the skip is
        counted, never silent."""
        scope = pool_scope(group)
        standby = self._scope_standby(scope)
        if standby is None or standby == self.host:
            self.wal_skips += 1
            self.service.metrics.record_counter("wal_skipped_standby_down")
            log.warning("wal_scale skipped for group %s seq %s: no alive "
                        "scope standby", group, decision.get("seq"))
            return False
        payload = {"epoch": list(self.membership.epoch.view()),
                   "scale_wal": {"group": str(group),
                                 "decision": dict(decision),
                                 "entry": dict(entry)}}
        stamp_scoped(self.membership.scopes, scope, payload)
        msg = Message(MessageType.METADATA, self.host, payload)
        try:
            out = self.transport.call(standby, SERVICE, msg, timeout=2.0)
        except TransportError:
            return False
        if out is None or reply_is_stale(self.membership.epoch, out):
            return False
        return out.type is not MessageType.ERROR

    def wal_pool(self, name: str,
                 frame: dict[str, Any]) -> dict[str, Any] | None:
        """Synchronous write-ahead for ONE managed pool's journal segment
        (serve/lm_manager.py:_replicate_pool): ships the pool's wire
        entry — or a delta frame since the standby's acked base — at its
        per-pool monotone ``wal_seq`` so an admission or terminal
        transition the pool's owner just journaled survives an immediate
        death without waiting for the periodic full snapshot — and so
        scoped adoption can replay exactly this pool's segment while
        other pools' state is untouched. DistServe handoff edges
        ride these same frames on BOTH endpoints: the decode
        pool's ``req["handoff"]`` state machine (prefilling → shipping →
        adopted | fallback) rides its request rows, and the prefill
        pool's ``handoffs`` ledger rides the scalar ``fields`` of a
        delta — so an adopter that replays a pool WAL sees any
        non-terminal handoff and re-ships or falls back
        (serve/lm_manager.py:_handoff_ship), never loses the request.
        The target is the POOL SCOPE's
        own standby successor, and the gate is holding the journal (the
        manager only replicates pools it owns), not cluster mastership.
        Returns the standby's ACK payload (which may carry
        ``need_full`` when a delta frame missed its base) or None when
        skipped/unreachable/fenced — the caller treats None as an unacked
        chain and re-seeds with a full entry next mutation. Same skip
        discipline as wal_append: a dead standby never stalls the
        serving path, but every skip is counted, never silent."""
        scope = pool_scope(name)
        standby = self._scope_standby(scope)
        if standby is None or standby == self.host:
            self.wal_skips += 1
            self.service.metrics.record_counter("wal_skipped_standby_down")
            log.warning("wal_pool skipped for pool %s seq %s: no alive "
                        "scope standby", name, frame.get("wal_seq"))
            return None
        payload = {"epoch": list(self.membership.epoch.view()),
                   "pool_wal": {"name": str(name),
                                "entry": dict(frame)}}
        stamp_scoped(self.membership.scopes, scope, payload)
        msg = Message(MessageType.METADATA, self.host, payload)
        with self._lock:
            self._pool_wal_bytes += len(
                json.dumps(frame, separators=(",", ":"),
                           default=str).encode())
        try:
            out = self.transport.call(standby, SERVICE, msg, timeout=2.0)
        except TransportError:
            return None
        if out is None or reply_is_stale(self.membership.epoch, out):
            return None
        if out.type is MessageType.ERROR:
            return None
        return dict(out.payload or {})

    # -- standby side ------------------------------------------------------

    def _handle(self, service: str, msg: Message) -> Message | None:
        if msg.type is not MessageType.METADATA:
            return None
        # epoch fence: a deposed master's replication must not overwrite
        # the adopted state it diverged from (its seq counter may be
        # HIGHER than ours — seq orders snapshots within one epoch only)
        stale = check_payload(self.membership.epoch, msg.payload, self.host)
        if stale is not None:
            return stale
        # per-scope fence: a deposed POOL owner's WAL frames are refused
        # for that scope only (the scope's adopter minted a higher scope
        # epoch; the cluster fence above may not have moved at all)
        stale = check_scoped(self.membership.scopes, msg.payload, self.host)
        if stale is not None:
            return stale
        with self._lock:
            if "wal" in msg.payload:        # per-query write-ahead delta
                d = msg.payload["wal"]
                self._wal[(d["model"], int(d["qnum"]))] = d
                return Message(MessageType.ACK, self.host)
            if "scale_wal" in msg.payload:  # autoscaler decision delta
                d = msg.payload["scale_wal"]
                cur = self._scale_wal.get(d["group"])
                if (cur is None
                        or int(cur["decision"].get("seq", -1))
                        <= int(d["decision"].get("seq", -1))):
                    self._scale_wal[d["group"]] = d
                return Message(MessageType.ACK, self.host)
            if "pool_wal" in msg.payload:   # per-pool journal delta
                d = msg.payload["pool_wal"]
                frame = d["entry"]
                cur = self._pool_wal.get(d["name"])
                if frame.get("delta"):
                    held = cur["entry"] if cur else None
                    merged = self._merge_pool_delta_locked(held, frame)
                    if merged is None:
                        # gap: NACK so the sender re-ships a full entry
                        return Message(MessageType.ACK, self.host,
                                       {"need_full": True})
                    self._pool_wal[d["name"]] = {"name": d["name"],
                                                 "entry": merged}
                elif (cur is None
                        or int(cur["entry"].get("wal_seq", -1))
                        <= int(frame.get("wal_seq", -1))):
                    self._pool_wal[d["name"]] = d
                return Message(MessageType.ACK, self.host)
            seq = int(msg.payload.get("seq", 0))
            if seq > self._received_seq:
                self._received = msg.payload
                self._received_seq = seq
                # deltas the snapshot has caught up with are durable in it
                have = {(t["model"], int(t["qnum"]))
                        for t in msg.payload.get("tasks", [])}
                self._wal = {k: v for k, v in self._wal.items()
                             if k not in have}
                groups = (msg.payload.get("lm") or {}).get("groups", {})
                self._scale_wal = {
                    g: v for g, v in self._scale_wal.items()
                    if int((groups.get(g) or {}).get("next_seq", -1))
                    < int(v["decision"].get("seq", -1)) + 1}
                pools = (msg.payload.get("lm") or {}).get("pools", {})
                self._pool_wal = {
                    n: v for n, v in self._pool_wal.items()
                    if int((pools.get(n) or {}).get("wal_seq", -1))
                    < int(v["entry"].get("wal_seq", -1))}
        return Message(MessageType.ACK, self.host)

    @staticmethod
    def _merge_pool_delta_locked(held: dict[str, Any] | None,
                                 frame: dict[str, Any]) \
            -> dict[str, Any] | None:
        """Apply a delta frame onto the held full entry. A frame applies
        only when its ``base_seq`` equals the held entry's wal_seq
        EXACTLY — any gap (no held entry, a lost frame, a standby that
        restarted) returns None and the ACK carries ``need_full``, so the
        sender re-ships the full entry. The standby therefore always
        holds FULL merged entries: adoption-time replay
        (``apply_pool_wal``) never sees a frame."""
        if held is None or held.get("delta") \
                or int(held.get("wal_seq", -1)) \
                != int(frame.get("base_seq", -2)):
            return None
        merged = dict(held)
        merged.update(frame.get("fields", {}))
        if "idem" in frame:
            merged["idem"] = dict(frame["idem"])
        reqs = dict(held.get("requests", {}))
        for rid, req in frame.get("changed", {}).items():
            reqs[rid] = req
        for rid in frame.get("removed", ()):
            reqs.pop(rid, None)
        merged["requests"] = reqs
        merged["wal_seq"] = int(frame["wal_seq"])
        return merged

    def _on_member_change(self, host: str, old: MemberStatus | None,
                          new: MemberStatus) -> None:
        if new is not MemberStatus.LEAVE:
            return
        # scope-scoped adoption FIRST: ANY host's death makes
        # each survivor adopt exactly the dead host's pool scopes that
        # place on it — cluster mastership may not move at all
        self._adopt_scopes_of(host)
        # then cluster adoption: when the CURRENT master (fence owner once
        # one exists, the configured coordinator before any mint) is the
        # dead host and this node is next in the chain
        owner = self.membership.epoch.owner() or self.config.coordinator
        if host == owner and self.membership.acting_master() == self.host:
            self.adopt()

    def _adopt_scopes_of(self, dead: str) -> None:
        """Adopt the pool scopes the dead host owned (gossiped claims)
        whose rendezvous placement over the survivors lands here: replay
        exactly those scopes' WAL segments, mint their scope fences (the
        dead owner's stamps are refused per pool from here on), and
        claim ownership so routing converges. Every OTHER owner's scopes
        are untouched — the blast radius of one death is exactly its own
        scopes."""
        owners = getattr(self.membership, "owners", None)
        mgr = self.lm_manager
        if owners is None or mgr is None:
            return
        alive = set(self.membership.members.alive_hosts()) - {dead}
        # quorum gate: an isolated minority falsely suspects the WHOLE
        # majority — if it adopted their scopes it would mint claims and
        # scope fences that win the merge at heal, deposing the rightful
        # owners. A node may adopt a dead owner's scopes only while it
        # sees a strict majority of the configured registry alive; a
        # minority successor stays put (unavailable, never split-brained)
        if 2 * len(alive | {self.host}) <= len(self.config.hosts):
            return
        # NOTE: adoption placement is deliberately quarantine-BLIND.
        # Every surviving host evaluates this formula independently, so
        # its inputs must converge fast; health verdicts are per-host
        # views with long divergence windows — feeding them in lets two
        # hosts each compute themselves successor (per-pool split
        # brain). Quarantine steers single-decider placement (the acting
        # master's lm_serve assignment) and routing only.
        scopes = [s for s in owners.owned_by(dead)
                  if place_scope(s, self.config.hosts, alive) == self.host]
        if not scopes:
            return
        want = set(scopes)
        with self._lock:
            pool_wal = {n: dict(d) for n, d in self._pool_wal.items()
                        if pool_scope(n) in want}
            scale_wal = {g: dict(d) for g, d in self._scale_wal.items()
                         if pool_scope(g) in want}
        svc = self.service
        if pool_wal:
            replayed = mgr.apply_pool_wal(pool_wal)
            if replayed:
                svc.metrics.record_counter("pool_wal_replayed", replayed)
        if scale_wal:
            mgr.apply_scale_wal(scale_wal)
        for scope in scopes:
            self.membership.scopes.fence(scope).mint(self.host)
            svc.metrics.record_counter("pool_scope_adopted")
            owners.claim(scope, self.host)
            svc.metrics.record_counter("scope_owner_moves")
        log.info("%s adopted %d pool scope(s) of dead owner %s: %s",
                 self.host, len(scopes), dead, scopes)
        mgr.on_adopt()

    def adopt(self) -> None:
        """Become the coordinator: mint a strictly higher epoch (fencing
        the deposed master everywhere its stamps are checked), load the
        newest replicated snapshot, apply any write-ahead deltas it
        predates, and resume every unfinished range."""
        fence = self.membership.epoch
        with self._lock:
            if fence.owner() == self.host:
                return          # already own the current epoch
            snap = self._received
            wal = dict(self._wal)
            scale_wal = {g: dict(d) for g, d in self._scale_wal.items()}
            pool_wal = {n: dict(d) for n, d in self._pool_wal.items()}
        # the snapshot carries the deposed master's epoch: fold it into
        # the high-water mark FIRST so the mint lands strictly above
        # everything that master ever stamped
        ep = snap.get("epoch") if snap is not None else None
        if ep:
            fence.observe(int(ep[0]), ep[1])
        epoch = fence.mint(self.host)
        log.info("%s adopting mastership at epoch %d (snapshot seq %s, "
                 "%d wal deltas)", self.host, epoch,
                 snap.get("seq") if snap else None, len(wal))
        svc = self.service
        asp = None
        if svc.spans is not None:
            # the adoption is itself a span — in its OWN trace (the event
            # is cluster-scoped, not owned by any one request), finished
            # after resume_in_flight so its duration covers the promotion
            asp = svc.spans.start(
                "failover.adopt",
                attrs={"epoch": epoch,
                       "snapshot_seq": snap.get("seq") if snap else None,
                       "wal_deltas": len(wal)})
        if snap is not None:
            svc.scheduler.book.load_wire(snap["tasks"])
            with svc._results_lock:
                svc._qnum.update({m: max(int(q), svc._qnum.get(m, 0))
                                  for m, q in snap["qnum"].items()})
            svc.metrics.load_wire(snap["metrics"])
            svc.idem_load_wire(snap.get("idem", {}))
            with svc._results_lock:
                for key, recs in snap["results"].items():
                    m, q = key.split("\x00")
                    existing = svc._results.setdefault((m, int(q)), [])
                    seen = {tuple(r) for r in existing}
                    existing.extend(tuple(r) for r in recs
                                    if tuple(r) not in seen)
        # write-ahead deltas: queries ACKed after the newest snapshot was
        # built (possibly before ANY snapshot ran) — re-book their task
        # assignments so resume_in_flight re-dispatches them
        from idunno_tpu_torch.scheduler.tasks import Task
        for (m, q), d in sorted(wal.items()):
            if not svc.scheduler.book.tasks_for_query(m, q):
                svc.scheduler.book.record(
                    [Task.from_wire(t) for t in d["tasks"]])
            with svc._results_lock:
                svc._qnum[m] = max(svc._qnum.get(m, 0), int(q))
            if d.get("idem"):
                # a client retrying its acked submit against the NEW
                # master must dedupe, not double-book
                svc.record_idem(d["idem"], int(q))
        self.resume_in_flight()
        if self.lm_manager is not None:
            # multi-owner filter: becoming cluster master
            # adopts master DUTIES (CNN book, train jobs, fair share) —
            # NOT every pool scope. A scope whose claimed owner is a
            # SURVIVOR stays that owner's, untouched; scopes of the dead
            # master (or unclaimed ones) load here only if their
            # rendezvous placement over the survivors lands on this host
            # (the scope's own successor adopted the rest via
            # _adopt_scopes_of, which ran first).
            owners = getattr(self.membership, "owners", None)
            alive = set(self.membership.members.alive_hosts())

            def keep(scope: str) -> bool:
                if owners is None:
                    return True
                claimed = owners.owner(scope)
                if claimed == self.host:
                    return True
                if claimed is not None and claimed in alive:
                    return False    # surviving owner keeps serving
                return place_scope(scope, self.config.hosts,
                                   alive) == self.host

            held_before = set(self.lm_manager.scope_names())
            loaded = False
            if snap is not None and "lm" in snap:
                self.lm_manager.load_wire(snap["lm"], keep_scope=keep)
                loaded = True
            if scale_wal:
                # scaling decisions WAL'd after the newest snapshot:
                # replay them exactly (group wire entries are
                # authoritative where their decision log is longer)
                self.lm_manager.apply_scale_wal(scale_wal,
                                                keep_scope=keep)
                loaded = True
            if pool_wal:
                # per-pool journal segments WAL'd after the newest
                # snapshot: replay per scope — a pool whose wal_seq moved
                # past the snapshot gets exactly its own newer journal
                replayed = self.lm_manager.apply_pool_wal(pool_wal,
                                                          keep_scope=keep)
                if replayed:
                    svc.metrics.record_counter("pool_wal_replayed",
                                               replayed)
                loaded = True
            if loaded:
                # per-scope fences: mint a strictly-higher epoch for every
                # NEWLY adopted pool/group scope, so the deposed master's
                # pool-directed stamps are rejected per pool — scopes this
                # host already held (a surviving owner becoming master)
                # keep their fence AND their claim untouched
                for scope in self.lm_manager.scope_names():
                    if scope in held_before:
                        continue
                    self.membership.scopes.fence(scope).mint(self.host)
                    svc.metrics.record_counter("pool_scope_adopted")
                    if owners is not None \
                            and owners.owner(scope) != self.host:
                        owners.claim(scope, self.host)
                        svc.metrics.record_counter("scope_owner_moves")
                self.lm_manager.on_adopt()
        if asp is not None:
            svc.spans.finish(
                asp, resumed=len(svc.scheduler.book.in_flight()))

    def resume_in_flight(self) -> None:
        """Reassign in-flight tasks stranded on dead hosts (including the
        dead coordinator) and re-dispatch everything still marked working —
        duplicates are rejected by the task book."""
        svc = self.service
        alive = set(self.membership.members.alive_hosts())
        for task in svc.scheduler.book.in_flight():
            if task.worker not in alive:
                candidates = sorted(alive - {task.worker})
                if not candidates:
                    continue
                svc.scheduler.book.reassign(
                    task, svc.scheduler.rng.choice(candidates),
                    svc.clock())
            svc._dispatch(task)
