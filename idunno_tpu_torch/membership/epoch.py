"""Monotone epoch fence for coordinator actions (Raft-style terms).

The reference's client failover (`mp4_machinelearning.py:956-963`) retries
primary→standby with no fencing: after a partition isolates the primary,
both coordinators keep dispatching and nothing deposes the stale one when
the network heals (SURVEY.md §7 bug-not-to-replicate). Here every adoption
mints a strictly increasing epoch (Ongaro & Ousterhout, "In Search of an
Understandable Consensus Algorithm", 2014 — the term mechanism only; no
log replication or quorum election, the standby chain is configured).
Coordinator-originated verbs (dispatch, metadata replication, lm_* control
RPCs, SDFS internal pushes) are stamped with the sender's fence view;
every receiver tracks the highest epoch seen, rejects lower-epoch verbs
with a typed ``StaleEpoch`` reply, and a deposed coordinator that observes
a higher epoch steps down — split brain becomes impossible by
construction, and heal-time convergence is automatic because the fence
view also rides the membership ping/pong gossip.

Epoch 0 with no owner is the bootstrap state: the configured coordinator
acts without minting, so a cluster that never fails over never pays for
fencing (and older snapshots without an ``epoch`` field load unchanged).
"""
from __future__ import annotations

import threading

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.transport import TransportError
from idunno_tpu_torch.utils.types import MessageType


class StaleEpoch(TransportError):
    """A peer rejected our verb because it has seen a higher epoch — we are
    (or are acting for) a deposed coordinator. Never retryable: retrying a
    fenced verb cannot succeed, the caller must step down instead."""

    def __init__(self, message: str, epoch: int = 0,
                 owner: str | None = None) -> None:
        super().__init__(message, reason="stale_epoch")
        self.epoch = epoch
        self.owner = owner


class StaleScope(TransportError):
    """A peer rejected our verb because it has seen a higher epoch for ONE
    fence scope (a managed pool/group) — only that scope's journal is
    fenced; the cluster-wide fence and every other scope are untouched.
    Never retryable for the same reason as StaleEpoch, but the caller
    steps down for the named scope only."""

    def __init__(self, message: str, scope: str, epoch: int = 0,
                 owner: str | None = None) -> None:
        super().__init__(message, reason="stale_scope")
        self.scope = scope
        self.epoch = epoch
        self.owner = owner


class EpochFence:
    """Thread-safe (epoch, owner) high-water mark.

    ``observe`` advances on gossip/stamps from peers; ``mint`` is called by
    an adopting coordinator and returns a strictly higher epoch owned by
    it. On equal epochs the first-seen owner is kept (two mints of the
    same epoch cannot happen through ``adopt`` because the snapshot carries
    the old epoch and ``mint`` goes strictly above the high-water)."""

    def __init__(self) -> None:
        self._epoch = 0
        self._owner: str | None = None
        self._lock = threading.Lock()

    def current(self) -> int:
        with self._lock:
            return self._epoch

    def owner(self) -> str | None:
        with self._lock:
            return self._owner

    def view(self) -> tuple[int, str | None]:
        with self._lock:
            return self._epoch, self._owner

    def observe(self, epoch: int, owner: str | None = None) -> bool:
        """Advance the high-water mark; True if it moved."""
        with self._lock:
            if epoch > self._epoch:
                self._epoch = int(epoch)
                self._owner = owner
                return True
            return False

    def mint(self, owner: str) -> int:
        with self._lock:
            self._epoch += 1
            self._owner = owner
            return self._epoch


class FenceRegistry:
    """Keyed fence map: one ``EpochFence`` per scope (``pool:<name>`` for
    managed LM pools/replica groups), created on demand. Each scope's
    epoch advances independently, so adopting one pool's fence deposes the
    old owner for THAT pool only — the cluster-wide ``EpochFence`` remains
    the authority for membership + SDFS-master duties. Scope views ride
    the membership gossip (``"scopes"`` payload key) exactly like the
    cluster fence view rides ``"epoch"``."""

    def __init__(self) -> None:
        self._fences: dict[str, EpochFence] = {}
        self._lock = threading.Lock()

    def fence(self, scope: str) -> EpochFence:
        with self._lock:
            f = self._fences.get(scope)
            if f is None:
                f = self._fences[scope] = EpochFence()
            return f

    def scopes(self) -> list[str]:
        with self._lock:
            return sorted(self._fences)

    def view_all(self) -> dict[str, list]:
        """Gossip wire form: only scopes that ever moved off bootstrap
        (a never-minted scope carries no fencing information)."""
        with self._lock:
            fences = dict(self._fences)
        out: dict[str, list] = {}
        for scope, f in fences.items():
            e, owner = f.view()
            if e > 0 or owner is not None:
                out[scope] = [e, owner]
        return out

    def observe_all(self, views) -> None:
        if not isinstance(views, dict):
            return
        for scope, ep in views.items():
            if ep:
                self.fence(str(scope)).observe(int(ep[0]), ep[1])


def pool_scope(name: str) -> str:
    """Fence scope for a managed pool name. Replica-group members
    (``{group}@r{i}``) share their group's scope: the group journal +
    scale WAL are one ownership unit, so its replicas fence together."""
    return f"pool:{name.rsplit('@r', 1)[0]}"


def place_scope(scope: str, hosts, alive, quarantined=()) -> str | None:
    """Deterministic owner for a pool scope: the first ALIVE host in the
    scope's rendezvous order over the full configured registry
    (utils/ring.py:rendezvous_order). Every node computes the same
    answer from the same membership view, and one host's death moves
    only the scopes that ranked it first. None when nothing is alive.

    ``quarantined`` (gray-failure defense, membership/health.py): hosts
    the health ledger has quarantined are skipped when minting NEW
    owners — a limping host must not win placement — unless skipping
    them would leave nothing (availability beats health)."""
    from idunno_tpu_torch.utils.ring import rendezvous_order
    alive = set(alive)
    quarantined = set(quarantined)
    fallback = None
    for h in rendezvous_order(scope, tuple(hosts)):
        if h not in alive:
            continue
        if h in quarantined:
            if fallback is None:
                fallback = h
            continue
        return h
    return fallback


class ScopeOwnerRedirect(Exception):
    """A pool-directed verb landed on a host that is not the scope's
    placed owner — the typed one-hop redirect: the ERROR reply names the
    owner so the client re-sends there directly (one hop, counted as
    ``scope_owner_redirects``), instead of walking the coordinator
    chain."""

    def __init__(self, scope: str, owner: str | None) -> None:
        super().__init__(f"scope {scope} is owned by {owner}; redirect")
        self.scope = scope
        self.owner = owner


class ScopeOwners:
    """Gossiped scope→owner claim map, the routing half of multi-owner
    placement (the fences in ``FenceRegistry`` are the safety half).
    Each claim carries a per-scope monotone seq; ``observe_all`` keeps
    the higher seq and breaks exact ties on the lexicographically
    greater owner so every node converges to the same view without
    coordination. Claims are advisory routing state — a wrong view
    costs one redirect hop or a scoped fence check, never
    correctness."""

    def __init__(self) -> None:
        self._map: dict[str, tuple[str, int]] = {}
        self._lock = threading.Lock()

    def owner(self, scope: str) -> str | None:
        with self._lock:
            ent = self._map.get(scope)
            return ent[0] if ent else None

    def view(self, scope: str) -> tuple[str, int] | None:
        with self._lock:
            ent = self._map.get(scope)
            return (ent[0], ent[1]) if ent else None

    def scopes(self) -> list[str]:
        with self._lock:
            return sorted(self._map)

    def owned_by(self, host: str) -> list[str]:
        with self._lock:
            return sorted(s for s, (o, _) in self._map.items()
                          if o == host)

    def claim(self, scope: str, owner: str) -> int:
        """Record ``owner`` as the scope's owner at a seq strictly above
        everything observed — a claim always wins over the state it was
        made from, and replicated/gossiped copies of an OLD claim can
        never re-demote it."""
        with self._lock:
            ent = self._map.get(scope)
            seq = (ent[1] if ent else 0) + 1
            self._map[scope] = (owner, seq)
            return seq

    def view_all(self) -> dict[str, list]:
        """Gossip wire form: ``{scope: [owner, seq]}``."""
        with self._lock:
            return {s: [o, q] for s, (o, q) in self._map.items()}

    def observe_all(self, views) -> None:
        if not isinstance(views, dict):
            return
        with self._lock:
            for scope, ent in views.items():
                if not ent:
                    continue
                owner, seq = str(ent[0]), int(ent[1])
                cur = self._map.get(str(scope))
                if (cur is None or seq > cur[1]
                        or (seq == cur[1] and owner > cur[0])):
                    self._map[str(scope)] = (owner, seq)


# -- wire helpers (shared by every stamped service) ------------------------

def stamp(fence: EpochFence, payload: dict) -> dict:
    """Stamp a coordinator-originated payload with the sender's fence view
    (in place; returns the payload for chaining)."""
    e, owner = fence.view()
    payload["epoch"] = [e, owner]
    return payload


def observe_payload(fence: EpochFence, payload) -> None:
    """Advance the local fence from a stamped payload without rejecting —
    for peer-originated messages (worker results, gossip) whose work is
    valid at any epoch."""
    ep = payload.get("epoch") if isinstance(payload, dict) else None
    if ep:
        fence.observe(int(ep[0]), ep[1])


def check_payload(fence: EpochFence, payload, host: str) -> Message | None:
    """Receiver-side fence check for a coordinator-originated verb: returns
    a typed stale-epoch ERROR reply if the stamp is below the local
    high-water mark, else observes the stamp and returns None. Unstamped
    payloads (client RPCs, pre-fence peers) always pass."""
    ep = payload.get("epoch") if isinstance(payload, dict) else None
    if not ep:
        return None
    e = int(ep[0])
    cur, owner = fence.view()
    if e < cur:
        return Message(MessageType.ERROR, host,
                       {"error": f"stale epoch {e} < {cur}"
                                 f" (owner {owner})",
                        "stale_epoch": True, "epoch": [cur, owner]})
    fence.observe(e, ep[1])
    return None


def reply_is_stale(fence: EpochFence, reply: Message | None) -> bool:
    """Sender-side: True if the reply is a stale-epoch rejection. Observes
    the rejecting peer's (higher) fence view so the caller demotes."""
    if reply is None or reply.type is not MessageType.ERROR:
        return False
    p = reply.payload if isinstance(reply.payload, dict) else {}
    if not p.get("stale_epoch"):
        return False
    observe_payload(fence, p)
    return True


# -- scoped wire helpers (per-pool fences) ---------------------------------
#
# Scoped stamps ride BESIDE the cluster stamp under their own payload key
# ("scope_epoch": [scope, e, owner]) and scoped rejections use "stale_scope"
# — never "stale_epoch" — so a pool-level deposal can NOT demote the sender
# cluster-wide through reply_is_stale. Unstamped payloads pass everywhere,
# exactly like the cluster fence.

def stamp_scoped(registry: FenceRegistry, scope: str,
                 payload: dict) -> dict:
    """Stamp a pool-directed payload with the sender's scope-fence view
    (in place; returns the payload for chaining)."""
    e, owner = registry.fence(scope).view()
    payload["scope_epoch"] = [scope, e, owner]
    return payload


def observe_scoped(registry: FenceRegistry, payload) -> None:
    """Advance the local scope fence from a stamped payload without
    rejecting (gossip / replies)."""
    ep = payload.get("scope_epoch") if isinstance(payload, dict) else None
    if ep:
        registry.fence(str(ep[0])).observe(int(ep[1]), ep[2])


def check_scoped(registry: FenceRegistry, payload,
                 host: str) -> Message | None:
    """Receiver-side scope-fence check: a stamp below the local high-water
    mark for its scope gets a typed stale-scope ERROR reply (the rejection
    names the scope and carries the rejecting view); else the stamp is
    observed and None returned. Unstamped payloads always pass."""
    ep = payload.get("scope_epoch") if isinstance(payload, dict) else None
    if not ep:
        return None
    scope, e = str(ep[0]), int(ep[1])
    fence = registry.fence(scope)
    cur, owner = fence.view()
    if e < cur:
        return Message(MessageType.ERROR, host,
                       {"error": f"stale scope epoch {e} < {cur} for "
                                 f"{scope} (owner {owner}): the managed "
                                 "journal for this scope is fenced",
                        "stale_scope": scope,
                        "scope_epoch": [scope, cur, owner]})
    fence.observe(e, ep[2])
    return None


def reply_stale_scope(registry: FenceRegistry,
                      reply: Message | None) -> str | None:
    """Sender-side: the fenced scope name if the reply is a stale-scope
    rejection (observing the rejecting peer's view), else None."""
    if reply is None or reply.type is not MessageType.ERROR:
        return None
    p = reply.payload if isinstance(reply.payload, dict) else {}
    scope = p.get("stale_scope")
    if not scope:
        return None
    observe_scoped(registry, p)
    return str(scope)
