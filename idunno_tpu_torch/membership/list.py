"""Membership list with merge-by-timestamp semantics.

Reference: each node keeps ``membership_list`` entries carrying a status and
a timestamp; on receiving a piggybacked list it keeps, per host, whichever
entry has the newer timestamp (`mp4_machinelearning.py:272-282`). A LEAVE
with a newer timestamp therefore overrides RUNNING and vice versa (rejoin).

``ts`` is the authoritative status-change time set by the owning/master node
(serialized); ``last_heard`` is a purely local monotonic receive time used by
the failure monitor (never serialized — the reference's separate
``last_update`` dict, `:847`).

All access is guarded by an internal lock: with the real socket transport,
merges arrive on the UDP receive thread concurrently with the heartbeat
thread iterating the list (the reference shares its dicts across 13 threads
with locks it never acquires — SURVEY.md §5).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any

from idunno_tpu_torch.utils.types import MemberStatus


@dataclass
class MemberEntry:
    host: str
    status: MemberStatus
    ts: float                       # authoritative status-change time
    last_heard: float = 0.0         # local receive clock (not serialized)

    def to_wire(self) -> dict[str, Any]:
        return {"host": self.host, "status": self.status.value, "ts": self.ts}

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "MemberEntry":
        return cls(host=d["host"], status=MemberStatus(d["status"]),
                   ts=float(d["ts"]))


class MembershipList:
    def __init__(self) -> None:
        self._entries: dict[str, MemberEntry] = {}
        self._lock = threading.RLock()

    def get(self, host: str) -> MemberEntry | None:
        with self._lock:
            return self._entries.get(host)

    def entries(self) -> list[MemberEntry]:
        """Snapshot, sorted by host."""
        with self._lock:
            return sorted(self._entries.values(), key=lambda e: e.host)

    def set(self, host: str, status: MemberStatus, ts: float) -> None:
        with self._lock:
            e = self._entries.get(host)
            if e is None:
                self._entries[host] = MemberEntry(host, status, ts)
            else:
                e.status, e.ts = status, ts

    def touch(self, host: str, now: float) -> None:
        with self._lock:
            e = self._entries.get(host)
            if e is not None:
                e.last_heard = max(e.last_heard, now)

    def alive_hosts(self) -> list[str]:
        return [e.host for e in self.entries() if e.status.alive]

    def is_alive(self, host: str) -> bool:
        e = self.get(host)
        return e is not None and e.status.alive

    def merge(self, wire_entries: list[dict[str, Any]]) -> list[tuple[str, MemberStatus | None, MemberStatus]]:
        """Merge a received list; returns status transitions
        [(host, old_status_or_None, new_status)] that resulted."""
        changes = []
        with self._lock:
            for d in wire_entries:
                incoming = MemberEntry.from_wire(d)
                mine = self._entries.get(incoming.host)
                if mine is None:
                    incoming.last_heard = 0.0
                    self._entries[incoming.host] = incoming
                    changes.append((incoming.host, None, incoming.status))
                elif incoming.ts > mine.ts:
                    old = mine.status
                    mine.status, mine.ts = incoming.status, incoming.ts
                    if old is not incoming.status:
                        changes.append((incoming.host, old, incoming.status))
        return changes

    def to_wire(self) -> list[dict[str, Any]]:
        return [e.to_wire() for e in self.entries()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
