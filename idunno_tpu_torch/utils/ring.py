"""Hash-ring placement for replicated files.

Reference semantics: a file is placed at ``hash(name) % 10`` and replicated to
the next ring slots, skipping slot 0 (the master keeps its own copy anyway) —
`get_file_neighbors` (`utils.py:48-55`), call site `mp4_machinelearning.py:361`.

Here the ring is the configured host registry; placement is a deterministic
stable hash (not Python's randomized ``hash``) so every node computes the same
replica set.
"""
from __future__ import annotations

import zlib


def hash_ring_index(name: str, n_hosts: int) -> int:
    """Deterministic ring slot for a file name (stable across processes,
    unlike the reference's ``hash(sdfsfilename)%10``)."""
    return zlib.crc32(name.encode()) % n_hosts


def ring_order(name: str, hosts: tuple[str, ...] | list[str]) -> list[str]:
    """All hosts in ring order starting from ``name``'s hash slot — callers
    filter by liveness and truncate to their replication factor."""
    n = len(hosts)
    start = hash_ring_index(name, n)
    return [hosts[(start + i) % n] for i in range(n)]


def rendezvous_order(name: str,
                     hosts: tuple[str, ...] | list[str]) -> list[str]:
    """Highest-random-weight (rendezvous) preference order of ``hosts``
    for ``name``: every node computes the same ranking from the full
    configured registry, and removing one host perturbs only the names
    that ranked it first — the minimal-disruption property ring slots
    don't have. Ties (crc32 collisions) break on the host name so the
    order is total."""
    return sorted(hosts,
                  key=lambda h: (-zlib.crc32(f"{h}|{name}".encode()), h))
