"""95th percentile (nearest rank) of the wait from a request's due time to
its admission into a slot: the time the harness saw it complete, less its
``Completion.service_s`` (admission to retirement, the pool's own
counter)."""
from perfbench.traffic import percentile


def read(r):
    waits = r.counters.get("queue_wait_s") or []
    return percentile(waits, 95) * 1e3 if waits else None
