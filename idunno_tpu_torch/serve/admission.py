"""Admission policy for the LM serving front door.

The gateway (`serve/gateway.py`) decides *whether* a request may enter a
pool and *when* it is dispatched; this module holds the policy pieces the
rest of the stack needs to name without importing the queue machinery:

- the priority classes (`interactive` strictly before `batch`),
- the typed rejection (`AdmissionShed`, with a machine-parseable reason
  that survives a trip through an RPC error string — the manager journal
  parses it back out with `shed_reason` to record the request terminal),
- the backpressure rule (`BackpressureConfig.pressure_reason`) computed
  from live pool gauges: requests queued upstream of a slot, slot
  occupancy, and free KV blocks on paged pools.

Design follows Clockwork (Gujarati et al., OSDI 2020): reject early and
explicitly at the front door, where per-class latency targets are still
salvageable, rather than letting an unbounded inbox melt queue-wait
percentiles for everyone (see PAPERS.md).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

# Class order IS dispatch order: every queued interactive request is
# dispatched before any batch request, regardless of deadlines.
PRIORITIES = ("interactive", "batch")

SHED_REASONS = ("quota", "queue_full", "backpressure", "expired")

_SHED_RE = re.compile(r"shed\[([a-z_]+)\]")


class AdmissionShed(ValueError):
    """Typed front-door rejection. Subclasses ValueError so existing RPC
    error plumbing (`serve/control.py` wraps handler ValueErrors into
    `{"error": str(e)}`) carries it unchanged; the reason is re-parsed on
    the far side with `shed_reason`."""

    def __init__(self, reason: str, detail: str = "") -> None:
        assert reason in SHED_REASONS, reason
        self.reason = reason
        self.detail = detail
        super().__init__(f"shed[{reason}]" + (f": {detail}" if detail else ""))


def shed_reason(text: str) -> str | None:
    """Reason parsed from a stringified AdmissionShed (None = not a shed).
    The manager's `_forward` uses this to classify a remote ValueError as
    a journal-terminal shed vs an infrastructure failure."""
    m = _SHED_RE.search(text or "")
    return m.group(1) if m else None


def is_prefill_heavy(prompt_len: int, threshold: int) -> bool:
    """DistServe's split criterion at request-routing granularity (Zhong
    et al., OSDI 2024): an admission whose prompt is at least
    ``threshold`` tokens is PREFILL-heavy — its cost is dominated by the
    compute-bound prompt pass, and interleaving it with latency-bound
    decode traffic inflates decode queue waits. Replica groups
    (`serve/lm_manager.py:_route_group_locked`) route these to the
    group's `prefill_chunk`-tuned replica. ``threshold`` <= 0 disables
    the split."""
    return threshold > 0 and int(prompt_len) >= int(threshold)


@dataclass(frozen=True)
class BackpressureConfig:
    """Occupancy-driven shed thresholds.

    ``backlog`` below = requests in the system but not yet retired
    (gateway queues + pool inbox + server queue + live slots). With all
    slots busy, a backlog of ``slots * (1 + k)`` means a new arrival
    waits ~k full service quanta for a slot — so ``k`` is a queue-wait
    bound expressed in units of per-request service time. Batch sheds at
    a small k, interactive at a larger one, and the gap is what keeps
    interactive p99 queue wait bounded under overload while batch takes
    the sheds.

    ``min_free_kv_frac`` sheds batch early on paged pools when the block
    pool runs dry: free blocks are the prefix cache's working set, and
    admitting more batch bulk when residency is exhausted trades cached
    prefills for queue depth (vLLM's watermark heuristic).
    """

    batch_wait_slack: float = 2.0
    interactive_wait_slack: float = 4.0
    min_free_kv_frac: float = 0.125

    def pressure_reason(self, priority: str, gauges: dict) -> str | None:
        """Shed detail string when ``gauges`` say the pool is too loaded
        for a new ``priority`` request, else None. ``gauges`` keys:
        ``waiting`` (queued upstream of a slot, gateway depth included),
        ``live``, ``slots``, and optionally ``kv_blocks_free`` /
        ``kv_blocks_total`` (0/absent on unpaged pools)."""
        slots = max(int(gauges.get("slots", 1)), 1)
        backlog = int(gauges.get("waiting", 0)) + int(gauges.get("live", 0))
        slack = (self.interactive_wait_slack if priority == "interactive"
                 else self.batch_wait_slack)
        if backlog >= slots * (1.0 + slack):
            return (f"backlog {backlog} >= {slots} slots * "
                    f"(1 + {slack:g} slack)")
        if priority == "batch":
            total = int(gauges.get("kv_blocks_total", 0))
            if total > 0:
                free = int(gauges.get("kv_blocks_free", 0))
                if free / total < self.min_free_kv_frac:
                    return (f"free KV blocks {free}/{total} < "
                            f"{self.min_free_kv_frac:g} floor")
        return None
