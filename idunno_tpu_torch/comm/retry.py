"""Bounded exponential backoff with jitter for control-plane RPC.

The reference retries nothing: a lost ACK surfaces as a client error and a
re-submit double-books (`mp4_machinelearning.py:956-963` fails over
primary→standby exactly once, then gives up). Here mutating verbs carry
client-generated idempotency keys deduped server-side (submit / lm_submit /
SDFS put), which makes retrying safe — so the transport layer can retry
typed-retryable faults (timeout/refused/closed/unreachable) under a
deadline without risking duplicate work. ``stale_epoch`` rejections are
never retried: a fenced coordinator must step down, not hammer the new one
(membership/epoch.py).

Full jitter (delay × U[0.5, 1)) decorrelates the retry storms of many
clients hitting one recovering coordinator. Defaults are small (3 attempts
from 20 ms) because callers sit in front of their own failover loops —
this layer only rides out blips, it does not replace them.
"""
from __future__ import annotations

import random
import threading
import time
from collections.abc import Callable

from idunno_tpu_torch.comm.transport import TransportError

# process-wide retry accounting: retries are counted, not only logged.
# Module-level because this helper has no node
# handle — `metrics_export` (serve/control.py) merges these into the
# Prometheus exposition, and `counters()` consumers read them via
# `retry_counters()`. Thread-safe; reset only in tests.
_counters_lock = threading.Lock()
_counters = {"retry_attempts": 0, "retry_exhausted": 0,
             "hedged_rpcs": 0, "hedge_wins": 0}


def _count(name: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[name] += n


def retry_counters() -> dict[str, int]:
    """Snapshot of the process-wide retry counters."""
    with _counters_lock:
        return dict(_counters)


def reset_retry_counters() -> None:
    """Test hook: zero the process-wide counters."""
    with _counters_lock:
        for k in _counters:
            _counters[k] = 0


def call_with_retry(fn: Callable[[], object], *, attempts: int = 3,
                    base_s: float = 0.02, cap_s: float = 0.25,
                    deadline_s: float = 2.0,
                    rng: random.Random | None = None,
                    sleep: Callable[[float], None] = time.sleep,
                    clock: Callable[[], float] = time.monotonic):
    """Run ``fn`` retrying retryable TransportErrors with exponential
    backoff + jitter, bounded by both ``attempts`` and ``deadline_s``.
    Non-retryable errors (e.g. StaleEpoch) and non-transport exceptions
    propagate immediately."""
    roll = (rng or random).random
    t0 = clock()
    delay = base_s
    last: TransportError | None = None
    for attempt in range(max(1, attempts)):
        try:
            return fn()
        except TransportError as e:
            if not getattr(e, "retryable", True):
                raise
            last = e
        if attempt + 1 >= attempts:
            break
        pause = delay * (0.5 + 0.5 * roll())
        if clock() - t0 + pause > deadline_s:
            break
        _count("retry_attempts")
        sleep(pause)
        delay = min(delay * 2.0, cap_s)
    assert last is not None
    _count("retry_exhausted")
    raise last


def call_hedged(fns, *, delay_s: float = 0.05,
                on_late: Callable[[object], None] | None = None):
    """Tail-hedged read (Dean & Barroso, *The Tail at Scale*, CACM 2013):
    fire ``fns[0]``; if it has not answered within ``delay_s``, fire the
    backup thunks too and return the FIRST success. Every call site must
    be declared in ``contracts.HEDGE_SAFE`` with idempotent READ verbs
    only (machine-checked by protocol_lint's hedge checker) — a hedged
    mutation lands twice.

    ``on_late(result)`` receives each losing thunk's eventual success so
    callers with delivery-marking reads (lm_poll) can merge rather than
    lose the duplicate's rows. Late *failures* are discarded.

    Single-thunk (or non-positive delay with one fn) degenerates to a
    plain call: no thread, no counter. NOT for the chaos harness —
    hedge threads would interleave the seeded rng draws; `hedge_reads`
    stays off there by config default.
    """
    fns = list(fns)
    if not fns:
        raise ValueError("call_hedged needs at least one thunk")
    if len(fns) == 1:
        return fns[0]()

    done = threading.Event()
    lock = threading.Lock()
    results: list[tuple[int, object]] = []    # (thunk index, value)
    errors: list[BaseException] = []
    launched = [False] * len(fns)

    def run(i: int) -> None:
        try:
            out = fns[i]()
        except BaseException as e:  # noqa: BLE001 - collected, re-raised
            with lock:
                errors.append(e)
                all_failed = len(errors) == sum(launched)
            if all_failed:
                done.set()
            return
        late = None
        with lock:
            results.append((i, out))
            late = len(results) > 1
        if late and on_late is not None:
            on_late(out)
        done.set()

    threads = []
    with lock:
        launched[0] = True
    t0 = threading.Thread(target=run, args=(0,), daemon=True)
    threads.append(t0)
    t0.start()
    if not done.wait(max(0.0, delay_s)):
        _count("hedged_rpcs")
        for i in range(1, len(fns)):
            with lock:
                launched[i] = True
            t = threading.Thread(target=run, args=(i,), daemon=True)
            threads.append(t)
            t.start()
    # first success wins; if every launched thunk failed, re-raise the
    # last error. Clear-before-check: appends happen under the lock
    # strictly before set(), so nothing observable is lost to the clear.
    while True:
        done.wait()
        done.clear()
        with lock:
            if results:
                idx, out = results[0]
                if idx > 0:
                    _count("hedge_wins")
                return out
            if len(errors) == sum(launched):
                raise errors[-1]
