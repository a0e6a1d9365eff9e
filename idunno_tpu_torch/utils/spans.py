"""Dapper-style request tracing: spans on the wire, ring buffers per node.

Always-on distributed tracing (Sigelman et al., "Dapper", 2010 — PAPERS.md)
riding the exact payload-stamp mechanism `membership/epoch.py` built for
epoch fences: a ``trace`` key (``[trace_id, parent_span_id]``) travels on
existing verb payloads next to the ``epoch`` stamp, each node records named
spans into a bounded in-memory ring buffer, and the ``trace`` control verb
(serve/control.py) collects a request's spans cluster-wide for the shell
waterfall and `tools/trace_export.py` (Chrome/Perfetto trace-event JSON).

Design rules, mirrored from the fence helpers:

- **Stamping is optional everywhere**: an unstamped payload (old client,
  pre-trace peer) records nothing and changes nothing — tracing can never
  fail a request.
- **Deterministic ids**: span ids are ``<node>:<seq>`` from a per-store
  counter and trace ids ``t:<node>:<seq>`` — no uuid/random, so the chaos
  harness (`idunno_tpu/chaos.py`) replays byte-identical traces from a
  seed, and two stores never collide because the node name is the prefix.
- **Injectable clock**: the store takes ``clock=`` exactly like
  `serve/metrics.py:MetricsTracker`, so fake-clock tests (gateway suite,
  chaos, TimedFakeEngine clusters) get exact, assertable timelines.
- **Bounded**: a deque(maxlen) ring — tracing a busy node costs a dict
  append, never unbounded memory; `dump()` is the observation window.

The thread-local *current context* (`current()`) lets the JSON-lines log
formatter (`utils/logging.py`) tag records with the active trace/span so
logs and traces cross-link.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable

TRACE_KEY = "trace"
DEFAULT_CAPACITY = 4096

_tls = threading.local()


def current() -> tuple[str, str] | None:
    """The thread's active (trace_id, span_id), or None. Set by
    `SpanStore.span()` / `push_ctx()`; read by the JSON log formatter."""
    return getattr(_tls, "ctx", None)


@contextmanager
def push_ctx(trace_id: str, span_id: str):
    """Make (trace_id, span_id) the thread's current context for the
    block — for handlers that adopt a wire context without opening a
    local span."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (trace_id, span_id)
    try:
        yield
    finally:
        _tls.ctx = prev


# -- wire helpers (the `epoch.py:stamp`/`check_payload` pattern) ----------

def stamp_trace(payload: dict, ctx: tuple[str, str] | None) -> dict:
    """Stamp a payload with a (trace_id, span_id) context, in place
    (returns the payload for chaining). ``ctx=None`` is a no-op so call
    sites never need to branch."""
    if ctx is not None:
        payload[TRACE_KEY] = [ctx[0], ctx[1]]
    return payload


def trace_from_payload(payload) -> tuple[str, str] | None:
    """Extract a (trace_id, parent_span_id) context from a stamped
    payload; None when unstamped (old peer / plain client)."""
    tc = payload.get(TRACE_KEY) if isinstance(payload, dict) else None
    if not tc or len(tc) < 2 or tc[0] is None:
        return None
    return str(tc[0]), str(tc[1])


@dataclass
class Span:
    """One named, timed hop. ``t_end`` is None while open; attrs are
    free-form JSON-safe scalars (shed reason, prefix hit depth, epoch)."""

    trace_id: str
    span_id: str
    parent: str | None
    name: str
    node: str
    t_start: float
    t_end: float | None = None
    attrs: dict = field(default_factory=dict)

    @property
    def ctx(self) -> tuple[str, str]:
        return self.trace_id, self.span_id

    def duration(self) -> float:
        return 0.0 if self.t_end is None else self.t_end - self.t_start

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent": self.parent, "name": self.name, "node": self.node,
                "t_start": round(self.t_start, 6),
                "t_end": (round(self.t_end, 6)
                          if self.t_end is not None else None),
                "attrs": dict(self.attrs)}

    @staticmethod
    def from_wire(d: dict) -> "Span":
        return Span(trace_id=str(d["trace_id"]), span_id=str(d["span_id"]),
                    parent=d.get("parent"), name=str(d["name"]),
                    node=str(d.get("node", "?")),
                    t_start=float(d["t_start"]),
                    t_end=(float(d["t_end"])
                           if d.get("t_end") is not None else None),
                    attrs=dict(d.get("attrs") or {}))


class SpanStore:
    """Per-node bounded span recorder; all methods thread-safe.

    One instance per host (`serve/node.py` hangs it off the Node; the
    chaos cluster builds one per fake host with the shared fake clock).
    Span/trace ids are minted from a node-prefixed counter so they are
    deterministic under seeded simulation and globally unique in a real
    cluster."""

    def __init__(self, node: str, *,
                 clock: Callable[[], float] = time.monotonic,
                 capacity: int = DEFAULT_CAPACITY) -> None:
        self.node = node
        self.clock = clock
        self._lock = threading.Lock()
        self._buf: deque[Span] = deque(maxlen=int(capacity))
        self._seq = 0
        self._recorded = 0            # lifetime total (ring may evict)

    # -- id minting -------------------------------------------------------

    def _next(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def new_trace(self) -> str:
        return f"t:{self.node}:{self._next()}"

    # -- recording --------------------------------------------------------

    def start(self, name: str, *, trace: str | None = None,
              parent: str | None = None,
              attrs: dict | None = None) -> Span:
        """Open a span (not yet in the buffer — `finish` appends it).
        ``trace=None`` mints a fresh trace rooted at this span."""
        return Span(trace_id=trace or self.new_trace(),
                    span_id=f"{self.node}:{self._next()}", parent=parent,
                    name=name, node=self.node, t_start=self.clock(),
                    attrs=dict(attrs or {}))

    def finish(self, span: Span, **attrs: Any) -> Span:
        span.t_end = self.clock()
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._buf.append(span)
            self._recorded += 1
        return span

    def record(self, name: str, *, trace: str | None = None,
               parent: str | None = None, t_start: float | None = None,
               t_end: float | None = None,
               attrs: dict | None = None) -> Span:
        """One-shot span, appended immediately. Explicit ``t_start``/
        ``t_end`` let callers time against a different clock they own
        (e.g. the gateway's queue-enter timestamp)."""
        now = self.clock()
        span = Span(trace_id=trace or self.new_trace(),
                    span_id=f"{self.node}:{self._next()}", parent=parent,
                    name=name, node=self.node,
                    t_start=now if t_start is None else float(t_start),
                    t_end=now if t_end is None else float(t_end),
                    attrs=dict(attrs or {}))
        with self._lock:
            self._buf.append(span)
            self._recorded += 1
        return span

    @contextmanager
    def span(self, name: str, *, trace: str | None = None,
             parent: str | None = None, attrs: dict | None = None):
        """Timed block; sets the thread-local current context so nested
        logging cross-links. Yields the Span for attr updates."""
        sp = self.start(name, trace=trace, parent=parent, attrs=attrs)
        prev = getattr(_tls, "ctx", None)
        _tls.ctx = sp.ctx
        try:
            yield sp
        finally:
            _tls.ctx = prev
            self.finish(sp)

    # -- observation ------------------------------------------------------

    def dump(self, trace_id: str | None = None,
             limit: int | None = None) -> list[dict]:
        """Wire dicts of the buffered window, oldest first; filtered to
        one trace when ``trace_id`` is given, last ``limit`` otherwise."""
        with self._lock:
            spans = list(self._buf)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        if limit is not None and limit > 0:
            spans = spans[-limit:]
        return [s.to_wire() for s in spans]

    def recorded_total(self) -> int:
        with self._lock:
            return self._recorded

    def depth(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
