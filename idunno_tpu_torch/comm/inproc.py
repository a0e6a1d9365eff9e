"""In-process fake network — the test cluster substrate.

The reference was only ever tested by hand on 10 real VMs (SURVEY.md §4).
This transport lets N node objects form a cluster inside one process with
controllable failures: ``kill(host)`` makes a node unreachable (process
crash), ``partition(a, b)`` drops traffic between two hosts (network cut),
both reversible. Delivery is synchronous on the caller's thread — tests stay
deterministic; the node runtime supplies its own threads for periodic loops.

Beyond binary kill/cut, the network injects *seeded* partial faults in the
style of FoundationDB's deterministic simulation (Zhou et al., SIGMOD 2021):

- ``cut_oneway(src, dst)`` — asymmetric loss: src→dst traffic is dropped
  while dst→src still flows (requests lost one way; replies lost the
  other — a reliable call whose *reply* direction is cut runs the handler
  and then raises, the exact lost-ACK shape idempotency keys exist for).
- ``set_chaos(drop=…, dup=…, delay=…, seed=…)`` — probabilistic drop,
  duplication (handler runs twice per request), and bounded delay/reorder
  of datagrams, drawn from one ``random.Random(seed)`` so a failing chaos
  schedule replays exactly from its seed.
- ``lose_next_reply(src, dst, n)`` — a targeted, deterministic lost ACK:
  the next ``n`` reliable calls src→dst execute server-side but the caller
  sees a timeout.
- ``slow_host(host, factor)`` — a sustained FAIL-SLOW fault (gray
  failure): every call touching the host reports an inflated
  handler latency (``base_call_s × factor``) to the caller's attached
  health ledger — a *handler-delay multiplier*, distinct from the
  per-datagram ``delay`` reordering above. Deterministic (no clock, no
  rng): the latency is synthesized, not slept, unless ``sleep_s`` is
  given (the gray bench uses a real sleep so hedging has a real tail to
  cut). Cleared by ``clear_chaos``.

Chaos is off by default (all probabilities 0, no cuts): existing fixtures
burn no RNG draws and behave exactly as before.
"""
from __future__ import annotations

import random
import threading
import time

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.transport import Handler, Transport, TransportError


class InProcNetwork:
    """Shared registry of node transports + fault state."""

    def __init__(self, seed: int | None = None) -> None:
        self._nodes: dict[str, "InProcTransport"] = {}
        self._dead: set[str] = set()
        self._cuts: set[frozenset[str]] = set()
        self._oneway: set[tuple[str, str]] = set()
        self._lose_reply: dict[tuple[str, str], int] = {}
        self._rng = random.Random(seed)
        self._drop_p = 0.0
        self._dup_p = 0.0
        self._delay_p = 0.0
        self._delay_max = 4
        self._chaos_links: set[tuple[str, str]] | None = None
        # held datagrams: [deliveries_left_until_release, src, dst,
        # service, msg] — releasing after N subsequent delivers gives
        # bounded delay AND reordering without a clock dependency
        self._held: list[list] = []
        # fail-slow fault state: host -> (latency multiplier, real sleep)
        self._slow: dict[str, tuple[float, float]] = {}
        # nominal per-call handler latency reported to health ledgers
        # when no fault is active (everything equally fast = no verdicts)
        self.base_call_s = 0.01
        self._lock = threading.RLock()

    def transport(self, host: str) -> "InProcTransport":
        with self._lock:
            t = InProcTransport(host, self)
            self._nodes[host] = t
            return t

    # -- fault injection --------------------------------------------------

    def kill(self, host: str) -> None:
        with self._lock:
            self._dead.add(host)

    def revive(self, host: str) -> None:
        with self._lock:
            self._dead.discard(host)

    def partition(self, a: str, b: str) -> None:
        with self._lock:
            self._cuts.add(frozenset((a, b)))

    def heal(self, a: str, b: str) -> None:
        with self._lock:
            self._cuts.discard(frozenset((a, b)))

    def cut_oneway(self, src: str, dst: str) -> None:
        """Drop src→dst traffic only (dst→src still flows)."""
        with self._lock:
            self._oneway.add((src, dst))

    def heal_oneway(self, src: str, dst: str) -> None:
        with self._lock:
            self._oneway.discard((src, dst))

    def lose_next_reply(self, src: str, dst: str, n: int = 1) -> None:
        """The next ``n`` reliable calls src→dst run the handler but the
        caller gets a timeout — a deterministic lost ACK."""
        with self._lock:
            self._lose_reply[(src, dst)] = (
                self._lose_reply.get((src, dst), 0) + n)

    def set_chaos(self, *, drop: float = 0.0, dup: float = 0.0,
                  delay: float = 0.0, max_delay: int = 4,
                  seed: int | None = None,
                  links=None) -> None:
        """Enable probabilistic faults on every delivery (or only on
        ``links``, an iterable of (src, dst) pairs). ``drop``/``dup``/
        ``delay`` are per-delivery probabilities; a dropped reliable call
        splits 50/50 between lost-request and lost-reply. Reseeds the
        schedule RNG when ``seed`` is given."""
        with self._lock:
            self._drop_p = float(drop)
            self._dup_p = float(dup)
            self._delay_p = float(delay)
            self._delay_max = max(1, int(max_delay))
            self._chaos_links = (None if links is None
                                 else {tuple(l) for l in links})
            if seed is not None:
                self._rng = random.Random(seed)

    def slow_host(self, host: str, factor: float,
                  sleep_s: float = 0.0) -> None:
        """Sustained fail-slow: calls to/from ``host`` report
        ``base_call_s × factor`` latency to attached health ledgers
        (and really sleep ``sleep_s`` when given — bench only; chaos
        stays sleepless so fake clocks own time)."""
        with self._lock:
            self._slow[host] = (max(1.0, float(factor)), float(sleep_s))

    def clear_slow(self, host: str | None = None) -> None:
        with self._lock:
            if host is None:
                self._slow.clear()
            else:
                self._slow.pop(host, None)

    def call_latency(self, src: str, dst: str) -> float:
        """Synthesized handler latency for one reliable call src→dst —
        what the caller's health ledger observes. Pure function of the
        fault state: deterministic under seeded schedules."""
        with self._lock:
            f = max(self._slow.get(dst, (1.0, 0.0))[0],
                    self._slow.get(src, (1.0, 0.0))[0])
            return self.base_call_s * f

    def clear_chaos(self) -> None:
        with self._lock:
            self._drop_p = self._dup_p = self._delay_p = 0.0
            self._chaos_links = None
            self._lose_reply.clear()
            self._slow.clear()

    def heal_all(self) -> None:
        """Remove every cut (symmetric and one-way); chaos probabilities
        and held datagrams are untouched (clear_chaos / flush_held)."""
        with self._lock:
            self._cuts.clear()
            self._oneway.clear()

    def unperturbed(self, host: str) -> bool:
        """True when ``host`` is alive and no cut (symmetric or one-way)
        touches it — the precondition for the chaos harness's
        false-LEAVE invariant: a merely SLOW host with clean links must
        never be declared dead."""
        with self._lock:
            return (host not in self._dead
                    and not any(host in c for c in self._cuts)
                    and not any(host in pair for pair in self._oneway))

    def flush_held(self) -> None:
        """Deliver every delayed datagram now (still subject to the
        *current* reachability — a heal then flush models late packets
        crossing the healed link)."""
        with self._lock:
            due, self._held = self._held, []
        for _, src, dst, service, msg in due:
            self._release_one(src, dst, service, msg)

    # -- delivery ---------------------------------------------------------

    def _reachable(self, src: str, dst: str) -> bool:
        with self._lock:
            return (dst in self._nodes and dst not in self._dead
                    and src not in self._dead
                    and frozenset((src, dst)) not in self._cuts
                    and (src, dst) not in self._oneway)

    def _chaos_roll(self, src: str, dst: str, reliable: bool) -> str:
        with self._lock:
            total = self._drop_p + self._dup_p + self._delay_p
            if total <= 0.0:
                return "ok"
            if (self._chaos_links is not None
                    and (src, dst) not in self._chaos_links):
                return "ok"
            r = self._rng.random()
            if r < self._drop_p:
                if reliable and self._rng.random() < 0.5:
                    return "drop_reply"
                return "drop"
            if r < self._drop_p + self._dup_p:
                return "dup"
            if r < total:
                return "delay"
            return "ok"

    def _tick_held(self) -> None:
        """Each delivery ages held datagrams by one; release the due ones
        (re-checking reachability at release time, like real late
        packets)."""
        with self._lock:
            if not self._held:
                return
            keep: list[list] = []
            due: list[list] = []
            for item in self._held:
                item[0] -= 1
                (due if item[0] <= 0 else keep).append(item)
            self._held = keep
        for _, src, dst, service, msg in due:
            self._release_one(src, dst, service, msg)

    def _release_one(self, src: str, dst: str, service: str,
                     msg: Message) -> None:
        try:
            if self._reachable(src, dst):
                self._deliver_raw(src, dst, service, msg, reliable=False)
        except TransportError:
            pass

    def _deliver_raw(self, src: str, dst: str, service: str,
                     msg: Message, reliable: bool) -> Message | None:
        with self._lock:
            node = self._nodes.get(dst)
            handler = node._handlers.get(service) if node else None
        if handler is None:
            if reliable:
                raise TransportError(f"{dst} has no service {service!r}",
                                     reason="closed")
            return None
        # round-trip through bytes so serialization bugs surface in tests
        wire = Message.from_bytes(msg.to_bytes())
        return handler(service, wire)

    def deliver(self, src: str, dst: str, service: str,
                msg: Message, reliable: bool) -> Message | None:
        self._tick_held()
        if not self._reachable(src, dst):
            if reliable:
                raise TransportError(f"{dst} unreachable from {src}")
            return None
        mode = self._chaos_roll(src, dst, reliable)
        with self._lock:
            rev_cut = (dst, src) in self._oneway
            lose_reply = self._lose_reply.get((src, dst), 0) > 0
            if reliable and lose_reply:
                self._lose_reply[(src, dst)] -= 1
        if reliable:
            if mode == "drop":
                raise TransportError(
                    f"request {src}->{dst} dropped (chaos)",
                    reason="timeout")
            with self._lock:
                naps = max(self._slow.get(dst, (1.0, 0.0))[1],
                           self._slow.get(src, (1.0, 0.0))[1])
            if naps > 0.0:
                # bench-mode fail-slow only: chaos schedules keep
                # sleep_s=0 so the fake clock owns all time
                time.sleep(naps)
            # delay is unobservable on a synchronous call — deliver
            out = self._deliver_raw(src, dst, service, msg, reliable=True)
            if mode == "dup":    # duplicated request frame: handler twice
                self._deliver_raw(src, dst, service, msg, reliable=True)
            if mode == "drop_reply" or rev_cut or lose_reply:
                raise TransportError(
                    f"reply {dst}->{src} lost from {src}'s view",
                    reason="timeout")
            return out
        if mode == "drop":
            return None
        if mode == "delay":
            with self._lock:
                hold = 1 + self._rng.randrange(self._delay_max)
                self._held.append([hold, src, dst, service, msg])
            return None
        out = self._deliver_raw(src, dst, service, msg, reliable=False)
        if mode == "dup":
            self._deliver_raw(src, dst, service, msg, reliable=False)
        return out


class InProcTransport(Transport):
    def __init__(self, host: str, net: InProcNetwork) -> None:
        self.host = host
        self._net = net
        self._handlers: dict[str, Handler] = {}

    def serve(self, service: str, handler: Handler) -> None:
        self._handlers[service] = handler

    def call(self, host: str, service: str, msg: Message,
             timeout: float | None = None) -> Message | None:
        h = self.health
        if h is None:
            return self._net.deliver(self.host, host, service, msg,
                                     reliable=True)
        # differential health feed: the synthesized per-call latency is a
        # pure function of the network's fail-slow state, so seeded chaos
        # schedules observe identical samples on replay
        lat = self._net.call_latency(self.host, host)
        try:
            out = self._net.deliver(self.host, host, service, msg,
                                    reliable=True)
        except TransportError:
            h.observe(host, lat, error=True)
            raise
        h.observe(host, lat)
        return out

    def datagram(self, host: str, service: str, msg: Message) -> None:
        try:
            self._net.deliver(self.host, host, service, msg, reliable=False)
        except TransportError:
            pass

    def close(self) -> None:
        self._handlers.clear()
