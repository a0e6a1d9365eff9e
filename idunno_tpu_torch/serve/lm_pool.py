"""Thread-owned serving loop around `engine.serve_lm.DecodeServer`.

`DecodeServer` is a single-threaded object (device state + host bookkeeping
mutate together); the cluster runtime needs submissions and polls arriving
from RPC handler threads while a dedicated thread drives the decode loop.
This wrapper gives the server exactly one driving thread and puts a lock
between it and the RPC side: submissions land in a host-side inbox the loop
drains, completions accumulate in a host-side outbox polls swap out.

The loop sleeps on an event while idle (no busy-spin — the reference's
`monitor_query_rate` burns a core, `mp4_machinelearning.py:1016-1036`) and
wakes on submit or stop.

With a `serve/gateway.py:AdmissionGateway` attached, submissions go
through admission (quota/backpressure sheds raise on the caller's
thread) into the gateway's priority queues instead of the FIFO inbox;
the loop thread pulls from the gateway with a dispatch budget that keeps
the server-side queue shallow (~2 batches deep), so EDF/fair-queueing
decisions are made as late as possible, and completes expired entries
as ``rejected="expired"`` without ever decoding them.
"""
from __future__ import annotations

import threading

from idunno_tpu_torch.engine.serve_lm import Completion, DecodeServer
from idunno_tpu_torch.serve.admission import PRIORITIES, AdmissionShed
from idunno_tpu_torch.serve.gateway import AdmissionGateway


class LMServingLoop:
    """One background thread driving one DecodeServer; all public methods
    are safe to call from any thread."""

    def __init__(self, server: DecodeServer, name: str = "lm",
                 gateway: AdmissionGateway | None = None,
                 spans=None) -> None:
        self.server = server
        self.gateway = gateway
        # per-node span recorder (utils/spans.SpanStore | None); wiring it
        # here also hands it to the server for prefill/decode-step spans
        self.spans = spans
        if spans is not None:
            server.spans = spans
        # rid → (trace_id, admit_span_id, t_enq) while in flight;
        # rid → trace_id survives completion so the `trace` verb can
        # resolve a finished request's trace (bounded, insertion-ordered)
        self._traces: dict[int, tuple] = {}
        self._trace_ids: dict[int, str] = {}
        self._lock = threading.Lock()
        # (id, toks, max_new, temperature, top_p, top_k, pres, freq,
        #  stop, seed)
        self._inbox: list[tuple] = []
        self._outbox: list[Completion] = []
        self._next_id = 0
        self._id_map: dict[int, int] = {}     # server-side id → public id
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._errors: list[str] = []
        # cancellation + snapshot both mutate/read DecodeServer state, so
        # they are handed to the loop thread: cancels as a drained box,
        # snapshots as a request/response pair of events
        self._cancel_box: list[int] = []      # server-side ids
        self._snap_serial = threading.Lock()  # one snapshot waiter at a time
        self._snap_want = threading.Event()
        self._snap_done = threading.Event()
        self._snap: list[dict] = []
        # cluster prefix-cache ops (publish/probe/fetch) mutate server
        # state, so RPC threads marshal them to the loop thread exactly
        # like snapshots; tenant notes ride a drained box
        self._prefix_serial = threading.Lock()
        self._prefix_want = threading.Event()
        self._prefix_done = threading.Event()
        self._prefix_req: tuple | None = None
        self._prefix_out: object = None
        self._note_box: list[tuple] = []      # (tokens, tenant)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"{name}-decode-loop")
        self._thread.start()

    # -- any thread -------------------------------------------------------

    def submit(self, tokens: list[int], max_new: int, *,
               temperature: float = 0.0, top_p: float = 1.0,
               top_k: int = 0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0,
               stop: list[list[int]] | None = None,
               seed: int | None = None,
               tenant: str = "default", priority: str = "interactive",
               deadline_ms: float | None = None,
               readmit: bool = False,
               trace: tuple | None = None) -> int:
        """Validate + queue a prompt; returns the public request id.
        Raises once the pool is stopped — a submit racing `stop()` must
        error loudly, not return an id that never completes.

        On a gateway pool, admission runs here on the caller's thread:
        an `AdmissionShed` (quota / queue_full / backpressure) raises
        before any id is queued. ``readmit=True`` is the manager's replay
        path — an already-admitted request being re-forwarded after node
        death bypasses admission checks (but still queues by class/ft)."""
        # validate eagerly on the caller's thread so the RPC gets the error
        # (the loop thread has nowhere to raise to)
        self.server.validate(tokens, max_new, temperature, top_p, top_k,
                             presence_penalty, frequency_penalty, stop)
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        tr = tuple(trace) if self.spans is not None and trace else None
        with self._lock:
            # checked under the lock: stop() sets the flag BEFORE its own
            # locked inbox drain, so an append here either precedes the
            # drain (request errored there) or sees the flag (raises here)
            if self._stop.is_set():
                raise ValueError("serving pool is stopped")
            rid = self._next_id
            self._next_id += 1
            entry = (rid, list(tokens), max_new, temperature, top_p, top_k,
                     presence_penalty, frequency_penalty, stop, seed)
            if self.gateway is None:
                self._inbox.append(entry)
        if self.gateway is None:
            if tr is not None:   # outside the lock: _book_trace takes it
                sp = self.spans.record(
                    "lm.admit", trace=tr[0], parent=tr[1],
                    attrs={"rid": rid, "tenant": tenant,
                           "priority": priority, "gateway": False})
                self._book_trace(rid, tr[0], sp.span_id, sp.t_end)
        if self.gateway is not None:
            # outside self._lock: the gateway has its own lock, and a shed
            # must not leave loop state half-mutated (rid gaps are fine)
            t0 = self.spans.clock() if tr is not None else None
            try:
                self.gateway.admit(rid, entry, tenant=tenant,
                                   priority=priority,
                                   deadline_ms=deadline_ms,
                                   pool_gauges=self._pool_gauges(),
                                   readmit=readmit)
            except AdmissionShed as e:
                if tr is not None:   # shed is terminal — trace records it
                    self.spans.record(
                        "lm.shed", trace=tr[0], parent=tr[1], t_start=t0,
                        attrs={"rid": rid, "reason": e.reason,
                               "tenant": tenant, "priority": priority})
                raise
            if tr is not None:
                sp = self.spans.record(
                    "lm.admit", trace=tr[0], parent=tr[1], t_start=t0,
                    attrs={"rid": rid, "tenant": tenant,
                           "priority": priority, "gateway": True,
                           "readmit": bool(readmit)})
                self._book_trace(rid, tr[0], sp.span_id, sp.t_end)
            # a stop() racing in between admit and here has already drained
            # the gateway; pull our entry back out and error like any other
            # post-stop submit (cancel() returning None = stop drained it,
            # in which case it was errored there)
            if self._stop.is_set() and self.gateway.cancel(rid) is not None:
                raise ValueError("serving pool is stopped")
        # tenant attribution for cluster prefix publishes (no-op when
        # the cluster tier is off)
        self.note_tenant(tokens, tenant)
        self._wake.set()
        return rid

    def _book_trace(self, rid: int, tid: str, sid: str,
                    t_enq: float) -> None:
        """Remember an admitted request's trace: in-flight tuple for the
        queue-wait/finish spans, plus the rid → trace_id map the `trace`
        verb resolves after completion (bounded FIFO)."""
        with self._lock:
            self._traces[rid] = (tid, sid, t_enq)
            self._trace_ids[rid] = tid
            while len(self._trace_ids) > 4096:
                self._trace_ids.pop(next(iter(self._trace_ids)))

    def _trace_done(self, rid: int, name: str, **attrs) -> None:
        """Record the terminal span (finish/cancel/expire) for ``rid`` and
        retire its in-flight trace entry."""
        tr = self._traces.pop(rid, None)
        if tr is not None and self.spans is not None:
            self.spans.record(name, trace=tr[0], parent=tr[1],
                              attrs={"rid": rid, **attrs})

    def trace_of(self, rid: int) -> str | None:
        """Trace id of a public request id (live or recently finished);
        None for untraced/unknown ids."""
        with self._lock:
            return self._trace_ids.get(rid)

    def _pool_gauges(self) -> dict:
        """Live occupancy snapshot for backpressure. Reads of the server's
        containers from RPC threads are GIL-atomic len()s; the gateway adds
        its own queue depth to ``waiting`` under its lock."""
        srv = self.server
        g = {"waiting": len(self._inbox) + len(srv._queue),
             "live": len(srv._live), "slots": srv.slots}
        bp = srv._block_pool
        if bp is not None:
            g["kv_blocks_free"] = bp.num_free
            g["kv_blocks_total"] = bp.num_blocks
        return g

    def poll(self) -> list[Completion]:
        """Completions since the last poll (public ids)."""
        with self._lock:
            out, self._outbox = self._outbox, []
            return out

    def cancel(self, rid: int) -> bool:
        """Best-effort cancel of public request ``rid``. A request still in
        the inbox is dropped here and completes (cancelled, prompt-only)
        immediately; one already on the server is cancelled by the loop
        thread at its next iteration and completes with whatever tokens it
        had. Returns False when the id is unknown — already completed (its
        tokens are in the outbox or were polled) or never submitted."""
        if self.gateway is not None:
            e = self.gateway.cancel(rid)
            if e is not None:
                full = (self.server.prefix or []) + list(e.payload[1])
                with self._lock:
                    self._outbox.append(Completion(
                        id=rid, tokens=full,
                        prompt_len=len(full), cancelled=True,
                        logprobs=([] if self.server.track_logprobs
                                  else None)))
                self._trace_done(rid, "lm.cancel", where="gateway")
                return True
        with self._lock:
            for i, entry in enumerate(self._inbox):
                if entry[0] == rid:
                    del self._inbox[i]
                    full = (self.server.prefix or []) + list(entry[1])
                    self._outbox.append(Completion(
                        id=rid, tokens=full,
                        prompt_len=len(full), cancelled=True,
                        logprobs=([] if self.server.track_logprobs
                                  else None)))
                    self._trace_done(rid, "lm.cancel", where="inbox")
                    return True
            sid = next((s for s, r in self._id_map.items() if r == rid),
                       None)
            if sid is None:
                return False
            self._cancel_box.append(sid)
        self._wake.set()
        return True

    def prefix_op(self, op: str, timeout: float = 30.0, **kw) -> dict:
        """Run a cluster prefix-cache operation ("publish" | "probe" |
        "fetch") on the LOOP thread — the DecodeServer's radix tree and
        block pool are loop-thread-owned, so RPC handlers must marshal
        (same request/response-event shape as `snapshot`). Raises the
        op's error on this thread; ValueError on timeout."""
        if self.server.cluster_prefix is None:
            raise ValueError("pool has no cluster prefix cache "
                             "(serve with cluster_prefix=)")
        with self._prefix_serial:
            self._prefix_done.clear()
            self._prefix_req = (op, kw)
            self._prefix_want.set()
            self._wake.set()
            if not self._prefix_done.wait(timeout):
                self._prefix_want.clear()
                self._prefix_req = None
                raise ValueError(f"prefix_{op} timed out after "
                                 f"{timeout}s")
            out = self._prefix_out
        if isinstance(out, Exception):
            raise ValueError(f"prefix_{op}: {out}") from out
        return out

    def handoff_op(self, op: str, timeout: float = 30.0, **kw) -> dict:
        """Run a DistServe KV-handoff operation ("probe" | "export" |
        "adopt" | "fallback") on the LOOP thread — handoff export/adopt
        walk the radix tree and block pool, which are loop-thread-owned,
        so RPC handlers marshal exactly like `prefix_op` (the two op
        families share the serialized request/response channel). Gated
        on the block tier, NOT the cluster prefix cache: a handoff is
        point-to-point and needs no SDFS ring."""
        if self.server._radix is None:
            raise ValueError("pool has no KV block tier "
                             "(serve with kv_block_size > 0)")
        with self._prefix_serial:
            self._prefix_done.clear()
            self._prefix_req = (f"handoff_{op}", kw)
            self._prefix_want.set()
            self._wake.set()
            if not self._prefix_done.wait(timeout):
                self._prefix_want.clear()
                self._prefix_req = None
                raise ValueError(f"kv_handoff {op} timed out after "
                                 f"{timeout}s")
            out = self._prefix_out
        if isinstance(out, Exception):
            raise ValueError(f"kv_handoff {op}: {out}") from out
        return out

    def note_tenant(self, tokens: list[int], tenant: str) -> None:
        """Record (prompt head → tenant) for publish attribution; the
        loop thread drains the box into the cluster cache."""
        if self.server.cluster_prefix is None:
            return
        with self._lock:
            self._note_box.append((list(tokens), str(tenant)))

    def snapshot(self, timeout: float = 2.0) -> list[dict]:
        """Progress of every live row (public ids): prompt + tokens
        generated so far — the streaming surface behind ``lm_partial``.
        Fulfilled by the loop thread at its next iteration; returns [] if
        the loop doesn't answer within ``timeout`` (stopped or wedged)."""
        with self._snap_serial:
            self._snap_done.clear()
            self._snap_want.set()
            self._wake.set()
            if not self._snap_done.wait(timeout):
                self._snap_want.clear()
                return []
            with self._lock:
                return list(self._snap)

    def stats(self) -> dict:
        """Server counters + this loop's queue depths. The server's dict is
        only mutated by the loop thread; int reads are GIL-atomic."""
        out = self.server.stats()
        with self._lock:
            out["inbox"] = len(self._inbox)
            out["unpolled"] = len(self._outbox)
        if self.gateway is not None:
            out["gateway"] = self.gateway.stats()
        return out

    def errors(self) -> list[str]:
        """Errors since the last call (drained, like `poll`)."""
        with self._lock:
            out, self._errors = self._errors, []
            return out

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        with self._lock:          # fail anything the loop never drained
            dropped, self._inbox = self._inbox, []
            if self.gateway is not None:
                dropped = dropped + [e.payload for e in self.gateway.drain()]
            for entry in dropped:
                self._traces.pop(entry[0], None)
                if len(self._errors) < 100:
                    self._errors.append(
                        f"request {entry[0]} dropped: pool stopped")

    # -- loop thread ------------------------------------------------------

    def _drain_inbox(self) -> None:
        with self._lock:
            batch, self._inbox = self._inbox, []
        for (rid, tokens, max_new, temperature, top_p, top_k, pres,
             freq, stop, seed) in batch:
            ctx = self._queue_wait_span(rid)
            sid = self.server.submit(tokens, max_new,
                                     temperature=temperature, top_p=top_p,
                                     top_k=top_k, presence_penalty=pres,
                                     frequency_penalty=freq, stop=stop,
                                     seed=rid if seed is None else seed,
                                     trace=ctx)
            # under the lock: cancel() iterates this map from RPC threads
            with self._lock:
                self._id_map[sid] = rid

    def _queue_wait_span(self, rid: int,
                         t_enq: float | None = None) -> tuple | None:
        """Record the queue-wait span for ``rid`` (admission → dispatch to
        the server) and return the (trace_id, admit_span_id) context the
        server's prefill span chains under; None when untraced.
        ``t_enq`` overrides the booked enqueue time (the gateway entry's
        own timestamp — same clock in fake-clock tests)."""
        tr = self._traces.get(rid)
        if tr is None or self.spans is None:
            return None
        self.spans.record(
            "lm.queue_wait", trace=tr[0], parent=tr[1],
            t_start=tr[2] if t_enq is None else float(t_enq),
            attrs={"rid": rid})
        return tr[0], tr[1]

    def _drain_gateway(self) -> None:
        """Pull admitted work from the gateway under a dispatch budget
        that keeps the server queue ~2 batches deep (dispatching later
        keeps EDF/expiry decisions informed by the freshest deadlines),
        and retire expired entries as rejected completions."""
        if self.gateway is None:
            return
        budget = max(0, 2 * self.server.slots - self.server.pending())
        ready, expired = self.gateway.take(budget)
        for e in expired:
            full = (self.server.prefix or []) + list(e.payload[1])
            with self._lock:
                self._outbox.append(Completion(
                    id=e.rid, tokens=full, prompt_len=len(full),
                    rejected="expired",
                    logprobs=([] if self.server.track_logprobs else None)))
            self._trace_done(e.rid, "lm.expire", reason="expired")
        for e in ready:
            (rid, tokens, max_new, temperature, top_p, top_k, pres,
             freq, stop, seed) = e.payload
            ctx = self._queue_wait_span(rid, t_enq=e.t_enq)
            sid = self.server.submit(tokens, max_new,
                                     temperature=temperature, top_p=top_p,
                                     top_k=top_k, presence_penalty=pres,
                                     frequency_penalty=freq, stop=stop,
                                     seed=rid if seed is None else seed,
                                     trace=ctx)
            with self._lock:
                self._id_map[sid] = rid

    def _drain_cancels(self) -> None:
        with self._lock:
            batch, self._cancel_box = self._cancel_box, []
        for sid in batch:
            self.server.cancel(sid)

    def _fulfill_prefix(self) -> None:
        if not self._prefix_want.is_set():
            return
        req = self._prefix_req
        if req is None:                 # waiter timed out and withdrew
            self._prefix_want.clear()
            return
        op, kw = req
        try:
            if op == "publish":
                out: object = self.server.prefix_publish(**kw)
            elif op == "probe":
                out = self.server.prefix_probe(**kw)
            elif op == "fetch":
                out = self.server.prefix_warm(**kw)
            elif op == "handoff_probe":
                out = self.server.handoff_probe(**kw)
            elif op == "handoff_export":
                out = self.server.handoff_export(**kw)
            elif op == "handoff_adopt":
                out = self.server.handoff_adopt(**kw)
            elif op == "handoff_fallback":
                out = self.server.handoff_fallback(**kw)
            else:
                out = ValueError(f"unknown prefix op {op!r}")
        except Exception as e:  # noqa: BLE001 - waiter must not hang
            out = e
        self._prefix_req = None
        self._prefix_out = out
        self._prefix_want.clear()
        self._prefix_done.set()

    def _drain_notes(self) -> None:
        cp = self.server.cluster_prefix
        if cp is None:
            return
        with self._lock:
            batch, self._note_box = self._note_box, []
        for tokens, tenant in batch:
            cp.note(tokens, tenant)

    def _fulfill_snapshot(self) -> None:
        if not self._snap_want.is_set():
            return
        try:
            snap = self.server.snapshot()
        except Exception as e:  # noqa: BLE001 - waiter must not hang
            snap = []
            with self._lock:
                if len(self._errors) < 100:
                    self._errors.append(f"snapshot: {type(e).__name__}: {e}")
        with self._lock:
            rows = []
            for e in snap:
                rid = self._id_map.get(e["id"], e["id"])
                tr = self._traces.get(rid)
                tid = tr[0] if tr else self._trace_ids.get(rid)
                # untraced rows gain no `trace` key — the streaming
                # surface predates tracing and clients diff it exactly
                rows.append(dict(e, id=rid, **({"trace": tid} if tid
                                               else {})))
            self._snap = rows
        self._snap_want.clear()
        self._snap_done.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._drain_cancels()
                self._drain_notes()
                self._drain_inbox()
                self._drain_gateway()
                live = self.server.step()
                done = self.server.poll()
            except Exception as e:  # noqa: BLE001 - loop must stay alive
                with self._lock:
                    if len(self._errors) < 100:   # bounded between drains
                        self._errors.append(f"{type(e).__name__}: {e}")
                live, done = 0, []
            self._fulfill_prefix()
            self._fulfill_snapshot()
            if done:
                with self._lock:
                    for c in done:
                        rid = self._id_map.pop(c.id, c.id)
                        self._outbox.append(Completion(
                            id=rid,
                            tokens=c.tokens, prompt_len=c.prompt_len,
                            service_s=c.service_s, cancelled=c.cancelled,
                            logprobs=c.logprobs,
                            cold_start=c.cold_start))
                        self._trace_done(
                            rid,
                            "lm.cancel" if c.cancelled else "lm.finish",
                            tokens=len(c.tokens))
            if live == 0:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
