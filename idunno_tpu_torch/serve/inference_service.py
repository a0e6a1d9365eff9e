"""The distributed inference serving path (SURVEY.md C6, C7, C9, C11).

Call path, re-architected from the reference's §3.2 stack:

  client ``submit_query`` ──INFERENCE──► acting master
      master: FairScheduler.assign → per-task ──JOB──► workers
      worker: queue → engine (jit batched forward on its chips)
              ──RESULT──► acting master (NOT a 10-way TCP broadcast,
                          `mp4_machinelearning.py:603-613`)
      master: TaskBook.mark_finished, metrics, result accumulation

Failure handling on the master: membership LEAVE → in-flight tasks of the
dead worker reassigned to ring successors and re-dispatched
(`transfer_failed_inference_work`, `:706-760`); straggler monitor re-sends
tasks stuck past the timeout with the comparison fixed (`:809-830`, bug
`:822`) and actually enabled (the reference ships it switched off, `:1277`).

Workers execute jobs from a queue: the transport handler only enqueues, so
dispatch never blocks on inference. The runtime drives ``process_jobs_once``
from a thread; tests call it directly for determinism.
"""
from __future__ import annotations

import threading
import time
import uuid
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any, Protocol

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.retry import call_with_retry
from idunno_tpu_torch.comm.transport import Transport, TransportError
from idunno_tpu_torch.config import ClusterConfig
from idunno_tpu_torch.membership.epoch import (check_payload, observe_payload,
                                         reply_is_stale)
from idunno_tpu_torch.membership.service import MembershipService
from idunno_tpu_torch.scheduler.fair import FairScheduler
from idunno_tpu_torch.scheduler.tasks import Task, WORKING
from idunno_tpu_torch.serve.metrics import MetricsTracker
from idunno_tpu_torch.utils.spans import stamp_trace, trace_from_payload
from idunno_tpu_torch.utils.types import MemberStatus, MessageType

SERVICE = "inference"
RESULT_SERVICE = "result"


class Engine(Protocol):
    """What a worker needs from its model engine (the real
    ``idunno_tpu_torch.engine.InferenceEngine`` or a test fake)."""

    def infer(self, name: str, start: int, end: int,
              dataset_root: str | None = None) -> Any: ...


@dataclass
class Job:
    model: str
    qnum: int
    start: int
    end: int
    dataset: str | None
    # dispatch stamp echoed in error reports so a stale report about an
    # OLD assignment can't be mistaken for the current one
    assigned: float = 0.0
    # (trace_id, parent_span_id) riding the JOB payload — the worker span
    # parents under the master's dispatch span
    trace: tuple | None = None


class InferenceServiceError(Exception):
    pass


class InferenceService:
    def __init__(self, host: str, config: ClusterConfig,
                 transport: Transport, membership: MembershipService,
                 engine: Engine, metrics: MetricsTracker | None = None,
                 scheduler: FairScheduler | None = None,
                 dataset_root: str | None = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.host = host
        self.config = config
        self.transport = transport
        self.membership = membership
        self.engine = engine
        self.clock = clock
        self.metrics = metrics or MetricsTracker(clock=clock)
        self.scheduler = scheduler or FairScheduler(config, clock=clock)
        self.dataset_root = dataset_root
        # synchronous standby write-ahead invoked at the end of every
        # master-side submit as wal_hook(model, qnum, tasks, dataset, idem)
        # (serve/node.py wires it to FailoverManager.wal_append);
        # None = periodic-only replication
        self.wal_hook = None

        # coordinator state
        self._qnum: dict[str, int] = {}          # per-model counter (`:965-966`)
        self._results: dict[tuple[str, int], list[tuple[str, str, float]]] = {}
        # per-model weight-provenance markers seen in RESULTs ("pretrained"
        # / "store" / "random") — random init must never pass as real
        # classifications
        self._weights_seen: dict[str, set[str]] = {}
        # per-model engine-failure reports: proof a model EXECUTED (and
        # failed) somewhere — it is not cold-compiling, so the straggler
        # monitor's first-compile grace must not shield it
        self._task_errors: dict[str, int] = {}
        # client idempotency keys → booked qnum: a retry after a lost ACK
        # returns the original booking instead of double-submitting
        # (replicated in the failover snapshot + WAL deltas)
        self._idem: dict[str, int] = {}
        # SpanStore wired by serve/node.py; None = tracing off everywhere
        self.spans = None
        # (model, qnum) → (trace_id, schedule_span_id): dispatch /
        # re-dispatch / collect spans of a query all hang off its schedule
        # span. Master-local (like metrics counters) — bounded FIFO.
        self._trace_ctx: dict[tuple[str, int], tuple] = {}
        self._results_lock = threading.RLock()

        # worker state
        self._jobs: list[Job] = []
        self._pending_results: list[Message] = []   # computed, undelivered
        self._jobs_lock = threading.RLock()
        self._jobs_available = threading.Event()
        # background member-change re-dispatch sends (join_reassign_dispatch)
        self._reassign_threads: list[threading.Thread] = []

        transport.serve(SERVICE, self._handle_inference)
        transport.serve(RESULT_SERVICE, self._handle_result)
        membership.on_change(self._on_member_change)

    # ------------------------------------------------------------------ #
    # client API
    # ------------------------------------------------------------------ #

    def _master_call(self, msg: Message) -> Message:
        """Primary→standby failover (`send_inference_command`, `:956-963`)
        — plus bounded backoff retries per target (safe: the message
        carries an idempotency key, so a retry after a lost ACK dedupes
        server-side) and fence-aware rerouting: a "not acting master" /
        stale-epoch rejection moves on to the next target instead of
        failing the submit."""
        targets = [self.membership.acting_master()]
        for t in (self.config.coordinator, self.config.standby_coordinator):
            if t not in targets:
                targets.append(t)
        last: object = None
        for t in targets:
            if t == self.host:
                out = self._handle_inference(SERVICE, msg)
            else:
                try:
                    out = call_with_retry(
                        lambda t=t: self.transport.call(t, SERVICE, msg,
                                                        timeout=30.0),
                        attempts=self.config.rpc_retry_attempts,
                        base_s=self.config.rpc_retry_base_s,
                        cap_s=self.config.rpc_retry_cap_s,
                        deadline_s=self.config.rpc_retry_deadline_s)
                except TransportError as e:
                    last = e
                    continue
            if out is None:
                continue
            observe_payload(self.membership.epoch, out.payload)
            if out.type is MessageType.ERROR:
                if out.payload.get("not_master") \
                        or out.payload.get("stale_epoch"):
                    last = out.payload.get("error")
                    continue        # deposed/unfenced peer: try the next
                raise InferenceServiceError(
                    out.payload.get("error", "inference error"))
            return out
        raise InferenceServiceError(f"no reachable coordinator: {last}")

    def submit_query(self, model: str, start: int, end: int,
                     dataset: str | None = None) -> int:
        """Submit one query range; returns the assigned query number.
        ``dataset`` overrides this node's default root for the query —
        e.g. ``store://<name>`` resolves against a dataset published into
        the replicated store on every worker (`engine.data_store`)."""
        # one idempotency key per LOGICAL submit, constant across every
        # retry/failover attempt inside _master_call: a lost ACK retried
        # against the same (or the newly adopted) master returns the
        # original qnum instead of booking twice
        payload = {"model": model, "start": start, "end": end,
                   "dataset": dataset or self.dataset_root,
                   "idem": f"{self.host}:{uuid.uuid4().hex}"}
        sp = None
        if self.spans is not None:
            sp = self.spans.start("cnn.submit",
                                  attrs={"model": model, "start": start,
                                         "end": end})
            stamp_trace(payload, sp.ctx)
        try:
            out = self._master_call(Message(
                MessageType.INFERENCE, self.host, payload))
        except Exception:
            if sp is not None:
                self.spans.finish(sp, error=True)
            raise
        if sp is not None:
            self.spans.finish(sp, qnum=int(out.payload["qnum"]))
        return int(out.payload["qnum"])

    def inference(self, model: str, start: int, end: int,
                  pace_s: float | None = None,
                  sleep: Callable[[float], None] = time.sleep,
                  dataset: str | None = None) -> list[int]:
        """The `inference <start> <end> <model>` verb: chunk the range into
        standard-batch queries, one submission per pacing interval
        (`Server.inference`, `:1104-1109`)."""
        bs = self.config.query_batch_size
        pace = self.config.query_interval_s if pace_s is None else pace_s
        qnums = []
        cursor = start
        while cursor <= end:
            chunk_end = min(cursor + bs - 1, end)
            qnums.append(self.submit_query(model, cursor, chunk_end,
                                           dataset=dataset))
            cursor = chunk_end + 1
            if cursor <= end and pace > 0:
                sleep(pace)
        return qnums

    def results(self, model: str, qnum: int) -> list[tuple[str, str, float]]:
        with self._results_lock:
            return list(self._results.get((model, qnum), []))

    def all_results(self) -> dict[str, list[tuple[str, str, float]]]:
        """c4 view: "model qnum" → records (`:1208-1211`)."""
        with self._results_lock:
            return {f"{m} {q}": list(v)
                    for (m, q), v in sorted(self._results.items())}

    def query_done(self, model: str, qnum: int) -> bool:
        return self.scheduler.book.query_done(model, qnum)

    def query_failed(self, model: str, qnum: int) -> bool:
        """True when part of the query permanently failed (retry cap):
        waiting for `query_done` would block forever."""
        return self.scheduler.book.query_failed(model, qnum)

    def models_seen(self) -> list[str]:
        """Models with at least one known query — the single source for the
        shell's c1/c2 and the remote stats verb (query counters plus the
        task book, which can know models the counters don't after a
        failover adoption)."""
        models = {m for m, _ in self.scheduler.book.queries()}
        with self._results_lock:
            models.update(self._qnum)
        return sorted(models)

    def weights_provenance(self) -> dict[str, str]:
        """Per-model weight provenance aggregated over RESULTs:
        "pretrained" | "store" | "random" | "unknown", or "mixed(...)" if workers
        disagree (e.g. one node has the checkpoint cached, another not)."""
        with self._results_lock:
            out = {}
            for m, seen in self._weights_seen.items():
                out[m] = (next(iter(seen)) if len(seen) == 1
                          else "mixed(" + ",".join(sorted(seen)) + ")")
            return out

    # ------------------------------------------------------------------ #
    # coordinator side
    # ------------------------------------------------------------------ #

    def _handle_inference(self, service: str, msg: Message) -> Message | None:
        # fence first, before either branch can touch scheduler state: a
        # verb stamped below our epoch high-water comes from a deposed
        # coordinator — reject (typed), never act; the reply deposes the
        # sender. Unstamped client submissions pass untouched.
        stale = check_payload(self.membership.epoch, msg.payload, self.host)
        if stale is not None:
            return stale
        if msg.type is MessageType.INFERENCE:      # client submission
            if not self.membership.is_acting_master:
                return Message(MessageType.ERROR, self.host,
                               {"error": f"{self.host} not acting master",
                                "not_master": True})
            p = msg.payload
            return self._master_submit(p["model"], int(p["start"]),
                                       int(p["end"]), p.get("dataset"),
                                       idem=p.get("idem"),
                                       trace=trace_from_payload(p))
        if msg.type is MessageType.JOB:            # dispatched task
            p = msg.payload
            with self._jobs_lock:
                self._jobs.append(Job(model=p["model"], qnum=int(p["qnum"]),
                                      assigned=float(p.get("assigned", 0.0)),
                                      start=int(p["start"]),
                                      end=int(p["end"]),
                                      dataset=p.get("dataset"),
                                      trace=trace_from_payload(p)))
                self._jobs_available.set()
            return Message(MessageType.ACK, self.host)
        return Message(MessageType.ERROR, self.host,
                       {"error": f"bad inference verb {msg.type}"})

    def _master_submit(self, model: str, start: int, end: int,
                       dataset: str | None,
                       idem: str | None = None,
                       trace: tuple | None = None) -> Message:
        workers = self._eligible_workers()     # before reserving the idem
        # key: a failed submit must stay retryable as a fresh booking
        if not workers:
            return Message(MessageType.ERROR, self.host,
                           {"error": "no alive workers"})
        with self._results_lock:                 # _qnum guarded like results
            # idempotency: check-and-reserve under the same lock as the
            # qnum bump, so two concurrent retries of one logical submit
            # can't both book (the first wins, the second reads its qnum)
            if idem is not None and idem in self._idem:
                dup = self._idem[idem]
                if self.spans is not None and trace is not None:
                    # retry after a lost ACK: the dedup is a span too, so
                    # the trace shows both attempts and ONE booking
                    self.spans.record(
                        "cnn.schedule", trace=trace[0], parent=trace[1],
                        t_start=self.spans.clock(),
                        attrs={"model": model, "qnum": dup,
                               "duplicate": True})
                return Message(MessageType.ACK, self.host,
                               {"qnum": dup, "duplicate": True})
            self.scheduler.avg_query_time = {
                m: self.metrics.avg_query_time(m)
                for m in set(self._qnum) | {model}}
            qnum = self._qnum.get(model, 0) + 1
            self._qnum[model] = qnum
            if idem is not None:
                self._idem[idem] = qnum
                if len(self._idem) > 4096:     # bounded: oldest keys fall
                    for k in list(self._idem)[:1024]:
                        del self._idem[k]
        ssp = None
        if self.spans is not None:
            # mints a fresh trace when the client didn't stamp one (e.g. a
            # shell-local submit): every query is traceable either way
            ssp = self.spans.start(
                "cnn.schedule",
                trace=trace[0] if trace else None,
                parent=trace[1] if trace else None,
                attrs={"model": model, "qnum": qnum,
                       "start": start, "end": end})
            with self._results_lock:
                self._trace_ctx[(model, qnum)] = (ssp.trace_id, ssp.span_id)
                if len(self._trace_ctx) > 4096:
                    for k in list(self._trace_ctx)[:1024]:
                        del self._trace_ctx[k]
        tasks = self.scheduler.assign(model, qnum, start, end, workers,
                                      dataset=dataset)
        for t in tasks:
            self._dispatch(t)
        if ssp is not None:
            self.spans.finish(ssp, tasks=len(tasks))
        # write-ahead to the standby BEFORE the client sees the ack: an
        # acked query must survive an immediate coordinator death, not
        # only one that lands after the next periodic replication tick
        # (FailoverManager.wal_append — a tiny per-query delta, never the
        # full snapshot, so the ack path stays O(1); best-effort when the
        # standby is down, like the periodic loop; wired by serve/node.py)
        if self.wal_hook is not None:
            self.wal_hook(model, qnum, tasks, dataset, idem)
        return Message(MessageType.ACK, self.host, {"qnum": qnum})

    # -- idempotency-map replication glue (FailoverManager) ---------------

    def record_idem(self, idem: str, qnum: int) -> None:
        with self._results_lock:
            self._idem[idem] = int(qnum)

    def idem_to_wire(self) -> dict[str, int]:
        with self._results_lock:
            return dict(self._idem)

    def idem_load_wire(self, wire: dict[str, int]) -> None:
        with self._results_lock:
            for k, v in wire.items():
                self._idem.setdefault(k, int(v))

    def trace_of(self, model: str, qnum: int) -> str | None:
        """Trace id of a scheduled query (the `trace` verb resolves
        ``model qnum`` through this); None when untraced or evicted."""
        with self._results_lock:
            tr = self._trace_ctx.get((model, int(qnum)))
            return tr[0] if tr else None

    def _eligible_workers(self) -> list[str]:
        """All alive hosts serve as workers, the coordinator included
        (`send_inference_work` local-execute branch, `:764-791`)."""
        return self.membership.members.alive_hosts()

    def _dispatch(self, task: Task) -> None:
        # On send failure, reassign on the spot rather than waiting for the
        # failure detector — with a cumulative exclusion set so several
        # simultaneously-dead workers can't ping-pong the dispatch forever.
        tried: set[str] = set()
        tr = None
        if self.spans is not None:
            with self._results_lock:
                tr = self._trace_ctx.get((task.model, task.qnum))
        while True:
            # snapshot the assignment this attempt is for (atomic — a torn
            # read could pair the new worker with the old stamp), and
            # rebuild the message per attempt: the echoed ``assigned``
            # stamp must match the CURRENT booking or the worker's error
            # report about it would be dropped as stale
            worker, stamp, state = self.scheduler.book.assignment(task)
            if state != WORKING:
                return          # finished/failed while queued for dispatch
            msg = Message(MessageType.JOB, self.host,
                          {"model": task.model, "qnum": task.qnum,
                           "start": task.start, "end": task.end,
                           "dataset": task.dataset,
                           "assigned": stamp,
                           "epoch": list(self.membership.epoch.view())})
            dsp = None
            if tr is not None:
                # one span per ATTEMPT: re-dispatch after a dead worker
                # shows up as a second span naming the new worker
                dsp = self.spans.start(
                    "cnn.dispatch", trace=tr[0], parent=tr[1],
                    attrs={"model": task.model, "qnum": task.qnum,
                           "start": task.start, "end": task.end,
                           "worker": worker})
                stamp_trace(msg.payload, (tr[0], dsp.span_id))
            if worker == self.host:
                self._handle_inference(SERVICE, msg)
                if dsp is not None:
                    self.spans.finish(dsp, local=True)
                return
            try:
                out = self.transport.call(worker, SERVICE, msg,
                                          timeout=30.0)
                if dsp is not None:
                    self.spans.finish(dsp)
                if reply_is_stale(self.membership.epoch, out):
                    # the worker has seen a higher epoch: we are deposed.
                    # Step down — do NOT treat this as a dead worker and
                    # re-dispatch (that is exactly the split-brain double
                    # execution fencing exists to prevent); the real
                    # master owns this task now.
                    return
                return
            except TransportError:
                if dsp is not None:
                    self.spans.finish(dsp, error="TransportError")
                tried.add(worker)
                alive = [h for h in self._eligible_workers()
                         if h not in tried]
                if not alive:
                    return    # straggler monitor will retry later
                moved = self.scheduler.book.reassign_if_current(
                    task, worker, stamp,
                    self.scheduler.rng.choice(alive), self.clock())
                if moved is None:
                    # another thread re-booked (second death, straggler
                    # pass, error report) while this send was in flight;
                    # that thread owns the dispatch now — dropping here
                    # prevents double-moves and double-execution
                    return
                task = moved

    def _handle_result(self, service: str, msg: Message) -> Message | None:
        """Acting master accumulates results + metrics (`:623-704`);
        error reports from workers re-dispatch the task immediately."""
        p = msg.payload
        # observe (never reject) the worker's fence view: the work itself
        # is valid at any epoch (the book dedupes), but a result stamped
        # ABOVE our view means we were deposed while partitioned — the
        # observe demotes us and the is_acting_master checks below hand
        # the result back to the worker for the real master
        observe_payload(self.membership.epoch, p)
        model, qnum = p["model"], int(p["qnum"])
        start, end = int(p["start"]), int(p["end"])
        if p.get("error"):
            if not self.membership.is_acting_master:
                # keep the report queued worker-side for the real master
                return Message(MessageType.ERROR, self.host,
                               {"error": f"{self.host} not acting master",
                                "not_master": True})
            assigned = float(p.get("assigned", 0.0))
            task = next(
                (t for t in self.scheduler.book.in_flight(msg.sender)
                 if t.model == model and t.qnum == qnum
                 and t.start == start and t.end == end
                 # the echoed dispatch stamp ties the report to THIS
                 # assignment: a stale report (queued while partitioned)
                 # about an older assignment of the same range to the
                 # same worker must not burn the current attempt's budget
                 and abs(t.t_assigned - assigned) < 1e-6), None)
            if task is None:              # stale (already moved/finished)
                return Message(MessageType.ACK, self.host,
                               {"duplicate": True})
            # evidence of life for the model: it executed and FAILED, so
            # the cold-compile straggler grace no longer applies to it
            # (master-local; a failover resets it, costing at most one
            # grace period)
            self._task_errors[model] = self._task_errors.get(model, 0) + 1
            # the report is about THIS (sender, stamp) assignment — the
            # snapshot keeps a concurrent re-booking from being moved twice
            self._redispatch_or_fail(
                task, f"engine error on {msg.sender}: {p['error']}",
                snapshot=(msg.sender, assigned))
            return Message(MessageType.ACK, self.host)
        task = self.scheduler.book.mark_finished(model, qnum, start, end,
                                                 self.clock())
        if task is None:
            if self.membership.is_acting_master:
                # genuinely stale/duplicate — accept and drop
                return Message(MessageType.ACK, self.host,
                               {"duplicate": True})
            # unknown task on a NON-master (e.g. the standby before
            # adoption): refuse, so the worker keeps the result queued
            # instead of believing it was delivered.
            return Message(MessageType.ERROR, self.host,
                           {"error": f"{self.host} has no record of task",
                            "not_master": True})
        records = [tuple(r) for r in p["records"]]
        with self._results_lock:
            self._results.setdefault((model, qnum), []).extend(records)
            self._weights_seen.setdefault(model, set()).add(
                p.get("weights", "unknown"))
        self.metrics.record_task(model, task.n_items,
                                 float(p["elapsed_s"]),
                                 self.config.query_batch_size)
        done = self.scheduler.book.query_done(model, qnum)
        if done:
            self.metrics.record_query_done(model)
        tctx = trace_from_payload(p)
        if self.spans is not None and tctx is not None:
            now = self.spans.clock()
            self.spans.record("cnn.collect", trace=tctx[0], parent=tctx[1],
                              t_start=now, t_end=now,
                              attrs={"model": model, "qnum": qnum,
                                     "start": start, "end": end,
                                     "n": len(records),
                                     "worker": msg.sender,
                                     "query_done": done})
        return Message(MessageType.ACK, self.host)

    # -- failure / straggler handling (master) ----------------------------

    def _on_member_change(self, host: str, old: MemberStatus | None,
                          new: MemberStatus) -> None:
        if new is not MemberStatus.LEAVE or not self.membership.is_acting_master:
            return
        alive = self._eligible_workers()
        # book mutation is synchronous (tasks re-booked before returning);
        # only the network sends go off-thread: this callback runs on the
        # membership monitor loop, and a dispatch to a PARTITIONED
        # successor blocks on the full RPC timeout — failure detection for
        # other hosts must not stall behind it (same discipline as
        # lm_manager._on_member_change). The stale-snapshot guards in
        # _dispatch/_redispatch_or_fail keep the now-concurrent paths from
        # double-moving shared tasks.
        tasks = self.scheduler.reassign_failed(host, alive)
        if not tasks:
            return

        def _safe_dispatch(t: Task) -> None:
            try:
                self._dispatch(t)
            except Exception:  # noqa: BLE001 - a failed send must not
                # abandon the task silently; the straggler monitor retries
                import logging
                logging.getLogger("idunno.serving").warning(
                    "reassignment dispatch of %s#%s [%s, %s] failed",
                    t.model, t.qnum, t.start, t.end, exc_info=True)

        # one thread per task: a partitioned successor costs ITS task the
        # RPC timeout, not every later task's dispatch latency too. The
        # threads are tracked so tests (and shutdown paths) can join them
        # — the InProc transport's determinism contract is preserved via
        # `join_reassign_dispatch`, not by blocking the monitor loop here.
        for t in tasks:
            th = threading.Thread(target=_safe_dispatch, args=(t,),
                                  daemon=True,
                                  name=f"{self.host}-reassign")
            # start before recording: joining an unstarted thread raises
            th.start()
            with self._jobs_lock:
                self._reassign_threads = [
                    x for x in self._reassign_threads if x.is_alive()] + [th]

    def join_reassign_dispatch(self, timeout: float = 5.0) -> None:
        """Wait for in-flight member-change re-dispatch sends (they run on
        background threads so a partitioned successor can't stall the
        membership monitor loop). Deterministic tests call this between
        `monitor_once` and their job pump."""
        with self._jobs_lock:
            threads = list(self._reassign_threads)
        deadline = time.monotonic() + timeout
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))

    # a model with NO completed task cluster-wide yet is probably
    # compiling on every worker at once (first TPU compile of a shape is
    # ~40-80 s, well past straggler_timeout_s): give its never-moved tasks
    # this grace so the monitor doesn't bounce the first query between
    # equally-cold workers and burn its retry cap on compiles. One grace
    # per task (reassign resets t_assigned, so per-move grace would
    # multiply time-to-FAILED for a wedged-but-not-failing engine to
    # many minutes); after the first result, error report, or move, the
    # plain straggler timeout applies.
    first_compile_grace_s = 150.0

    def monitor_stragglers_once(self) -> int:
        """Re-dispatch tasks stuck past the straggler timeout (stretched
        to ``first_compile_grace_s`` for never-moved tasks of models with
        no completed task yet — every worker is cold-compiling, not
        stuck); returns how many moved. A task past the retry cap is
        marked permanently FAILED (deterministic failures must not bounce
        between workers forever); pollers see it via `query_failed`."""
        if not self.membership.is_acting_master:
            return 0
        alive = self._eligible_workers()     # one snapshot for the pass
        moved = 0
        now = self.clock()
        for task in self.scheduler.stragglers():
            # atomic snapshot of the assignment this suspicion is about;
            # _redispatch_or_fail drops the move if the book moved on
            worker, stamp, state = self.scheduler.book.assignment(task)
            if state != WORKING:
                continue
            # cumulative counters, not the windowed average: a warm model
            # idle past the metrics window must NOT regain compile grace,
            # and a model with reported engine FAILURES isn't compiling
            if (task.moves == 0 and task.retries == 0
                    and self.metrics.finished_images(task.model) == 0
                    and not self._task_errors.get(task.model)
                    and now - stamp <= self.first_compile_grace_s):
                continue      # cold model, every worker compiling: wait
            if self._redispatch_or_fail(task, "straggler",
                                        snapshot=(worker, stamp),
                                        alive=alive):
                moved += 1
        # gray-failure early pass: a task whose worker the
        # differential-health ledger holds SUSPECT or QUARANTINED (slow
        # but heartbeat-alive — the full timeout would wait out a limp
        # that heartbeats never surface) re-dispatches after
        # straggler_early_frac of the window, onto a healthy worker when
        # one exists. Same snapshot/retry-cap semantics as the full pass.
        health = getattr(self.membership, "health", None)
        unhealthy = health.unhealthy() if health is not None else set()
        if unhealthy:
            early_s = (self.config.straggler_timeout_s
                       * self.config.straggler_early_frac)
            healthy_alive = [w for w in alive
                             if w not in unhealthy] or alive
            for task in self.scheduler.book.stragglers(now, early_s):
                worker, stamp, state = self.scheduler.book.assignment(task)
                if state != WORKING or worker not in unhealthy:
                    continue
                if (task.moves == 0 and task.retries == 0
                        and self.metrics.finished_images(task.model) == 0
                        and not self._task_errors.get(task.model)
                        and now - stamp <= self.first_compile_grace_s):
                    continue
                if self._redispatch_or_fail(task, "gray-straggler",
                                            snapshot=(worker, stamp),
                                            alive=healthy_alive):
                    moved += 1
                    self.metrics.record_counter("early_redispatches")
        return moved

    def _redispatch_or_fail(self, task: Task, why: str,
                            snapshot: tuple[str, float],
                            alive: list[str] | None = None) -> bool:
        """Shared failure semantics for the straggler monitor and worker
        error reports: move the task (consuming its retry budget) or,
        past ``max_task_retries``, mark it permanently FAILED. Returns
        True when the task moved. ``snapshot`` is the (worker, stamp)
        assignment the caller's suspicion is ABOUT — required, captured
        where the suspicion arose, so the check spans the caller's whole
        decision window — if the book has moved the task since
        (concurrent member-change reassignment or a racing report), the
        suspicion is stale and the move is dropped: the re-booking thread
        owns the dispatch, and a double move would burn the retry budget
        twice and execute the task on two workers."""
        exp_worker, exp_stamp = snapshot
        cur_worker, cur_stamp, cur_state = \
            self.scheduler.book.assignment(task)
        if (cur_state != WORKING or cur_worker != exp_worker
                or abs(cur_stamp - exp_stamp) > 1e-6):
            return False
        if task.retries >= self.config.max_task_retries:
            # (a move between the check above and here would mislabel the
            # moved task FAILED — the window is lock-free microseconds,
            # vs. the RPC-length window the snapshot check closes)
            self.scheduler.book.mark_failed(task, self.clock())
            import logging
            logging.getLogger("idunno.serving").error(
                "task %s#%s [%s, %s] FAILED after %d re-dispatches "
                "(last worker %s; %s)", task.model, task.qnum, task.start,
                task.end, task.retries, task.worker, why)
            return False
        moved = self.scheduler.redispatch_straggler(
            task, alive if alive is not None else self._eligible_workers(),
            expected_worker=exp_worker, expected_stamp=exp_stamp)
        if moved is None:
            return False              # re-booked mid-decision: not ours
        self._dispatch(moved)
        return True

    # ------------------------------------------------------------------ #
    # worker side
    # ------------------------------------------------------------------ #

    def pending_jobs(self) -> int:
        with self._jobs_lock:
            return len(self._jobs)

    def process_jobs_once(self) -> int:
        """Retry undelivered results, then execute every queued job on the
        local engine; returns the number of jobs executed."""
        with self._jobs_lock:
            retries, self._pending_results = self._pending_results, []
            jobs, self._jobs = self._jobs, []
            self._jobs_available.clear()
        for msg in retries:          # re-send only, never re-compute
            self._deliver_result(msg)
        for job in jobs:
            self._execute(job)
        return len(jobs)

    def wait_for_jobs(self, timeout: float) -> bool:
        return self._jobs_available.wait(timeout)

    def _execute(self, job: Job) -> None:
        t0 = self.clock()
        traced = self.spans is not None and job.trace is not None
        ts0 = self.spans.clock() if traced else 0.0
        try:
            res = self.engine.infer(
                job.model, job.start, job.end,
                dataset_root=job.dataset or self.dataset_root)
        except Exception as e:  # noqa: BLE001 - a bad job must not kill
            # the worker: an engine failure (unfetchable dataset, bad model
            # name, device error) is REPORTED to the master, which
            # re-dispatches immediately (no straggler-timeout wait) and
            # counts it as evidence the model isn't merely compiling
            # (the cold-model grace must not shield deterministic
            # failures). The worker keeps serving its queue.
            import logging
            logging.getLogger("idunno.serving").warning(
                "job %s#%s [%s, %s] failed on %s (%s: %s); reporting to "
                "master for re-dispatch", job.model, job.qnum, job.start,
                job.end, self.host, type(e).__name__, e)
            err_payload = {"model": job.model, "qnum": job.qnum,
                           "start": job.start, "end": job.end,
                           "assigned": job.assigned,
                           "error": f"{type(e).__name__}: {e}"}
            if traced:
                wsp = self.spans.record(
                    "cnn.worker", trace=job.trace[0], parent=job.trace[1],
                    t_start=ts0,
                    attrs={"model": job.model, "qnum": job.qnum,
                           "start": job.start, "end": job.end,
                           "error": f"{type(e).__name__}: {e}"[:120]})
                stamp_trace(err_payload, (job.trace[0], wsp.span_id))
            self._deliver_result(Message(
                MessageType.RESULT, self.host, err_payload))
            return
        elapsed = getattr(res, "elapsed_s", None)
        if elapsed is None:
            elapsed = self.clock() - t0
        records = getattr(res, "records", res)
        payload = {"model": job.model, "qnum": job.qnum,
                   "start": job.start, "end": job.end,
                   "elapsed_s": elapsed,
                   "weights": getattr(res, "weights", "unknown"),
                   "records": [list(r) for r in records]}
        if traced:
            wsp = self.spans.record(
                "cnn.worker", trace=job.trace[0], parent=job.trace[1],
                t_start=ts0,
                attrs={"model": job.model, "qnum": job.qnum,
                       "start": job.start, "end": job.end,
                       "n": len(payload["records"]),
                       "elapsed_s": round(float(elapsed), 6)})
            # the RESULT carries the worker span as parent so the master's
            # collect span closes the loop under it
            stamp_trace(payload, (job.trace[0], wsp.span_id))
        msg = Message(MessageType.RESULT, self.host, payload)
        self._deliver_result(msg)

    def _deliver_result(self, msg: Message) -> None:
        """Send a computed RESULT to the acting master (standby fallback);
        queue the *message* for retry on failure — the inference itself is
        never re-executed."""
        # stamp OUR fence view per delivery attempt (it may have advanced
        # since the job executed): a deposed master receiving it observes
        # the higher epoch and steps down
        msg.payload["epoch"] = list(self.membership.epoch.view())
        master = self.membership.acting_master()
        targets = [master]
        if self.config.standby_coordinator not in targets:
            targets.append(self.config.standby_coordinator)
        for target in targets:
            if target == self.host:
                out = self._handle_result(RESULT_SERVICE, msg)
            else:
                try:
                    out = self.transport.call(target, RESULT_SERVICE, msg,
                                              timeout=30.0)
                except TransportError:
                    continue
            if out is not None and out.type is MessageType.ACK:
                return
        with self._jobs_lock:
            self._pending_results.append(msg)
            self._jobs_available.set()
