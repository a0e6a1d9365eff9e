"""Task bookkeeping for the coordinator.

The reference keeps two parallel dicts: ``worker_set[(model, qnum)]`` holding
``(vm, start, end, 'w'/'f', t_start, t_end)`` tuples and the reverse map
``working_vm_set[vm]`` (`mp4_machinelearning.py:137-144, 529-533`). Here both
views live behind one thread-safe book with typed tasks, and the whole book
serializes to/from wire form for standby-coordinator state replication
(replacing the stringified-dict broadcast, `:971-1011`).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any

WORKING = "w"        # reference's 'w' / 'f' task states (`:529-533, 645-652`)
FINISHED = "f"
FAILED = "x"         # beyond reference: permanently failed (retry cap hit)


@dataclass
class Task:
    model: str
    qnum: int
    worker: str
    start: int                  # inclusive, reference range convention
    end: int
    state: str = WORKING
    t_assigned: float = 0.0
    t_finished: float = 0.0
    # the query's dataset root travels WITH the task so failure/straggler
    # re-dispatch (and post-failover resumption) reruns it on the same data
    dataset: str | None = None
    # suspected-task moves (straggler monitor + worker engine-error
    # reports) — capped by max_task_retries so a job that
    # deterministically FAILS (worker survives, task never finishes)
    # can't re-dispatch forever
    retries: int = 0
    # every move (straggler + crash/transport) — capped by the much larger
    # max_task_moves so a job that deterministically KILLS its workers
    # (whose moves reset t_assigned and never look like stragglers) is
    # also bounded
    moves: int = 0

    @property
    def n_items(self) -> int:
        return self.end - self.start + 1

    def to_wire(self) -> dict[str, Any]:
        return {"model": self.model, "qnum": self.qnum, "worker": self.worker,
                "start": self.start, "end": self.end, "state": self.state,
                "t_assigned": self.t_assigned, "t_finished": self.t_finished,
                "dataset": self.dataset, "retries": self.retries,
                "moves": self.moves}

    @classmethod
    def from_wire(cls, d: dict[str, Any]) -> "Task":
        return cls(model=d["model"], qnum=int(d["qnum"]), worker=d["worker"],
                   start=int(d["start"]), end=int(d["end"]), state=d["state"],
                   t_assigned=float(d["t_assigned"]),
                   t_finished=float(d["t_finished"]),
                   dataset=d.get("dataset"),
                   retries=int(d.get("retries", 0)),
                   moves=int(d.get("moves", 0)))


class TaskBook:
    """All in-flight and finished tasks, indexed by query and by worker."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._by_query: dict[tuple[str, int], list[Task]] = {}

    # -- mutation ---------------------------------------------------------

    def record(self, tasks: list[Task]) -> None:
        with self._lock:
            for t in tasks:
                self._by_query.setdefault((t.model, t.qnum), []).append(t)

    def reassign(self, task: Task, new_worker: str, now: float,
                 count_retry: bool = False) -> Task:
        """Move an in-flight task to another worker (failure/straggler
        re-dispatch, `:706-760`). ``count_retry`` increments the
        retry-cap counter — set only for SUSPECTED-TASK moves (the
        straggler monitor and worker engine-error reports, both via
        `InferenceService._redispatch_or_fail`): moves caused by worker
        crashes or dispatch transport failures are infrastructure churn
        and must not consume the budget meant for jobs that
        deterministically fail wherever they run."""
        with self._lock:
            task.worker = new_worker
            task.t_assigned = now
            task.moves += 1
            if count_retry:
                task.retries += 1
            return task

    def assignment(self, task: Task) -> tuple[str, float, str]:
        """Atomic (worker, t_assigned, state) snapshot. Reading the two
        fields without the lock can tear against a concurrent `reassign`
        (new worker with the old stamp), which would stamp a JOB message
        no error report could ever match."""
        with self._lock:
            return task.worker, task.t_assigned, task.state

    def reassign_if_current(self, task: Task, expected_worker: str,
                            expected_stamp: float, new_worker: str,
                            now: float,
                            count_retry: bool = False) -> Task | None:
        """`reassign`, but only if the caller's view of the assignment is
        still the booked one. Dispatch retry loops run on several threads
        (member-change reassignment, straggler monitor, error reports) and
        share Task objects; a loop whose snapshot went stale must DROP its
        claim — the thread that re-booked the task owns its dispatch —
        instead of double-moving (and double-executing) it. Returns None
        when the book has moved on (also when the task finished/failed)."""
        with self._lock:
            if (task.state != WORKING or task.worker != expected_worker
                    or abs(task.t_assigned - expected_stamp) > 1e-6):
                return None
            return self.reassign(task, new_worker, now,
                                 count_retry=count_retry)

    def mark_failed(self, task: Task, now: float) -> Task:
        """Permanently fail a task (retry cap exhausted): the query will
        never be 'done'; `query_failed` surfaces it to pollers instead of
        letting them wait forever."""
        with self._lock:
            task.state = FAILED
            task.t_finished = now
            return task

    def mark_finished(self, model: str, qnum: int, start: int, end: int,
                      now: float) -> Task | None:
        """Flip the matching task to finished (`:645-652`); returns it, or
        None if no matching unfinished task (duplicate/stale result).
        A FAILED task also accepts: failure is a give-up marker, not a
        fact — a slow-but-correct worker delivering after the retry cap
        heals the query instead of having its records dropped."""
        with self._lock:
            for t in self._by_query.get((model, qnum), []):
                if t.start == start and t.end == end \
                        and t.state in (WORKING, FAILED):
                    t.state = FINISHED
                    t.t_finished = now
                    return t
        return None

    # -- queries ----------------------------------------------------------

    def tasks_for_query(self, model: str, qnum: int) -> list[Task]:
        with self._lock:
            return list(self._by_query.get((model, qnum), []))

    def query_done(self, model: str, qnum: int) -> bool:
        with self._lock:
            tasks = self._by_query.get((model, qnum), [])
            return bool(tasks) and all(t.state == FINISHED for t in tasks)

    def query_failed(self, model: str, qnum: int) -> bool:
        """True when any of the query's tasks is permanently failed."""
        with self._lock:
            return any(t.state == FAILED
                       for t in self._by_query.get((model, qnum), []))

    def tasks_on_worker(self, worker: str) -> list[Task]:
        """The reference's ``working_vm_set`` view (`:140-144`)."""
        with self._lock:
            return [t for ts in self._by_query.values() for t in ts
                    if t.worker == worker]

    def in_flight(self, worker: str | None = None) -> list[Task]:
        with self._lock:
            return [t for ts in self._by_query.values() for t in ts
                    if t.state == WORKING
                    and (worker is None or t.worker == worker)]

    def stragglers(self, now: float, timeout: float) -> list[Task]:
        """In-flight tasks assigned more than ``timeout`` ago — with the
        comparison the right way around (the reference computes
        ``start_time - time_now`` which is never positive, `:822`)."""
        with self._lock:
            return [t for ts in self._by_query.values() for t in ts
                    if t.state == WORKING and now - t.t_assigned > timeout]

    def queries(self) -> list[tuple[str, int]]:
        with self._lock:
            return sorted(self._by_query)

    # -- failover serialization ------------------------------------------

    def to_wire(self) -> list[dict[str, Any]]:
        with self._lock:
            return [t.to_wire() for ts in self._by_query.values() for t in ts]

    def load_wire(self, tasks: list[dict[str, Any]]) -> None:
        with self._lock:
            self._by_query.clear()
            for d in tasks:
                t = Task.from_wire(d)
                self._by_query.setdefault((t.model, t.qnum), []).append(t)
