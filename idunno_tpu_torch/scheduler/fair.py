"""Fair-time scheduling across concurrent model jobs.

Reference semantics (`assign_inference_work`, `mp4_machinelearning.py
:501-539`): with two jobs, each model gets ``round(t_m / (t_a + t_r) *
RATE_FACTOR)`` workers, clamped to the alive-worker count, where ``t_m`` is
the model's measured average query time — i.e. *resources proportional to
per-query cost*, so both jobs make equal progress in wall-clock time
(fair TIME sharing). Workers for each job are drawn by ``random.sample``
from the alive set independently per job (jobs may time-share a worker), and
the query range is split contiguously and near-evenly (`:516-536`).

Generalisations here: any number of concurrent models (the two-model formula
is the N=2 case of proportional shares); injected seeded RNG so scheduling is
reproducible (the reference's bare ``random.sample`` is not, `:520`); at
least one worker per active job so a new job is never starved before it has
timing history.
"""
from __future__ import annotations

import random
import time
from collections.abc import Callable

from idunno_tpu_torch.config import ClusterConfig
from idunno_tpu_torch.scheduler.tasks import Task, TaskBook


def fair_shares(avg_query_time: dict[str, float], rate_factor: int,
                n_workers: int) -> dict[str, int]:
    """Workers per model, proportional to measured per-query time; models
    with no history yet weigh as the mean of the others (ratio 1.0 in the
    reference when resnet has no data, `:504-506`)."""
    if not avg_query_time:
        return {}
    known = [t for t in avg_query_time.values() if t > 0]
    default = sum(known) / len(known) if known else 1.0
    weights = {m: (t if t > 0 else default)
               for m, t in avg_query_time.items()}
    total = sum(weights.values())
    shares = {}
    for m, w in weights.items():
        n = round(w / total * rate_factor)
        shares[m] = max(min(n, n_workers), 1 if n_workers else 0)
    return shares


def heterogeneous_shares(cnn_query_s: dict[str, float],
                         lm_request_s: dict[str, float],
                         rate_factor: int,
                         n_workers: int) -> dict[str, int]:
    """The reference's two-model ratio formula (`mp4_machinelearning.py
    :501-539`) generalized across JOB TYPES: CNN query jobs (measured avg
    seconds per query) and LM decode pools (measured avg seconds per
    request) divide the cluster's worker units proportionally to measured
    per-unit cost, so every job — whatever its type — makes equal
    wall-clock progress. Keys come back namespaced ``cnn:<model>`` /
    ``lm:<pool>``; a job with no history yet weighs as the mean of the
    others, exactly like the reference's no-data ratio 1.0."""
    times = {f"cnn:{m}": t for m, t in cnn_query_s.items()}
    times.update({f"lm:{p}": t for p, t in lm_request_s.items()})
    return fair_shares(times, rate_factor, n_workers)


def split_range(start: int, end: int, workers: list[str]) -> list[tuple[str, int, int]]:
    """Contiguous near-even split of the inclusive range across workers
    (`:523-536`: per step, round(remaining_items / remaining_workers))."""
    out = []
    remaining = end - start + 1
    cursor = start
    for i, w in enumerate(workers):
        n = round(remaining / (len(workers) - i))
        if n <= 0:
            continue
        out.append((w, cursor, cursor + n - 1))
        cursor += n
        remaining -= n
    return out


class FairScheduler:
    """Coordinator-side assignment engine over a TaskBook."""

    def __init__(self, config: ClusterConfig,
                 rng: random.Random | None = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.config = config
        self.rng = rng or random.Random(0)
        self.clock = clock
        self.book = TaskBook()
        # measured avg query seconds per model — fed by the metrics layer
        self.avg_query_time: dict[str, float] = {}
        # non-CNN jobs sharing the cluster (namespaced keys, e.g.
        # "lm:<pool>" → measured avg seconds per request) — fed by the LM
        # pool manager; they weigh in the fair share but are never
        # assigned CNN tasks
        self.extra_jobs: dict[str, float] = {}

    def active_models(self) -> list[str]:
        """Models with unfinished work (the 'concurrent jobs' the fair share
        divides between)."""
        return sorted({t.model for t in self.book.in_flight()})

    def assign(self, model: str, qnum: int, start: int, end: int,
               workers: list[str], dataset: str | None = None) -> list[Task]:
        """Split one query across this model's fair share of workers and
        record the tasks."""
        if not workers:
            return []
        times = dict(self.avg_query_time)
        for m in {model, *self.active_models()}:
            times.setdefault(m, 0.0)
        # heterogeneous arbitration: live LM pools claim their measured
        # share of the worker units, shrinking every CNN job's slice
        # proportionally (reference formula over the job UNION)
        times.update(self.extra_jobs)
        shares = fair_shares(times, self.config.rate_factor, len(workers))
        n = max(1, min(shares.get(model, 1), len(workers),
                       end - start + 1))
        chosen = self.rng.sample(workers, n)
        now = self.clock()
        tasks = [Task(model=model, qnum=qnum, worker=w, start=s, end=e,
                      t_assigned=now, dataset=dataset)
                 for w, s, e in split_range(start, end, chosen)]
        self.book.record(tasks)
        return tasks

    def reassign_failed(self, dead: str, alive: list[str]) -> list[Task]:
        """Reference ``transfer_failed_inference_work`` (`:706-760`): every
        in-flight task on the dead worker moves to its first eligible ring
        successor (round-robin over alive workers here — the ring-successor
        walk with dead/master skips, minus the reference's bias of piling
        everything onto one neighbor). A task already moved
        ``max_task_moves`` times is marked permanently FAILED instead (its
        t_assigned resets on every move, so the straggler cap can never
        catch a job that keeps killing its workers); returns only the
        tasks that actually moved."""
        moved = []
        candidates = [h for h in alive if h != dead]
        if not candidates:
            return []
        now = self.clock()
        for i, task in enumerate(self.book.in_flight(worker=dead)):
            if task.moves >= self.config.max_task_moves:
                self.book.mark_failed(task, now)
                import logging
                logging.getLogger("idunno.scheduler").error(
                    "task %s#%s [%s, %s] FAILED after %d total moves "
                    "(kept losing its workers)", task.model, task.qnum,
                    task.start, task.end, task.moves)
                continue
            successor = self._ring_successor(dead, candidates, i)
            moved.append(self.book.reassign(task, successor, now))
        return moved

    def _ring_successor(self, dead: str, candidates: list[str],
                        offset: int) -> str:
        hosts = self.config.hosts
        if dead in hosts:
            start = hosts.index(dead)
            ring = [hosts[(start + k) % len(hosts)]
                    for k in range(1, len(hosts) + 1)]
            ordered = [h for h in ring if h in candidates]
            if ordered:
                return ordered[offset % len(ordered)]
        return candidates[offset % len(candidates)]

    def stragglers(self) -> list[Task]:
        return self.book.stragglers(self.clock(),
                                    self.config.straggler_timeout_s)

    def redispatch_straggler(self, task: Task, alive: list[str],
                             expected_worker: str | None = None,
                             expected_stamp: float | None = None
                             ) -> Task | None:
        """Move a stuck task to a different alive worker (reference
        `monitor_inference_work` re-sends to the same worker, `:809-830`;
        moving is strictly better when the worker is wedged). These moves —
        and only these — count against the task's retry cap. With an
        expected (worker, stamp) snapshot the move is currency-checked
        (TaskBook.reassign_if_current) and returns None when another
        thread re-booked the task first."""
        others = [h for h in alive if h != task.worker] or alive
        target = self.rng.choice(others)
        if expected_worker is None:
            return self.book.reassign(task, target, self.clock(),
                                      count_retry=True)
        return self.book.reassign_if_current(
            task, expected_worker, expected_stamp, target, self.clock(),
            count_retry=True)
