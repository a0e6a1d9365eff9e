"""Query-rate and processing-time metrics (SURVEY.md C8).

Reference semantics kept, bugs not (`mp4_machinelearning.py:623-677,
1016-1036`):
- Per finished task, record a *normalized* per-query processing time:
  ``elapsed / n_items * batch_size`` — the time a full standard query (400
  images) would have taken at this task's rate (`:656-662`).
- 30 s sliding window (SLIDING_WINDOW_SECONDS=10 × FACTOR=3, `:56-57`)
  pruned on read, not by a busy-spin thread (`:1016-1036` burns a core).
- Stats vector [avg, p25, p50, p75, stddev] (`:618-621`).
- c1/c2 surface real numbers — the reference *fabricates* AlexNet stats as
  0.95 × ResNet's and quartiles from the max average (`:1232-1267`).
"""
from __future__ import annotations

import statistics
import threading
import time
from collections.abc import Callable
from dataclasses import dataclass


@dataclass
class ProcessingStats:
    avg: float
    q1: float
    q2: float
    q3: float
    stddev: float
    n: int

    def as_list(self) -> list[float]:
        return [self.avg, self.q1, self.q2, self.q3, self.stddev]


def _percentile(sorted_vals: list[float], p: float) -> float:
    """numpy.percentile's default linear interpolation (`:620`), without
    pulling numpy into the control plane."""
    if not sorted_vals:
        return 0.0
    k = (len(sorted_vals) - 1) * p / 100.0
    f = int(k)
    c = min(f + 1, len(sorted_vals) - 1)
    return sorted_vals[f] + (sorted_vals[c] - sorted_vals[f]) * (k - f)


class MetricsTracker:
    def __init__(self, clock: Callable[[], float] = time.time,
                 window_s: float = 30.0) -> None:
        self.clock = clock
        self.window_s = window_s
        self._lock = threading.RLock()
        self._finished_images: dict[str, int] = {}
        self._finished_queries: dict[str, int] = {}
        # (finish_time, normalized_per_query_time) per model (`:662-665`)
        self._proc: dict[str, list[tuple[float, float]]] = {}
        # (finish_time, n_images) per model for the rate window (`:649-652`)
        self._images: dict[str, list[tuple[float, int]]] = {}
        # last-seen LM serving gauges per pool (prefix_hit_rate,
        # cached_tokens_saved, kv_blocks_free/used — serve/prefix_cache.py);
        # point-in-time values, not windowed series
        self._lm_gauges: dict[str, dict] = {}
        # last-seen QoS gateway gauges per pool (per-class queue depth,
        # reject rate, queue-wait p50/p99 — serve/gateway.py); the gateway
        # keeps its own windows, these are the flattened readback
        self._gw_gauges: dict[str, dict] = {}
        # last-seen autoscaler gauges per replica group (replica count,
        # draining count, decisions_total — serve/autoscaler.py)
        self._as_gauges: dict[str, dict] = {}
        # named event counters (wal_skipped_standby_down, stale-epoch
        # rejections, …) — node-LOCAL observability, deliberately not
        # replicated in to_wire/load_wire: a counter describes what THIS
        # node saw, adopting another node's count would double-report
        self._counters: dict[str, int] = {}

    # -- recording --------------------------------------------------------

    def record_counter(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)
            return self._counters[name]

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def record_task(self, model: str, n_items: int, elapsed_s: float,
                    batch_size: int) -> None:
        now = self.clock()
        norm = (elapsed_s / max(n_items, 1)) * batch_size
        with self._lock:
            self._finished_images[model] = (
                self._finished_images.get(model, 0) + n_items)
            self._proc.setdefault(model, []).append((now, norm))
            self._images.setdefault(model, []).append((now, n_items))

    def record_query_done(self, model: str) -> None:
        with self._lock:
            self._finished_queries[model] = (
                self._finished_queries.get(model, 0) + 1)

    def record_lm_gauges(self, pool: str, gauges: dict) -> None:
        """Latest LM prefix-cache gauges for ``pool`` (overwritten per
        read — gauges, not counters; the C8 surface reads them back via
        `lm_gauges`)."""
        with self._lock:
            self._lm_gauges[pool] = dict(gauges)

    def record_gateway_gauges(self, pool: str, gauges: dict) -> None:
        """Latest QoS gateway gauges for ``pool`` (same overwrite-per-read
        contract as `record_lm_gauges`; read back via `gateway_gauges`)."""
        with self._lock:
            self._gw_gauges[pool] = dict(gauges)

    def record_autoscale_gauges(self, group: str, gauges: dict) -> None:
        """Latest autoscaler gauges for replica ``group`` (same
        overwrite-per-read contract; read back via `autoscale_gauges`)."""
        with self._lock:
            self._as_gauges[group] = dict(gauges)

    # -- reading ----------------------------------------------------------

    def _prune(self, series: list[tuple[float, float]] | list[tuple[float, int]],
               now: float) -> None:
        cutoff = now - self.window_s
        while series and series[0][0] < cutoff:
            series.pop(0)

    def finished_images(self, model: str) -> int:
        with self._lock:
            return self._finished_images.get(model, 0)

    def finished_queries(self, model: str) -> int:
        with self._lock:
            return self._finished_queries.get(model, 0)

    def image_rate(self, model: str) -> float:
        """Images/sec over the sliding window."""
        now = self.clock()
        with self._lock:
            series = self._images.setdefault(model, [])
            self._prune(series, now)
            return sum(n for _, n in series) / self.window_s

    def query_rate(self, model: str, batch_size: int) -> float:
        """Standard-size queries/sec over the sliding window (`:1027-1028`)."""
        return self.image_rate(model) / max(batch_size, 1)

    def processing_stats(self, model: str) -> ProcessingStats | None:
        """[avg, p25, p50, p75, stddev] of normalized per-query times in the
        window — honest numbers for c2 (`:618-621`), None when no data."""
        now = self.clock()
        with self._lock:
            series = self._proc.setdefault(model, [])
            self._prune(series, now)
            vals = sorted(t for _, t in series)
        if not vals:
            return None
        return ProcessingStats(
            avg=statistics.fmean(vals),
            q1=_percentile(vals, 25), q2=_percentile(vals, 50),
            q3=_percentile(vals, 75),
            stddev=statistics.pstdev(vals) if len(vals) > 1 else 0.0,
            n=len(vals))

    def reset_processing(self, model: str | None = None) -> None:
        """Drop the windowed timing series for one model (or all): the
        fair scheduler's `avg_query_time` signal must not carry one-time
        compile cost, so a warm-up pass resets here and the first REAL
        query starts the steady-state signal (the reference's 7/3 worked
        example is a steady-state split). Finished-counters and LM gauges
        survive — they are totals, not service-time signal."""
        with self._lock:
            if model is None:
                self._proc.clear()
                self._images.clear()
            else:
                self._proc.pop(model, None)
                self._images.pop(model, None)

    def lm_gauges(self, pool: str) -> dict | None:
        with self._lock:
            g = self._lm_gauges.get(pool)
            return dict(g) if g is not None else None

    def gateway_gauges(self, pool: str) -> dict | None:
        with self._lock:
            g = self._gw_gauges.get(pool)
            return dict(g) if g is not None else None

    def autoscale_gauges(self, group: str) -> dict | None:
        with self._lock:
            g = self._as_gauges.get(group)
            return dict(g) if g is not None else None

    def avg_query_time(self, model: str) -> float:
        """Feed for the fair scheduler (`model_average_inference_time`,
        `:504-506`). 0.0 = no history yet."""
        s = self.processing_stats(model)
        return s.avg if s else 0.0

    # -- Prometheus text exposition ---------------------------------------

    def prometheus_text(self, node: str,
                        extra_counters: dict[str, int] | None = None,
                        extra_gauges: dict[str, float] | None = None) -> str:
        """Text-format exposition (prometheus.io/docs/instrumenting/
        exposition_formats) of everything this tracker holds: event
        counters, per-model rates/percentiles, LM prefix-cache and QoS
        gateway gauges. ``extra_counters``/``extra_gauges`` merge
        process-wide series the tracker doesn't own (comm/retry.py
        counters, span-store depth) into the same scrape."""
        esc = (lambda s: str(s).replace("\\", "\\\\").replace('"', '\\"'))
        lines: list[str] = []

        def emit(metric: str, kind: str, value, **labels) -> None:
            if not any(ln.startswith(f"# TYPE {metric} ")
                       for ln in lines):
                lines.append(f"# TYPE {metric} {kind}")
            lab = ",".join(f'{k}="{esc(v)}"' for k, v
                           in [("node", node), *sorted(labels.items())])
            lines.append(f"{metric}{{{lab}}} {float(value):g}")

        with self._lock:
            counters = dict(self._counters)
            models = sorted(set(self._finished_images)
                            | set(self._finished_queries))
            lm_gauges = {p: dict(g) for p, g in self._lm_gauges.items()}
            gw_gauges = {p: dict(g) for p, g in self._gw_gauges.items()}
            as_gauges = {p: dict(g) for p, g in self._as_gauges.items()}
        for name, v in sorted({**counters,
                               **(extra_counters or {})}.items()):
            emit("idunno_events_total", "counter", v, name=name)
        for m in models:
            emit("idunno_finished_images_total", "counter",
                 self.finished_images(m), model=m)
            emit("idunno_finished_queries_total", "counter",
                 self.finished_queries(m), model=m)
            emit("idunno_image_rate", "gauge", self.image_rate(m), model=m)
            ps = self.processing_stats(m)
            if ps is not None:
                for q, v in (("avg", ps.avg), ("p25", ps.q1),
                             ("p50", ps.q2), ("p75", ps.q3)):
                    emit("idunno_processing_seconds", "gauge", v,
                         model=m, quantile=q)
        for pool, g in sorted(lm_gauges.items()):
            for k, v in sorted(g.items()):
                if isinstance(v, (int, float)):
                    emit("idunno_lm_gauge", "gauge", v, pool=pool, name=k)
        for pool, g in sorted(gw_gauges.items()):
            for k, v in sorted(g.items()):
                if isinstance(v, (int, float)):
                    emit("idunno_gateway_gauge", "gauge", v,
                         pool=pool, name=k)
        for group, g in sorted(as_gauges.items()):
            for k, v in sorted(g.items()):
                if isinstance(v, (int, float)):
                    emit("idunno_autoscale_gauge", "gauge", v,
                         group=group, name=k)
        for name, v in sorted((extra_gauges or {}).items()):
            emit("idunno_gauge", "gauge", v, name=name)
        return "\n".join(lines) + "\n"

    # -- failover serialization ------------------------------------------

    def to_wire(self) -> dict:
        with self._lock:
            return {"finished_images": dict(self._finished_images),
                    "finished_queries": dict(self._finished_queries),
                    "proc": {m: [list(x) for x in v]
                             for m, v in self._proc.items()},
                    "images": {m: [list(x) for x in v]
                               for m, v in self._images.items()},
                    "lm_gauges": {m: dict(g) for m, g
                                  in self._lm_gauges.items()},
                    "gw_gauges": {m: dict(g) for m, g
                                  in self._gw_gauges.items()},
                    "as_gauges": {m: dict(g) for m, g
                                  in self._as_gauges.items()}}

    def load_wire(self, d: dict) -> None:
        with self._lock:
            self._finished_images = {k: int(v) for k, v
                                     in d.get("finished_images", {}).items()}
            self._finished_queries = {k: int(v) for k, v
                                      in d.get("finished_queries", {}).items()}
            self._proc = {m: [(float(a), float(b)) for a, b in v]
                          for m, v in d.get("proc", {}).items()}
            self._images = {m: [(float(a), int(b)) for a, b in v]
                            for m, v in d.get("images", {}).items()}
            self._lm_gauges = {m: dict(g) for m, g
                               in d.get("lm_gauges", {}).items()}
            self._gw_gauges = {m: dict(g) for m, g
                               in d.get("gw_gauges", {}).items()}
            self._as_gauges = {m: dict(g) for m, g
                               in d.get("as_gauges", {}).items()}
