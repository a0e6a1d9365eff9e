"""Tracing and device-side step timing, a port of
``idunno_tpu/utils/tracing.py`` over ``torch.profiler``.

PyTorch launches CUDA work asynchronously: a call returns once its kernels
are queued, so a host clock around it measures the enqueue. On the card
the first call of a shape also builds the CUDA kernels (``ops/
cuda_build.py``) and may capture a CUDA graph. This module gives the
primitives the serving metrics and the benches build on:

- ``device_timed``: wrap a callable so each call waits for the card's work
  on its result and reports its seconds, flagging the first call of each
  argument shape (the build and capture call) as not warm.
- ``StepTimer``: accumulate step durations and give the reference's stats
  (average, quartiles, standard deviation).
- ``trace``: profile the wrapped region with ``torch.profiler`` (CPU
  operators of every thread, and the card's kernels, those inside a
  replayed CUDA graph included) into a Chrome trace under ``log_dir``.
  One trace at a time per process.
- ``annotate``: a named range inside a trace.
- ``cuda_ms`` and ``graph_ms``: a call's mean device milliseconds by
  CUDA events around a loop of calls, or by replaying them captured in
  one CUDA graph where the host's enqueue would outlast the device work.
"""
from __future__ import annotations

import contextlib
import os
import socket
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass
class TimedCall:
    seconds: float
    compiled: bool       # False on the first call of a shape (build, capture)


def _leaves(tree: Any) -> list:
    """The leaves of nested lists, tuples and dicts (dict values)."""
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    if isinstance(tree, dict):
        return [x for item in tree.values() for x in _leaves(item)]
    return [tree]


def _block(tree: Any) -> bool:
    """Wait for the work on every CUDA device that holds a tensor of
    ``tree``; returns whether ``tree`` held any tensor at all."""
    tensors = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return bool(tensors)


def device_timed(fn: Callable[..., Any]) -> Callable[..., tuple[Any, TimedCall]]:
    """Wrap ``fn`` → ``(out, TimedCall)`` per call.

    Waits for the card's work on the CUDA tensors of the result, so
    ``seconds`` covers their execution, not the enqueue. A result without
    any tensor (a server's step, which returns a count) waits for the
    current CUDA device when CUDA is in use.

    The compile flag follows the JAX module's first-seen-shapes rule,
    keyed on each argument's shape, dtype and device: the first call of a
    key (which on the card builds the kernels and may capture a graph) is
    ``compiled=False``. Anything that rebuilds without changing the
    arguments' shapes is labelled warm."""
    seen_shapes: set[tuple] = set()

    def wrapped(*args, **kwargs):
        key = tuple(
            (tuple(a.shape), str(a.dtype), str(a.device))
            if isinstance(a, torch.Tensor) else (None, None, None)
            for a in _leaves((args, kwargs)))
        first = key not in seen_shapes
        seen_shapes.add(key)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if not _block(out) and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return out, TimedCall(seconds, compiled=not first)

    return wrapped


@dataclass
class StepTimer:
    """Step-duration accumulator with the reference's stats shape."""

    durations_s: list[float] = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.durations_s.append(seconds)

    @contextlib.contextmanager
    def measure(self, result_to_block: Any | None = None):
        """Time the body; waits for the card's work on ``out["result"]``
        (the dict yielded) or else on ``result_to_block``, where they
        hold CUDA tensors."""
        t0 = time.perf_counter()
        out: dict[str, Any] = {}
        yield out
        if "result" in out:
            _block(out["result"])
        elif result_to_block is not None:
            _block(result_to_block)
        self.record(time.perf_counter() - t0)

    def stats(self) -> dict[str, float] | None:
        """avg / quartiles / stddev over recorded steps (None if empty)."""
        d = sorted(self.durations_s)
        if not d:
            return None
        n = len(d)

        def pct(p: float) -> float:
            if n == 1:
                return d[0]
            pos = p * (n - 1)
            lo = int(pos)
            hi = min(lo + 1, n - 1)
            return d[lo] + (d[hi] - d[lo]) * (pos - lo)

        return {
            "count": float(n),
            "average": sum(d) / n,
            "p25": pct(0.25),
            "p50": pct(0.50),
            "p75": pct(0.75),
            "stddev": statistics.pstdev(d) if n > 1 else 0.0,
        }


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches, by CUDA
    events, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device milliseconds of ``fn`` with the host out of the way:
    ``iters`` calls captured into one CUDA graph, replayed ``replays``
    times between CUDA events. For calls whose device time is shorter
    than the host's enqueue time (a small kernel behind a Python
    wrapper), where `cuda_ms` would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


# torch.profiler is one per process (Kineto and CUPTI are process-wide), so
# the rule that only one trace runs at a time is kept per process too
_TRACE_LOCK = threading.Lock()
_active_trace: list[str] = []

# Kineto drops every card activity that lies outside the profiling window,
# whose ends are taken on the host's clock when the profiler starts and
# stops. The card's timestamps can sit a millisecond or more from that
# clock, and a region that ends on a synchronize closes the window a few
# hundred microseconds after its last kernel, so the last kernels could
# fall outside it. A CUDA trace pads the window by this much on each side.
TRACE_PAD_S = 0.05
# The profiler can lose the records of the first kernels that run in a
# window: on the H100, the first 47-58 of some windows (about a
# millisecond of launches), while their runtime calls are recorded. A CUDA
# trace therefore opens with this many spin kernels (``torch.cuda._sleep``)
# ahead of the region, and its readers leave out the kernels whose name
# holds ``WARMUP_KERNEL``.
WARMUP_KERNELS = 200
WARMUP_KERNEL = "spin_kernel"


def _all_threads_config():
    """Kineto's all-threads mode (CPU operators of every thread, not only
    the one that started the trace) where this torch has it, else None."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:              # an older torch: the starting thread only
        return None


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the wrapped region with ``torch.profiler`` and yield the
    profile (its ``events()`` are readable after the region). CPU operators
    of every thread, plus the card's kernels and runtime calls on a
    machine with a card. On a clean exit the Chrome trace is written under
    ``log_dir`` as ``<host>.<pid>.<ns>.pt.trace.json.gz``; ``log_dir=None``
    keeps the trace in memory only.

    Only one trace runs at a time in a process: a second ``trace`` while
    one is active raises a RuntimeError naming the active one's log_dir.
    The profiler is stopped however the region ends. Where CUDA is in use
    the window opens with ``WARMUP_KERNELS`` spin kernels, then
    ``TRACE_PAD_S`` before the region, and closes ``TRACE_PAD_S`` after
    the card has finished the region's work."""
    with _TRACE_LOCK:
        if _active_trace:
            raise RuntimeError(
                f"a trace into {_active_trace[0]!r} is already running in "
                "this process; torch.profiler runs one at a time")
        _active_trace.append(str(log_dir))
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        cuda = torch.profiler.ProfilerActivity.CUDA in activities
        with torch.profiler.profile(
                activities=activities,
                experimental_config=_all_threads_config()) as prof:
            if cuda and torch.cuda.is_initialized():
                for _ in range(WARMUP_KERNELS):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                time.sleep(TRACE_PAD_S)
            yield prof
            if cuda and torch.cuda.is_initialized():
                torch.cuda.synchronize()
                time.sleep(TRACE_PAD_S)
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"{socket.gethostname()}.{os.getpid()}."
                         f"{time.time_ns()}.pt.trace.json.gz"))
    finally:
        with _TRACE_LOCK:
            _active_trace.clear()


def annotate(name: str):
    """Named sub-region for the profiler timeline."""
    return torch.profiler.record_function(name)
