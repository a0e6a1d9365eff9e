"""What every driver shares: the measured window with its traced
sub-window, the outcome a driver hands back, and the verdict of the
output check.

A driver (``perfbench/drivers/<name>.py``, named by the traffic mix) sets
the program up, calls ``Window.start`` when set-up is over, calls
``Window.tick`` at every boundary of its loop until it returns False, then
reads the peak memory, frees the program, runs the plain reference and
returns an ``Outcome``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from perfbench import trace as trace_mod

clock = time.monotonic


@dataclass
class Compared:
    """One number of the output check beside its limit: correct while
    ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    end_to_end: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: dict | None = None
    trace_counters: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    compared: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    readings: dict = field(default_factory=dict)


class Window:
    """The measured window of ``seconds``, and with ``traced`` a profiled
    segment of ``trace["seconds"]`` outside it, so that the profiler's
    cost never falls inside the window: closed loops run it right after
    the window (``trace_after``), the open loop at the end of the traffic
    it keeps offering after the window (``open_trace``, ``close_trace``).
    The profiler is started and stopped once during set-up, so that its
    first start, which takes seconds, is paid there. ``snap`` is called
    at the segment's two ends and its counters kept, so that a per-layer
    reader can relate the trace to the work done in it."""

    def __init__(self, seconds: float, trace: dict, traced: bool,
                 cuda: bool, snap=None) -> None:
        self.seconds = float(seconds)
        self.traced = traced
        self.cuda = cuda
        self.snap = snap
        self.trace_len = float(trace["seconds"])
        self.t0 = self.t_end = None
        self.trace_counters: dict = {}
        self._profile: trace_mod.Profile | None = None
        self._summary: dict | None = None
        if traced:
            warm = trace_mod.Profile(cuda)
            warm.start()
            warm.stop()

    def start(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = clock()
        return self.t0

    @property
    def close(self) -> float:
        return self.t0 + self.seconds

    def tick(self, now: float | None = None) -> bool:
        """True while the window is open."""
        return (clock() if now is None else now) < self.close

    def finish(self) -> float:
        """Close the window at this boundary, once the card has finished
        its work; returns the window's length."""
        if self.cuda:
            torch.cuda.synchronize()
        self.t_end = clock()
        return self.t_end - self.t0

    def open_trace(self) -> None:
        if self.snap is not None:
            self.trace_counters["start"] = self.snap()
        self._profile = trace_mod.Profile(self.cuda)
        self._profile.start()

    def close_trace(self) -> None:
        self._profile.stop()
        if self.snap is not None:
            self.trace_counters["stop"] = self.snap()

    def trace_after(self, step) -> None:
        """With ``traced``: ``step()`` over and over for the segment's
        length under the profiler, right after the window."""
        if not self.traced:
            return
        self.open_trace()
        t = clock()
        while clock() - t < self.trace_len:
            step()
        self.close_trace()

    def trace_summary(self) -> dict | None:
        """The profiled segment reduced (``trace.summarize``); None in an
        untraced run. Call once the run's work is over."""
        if self._profile is not None and self._summary is None:
            self._summary = self._profile.summary()
        return self._summary


def peak_memory(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def free_device(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def limits_check(limits: dict, values: dict) -> list[Compared]:
    """Each number that ``limits`` names beside its limit; a number the
    run could not read compares as NaN, which is never within a limit."""
    return [Compared(name, float(values.get(name, float("nan"))),
                     float(limits[name]["limit"]))
            for name in limits if not name.startswith("_")]
