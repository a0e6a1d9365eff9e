"""Profiling a sub-window of a run and reducing the trace to numbers.

The window is profiled with ``torch.profiler`` (CPU operators and the
card's kernels, those inside a replayed CUDA graph included) and written
as a Chrome trace under ``TMPDIR``, read back and deleted. The reduction
is a copy of the port's apportioner
(``idunno_tpu_torch/tools/parse_trace.py``), kept here so that the
yardstick does not move when the program does:

- device events are the card's kernels, memcpys and memsets; the spin
  kernels that open the profile (``SPIN_KERNELS`` of them, because the
  profiler can lose the records of a window's first kernels) are left out;
- busy time is the union of the device events' intervals inside the
  window, the window being the host range ``WINDOW_RANGE`` that the
  harness opens and closes around the profiled steps;
- idle gaps are the intervals between device events inside the window,
  each named by the host operator open, innermost, on the thread that
  launched the event after the gap, when the gap began.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

SPIN_KERNELS = 200
SPIN_NAME = "spin_kernel"
WINDOW_RANGE = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
PAD_S = 0.05


class Profile:
    """``torch.profiler`` over a sub-window: ``start`` and ``stop`` at two
    boundaries of a driver's loop, ``summary`` afterwards (the export and
    the reduction take seconds, so they wait until the window is over).
    With ``cuda`` the card's activity is traced too, the profile opens
    with the spin kernels, and the card is synchronised at both ends of
    the window range."""

    def __init__(self, cuda: bool = True) -> None:
        self.cuda = cuda
        self._prof = self._range = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        if self.cuda:
            for _ in range(SPIN_KERNELS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        self._range = torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        if self.cuda:
            time.sleep(PAD_S)
        self._prof.__exit__(None, None, None)

    def summary(self) -> dict:
        with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            with open(path) as f:
                return summarize(json.load(f))


def _window(doc: dict) -> tuple[float, float] | None:
    """The host range ``WINDOW_RANGE`` (start, end) in the trace's µs."""
    for e in doc.get("traceEvents", []):
        if (e.get("ph") == "X" and e.get("name") == WINDOW_RANGE
                and str(e.get("cat", "")).lower() in HOST_CATS):
            return e["ts"], e["ts"] + e.get("dur", 0.0)
    return None


def device_events(doc: dict) -> list[dict]:
    return [e for e in doc.get("traceEvents", [])
            if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_CATS
            and SPIN_NAME not in e.get("name", "")]


def _host_op_at(t: float, ops: list[dict], starts: list[float]):
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if t < ops[i]["ts"] + ops[i].get("dur", 0.0):
            return ops[i]["name"]
    return None


def summarize(doc: dict, top: int = 10) -> dict:
    """The window's numbers: its length and busy time (s), device seconds
    and event counts by name, memcpy seconds by direction, and the ``top``
    longest idle gaps named by host operator. Device events are clipped
    to the window."""
    win = _window(doc)
    events = sorted(device_events(doc), key=lambda e: e["ts"])
    if win is None:
        lo = events[0]["ts"] if events else 0.0
        hi = max((e["ts"] + e.get("dur", 0.0) for e in events), default=lo)
        win = (lo, hi)
    lo, hi = win
    clipped = []
    for e in events:
        s, t = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0.0), hi)
        if t > s:
            clipped.append((s, t, e))
    by_name: dict = defaultdict(lambda: [0.0, 0])
    memcpy: dict = defaultdict(float)
    for s, t, e in clipped:
        row = by_name[e["name"]]
        row[0] += (t - s) / 1e6
        row[1] += 1
        if str(e.get("cat", "")).lower() == "gpu_memcpy":
            memcpy[_direction(e)] += (t - s) / 1e6
    busy, gaps, cursor = 0.0, [], lo
    for s, t, e in clipped:
        if s > cursor:
            gaps.append((s - cursor, cursor, e))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if hi > cursor:
        gaps.append((hi - cursor, cursor, None))
    gaps.sort(key=lambda g: -g[0])
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "kernels": {k: (v[0], v[1]) for k, v in by_name.items()},
            "memcpy_s": dict(memcpy),
            "idle_gaps": _name_gaps(doc, gaps[:top])}


def _direction(e: dict) -> str:
    """HtoD, DtoH, DtoD or other, from the memcpy's name or kind."""
    text = (e.get("name", "") + " " + json.dumps(e.get("args") or {})).lower()
    for key, label in (("htod", "HtoD"), ("dtoh", "DtoH"), ("dtod", "DtoD"),
                       ("h2d", "HtoD"), ("d2h", "DtoH"), ("d2d", "DtoD")):
        if key in text:
            return label
    return "other"


def _name_gaps(doc: dict, gaps: list) -> list:
    launcher, host = {}, defaultdict(list)
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launcher[corr] = (e.get("pid"), e.get("tid"))
        elif cat in HOST_CATS and e.get("name") != WINDOW_RANGE:
            host[(e.get("pid"), e.get("tid"))].append(e)
    for ops in host.values():
        ops.sort(key=lambda e: e["ts"])
    starts = {k: [e["ts"] for e in ops] for k, ops in host.items()}
    named = []
    for dur, start, nxt in gaps:
        op = None
        if nxt is not None:
            where = launcher.get((nxt.get("args") or {}).get("correlation"))
            if where in host:
                op = _host_op_at(start, host[where], starts[where])
        named.append((op or "_none_", dur / 1e6))
    return named


def top_ops(summary: dict, n: int = 10) -> list:
    """The ``n`` device operations that took most time: [name, seconds]."""
    rows = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])
    return [[name[:64], secs] for name, (secs, _) in rows[:n]]


def kernel_seconds(summary: dict, patterns: tuple[str, ...]
                   ) -> tuple[float, int]:
    """Device seconds and calls of the kernels whose name holds one of
    ``patterns`` as the kernel's own symbol (followed by ``<`` or ``(``)."""
    import re
    pat = re.compile(r"(?:^|[\s:*&])(?:%s)\s*[<(]" % "|".join(
        re.escape(p) for p in patterns))
    secs, calls = 0.0, 0
    for name, (s, c) in summary["kernels"].items():
        if pat.search(name):
            secs += s
            calls += c
    return secs, calls
