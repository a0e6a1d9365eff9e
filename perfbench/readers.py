"""Arithmetic the per-layer readers (``perfbench/metrics/<name>.py``)
share. Each reader takes the run's readings (``run.per_layer``): the
cell, its configuration and mix, the driver's counters over the window,
the reduced trace of the profiled sub-window and the driver's counters at
its two ends, and the card's peaks. A reader returns None where it finds
nothing to read, never 0 for a share of a peak or a roofline.
"""
from __future__ import annotations

from perfbench import peaks as peaks_mod
from perfbench import trace as trace_mod

# the port's kernels by their symbols (idunno_tpu_torch/csrc/*.cu)
K1 = ("crop_normalize_vec16", "crop_normalize_scalar")
K2 = ("flash_fwd", "flash_fwd_tc")
K3 = ("paged_fwd",)
K4 = ("flash_bwd_dq", "flash_bwd_dq_tc")
K5 = ("flash_bwd_dkv", "flash_bwd_dkv_tc")


def idle_share(r) -> float | None:
    """% of the traced window in which no operation ran on the card."""
    if r.trace is None or r.trace["window_s"] <= 0 or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])


def mfu(r, flops: float) -> float | None:
    """% of the card's bf16 peak that ``flops`` over the window reach."""
    if r.peaks is None or flops <= 0 or r.counters.get("window_s", 0) <= 0:
        return None
    return 100.0 * flops / r.counters["window_s"] / r.peaks["bf16_flops"]


def roofline(r, patterns: tuple, flops_per_call: float,
             bytes_per_call: float, calls: int | None = None
             ) -> float | None:
    """% of the least time (``peaks.least_seconds``) of the traced calls
    of the kernels named by ``patterns`` over their traced device time;
    ``calls`` overrides the count of traced calls."""
    if r.trace is None or r.peaks is None:
        return None
    secs, n = trace_mod.kernel_seconds(r.trace, patterns)
    n = n if calls is None else calls
    if secs <= 0 or n <= 0:
        return None
    least = peaks_mod.least_seconds(flops_per_call * n, bytes_per_call * n,
                                    r.peaks)
    return 100.0 * least / secs


def traced_delta(r, key: str) -> float | None:
    """How much the driver's counter ``key`` grew over the traced
    sub-window."""
    tc = r.trace_counters
    if "start" not in tc or "stop" not in tc:
        return None
    return tc["stop"][key] - tc["start"][key]
