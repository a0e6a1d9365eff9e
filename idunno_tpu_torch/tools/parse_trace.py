"""Apportion a Kineto trace into device time by kernel and by class.

The port's counterpart of ``tools/parse_trace.py``, which reads a TPU's
XSpace protos. This one reads the Chrome trace JSON (``.json`` or
``.json.gz``) that ``utils/tracing.py:trace`` writes (``torch.profiler``
with Kineto), or the newest such file under a directory:

    python -m idunno_tpu_torch.tools.parse_trace <trace or dir> [out.json]
        [--steps N] [--top 40] [--cpu]

Device time is the time of the card's own events: kernels (those inside a
replayed CUDA graph included), memcpys and memsets. A user annotation
that Kineto projects onto the device timeline spans kernels already
counted and is left out, as ``chip_smoke.py:device_profile`` leaves it,
and so are the spin kernels with which ``trace`` opens a CUDA window
(``utils/tracing.py:WARMUP_KERNEL``; ``warmup_kernels`` counts them).
The record has the JAX tool's shape (``source``, the device total in ms,
``ops`` rows with ``total_ms``, ``pct`` and ``count``, an ``(other)`` row,
and ``steps`` and ``per_step_ms`` when steps are given) and adds:

- ``classes``: device ms by class: the port's kernels K1-K5 by their
  symbols (``KERNEL_SYMBOLS``), GEMMs (cuBLAS, CUTLASS, ``sm90_xmma``),
  copies and casts (memcpys, memsets, copy kernels), collectives
  (``nccl``), elementwise passes and reductions, and the rest;
  ``kernel_counts`` counts K1-K5's kernels;
- ``gaps``: the device's idle intervals between its first event and its
  last, longest first, each named by the host operator (``cpu_op``, or a
  ``user_annotation`` such as a ``record_function`` range) that was open,
  innermost, on the thread that launched the event after the gap, when
  the gap began: what the host was doing while the card waited.

Times are the trace's microseconds converted to ms, unrounded.
"""
from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
import sys
from collections import defaultdict

# the port's kernels (``idunno_tpu_torch/csrc/``) by their symbols, and the
# launch counter (``ops/launches.py``) of each
KERNEL_SYMBOLS = {
    "K1": ("crop_normalize_vec16", "crop_normalize_scalar"),
    "K2": ("flash_fwd", "flash_fwd_tc"),
    "K3": ("paged_fwd",),
    "K4": ("flash_bwd_dq", "flash_bwd_dq_tc"),
    "K5": ("flash_bwd_dkv", "flash_bwd_dkv_tc"),
}
LAUNCH_NAMES = {"K1": "preprocess", "K2": "flash_attention",
                "K3": "paged_attention", "K4": "flash_attention_bwd_dq",
                "K5": "flash_attention_bwd_dkv"}
CLASSES = ("K1", "K2", "K3", "K4", "K5", "gemm", "copy_cast", "collective",
           "elementwise_reduce", "other")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")

# a symbol as the kernel's own name: after a space, a qualifier or the
# start, and before its template arguments or parameters (so
# ``pytorch_flash::flash_fwd_kernel`` is not K2)
_SYMBOL = {k: re.compile(r"(?:^|[\s:*&])(?:%s)\s*[<(]" % "|".join(v))
           for k, v in KERNEL_SYMBOLS.items()}
_GEMM = ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")
_ELEMENTWISE = ("elementwise", "reduce", "softmax", "norm", "scan", "fill")


def load_trace(path: str) -> tuple[dict, str]:
    """The Chrome trace document at ``path`` (a file, or the newest
    ``*.json``/``*.json.gz`` trace under a directory) and its path."""
    if os.path.isdir(path):
        hits = sorted(glob.glob(os.path.join(path, "**", "*.json*"),
                                recursive=True), key=os.path.getmtime)
        hits = [h for h in hits if h.endswith((".json", ".json.gz"))]
        if not hits:
            raise FileNotFoundError(f"no *.json or *.json.gz under {path}")
        path = hits[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f), path


def kernel_class(name: str, cat: str = "kernel") -> str:
    """The class of a device event (``CLASSES``)."""
    for k, pat in _SYMBOL.items():
        if pat.search(name):
            return k
    low = name.lower()
    if "nccl" in low:
        return "collective"
    if cat in ("gpu_memcpy", "gpu_memset") or "copy" in low \
            or low.startswith(("memcpy", "memset")):
        return "copy_cast"
    if any(s in low for s in _GEMM):
        return "gemm"
    if any(s in low for s in _ELEMENTWISE):
        return "elementwise_reduce"
    return "other"


def _device_events(doc: dict, warmup: bool = False) -> list[dict]:
    """The card's events of ``doc``: those of the region, or (``warmup``)
    the spin kernels ``trace`` opened the window with."""
    from idunno_tpu_torch.utils.tracing import WARMUP_KERNEL

    return [e for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and str(e.get("cat", "")).lower()
            in DEVICE_CATS and (WARMUP_KERNEL in e.get("name", "")) == warmup]


def _host_op_at(t: float, ops: list[dict], starts: list[float]
                ) -> str | None:
    """The innermost (latest-starting) of ``ops`` (sorted by start,
    ``starts`` their starts) open at time ``t``."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if t < ops[i]["ts"] + ops[i].get("dur", 0.0):
            return ops[i]["name"]
    return None


def idle_gaps(doc: dict, top: int = 20) -> dict:
    """The device's idle intervals between its first event's start and
    its last event's end (the union of its events' intervals taken over
    every stream), longest first, the ``top`` longest each named by the
    host operator open on the thread that launched the next event when
    the gap began."""
    dev = sorted(_device_events(doc), key=lambda e: e["ts"])
    if not dev:
        return {"window_ms": 0.0, "idle_ms": 0.0, "gap_count": 0,
                "gaps": []}
    gaps = []
    end = dev[0]["ts"] + dev[0].get("dur", 0.0)
    for e in dev[1:]:
        if e["ts"] > end:
            gaps.append((e["ts"] - end, end, e))
        end = max(end, e["ts"] + e.get("dur", 0.0))
    window_ms = (end - dev[0]["ts"]) / 1e3
    idle_ms = sum(g[0] for g in gaps) / 1e3
    gaps.sort(key=lambda g: -g[0])
    launcher = {}      # correlation id → (pid, tid) of the runtime call
    host: dict = defaultdict(list)
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launcher[corr] = (e.get("pid"), e.get("tid"))
        elif cat in HOST_CATS:
            host[(e.get("pid"), e.get("tid"))].append(e)
    for ops in host.values():
        ops.sort(key=lambda e: e["ts"])
    starts = {k: [e["ts"] for e in ops] for k, ops in host.items()}
    named = []
    for dur, start, nxt in gaps[:top]:
        where = launcher.get((nxt.get("args") or {}).get("correlation"))
        op = (_host_op_at(start, host[where], starts[where])
              if where in host else None)
        named.append({"start_us": start, "ms": dur / 1e3,
                      "before": nxt["name"], "host_op": op})
    return {"window_ms": window_ms, "idle_ms": idle_ms,
            "gap_count": len(gaps), "gaps": named}


def apportion(path: str, steps: int | None = None, top: int = 40) -> dict:
    """Device time of the trace at ``path`` by kernel, by class, and the
    device's idle gaps (module docstring)."""
    doc, src = load_trace(path)
    agg: dict = defaultdict(lambda: [0.0, 0])
    classes = dict.fromkeys(CLASSES, 0.0)
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for e in _device_events(doc):
        ms = e.get("dur", 0.0) / 1e3
        row = agg[e["name"]]
        row[0] += ms
        row[1] += 1
        cls = kernel_class(e["name"], str(e.get("cat", "")).lower())
        classes[cls] += ms
        if cls in counts:
            counts[cls] += 1
    total = sum(t for t, _ in agg.values())
    rows = sorted(((n, t, c) for n, (t, c) in agg.items()),
                  key=lambda r: -r[1])
    out_rows, other_ms, other_c = [], 0.0, 0
    for i, (name, t, c) in enumerate(rows):
        pct = 100.0 * t / total if total else 0.0
        if i < top or pct >= 0.5:
            out_rows.append({"op": name, "total_ms": t, "pct": pct,
                             "count": c})
        else:
            other_ms += t
            other_c += c
    if other_c:
        out_rows.append({"op": "(other)", "total_ms": other_ms,
                         "pct": 100.0 * other_ms / total, "count": other_c})
    out = {"source": src, "device_total_ms": total, "ops": out_rows,
           "classes": classes, "kernel_counts": counts,
           "warmup_kernels": len(_device_events(doc, warmup=True)),
           **idle_gaps(doc, top)}
    if steps:
        out["steps"] = steps
        out["per_step_ms"] = total / steps
    return out


def main(argv: list[str] | None = None) -> int:
    from idunno_tpu_torch.tools import device, parser, stamp, write

    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("out_json", nargs="?")
    ap.add_argument("--steps", type=int, default=None,
                    help="divide totals into per-step numbers")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    if dev is None:
        return 2
    out = stamp(apportion(args.trace, steps=args.steps, top=args.top), dev)
    if args.out_json:
        write(out, args.out_json)
    text = json.dumps(out)
    print(text if len(text) < 8000 else json.dumps(
        {k: v for k, v in out.items() if k not in ("ops", "gaps")}
        | {"n_ops": len(out["ops"]), "n_gaps": len(out["gaps"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
