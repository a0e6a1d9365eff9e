"""Run one cell of the benchmark and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic mix,
limits and per-layer metrics are found by name (``perfbench/__init__``).
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy time over a
profiled sub-window. Every run checks what its window produced against
the plain reference and prints each number compared beside its limit, as
the last lines on standard error and under ``check``, the line's last
key. The last line on standard output is the result, and nothing is
printed there when the run cannot stand: no card, fewer cards than the
cell asks for, a failure, or a JAX module loaded in this process.

The program's build and kernel caches stay inside the checkout, at fixed
paths: the port builds its CUDA sources under ``idunno_tpu_torch/build/``,
and ``TRITON_CACHE_DIR`` and ``TORCH_EXTENSIONS_DIR`` point under
``.perfbench-cache/``.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from perfbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "idunno_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: str) -> None:
    """The program's kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".perfbench-cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``idunno_tpu_torch`` is not ``idunno_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def per_layer(cell, outcome, device_name: str) -> dict:
    """Each per-layer metric the cell reports, read by its own reader;
    a reader that finds nothing to read leaves its metric out."""
    from perfbench.peaks import peaks_for

    readings = SimpleNamespace(
        cell=cell, config=cell.config, traffic=cell.traffic,
        counters=outcome.counters, end_to_end=outcome.end_to_end,
        trace=outcome.trace, trace_counters=outcome.trace_counters,
        peaks=peaks_for(device_name))
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell, outcome, setup_s: float, traced: bool, device_name: str,
           count: int) -> dict:
    from perfbench import trace as trace_mod

    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if traced:
        metrics = per_layer(cell, outcome, device_name)
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": units["setup_s"]}}
        for name, value in outcome.end_to_end.items():
            metrics[name] = {"value": float(value), "unit": units[name]}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": all(c.ok for c in outcome.compared)
            and bool(outcome.compared),
            "attempted": int(outcome.attempted), "failed": int(outcome.failed),
            "metrics": metrics, "device": device}
    if traced and outcome.trace is not None:
        device["busy_s"] = outcome.trace["busy_s"]
        device["window_s"] = outcome.trace["window_s"]
        line["breakdown"] = {
            "device_ops": trace_mod.top_ops(outcome.trace),
            "idle_gaps": [[n[:64], s] for n, s in outcome.trace["idle_gaps"]]}
    line["card"] = card_line()
    line["check"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.compared}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(spec.ROOT)
    cell = spec.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")
    outcome = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                         device)
    setup_s = outcome.counters["window_start"] - T_START
    found = loaded_forbidden()
    if found:
        print(f"modules the port must not load are loaded: {found}",
              file=sys.stderr)
        return 3
    line = result(cell, outcome, setup_s, bool(args.trace),
                  torch.cuda.get_device_name(device), cell.chips)
    print("counters " + json.dumps(
        {k: v for k, v in outcome.counters.items() if not isinstance(v, list)}
        | {"readings": outcome.readings}), file=sys.stderr)
    for c in outcome.compared:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
